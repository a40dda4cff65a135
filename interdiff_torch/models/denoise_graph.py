"""Replay of a denoiser call from a captured CUDA graph.

A DDPM step of the eval path is one denoiser call of some 600 small
kernels, each dispatched by the host: the device waits on the host.
`GraphedDenoiser` is the base of both MDM denoisers: their ``denoise``
hands its eager body to :meth:`GraphedDenoiser.replayed`, which serves
the call from a `torch.cuda.CUDAGraph` of that body where the call allows
it, and runs the body eagerly otherwise.

A call replays when ``x`` is on CUDA, every input on its device, no
gradient is recorded, ``train`` is off, no ``generator`` is given and the
current stream is not capturing; anything else (training, the CPU, a
capture around the call) runs the body as it is.  Graphs are cached on
the module, at most :data:`GRAPHS`, the least recently used evicted
first, keyed by the inputs' shapes and dtypes, their device, the static
keywords (``force_mask``) and the two TF32 flags: a graph captured under
one precision never replays under another.  A key seen for the first
time is captured: a few eager calls on a side stream, then the capture,
into the module's own memory pool.

The contract of a replayed call is the eager call's: the inputs are
copied into the graph's own buffers (no tensor handed in is written), and
the output is a clone of the graph's (no tensor handed out is written by
a later call).  A graph reads the parameters' storage, so an in-place
``load_state_dict`` is followed without a capture; what re-allocates the
parameters (``.to()`` and every other ``_apply``, ``load_state_dict(
assign=True)``) drops the graphs.

In a session (`utils/profiling.py`) the counters ``denoise.calls`` (every
call), ``denoise.replays`` (calls served by a replay) and
``denoise.captures`` record the engagement.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from interdiff_torch.utils import profiling

GRAPHS = 4  # graphs a module keeps
WARMUP = 3  # eager calls on the side stream before a capture


class GraphedDenoiser(nn.Module):
    """An `nn.Module` whose ``denoise`` goes through :meth:`replayed`."""

    def __init__(self):
        super().__init__()
        # key -> (graph, its input buffers (None for a None input), its
        # output buffer)
        self._graphs: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._pool = None  # the memory pool of this module's captures

    def replayed(self, body: Callable, inputs: Tuple[Optional[torch.Tensor],
                                                     ...],
                 train: bool, generator: Optional[torch.Generator],
                 **static) -> torch.Tensor:
        """``body(*inputs, train=, generator=, **static)``, replayed from a
        graph where the call allows it (module docstring)."""
        profiling.count("denoise.calls", 1)
        x = inputs[0]
        if (train or generator is not None or not x.is_cuda
                or torch.is_grad_enabled()
                or torch.cuda.is_current_stream_capturing()
                or any(t is not None and t.device != x.device
                       for t in inputs)):
            return body(*inputs, train=train, generator=generator, **static)
        key = (tuple(None if t is None else (t.shape, t.dtype)
                     for t in inputs), x.device, tuple(sorted(static.items())),
               torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(body, inputs, static)
            self._graphs[key] = g
            if len(self._graphs) > GRAPHS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        graph, bufs, out = g
        for buf, t in zip(bufs, inputs):
            if buf is not None:
                buf.copy_(t)
        graph.replay()
        profiling.count("denoise.replays", 1)
        return out.clone()

    def _capture(self, body: Callable, inputs, static) -> tuple:
        """Warm ``body`` up on a side stream and capture it there, on
        buffers of its own that hold a copy of ``inputs``."""
        device = inputs[0].device
        bufs = tuple(None if t is None else t.clone() for t in inputs)
        with torch.cuda.device(device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    body(*bufs, train=False, generator=None, **static)
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                out = body(*bufs, train=False, generator=None, **static)
        profiling.count("denoise.captures", 1)
        return graph, bufs, out

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda(), .float() ... may re-allocate the parameters a
        # graph reads
        self._graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        if assign:  # new parameter tensors; in place, the graphs follow
            self._graphs.clear()
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def __getstate__(self):
        # a deep copy or a pickle has parameters of its own: no graph
        return {**super().__getstate__(), "_graphs": OrderedDict(),
                "_pool": None}
