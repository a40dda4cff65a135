"""SMPL-track long-term autoregressive evaluation
(`interdiff_tpu/eval/smpl_long.py`).

The reference's `eval_smpl_long.py` was never finished: it calls
`denormalize` and `correct`, which it defines nowhere
(`eval_smpl_long.py:278,285`).  The JAX package completes it around the
parts that do exist, and this is its port:

  * `get_batch` re-canonicalization (`eval_smpl_long.py:26-84`): the last
    ``past_len`` predicted frames become the new past window, translated so
    that the pelvis of its first frame sits at the origin, with no yaw
    re-alignment;
  * ``denormalize``: the inverse, the centroids added back to every
    translation of the new chunk;
  * ``correct``: the C1 seam fix-up `smooth_seam` at each chunk junction.

Everything works on the dense [B, T, 144] state; each chunk is one call of
the short-term sampler.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from interdiff_torch.eval.metrics import smooth_seam
from interdiff_torch.eval.smpl_short import SmplEvalConfig, pad_idx


def recanonicalize_state(x: torch.Tensor, pelvis: torch.Tensor,
                         cfg: SmplEvalConfig) -> Dict[str, torch.Tensor]:
    """Predicted state [B,T,144] and its pelvis [B,T,3] -> ``gt``, the new
    conditioning state (the last ``past_len`` frames as the past, the future
    a repeat of the last one), and ``centroid`` [B,3], the pelvis of the new
    first frame that was subtracted from every translation."""
    D = cfg.smpl_dim + 3
    p = cfg.past_len
    tail = x[:, -p:]
    centroid = pelvis[:, -p][:, None]  # [B,1,3]
    body = torch.cat([tail[..., :D - 3], tail[..., D - 3:D] - centroid],
                     dim=-1)
    obj = torch.cat([tail[..., D:-3], tail[..., -3:] - centroid], dim=-1)
    tail = torch.cat([body, obj], dim=-1)
    pad = tail[:, -1:].expand(-1, x.shape[1] - p, -1)
    return {"gt": torch.cat([tail, pad], dim=1), "centroid": centroid[:, 0]}


def denormalize_chunk(x: torch.Tensor, centroid: torch.Tensor,
                      cfg: SmplEvalConfig) -> torch.Tensor:
    """Inverse of :func:`recanonicalize_state` for a sampled chunk: the
    offset [B,3] added to the body's and the object's translation."""
    D = cfg.smpl_dim + 3
    c = centroid[:, None]
    return torch.cat([x[..., :D - 3], x[..., D - 3:D] + c, x[..., D:-3],
                      x[..., -3:] + c], dim=-1)


def rollout(sample_fn: Callable, pelvis_fn: Callable,
            generator: torch.Generator, gt: torch.Tensor,
            obj_points6: torch.Tensor, hand_pose: torch.Tensor,
            betas: torch.Tensor, *, num_chunks: int, cfg: SmplEvalConfig,
            seam_smooth: bool = True) -> torch.Tensor:
    """The first window and ``num_chunks`` autoregressive chunks after it
    -> the trajectory [B, past + (1 + num_chunks) * future, 144].

    ``sample_fn(generator, gt, obj_points6, hand, betas) -> x [B,T,144]``
    samples one window (its noise from ``generator``; the JAX package splits
    a key per chunk instead, so parity goes through a ``sample_fn`` that
    feeds explicit noise); ``pelvis_fn(x, hand, betas) -> [B,T,3]`` is the
    pelvis by SMPL FK.  Chunk k >= 2 is sampled in chunk k-1's canonical
    frame, so its global placement is the sum of every centroid subtracted
    so far.  The hand poses and betas shift with the window as the state
    does (`pad_idx`)."""
    x = sample_fn(generator, gt, obj_points6, hand_pose, betas)
    full = x
    idx = torch.as_tensor(pad_idx(cfg), device=x.device)
    offset = torch.zeros((x.shape[0], 3), dtype=x.dtype, device=x.device)
    for _ in range(num_chunks):
        nb = recanonicalize_state(x, pelvis_fn(x, hand_pose, betas), cfg)
        offset = offset + nb["centroid"]
        hand_pose = hand_pose[:, idx]
        betas = betas[:, idx]
        x = sample_fn(generator, nb["gt"], obj_points6, hand_pose, betas)
        x_global = denormalize_chunk(x, offset, cfg)
        full = torch.cat([full, x_global[:, cfg.past_len:]], dim=1)
        if seam_smooth:
            full = smooth_seam(full, cfg.future_len)
    return full
