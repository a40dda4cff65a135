"""Synthetic tiny-model fixtures (`interdiff_tpu/utils/fixtures.py`): a
small SMPL-H-shaped body (52 joints, 156-dim poses) and the correction
sampler over it, for tests and dry runs of the structure-exercising paths
(the sampler with correction in the loop, FK, signed distances) without
the unshipped SMPL-H pkls."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from interdiff_torch.smpl.model import SmplModel


def tiny_smpl_model(rng: np.random.Generator, V: int = 64, J: int = 22 + 30,
                    *, device=None) -> SmplModel:
    """Synthetic SMPL-H-shaped model: binary-tree kinematic topology,
    small random shape and pose directions, uniform skinning weights; the
    arrays the JAX package's `tiny_smpl_model` makes from the same
    ``rng``, in the same order.  On ``device`` (CUDA unless given)."""
    parents = np.zeros(J, dtype=np.int64)
    for j in range(1, J):
        parents[j] = (j - 1) // 2  # binary-tree topology
    return SmplModel.create(
        v_template=rng.standard_normal((V, 3)) * 0.2,
        shapedirs=rng.standard_normal((V, 3, 10)) * 0.01,
        posedirs=rng.standard_normal((V, 3, 9 * (J - 1))) * 0.001,
        j_regressor=np.abs(rng.random((J, V)))
        / np.abs(rng.random((J, V))).sum(1, keepdims=True),
        weights=np.full((V, J), 1.0 / J),  # uniform skinning weights
        parents=parents,
        faces=np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4]], dtype=np.int32),
        device=device)


def make_tiny_correction_sampler(
        model, diffusion, gt: torch.Tensor, *, num_markers: int = 40,
        n_pre: int = 4, body_seed: int = 3, proj_seed: int = 1,
        projector_state: Optional[Dict[str, torch.Tensor]] = None
) -> Callable:
    """The sampler with correction in the loop over the tiny body
    (`eval/smpl_short.py::make_sampler`): FK, the signed-distance gate and
    a projector with ``num_markers`` markers and ``n_pre`` DCT
    coefficients, the gate active on every step.  The projector holds
    ``projector_state`` (a state dict, for example a flax projector's
    through `utils/convert.py::flax_to_torch_state_dict`) or, without one,
    torch's initial weights under seed ``proj_seed``.  Built on ``gt``'s
    device; ``gt`` [B, T, 144] gives the clip length."""
    from interdiff_torch.eval.smpl_short import SmplEvalConfig, make_sampler
    from interdiff_torch.models.correction import ObjProjectorSmpl

    device = gt.device
    T = gt.shape[1]
    cfg = SmplEvalConfig(correction_t_max=diffusion.num_timesteps * 10,
                         correction_every=1, nn_chunk=None,
                         past_len=model.past_len,
                         future_len=T - model.past_len)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(proj_seed)
        projector = ObjProjectorSmpl(num_markers=num_markers, n_pre=n_pre,
                                     past_len=cfg.past_len,
                                     future_len=cfg.future_len,
                                     device=device)
    if projector_state is not None:
        projector.load_state_dict(projector_state, strict=True)
    return make_sampler(
        cfg, model, diffusion,
        smpl=tiny_smpl_model(np.random.default_rng(body_seed), device=device),
        projector=projector, markers_idx=np.arange(num_markers))
