"""Skeleton-track evaluation (`interdiff_tpu/eval/skeleton.py`, the
reference's `interdiff/eval_skeleton.py` and
`eval_skeleton_no_correction.py`): reverse diffusion with past-frame
inpainting, conditioned on the memory of `MDMSkeleton.encode`, with the
skeleton `ObjProjector` injected as a ``denoised_fn`` at t <= 500, every 50
steps, when asked.

A firing runs the projector on the clip's gt object pose and the denoised
joints and blends its rigid object (keypoints and pose) into the x0
prediction with weight ``1 - t/1000``; every row is corrected, there is no
per-row gate in this track.  The gate reads the loop's own index ``t``
(after respacing, the index into the respaced schedule, not
``timestep_map[t]``), as the JAX package passes it.  No kernel of the
port's runs on this path: the denoiser, the projector and the loop are
plain PyTorch.  The joint-object contact of the reference, a Python T x B
double loop (`eval_skeleton.py:29-31`), is one masked argmin here
(:func:`body_obj_contact`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from interdiff_torch import full_f32
from interdiff_torch.diffusion.gaussian import (
    GaussianDiffusion,
    Inpaint,
    firing_hook,
)
from interdiff_torch.models.correction import ObjProjectorSkeleton
from interdiff_torch.models.mdm_skeleton import (
    MDMSkeleton,
    rigid_keypoints_from_pose,
)
from interdiff_torch.parallel.mesh import randn_rows
from interdiff_torch.utils import profiling


@dataclass(frozen=True)
class SkeletonEvalConfig:
    past_len: int = 10
    future_len: int = 10
    num_joints: int = 21
    num_points: int = 12
    correction_t_max: int = 500
    correction_every: int = 50

    @property
    def seq_len(self) -> int:
        return self.past_len + self.future_len


def body_obj_contact(body: torch.Tensor, obj: torch.Tensor,
                     threshold: float = 0.1) -> torch.Tensor:
    """Vectorised `body_obj_to_contact` (`eval_skeleton.py:19-32`): body
    [B,T,J,3], obj [B,T,P,3] -> one-hot [B,T,J] marking the joint nearest
    to the object (the first at a tie) iff within ``threshold``."""
    d = torch.linalg.norm(body[:, :, :, None] - obj[:, :, None], dim=-1)
    min_d = d.amin(dim=3)  # [B,T,J]
    nearest = torch.argmin(min_d, dim=2)  # [B,T]
    onehot = F.one_hot(nearest, body.shape[2]).to(body.dtype)
    within = min_d.gather(2, nearest[..., None])[..., 0] < threshold
    return onehot * within[..., None].to(body.dtype)


def make_correction_denoised_fn(
    cfg: SkeletonEvalConfig, projector: ObjProjectorSkeleton, *,
    gt: torch.Tensor, zero_pose_obj: torch.Tensor,
    trace: Optional[List[Dict]] = None,
) -> Callable:
    """The correction hook ``denoised_fn(x0, t, step=None)``
    (`eval_skeleton.py:84-113`): gt [B,T,106] is the clip's state, whose
    pose block the projector reads; zero_pose_obj [B,P,3].

    It fires as `diffusion.gaussian.firing_hook` decides from ``cfg``'s
    ``correction_t_max`` and ``correction_every``.  ``trace`` receives a
    dict per firing: ``t`` and, on the card, the CUDA events ``start`` and
    ``end`` of the firing's span ``hook.firing``, whose children are
    ``hook.projector`` and ``hook.blend`` (the keypoints and the blend)."""
    bd = cfg.num_joints * 3
    od = cfg.num_points * 3
    pose_gt = gt[..., bd + od:]
    trans_gt, quat_gt = pose_gt[..., :3], pose_gt[..., 3:7]

    def correct(x: torch.Tensor, step: int) -> Tuple[torch.Tensor, None]:
        B, T = x.shape[:2]
        body = x[..., :bd]
        with profiling.span("hook.projector", cuda=x.is_cuda):
            quat_p, trans_p = projector.sample(quat_gt, trans_gt,
                                               body.reshape(B, T, -1, 3))
        with profiling.span("hook.blend", cuda=x.is_cuda):
            pose_proj = torch.cat([trans_p, quat_p], dim=-1)
            obj_proj = rigid_keypoints_from_pose(
                pose_proj, zero_pose_obj).reshape(B, T, od)
            x_corr = torch.cat([body, obj_proj, pose_proj], dim=-1)
            # the blend weights rounded as float32, as the JAX package's are
            frac = np.float32(step) / np.float32(1000.0)
            return (float(frac) * x
                    + float(np.float32(1.0) - frac) * x_corr), None

    return firing_hook(correct, t_max=cfg.correction_t_max,
                       every=cfg.correction_every, trace=trace)


def make_skeleton_sampler(
    cfg: SkeletonEvalConfig, model: MDMSkeleton,
    diffusion: GaussianDiffusion, *,
    projector: Optional[ObjProjectorSkeleton] = None,
    reuse_memory: bool = False, sampler: str = "ddpm",
    trace: Optional[List[Dict]] = None,
) -> Callable:
    """Build ``sample(skeleton, obj_points, poses, zero_pose_obj, *,
    noise=None, step_noise=None, generator=None) -> x [B,T,106]``
    (`eval_skeleton.py:115-145`); skeleton [B,T,21,3], obj_points
    [B,T,12,3], poses [B,T,7], zero_pose_obj [B,12,3].  The first
    ``past_len`` frames are inpainted.

    With a ``projector`` the loop runs :func:`make_correction_denoised_fn`
    (``trace`` goes to it).  ``reuse_memory=True`` adds the arguments
    ``memory, gt`` (the pair that ``model.encode`` returns) after
    ``zero_pose_obj``, so that a caller encodes once.  ``noise``
    [B,T,106] is the initial sample and ``step_noise`` [steps,B,T,106] the
    DDPM loop's per-step draws; what is not given is drawn from
    ``generator``.  ``sampler``: 'ddpm' | 'ddim' | 'plms'.  The sampler
    records no graph, whatever the caller's gradient mode.
    """
    GaussianDiffusion.check_sampler(sampler)
    full_f32()

    @torch.no_grad()
    def _run(skeleton, obj_points, poses, zero_pose_obj, memory, gt, *,
             noise=None, step_noise=None, generator=None):
        denoised_fn = None
        if projector is not None:
            denoised_fn = make_correction_denoised_fn(
                cfg, projector, gt=gt, zero_pose_obj=zero_pose_obj,
                trace=trace)
        if noise is None:
            noise = randn_rows(gt.shape, generator, gt.device, gt.dtype)

        def model_fn(x, ts):
            return model.denoise(x, ts, zero_pose_obj, memory)

        return diffusion.sample_loop(
            sampler, model_fn, noise=noise, step_noise=step_noise,
            generator=generator, inpaint=Inpaint.past(gt, cfg.past_len),
            denoised_fn=denoised_fn)

    if reuse_memory:
        return _run

    @torch.no_grad()
    def sample(skeleton, obj_points, poses, zero_pose_obj, *, noise=None,
               step_noise=None, generator=None):
        memory, gt = model.encode(skeleton, obj_points, poses, zero_pose_obj)
        return _run(skeleton, obj_points, poses, zero_pose_obj, memory, gt,
                    noise=noise, step_noise=step_noise, generator=generator)

    return sample


def split_skeleton_state(x: torch.Tensor, cfg: SkeletonEvalConfig
                         ) -> Dict[str, torch.Tensor]:
    """State [B,T,106] -> body [B,T,J,3], obj [B,T,P,3], pose [B,T,7]."""
    B, T = x.shape[:2]
    bd, od = cfg.num_joints * 3, cfg.num_points * 3
    return {
        "body": x[..., :bd].reshape(B, T, cfg.num_joints, 3),
        "obj": x[..., bd : bd + od].reshape(B, T, cfg.num_points, 3),
        "pose": x[..., bd + od :],
    }


def rollout_batch(x: torch.Tensor, zero_pose_obj: torch.Tensor,
                  cfg: SkeletonEvalConfig) -> Dict[str, torch.Tensor]:
    """Autoregressive re-batching (`eval_skeleton.py:71-80` `get_batch`):
    the last ``past_len`` predicted frames become the new past, padded to
    the full window by repeating the final frame."""
    parts = split_skeleton_state(x, cfg)
    T, p = x.shape[1], cfg.past_len

    def repack(a):
        pad = a[:, -1:].expand((-1, T - p) + tuple(a.shape[2:]))
        return torch.cat([a[:, -p:], pad], dim=1)

    return {
        "skeleton": repack(parts["body"]),
        "obj_points": repack(parts["obj"]),
        "poses": repack(parts["pose"]),
        "zero_pose_obj": zero_pose_obj,
    }
