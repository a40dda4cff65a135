"""SMPL-track short-term sampler (`interdiff_tpu/eval/smpl_short.py`), the
signature InterDiff inference path (`interdiff/eval_smpl_short.py`): reverse
diffusion with past-frame inpainting, conditioned on the memory of
`MDMSmpl.encode`, and the physics-informed `ObjProjector` injected as a
``denoised_fn`` at t <= 500, every 50 steps.

A firing of the correction runs SMPL forward kinematics over every frame,
vertex normals, the object->body signed nearest-neighbour sweep (kernel K2,
or K3 without pruning), the marker->object nearest neighbour (kernel K4),
the projector and a per-sample gated blend.  The loop is a Python loop; the
hook decides on the host whether a step fires, and everything per row stays
a `torch.where` on the device.  ``make_sampler(sampler=...)`` picks the
ancestral DDPM loop (the reference's default), DDIM or PLMS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import full_f32
from interdiff_torch.data.constants import MARKERSET_SSM67_SMPLH
from interdiff_torch.diffusion.gaussian import (
    GaussianDiffusion,
    Inpaint,
    firing_hook,
)
from interdiff_torch.geometry.normals import vertex_normals
from interdiff_torch.geometry.rotations import (
    matrix_to_axis_angle,
    rotation_6d_to_matrix,
)
from interdiff_torch.models.correction import ObjProjectorSmpl
from interdiff_torch.models.mdm_smpl import MDMSmpl
from interdiff_torch.ops.signed_distance import (
    nearest_neighbor,
    signed_nearest,
    signed_nearest_pruned,
)
from interdiff_torch.parallel.mesh import randn_rows
from interdiff_torch.smpl.model import SmplModel, smpl_forward
from interdiff_torch.utils import profiling
from interdiff_torch.utils.profiling import span


@dataclass(frozen=True)
class SmplEvalConfig:
    past_len: int = 10
    future_len: int = 25
    smpl_dim: int = 132
    correction_t_max: int = 500  # active only at t <= 500 (`:85`)
    correction_every: int = 50  # ... and t % 50 == 0
    nn_chunk: Optional[int] = 512  # kept for callers; see ops/signed_distance
    # Pruning of the gate's object->body sweep
    # (`ops/signed_distance.signed_nearest_pruned`): the same gate decisions
    # as long as delta exceeds the body's largest interior-to-vertex
    # distance (about 0.17 m for SMPL-scale bodies).  None sweeps in full.
    nn_prune_delta: Optional[float] = 0.25

    @property
    def seq_len(self) -> int:
        return self.past_len + self.future_len


def pad_idx(cfg: SmplEvalConfig) -> np.ndarray:
    return np.concatenate([np.arange(cfg.past_len),
                           np.full(cfg.future_len, cfg.past_len - 1)])


def _body_axis_angle(body: torch.Tensor) -> torch.Tensor:
    """Body block [B,T,135] -> axis-angle pose [B,T,66]."""
    B, T = body.shape[:2]
    return matrix_to_axis_angle(rotation_6d_to_matrix(
        body[..., :-3].reshape(B, T, -1, 6))).reshape(B, T, -1)


def make_correction_denoised_fn(
    cfg: SmplEvalConfig,
    smpl: SmplModel,
    projector: ObjProjectorSmpl,
    *,
    gt: torch.Tensor,  # [B, T, 144] inpainted motion (canonical gt state)
    hand_pose: torch.Tensor,  # [B, T, 90] gt hand poses
    betas: torch.Tensor,  # [B, T, 10]
    obj_points: torch.Tensor,  # [B, P, 3] canonical template xyz
    markers_idx: Optional[np.ndarray] = None,  # override for tiny test meshes
    trace: Optional[List[Dict]] = None,
) -> Callable:
    """Build the physics-informed ``denoised_fn(x0, t, step=None)``
    (`eval_smpl_short.py:84-130`).

    It fires at ``t <= cfg.correction_t_max``, every
    ``cfg.correction_every`` steps, decided on the host by
    `diffusion.gaussian.firing_hook`.  ``trace`` receives one dict per
    firing: ``t``, the gate's tensors, still on the
    device (``condition`` [B] bool, the corrected rows; ``penetration`` [B]
    and ``distance`` [B], which the gate holds against 0.002 and 0.02;
    ``marker_d`` [B,T,M], held against 0.02 for the contact labels;
    ``o2h_sq`` and ``o2h_dot`` [B*Tf,P] of the sweep) and, on the card, the
    CUDA events ``start`` and ``end`` of the firing's span ``hook.firing``.
    A firing's spans (`utils/profiling.py`): ``hook.gate`` (``hook.fk``,
    ``hook.normals``, ``hook.k2``, ``hook.k4``: everything up to the
    decision), ``hook.projector`` and ``hook.blend``; in a session it
    counts the rows gated (``hook.rows``) and corrected
    (``hook.rows_corrected``, summed on the device).
    """
    D = cfg.smpl_dim + 3  # body block
    markers_idx = torch.as_tensor(
        np.asarray(MARKERSET_SSM67_SMPLH if markers_idx is None
                   else markers_idx), dtype=torch.int64, device=gt.device)
    obj_gt9 = gt[..., D:]
    hand_padded = hand_pose[:, pad_idx(cfg)]  # future hands = last past

    def correct(x: torch.Tensor, step: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """-> (corrected x, the gate's tensors for ``trace``)."""
        B, T = x.shape[:2]
        body = x[..., :D]
        obj = x[..., D:]
        cuda = x.is_cuda

        with span("hook.gate", cuda=cuda):
            with span("hook.fk", cuda=cuda):
                obj_rot = rotation_6d_to_matrix(obj[..., :6])
                pose_full = torch.cat([_body_axis_angle(body), hand_padded],
                                      dim=-1)
                verts, _, _, _ = smpl_forward(
                    smpl, pose_full.reshape(B * T, -1),
                    betas.reshape(B * T, -1),
                    body[..., -3:].reshape(B * T, 3))
                verts = verts.reshape(B, T, -1, 3)
                markers = verts[:, :, markers_idx]  # [B, T, M, 3]

            obj_points_pred = (torch.einsum("btij,bpj->btpi", obj_rot,
                                            obj_points)
                               + obj[..., None, -3:])

            # the penetration gate (`:107-110`) reads future frames only,
            # so the object->body sweep and the normals run on the future
            # slice
            Tf = T - cfg.past_len
            verts_fut = verts[:, cfg.past_len:].reshape(B * Tf, -1, 3)
            obj_fut = obj_points_pred[:, cfg.past_len:].reshape(B * Tf, -1,
                                                                3)
            with span("hook.normals", cuda=cuda):
                normals_fut = vertex_normals(verts_fut, smpl.faces_idx,
                                             smpl.incident)
            with span("hook.k2", cuda=cuda):
                if cfg.nn_prune_delta is not None:
                    # beyond delta the pair is forced to the true (positive)
                    # sign, where the full sweep's far-field pseudonormal
                    # sign is an artifact of the nearest vertex
                    o2h_sq, o2h_dot = signed_nearest_pruned(
                        obj_fut, verts_fut, normals_fut,
                        delta=cfg.nn_prune_delta, chunk=cfg.nn_chunk)
                else:
                    o2h_sq, o2h_dot = signed_nearest(
                        obj_fut, verts_fut, normals_fut, chunk=cfg.nn_chunk)
            o2h_signed = (torch.sqrt(o2h_sq) * torch.sign(o2h_dot)
                          ).reshape(B, Tf, -1)

            w = torch.where(o2h_signed < 0, 20.0, 0.0)  # (`:107-110`)
            loss_dist_o = o2h_signed.abs() * w  # [B, Tf, P]

            # min over the object points per marker is a nearest-neighbour
            # query of the markers against the points
            with span("hook.k4", cuda=cuda):
                md2, _ = nearest_neighbor(
                    markers.reshape(B * T, -1, 3),
                    obj_points_pred.reshape(B * T, -1, 3),
                    chunk=cfg.nn_chunk)
            marker_d = torch.sqrt(md2.clamp(min=0.0)).reshape(B, T, -1)
            distance = marker_d.amin(dim=2).mean(dim=1)  # [B]
            penetration = loss_dist_o.mean(dim=(1, 2))  # [B]
            good = (penetration < 0.002) & (distance < 0.02)
            condition = ~good  # [B] True -> apply the correction
        if profiling.recording():
            profiling.count("hook.rows", B)
            profiling.count("hook.rows_corrected", condition.sum())

        with span("hook.projector", cuda=cuda):
            contact_label = marker_d < 0.02  # [B, T, M]
            contact = contact_label[:, cfg.past_len:].sum(dim=1)  # [B, M]
            # the projector reads the gt object stream (its future frames
            # are padded inside) and the denoised markers (`:125`)
            obj_proj = projector.sample(obj_gt9, markers,
                                        contact.to(torch.float32))

        with span("hook.blend", cuda=cuda):
            x_corr = torch.cat([body, obj_proj], dim=-1)
            frac = float(np.float32(step) / np.float32(1000.0))
            x_blend = frac * x + (1.0 - frac) * x_corr
            out = torch.where(condition[:, None, None], x_blend, x)
        return out, {
            "condition": condition, "penetration": penetration,
            "distance": distance, "marker_d": marker_d, "o2h_sq": o2h_sq,
            "o2h_dot": o2h_dot}

    return firing_hook(correct, t_max=cfg.correction_t_max,
                       every=cfg.correction_every, trace=trace)


def make_sampler(cfg: SmplEvalConfig, model: MDMSmpl,
                 diffusion: GaussianDiffusion, *,
                 smpl: Optional[SmplModel] = None,
                 projector: Optional[ObjProjectorSmpl] = None,
                 markers_idx: Optional[np.ndarray] = None,
                 reuse_memory: bool = False, sampler: str = "ddpm",
                 trace: Optional[List[Dict]] = None) -> Callable:
    """Build ``sample(gt, obj_points6, hand_pose, betas, *, noise=None,
    step_noise=None, generator=None) -> x [B,T,144]``: `sample_once` /
    `sample_once_proj` (`eval_smpl_short.py:133-215`).

    gt [B,T,144] is the clip's state (its first ``past_len`` frames are
    inpainted), obj_points6 [B,P,6] the object's template points and
    normals, hand_pose [B,T,90] the gt hand poses and betas [B,T,10] the
    body shape; the last two feed the correction only.

    With a ``projector`` (which needs ``smpl``) the loop runs
    :func:`make_correction_denoised_fn` (``markers_idx`` and ``trace`` go
    to it).  ``reuse_memory=True`` adds a ``memory`` argument after
    ``betas``: the conditioning encoder is deterministic, so best-of-N
    evaluation encodes once and shares the memory across the diverse
    samples.  ``noise`` [B,T,144] is the initial sample and ``step_noise``
    [steps, B,T,144] the per-step draws; what is not given is drawn from
    ``generator``.  The sampler records no graph, whatever the caller's
    gradient mode (a trainer validates with it).
    """
    if projector is not None and smpl is None:
        raise ValueError("the correction's `projector` needs the body model "
                         "`smpl`")
    GaussianDiffusion.check_sampler(sampler)
    full_f32()

    @torch.no_grad()
    def _run(gt, obj_points6, hand_pose, betas, memory, *, noise=None,
             step_noise=None, generator=None):
        denoised_fn = None
        if projector is not None:
            denoised_fn = make_correction_denoised_fn(
                cfg, smpl, projector, gt=gt, hand_pose=hand_pose,
                betas=betas, obj_points=obj_points6[..., :3],
                markers_idx=markers_idx, trace=trace)
        if noise is None:
            noise = randn_rows(gt.shape, generator, gt.device, gt.dtype)

        def model_fn(x, ts):
            return model.denoise(x, ts, memory)

        return diffusion.sample_loop(
            sampler, model_fn, noise=noise, step_noise=step_noise,
            generator=generator, inpaint=Inpaint.past(gt, cfg.past_len),
            denoised_fn=denoised_fn)

    if reuse_memory:
        return _run

    @torch.no_grad()
    def sample(gt, obj_points6, hand_pose, betas, *, noise=None,
               step_noise=None, generator=None):
        memory = model.encode(gt, obj_points6)
        return _run(gt, obj_points6, hand_pose, betas, memory, noise=noise,
                    step_noise=step_noise, generator=generator)

    return sample


def postprocess_sample(cfg: SmplEvalConfig, smpl: SmplModel, x: torch.Tensor,
                       hand_pose: torch.Tensor, betas: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    """Sampled state -> axis-angle body and object, SMPL verts and joints
    (`eval_smpl_short.py:155-178`): body_pred [B,T,159] (66 aa + 90 hand +
    3 trans), obj_pred [B,T,6] (aa + trans), verts, jtr, pelvis."""
    B, T = x.shape[:2]
    D = cfg.smpl_dim + 3
    body, obj = x[..., :D], x[..., D:]
    obj_aa = matrix_to_axis_angle(rotation_6d_to_matrix(obj[..., :6]))
    hand = hand_pose[:, pad_idx(cfg)]
    body_pred = torch.cat([_body_axis_angle(body), hand, body[..., -3:]],
                          dim=-1)
    verts, jtr, _, _ = smpl_forward(
        smpl, body_pred[..., :-3].reshape(B * T, -1),
        betas.reshape(B * T, -1), body_pred[..., -3:].reshape(B * T, 3))
    jtr = jtr.reshape(B, T, -1, 3)
    return {
        "body_pred": body_pred,
        "obj_pred": torch.cat([obj_aa, obj[..., -3:]], dim=-1),
        "verts": verts.reshape(B, T, -1, 3),
        "jtr": jtr,
        "pelvis": jtr[:, :, 0],
    }


def state_to_axis_angle(cfg: SmplEvalConfig, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """State [B,T,144] -> (body aa + trans [B,T,69], obj aa + trans
    [B,T,6]), without FK or hand padding (`train_diffusion_smpl.py:185-260`)."""
    D = cfg.smpl_dim + 3
    body, obj = x[..., :D], x[..., D:]
    obj_aa = matrix_to_axis_angle(rotation_6d_to_matrix(obj[..., :6]))
    return (torch.cat([_body_axis_angle(body), body[..., -3:]], dim=-1),
            torch.cat([obj_aa, obj[..., -3:]], dim=-1))
