"""Skeleton-track MDM denoiser (`interdiff_tpu/models/mdm_skeleton.py`),
contract from `interdiff/model/diffusion_skeleton.py`.

State per frame (106 = 21*3 + 12*3 + 7): [body joints (63) | object
keypoints (36) | object pose (3 trans + 4 quat **xyzw**, as the HO-GCN
dataset stores it)].  ``encode`` embeds the first ``past_len`` frames plus
one token of the object's zero-pose keypoints and runs the 8-layer encoder
into the conditioning memory; ``denoise`` runs the 8-layer decoder with
cross-attention to it and re-derives the 12 object keypoints rigidly from
the predicted 7-D pose (`diffusion_skeleton.py:218-248`), so the keypoint
block of a prediction always agrees with its pose block.  Submodule names
follow the flax tree (``bodyEmbedding``, ``shapeEmbedding``,
``encoder.layer_3``, ...).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from interdiff_torch import resolve_device
from interdiff_torch.geometry.rotations import (
    quat_xyzw_to_wxyz,
    quaternion_to_matrix,
)
from interdiff_torch.models.denoise_graph import GraphedDenoiser
from interdiff_torch.models.layers import (
    PositionalEncoding,
    TimestepEmbedder,
    TransformerStack,
    mdm_stack_kinds,
)


def rigid_keypoints_from_pose(pose: torch.Tensor,
                              zero_pose_obj: torch.Tensor) -> torch.Tensor:
    """`calc_obj_pred` (`diffusion_skeleton.py:218-229`), batch-first.

    pose: [B, T, 7] = [trans(3), quat xyzw(4)]; zero_pose_obj: [B, P, 3].
    Returns keypoints [B, T, P, 3] = R(q) @ zero_pose + trans.
    """
    rot = quaternion_to_matrix(quat_xyzw_to_wxyz(pose[..., 3:7]))
    return (torch.einsum("btij,bpj->btpi", rot, zero_pose_obj)
            + pose[:, :, None, :3])


class MDMSkeleton(GraphedDenoiser):
    """MDM denoiser for the skeleton (HO-GCN) track.

    Defaults mirror `train_diffusion_skeleton.py:355-366`: d_model 256, 4
    heads, ff 256, gelu, 8 encoder + 8 decoder layers with the first and
    last vanilla and the middle six QaN, cross-attention decoder
    (``latent_usage='memory'``).  Built on ``device`` (CUDA unless given),
    in eval mode.  ``encode`` and ``denoise`` record a graph when a
    parameter requires a gradient; the samplers hold `torch.no_grad`
    themselves.  ``dropout`` and the condition mask of ``cond_mask_prob``
    act with ``train=True`` only, drawn from the call's ``generator``; the
    train step runs the denoiser with ``train=False``, as the JAX package's
    does, and so refuses a model built with either rate above 0.
    """

    def __init__(self, num_joints: int = 21, num_points: int = 12,
                 embed_dim: int = 256, num_heads: int = 4, ff_size: int = 256,
                 num_layers: int = 8, dropout: float = 0.0,
                 activation: str = "gelu", past_len: int = 10,
                 cond_mask_prob: float = 0.0, latent_usage: str = "memory",
                 device=None):
        super().__init__()
        self.num_joints = num_joints
        self.num_points = num_points
        self.embed_dim = embed_dim
        self.past_len = past_len
        self.dropout = dropout
        self.cond_mask_prob = cond_mask_prob
        E = embed_dim
        self.bodyEmbedding = nn.Linear(self.body_dim, E)
        self.shapeEmbedding = nn.Linear(self.points_dim, E)
        self.objEmbedding = nn.Linear(self.points_dim, E)
        self.positional = PositionalEncoding(E, dropout)
        self.embedTimeStep = TimestepEmbedder(E)
        self.encoder = TransformerStack(
            E, num_heads, ff_size, mdm_stack_kinds(num_layers, cross=False),
            activation, dropout)
        self.decoder = TransformerStack(
            E, num_heads, ff_size,
            mdm_stack_kinds(num_layers, cross=latent_usage == "memory"),
            activation, dropout)
        self.bodyFinalLinear = nn.Linear(E, self.body_dim)
        self.objFinalLinear = nn.Linear(E, 7)
        self.to(resolve_device(device))
        self.eval()

    @property
    def body_dim(self) -> int:
        return self.num_joints * 3

    @property
    def points_dim(self) -> int:
        return self.num_points * 3

    @property
    def state_dim(self) -> int:
        return self.body_dim + self.points_dim + 7

    # -- conditioning ---------------------------------------------------------
    def encode(self, body_gt: torch.Tensor, obj_gt: torch.Tensor,
               pose_gt: torch.Tensor, zero_pose_obj: torch.Tensor, *,
               train: bool = False,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`_get_embeddings` (`diffusion_skeleton.py:194-215`): body_gt
        [B,T,21,3], obj_gt [B,T,12,3], pose_gt [B,T,7], zero_pose_obj
        [B,12,3] -> (memory [B, past_len, E], gt state [B, T, state_dim]).
        ``train`` applies dropout, drawn from ``generator``."""
        B, T = body_gt.shape[:2]
        body_flat = body_gt.reshape(B, T, self.body_dim)
        obj_flat = obj_gt.reshape(B, T, self.points_dim)
        gt = torch.cat([body_flat, obj_flat, pose_gt], dim=-1)
        shape_emb = self.shapeEmbedding(
            zero_pose_obj.reshape(B, 1, self.points_dim))
        p = self.past_len
        emb = (self.bodyEmbedding(body_flat[:, :p])
               + self.objEmbedding(obj_flat[:, :p]) + shape_emb)
        return self.encoder(self.positional(emb, train, generator),
                            train=train, generator=generator), gt

    def mask_cond(self, cond: torch.Tensor, *, force_mask: bool = False,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """Classifier-free guidance mask (`diffusion_skeleton.py:184-192`):
        zeros under ``force_mask``; in training with ``cond_mask_prob`` > 0,
        each sample's memory is zeroed with that probability, drawn from
        ``generator``."""
        if force_mask:
            return torch.zeros_like(cond)
        if train and self.cond_mask_prob > 0.0:
            prob = torch.full((cond.shape[0], 1, 1), self.cond_mask_prob,
                              dtype=cond.dtype, device=cond.device)
            return cond * (1.0 - torch.bernoulli(prob, generator=generator))
        return cond

    # -- denoising ------------------------------------------------------------
    def denoise(self, x: torch.Tensor, timesteps: torch.Tensor,
                zero_pose_obj: torch.Tensor,
                cond: Optional[torch.Tensor] = None, *,
                force_mask: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One denoiser call: x [B,T,106], timesteps [B] -> x0 [B,T,106].
        The decoder embeds the body and keypoint blocks (the pose block is
        not read, as in the reference, `diffusion_skeleton.py:236-239`).  A
        missing ``cond`` is the null condition (zeroed memory [B,1,E]).

        Without a gradient, ``train`` and ``generator``, on CUDA, the call
        is replayed from a CUDA graph (`models/denoise_graph.py`).  Either
        way no tensor handed in is written, and no tensor handed out is
        ever written again by a later call."""
        return self.replayed(self._denoise, (x, timesteps, zero_pose_obj,
                                             cond), train, generator,
                             force_mask=force_mask)

    def _denoise(self, x, timesteps, zero_pose_obj, cond=None, *,
                 force_mask=False, train=False, generator=None):
        """The eager body of :meth:`denoise`."""
        bd, od = self.body_dim, self.points_dim
        h = (self.bodyEmbedding(x[..., :bd])
             + self.objEmbedding(x[..., bd:bd + od])
             + self.embedTimeStep(timesteps))
        h = self.positional(h, train, generator)
        if cond is None:
            cond = torch.zeros((x.shape[0], 1, self.embed_dim),
                               dtype=x.dtype, device=x.device)
        else:
            cond = self.mask_cond(cond, force_mask=force_mask, train=train,
                                  generator=generator)
        h = self.decoder(h, cond, train=train, generator=generator)
        body_pred = self.bodyFinalLinear(h)
        pose_pred = self.objFinalLinear(h)
        obj_pred = rigid_keypoints_from_pose(pose_pred, zero_pose_obj)
        B, T = body_pred.shape[:2]
        return torch.cat([body_pred, obj_pred.reshape(B, T, od), pose_pred],
                         dim=-1)

    def forward(self, x, timesteps, zero_pose_obj, cond=None, *,
                force_mask: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return self.denoise(x, timesteps, zero_pose_obj, cond,
                            force_mask=force_mask, train=train,
                            generator=generator)

    def init_forward(self, body_gt: torch.Tensor, obj_gt: torch.Tensor,
                     pose_gt: torch.Tensor, zero_pose_obj: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """encode + denoise in one pass (the flax tree's initialiser)."""
        memory, gt = self.encode(body_gt, obj_gt, pose_gt, zero_pose_obj)
        return self.denoise(gt, timesteps, zero_pose_obj, memory)
