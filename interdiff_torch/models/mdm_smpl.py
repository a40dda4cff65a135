"""SMPL-track MDM denoiser (`interdiff_tpu/models/mdm_smpl.py`), contract
from `interdiff/model/diffusion_smpl.py:8-249`.

State per frame (144 channels): [body rot6d (132) | body trans (3) |
obj rot6d (6) | obj trans (3)].  ``encode`` embeds the first ``past_len``
frames plus one token of the object cloud (PointNet++, or with
``use_pointnet2=False`` a linear map of each point's [xyz | normal] averaged
over the points) and runs the 8-layer encoder into the conditioning
memory; ``denoise`` runs the 8-layer decoder with cross-attention to it.  Submodule names follow the flax tree
(``bodyEmbedding``, ``pcEmbedding.sa0.mlp0.conv0``, ``encoder.layer_3``, ...).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from interdiff_torch import resolve_device
from interdiff_torch.geometry.rotations import (
    axis_angle_to_matrix,
    matrix_to_rotation_6d,
)
from interdiff_torch.models.denoise_graph import GraphedDenoiser
from interdiff_torch.models.layers import (
    PositionalEncoding,
    TimestepEmbedder,
    TransformerStack,
    mdm_stack_kinds,
)
from interdiff_torch.models.pointnet import PointNet2Encoder


def smpl_gt_from_raw(body_pose_aa: torch.Tensor, body_trans: torch.Tensor,
                     obj_angles_aa: torch.Tensor,
                     obj_trans: torch.Tensor) -> torch.Tensor:
    """The 144-channel gt state from raw dataset tensors: body_pose_aa
    [B,T,66], body_trans [B,T,3], obj_angles_aa [B,T,3], obj_trans [B,T,3]
    -> [B,T,144] (ref `diffusion_smpl.py:211-214`)."""
    B, T = body_pose_aa.shape[:2]
    body6d = matrix_to_rotation_6d(axis_angle_to_matrix(
        body_pose_aa.reshape(B, T, -1, 3))).reshape(B, T, -1)
    obj6d = matrix_to_rotation_6d(axis_angle_to_matrix(
        obj_angles_aa.reshape(B, T, -1, 3))).reshape(B, T, -1)
    return torch.cat([body6d, body_trans, obj6d, obj_trans], dim=-1)


class MDMSmpl(GraphedDenoiser):
    """MDM denoiser for the SMPL (BEHAVE) track.

    Defaults mirror `train_diffusion_smpl.py:538-604`: smpl_dim 132, d_model
    256, 4 heads, ff 1024, gelu, 8+8 layers, past 10 / future 25, PointNet++
    object encoder with grouped FPS.  Built on ``device`` (CUDA unless
    given).  ``encode`` and ``denoise`` record a graph when a parameter
    requires a gradient; callers that only sample hold `torch.no_grad`
    themselves (the sampling loops and `make_sampler` do).

    ``dropout`` acts with ``train=True`` only, and so does the
    classifier-free mask of ``cond_mask_prob`` (a Bernoulli a sample); both
    draw from the ``generator`` the call is given.  The train step runs the
    denoiser with ``train=False``, as the JAX package's does, and so refuses
    a model built with either rate above 0 (`train/trainer.py::
    make_smpl_train_step`).
    """

    def __init__(self, smpl_dim: int = 132, embed_dim: int = 256,
                 num_heads: int = 4, ff_size: int = 1024, num_layers: int = 8,
                 dropout: float = 0.0, activation: str = "gelu",
                 past_len: int = 10, future_len: int = 25,
                 cond_mask_prob: float = 0.0, latent_usage: str = "memory",
                 use_pointnet2: bool = True, fps_groups: int = 16,
                 device=None):
        super().__init__()
        self.smpl_dim = smpl_dim
        self.embed_dim = embed_dim
        self.past_len = past_len
        self.future_len = future_len
        self.dropout = dropout
        self.cond_mask_prob = cond_mask_prob
        self.use_pointnet2 = use_pointnet2
        E = embed_dim
        self.bodyEmbedding = nn.Linear(self.body_dim, E)
        self.objEmbedding = nn.Linear(9, E)
        if use_pointnet2:
            self.pcEmbedding = PointNet2Encoder(
                c_in=1, c_out=E, num_keypoints=1, fps_groups=fps_groups)
        else:  # named as the flax Dense, so the bridge needs no new rule
            self.pcEmbedding = nn.Linear(6, E)
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
        self.objFinalLinear = nn.Linear(E, 9)
        self.to(resolve_device(device))
        self.eval()

    @property
    def body_dim(self) -> int:
        return self.smpl_dim + 3  # 135

    @property
    def state_dim(self) -> int:
        return self.body_dim + 9  # 144

    def encode(self, gt: torch.Tensor, obj_points: torch.Tensor, *,
               train_encoder: bool = False, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Conditioning memory: gt [B,T,144], obj_points [B,P,>=3] ->
        [B, past_len, E].  PointNet++ reads xyz (its feature channel is
        ||xyz||); the linear encoder reads [xyz | normal], so it needs 6
        channels.  ``train_encoder`` runs the PointNet++ BatchNorms on batch
        statistics and moves their running statistics (`layers.BatchNorm`);
        ``train`` applies dropout, drawn from ``generator``."""
        B = gt.shape[0]
        body = gt[..., : self.body_dim]
        obj = gt[..., self.body_dim:]
        if self.use_pointnet2:
            xyz = obj_points[..., :3]
            pc = torch.cat([xyz, torch.linalg.norm(xyz, dim=-1,
                                                   keepdim=True)], dim=-1)
            pc_emb = self.pcEmbedding(pc[:, None], train_encoder).reshape(
                B, 1, self.embed_dim)
        else:
            if obj_points.shape[-1] < 6:
                raise ValueError(
                    "the linear object encoder reads [xyz | normal] per "
                    f"point: obj_points has {obj_points.shape[-1]} channels, "
                    "needs 6")
            pc_emb = self.pcEmbedding(obj_points[..., :6]).mean(
                dim=1, keepdim=True)
        emb = (self.bodyEmbedding(body[:, : self.past_len])
               + self.objEmbedding(obj[:, : self.past_len]) + pc_emb)
        return self.encoder(self.positional(emb, train, generator),
                            train=train, generator=generator)

    def mask_cond(self, cond: torch.Tensor, *, force_mask: bool = False,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """Classifier-free guidance mask (`diffusion_smpl.py:185-193`):
        zeros under ``force_mask``; in train mode with ``cond_mask_prob`` >
        0, each sample's memory is zeroed with that probability, drawn from
        ``generator``."""
        if force_mask:
            return torch.zeros_like(cond)
        if train and self.cond_mask_prob > 0.0:
            prob = torch.full((cond.shape[0], 1, 1), self.cond_mask_prob,
                              dtype=cond.dtype, device=cond.device)
            return cond * (1.0 - torch.bernoulli(prob, generator=generator))
        return cond

    def denoise(self, x: torch.Tensor, timesteps: torch.Tensor,
                cond: Optional[torch.Tensor] = None, *,
                force_mask: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One denoiser call: x [B,T,144], timesteps [B] -> x0 [B,T,144].
        A missing ``cond`` is the null condition (zeroed memory).
        ``train`` applies dropout and the condition mask, drawn from
        ``generator``.

        Without a gradient, ``train`` and ``generator``, on CUDA, the call
        is replayed from a CUDA graph (`models/denoise_graph.py`).  Either
        way no tensor handed in is written, and no tensor handed out is
        ever written again by a later call."""
        return self.replayed(self._denoise, (x, timesteps, cond), train,
                             generator, force_mask=force_mask)

    def _denoise(self, x, timesteps, cond=None, *, force_mask=False,
                 train=False, generator=None):
        """The eager body of :meth:`denoise`."""
        t_emb = self.embedTimeStep(timesteps)  # [B, 1, E]
        h = (self.bodyEmbedding(x[..., : self.body_dim])
             + self.objEmbedding(x[..., self.body_dim:]) + t_emb)
        h = self.positional(h, train, generator)
        if cond is None:
            cond = torch.zeros((x.shape[0], 1, self.embed_dim),
                               dtype=x.dtype, device=x.device)
        else:
            cond = self.mask_cond(cond, force_mask=force_mask, train=train,
                                  generator=generator)
        h = self.decoder(h, cond, train=train, generator=generator)
        return torch.cat([self.bodyFinalLinear(h), self.objFinalLinear(h)],
                         dim=-1)

    def forward(self, x, timesteps, cond=None, *, force_mask: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        return self.denoise(x, timesteps, cond, force_mask=force_mask,
                            train=train, generator=generator)
