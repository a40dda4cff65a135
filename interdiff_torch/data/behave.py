"""BEHAVE (SMPL-track) data pipeline (`interdiff_tpu/data/behave.py`),
contract of `interdiff/data/dataset_smpl.py`: per-sequence npz loading, the
SMPL-H forward at load time that caches vertices, joints and vertex
normals, clip windows with the reference's jitter, and per-clip
canonicalization (the pelvis of frame 0 to the origin, the global orient
aligned in yaw).

A clip is a flat dict of dense numpy arrays [T, ...] and a batch stacks
them to [B, T, ...].  Everything but the load-time forward is host numpy,
copied from the JAX package so that both give the same bits on the same
inputs; the forward and the normals run on the port's device and come back
as numpy.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from interdiff_torch.data.constants import MARKERSET_SSM67_SMPLH
from interdiff_torch.geometry.normals import vertex_normals
from interdiff_torch.geometry.rotations_np import (
    rotvec_compose_np,
    rotvec_to_matrix_np,
)
from interdiff_torch.smpl.model import SmplModel, smpl_forward


def yaw_canonical_rotation(global_orient_rotvec: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The frame-0 yaw alignment of `dataset_smpl.py:119-125`.

    Returns ``(rotation, rotation_v)`` where ``rotation = rotation_v^-1`` is
    applied (as ``x @ rotation.T``) to every world-space quantity.  The yaw
    angle comes from the x/z components of the first **column** of the
    global-orient rotation matrix.
    """
    R0 = rotvec_to_matrix_np(global_orient_rotvec.astype(np.float64))
    denom = np.sqrt(R0[0, 0] ** 2 + R0[2, 0] ** 2)
    cos, sin = R0[0, 0] / denom, R0[2, 0] / denom
    rotation_v = np.eye(3, dtype=np.float32)
    rotation_v[0, 0] = cos
    rotation_v[2, 2] = cos
    rotation_v[0, 2] = -sin
    rotation_v[2, 0] = sin
    rotation = np.linalg.inv(rotation_v).astype(np.float32)
    return rotation, rotation_v


def canonicalize_clip(
    *,
    poses: np.ndarray,  # [T, D_pose] axis-angle SMPL params
    betas: np.ndarray,  # [T, 10]
    trans: np.ndarray,  # [T, 3]
    pelvis: np.ndarray,  # [T, 3]
    obj_angles: np.ndarray,  # [T, 3]
    obj_trans: np.ndarray,  # [T, 3]
    human_verts: Optional[np.ndarray],  # [T, V, 6] xyz + normals (world)
    obj_points: np.ndarray,  # [P, 6] template xyz + normals
    obj_contact_idx: Sequence[np.ndarray],  # per-frame contact point indices
    human_contact_idx: Sequence[np.ndarray],  # per-frame contact vert indices
    left_foot: np.ndarray,  # [T_raw, 3] in RAW sequence order
    right_foot: np.ndarray,
    frame_indices: np.ndarray,  # [T] raw indices of the clip frames
    ground_joint_label_first: int,  # raw label (10/11) for frame 0 fallback
    heavy: bool = True,
) -> Dict[str, np.ndarray]:
    """Canonicalize one clip exactly like `dataset_smpl.py:106-189`.

    Returns a dict of dense float32 arrays (T = clip length, V = num verts,
    P = num object points):
      body_pose [T,D], body_betas [T,10], body_trans [T,3], pelvis [T,3],
      obj_angles [T,3], obj_trans [T,3], human_verts [T,V,7],
      markers [T,67,7], obj_points_frames [T,P,7], ground_joint_label [T,2],
      plus 'rotation'/'rotation_v'/'centroid'.

    ``heavy=False`` skips the per-vertex/per-point products (human_verts,
    markers, obj_points_frames) — diffusion training consumes only the pose
    streams, and on a one-core host building ~9 MB of unused arrays per
    clip dominates the step time (the reference always builds everything
    and hides it behind 4 DataLoader workers).
    """
    T = poses.shape[0]
    V = human_verts.shape[1] if heavy else 0
    P = obj_points.shape[0]

    centroid = pelvis[0].astype(np.float32).copy()
    rotation, rotation_v = yaw_canonical_rotation(poses[0, :3])

    out_pose = poses.astype(np.float32).copy()
    out_trans = trans.astype(np.float32).copy()
    out_pelvis = pelvis.astype(np.float32).copy()
    out_obj_angles = obj_angles.astype(np.float32).copy()
    out_obj_trans = obj_trans.astype(np.float32).copy()
    out_verts = np.zeros((T, V, 7), dtype=np.float32)
    out_obj_points = np.zeros((T, P, 7), dtype=np.float32) if heavy else None
    ground = np.zeros((T, 2), dtype=np.float32)

    Rt = rotation.T  # applied as x @ Rt

    for i in range(T):
        tr = out_trans[i] - centroid
        pv = out_pelvis[i] - centroid
        pelvis_original = pv - tr  # pelvis in the original smpl coords
        out_trans[i] = (tr + pelvis_original) @ Rt - pelvis_original
        out_pelvis[i] = pv @ Rt

        out_pose[i, :3] = rotvec_compose_np(rotation, out_pose[i, :3])

        out_obj_trans[i] = (out_obj_trans[i] - centroid) @ Rt
        out_obj_angles[i] = rotvec_compose_np(rotation, out_obj_angles[i])

        if heavy:
            v = human_verts[i, :, :3].astype(np.float32) - centroid
            out_verts[i, :, :3] = v @ Rt
            out_verts[i, :, 3:6] = (human_verts[i, :, 3:6]
                                    .astype(np.float32) @ Rt)

            rot = rotvec_to_matrix_np(out_obj_angles[i].astype(np.float64)
                                      ).astype(np.float32)
            out_obj_points[i, :, :3] = (obj_points[:, :3].astype(np.float32)
                                        @ rot.T + out_obj_trans[i])
            out_obj_points[i, :, 3:6] = (obj_points[:, 3:6]
                                         .astype(np.float32) @ rot.T)
            out_obj_points[i, obj_contact_idx[i], 6] = 1.0

            out_verts[i, human_contact_idx[i], 6] = 1.0

        raw_i = int(frame_indices[i])
        if raw_i > 0:
            dl = np.linalg.norm(left_foot[raw_i] - left_foot[raw_i - 1])
            dr = np.linalg.norm(right_foot[raw_i] - right_foot[raw_i - 1])
            ground[i, 0] = float(dl < 0.01)
            ground[i, 1] = float(dr < 0.01)
        else:
            ground[i, ground_joint_label_first - 10] = 1.0

    out = {
        "body_pose": out_pose,
        "body_betas": betas.astype(np.float32),
        "body_trans": out_trans,
        "pelvis": out_pelvis,
        "obj_angles": out_obj_angles,
        "obj_trans": out_obj_trans,
        "ground_joint_label": ground,
        "centroid": centroid,
        "rotation": rotation,
        "rotation_v": rotation_v,
    }
    if heavy:
        out["human_verts"] = out_verts
        out["markers"] = out_verts[:, MARKERSET_SSM67_SMPLH, :]
        out["obj_points_frames"] = out_obj_points
    return out


@dataclass
class BehaveSequence:
    """Preprocessed per-sequence record (the reference's `records` dict,
    `dataset_smpl.py:71-87`)."""

    seq_name: str
    gender: str
    obj_name: str
    poses: np.ndarray  # [N, 156]
    betas: np.ndarray  # [N, 10]
    trans: np.ndarray  # [N, 3]
    obj_angles: np.ndarray  # [N, 3]
    obj_trans: np.ndarray  # [N, 3]
    pelvis: np.ndarray  # [N, 3]
    left_foot: np.ndarray  # [N, 3]
    right_foot: np.ndarray  # [N, 3]
    human_verts: np.ndarray  # [N, V, 6] xyz+normals
    obj_points: np.ndarray  # [P, 6]
    obj_contact_idx: List[np.ndarray]
    human_contact_idx: List[np.ndarray]
    ground_joint_label: np.ndarray  # [N]

    @property
    def num_frames(self) -> int:
        return self.poses.shape[0]


class BehaveDataset:
    """Clip dataset over preprocessed sequences.

    ``mode`` split: train = sequences not starting with 'Date03', test = the
    'Date03*' sequences (`dataset_smpl.py:29-31`).  Clip windows of
    ``(past+future)*sample_rate`` frames with the reference's jitter bias
    (`:90-97`): every window except the last jitters its start uniformly in
    [0, fragment); the last window absorbs the remainder.
    """

    def __init__(self, sequences: Sequence[BehaveSequence], *,
                 past_len: int = 10, future_len: int = 25,
                 sample_rate: int = 1,
                 rng: Optional[np.random.Generator] = None,
                 fields: str = "full"):
        if fields not in ("full", "light"):
            raise ValueError("fields must be 'full' or 'light'")
        self.sequences = list(sequences)
        self.past_len = past_len
        self.future_len = future_len
        self.sample_rate = sample_rate
        self.fields = fields
        self.rng = rng or np.random.default_rng(233)
        self.idx2frame: List[Tuple[int, int, int]] = []
        fragment = (past_len + future_len) * sample_rate
        for k, seq in enumerate(self.sequences):
            n = seq.num_frames
            for i in range(n // fragment):
                if i == n // fragment - 1:
                    bias = n + 1 - (n // fragment) * fragment
                else:
                    bias = fragment
                self.idx2frame.append((k, i * fragment, bias))

    def __len__(self) -> int:
        return len(self.idx2frame)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        k, frame_idx, bias = self.idx2frame[idx]
        seq = self.sequences[k]
        start = int(self.rng.integers(bias)) + frame_idx
        T = self.past_len + self.future_len
        frames = np.arange(start, start + T * self.sample_rate,
                           self.sample_rate)
        heavy = self.fields == "full"
        clip = canonicalize_clip(
            poses=seq.poses[frames],
            betas=seq.betas[frames],
            trans=seq.trans[frames],
            pelvis=seq.pelvis[frames],
            obj_angles=seq.obj_angles[frames],
            obj_trans=seq.obj_trans[frames],
            human_verts=seq.human_verts[frames] if heavy else None,
            obj_points=seq.obj_points,
            obj_contact_idx=[seq.obj_contact_idx[i] for i in frames],
            human_contact_idx=[seq.human_contact_idx[i] for i in frames],
            left_foot=seq.left_foot,
            right_foot=seq.right_foot,
            frame_indices=frames,
            ground_joint_label_first=int(seq.ground_joint_label[start]),
            heavy=heavy,
        )
        clip["obj_points"] = seq.obj_points.astype(np.float32)
        clip["gender"] = np.int32(0 if seq.gender == "male" else 1)
        clip["start_frame"] = np.int32(start)
        return clip


_STACK_KEYS = (
    "body_pose", "body_betas", "body_trans", "pelvis", "obj_angles",
    "obj_trans", "human_verts", "markers", "obj_points_frames",
    "ground_joint_label", "obj_points", "gender", "start_frame",
)


def collate(clips: Sequence[Dict[str, np.ndarray]],
            keys: Sequence[str] = _STACK_KEYS) -> Dict[str, np.ndarray]:
    """Stack clip dicts into a [B, ...] batch dict (dense arrays only)."""
    return {k: np.stack([c[k] for c in clips]) for k in keys if k in clips[0]}


def split_names(motion_path: str, mode: str) -> List[str]:
    """The sequence folders of one split, sorted: train = those not
    starting with 'Date03', test = the 'Date03*' ones."""
    names = sorted(os.listdir(motion_path))
    if mode == "train":
        return [n for n in names if not n.startswith("Date03")]
    if mode == "test":
        return [n for n in names if n.startswith("Date03")]
    raise ValueError("mode must be train or test")


@torch.no_grad()
def body_forward(model: SmplModel, poses: np.ndarray, betas: np.ndarray,
                 trans: np.ndarray, *, normals: bool = True,
                 chunk: int = 256
                 ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """SMPL forward of a whole sequence on the model's device, ``chunk``
    frames at a time (a 1,408-frame sequence of the 6890-vertex body is 233
    MB of vertices and normals): poses [N,3J], betas [N,10], trans [N,3] ->
    (verts [N,V,3], joints [N,J,3], vertex normals [N,V,3] or None), numpy
    float32."""
    device = model.v_template.device
    verts, jtr, nrm = [], [], []
    for s in range(0, poses.shape[0], chunk):
        v, j, _, _ = smpl_forward(
            model, *(torch.as_tensor(np.asarray(a[s:s + chunk]),
                                     dtype=torch.float32, device=device)
                     for a in (poses, betas, trans)))
        verts.append(v.cpu().numpy())
        jtr.append(j.cpu().numpy())
        if normals:
            nrm.append(vertex_normals(v, model.faces_idx,
                                      model.incident).cpu().numpy())
    return (np.concatenate(verts), np.concatenate(jtr),
            np.concatenate(nrm) if normals else None)


def load_behave_sequences(motion_path: str, *,
                          smpl_models: Mapping[str, SmplModel],
                          mode: str = "train",
                          timings: Optional[Dict[str, float]] = None
                          ) -> List[BehaveSequence]:
    """Load and preprocess the BEHAVE sequences of one split.

    ``smpl_models`` maps gender -> :class:`SmplModel`; the forward runs on
    that model's device, once per sequence, to cache vertices, joints and
    vertex normals (`dataset_smpl.py:44-70`).  The normals are read from
    and written to ``<sequence>/human_normal.npz`` in the JAX package's
    format (``np.savez(file, {"normals": ...})``), so the two packages
    share a corpus; a cache of another body's size is made anew, and a
    read-only mount skips the write.  ``timings``
    collects the wall seconds of ``read`` (the files), ``forward`` (FK and
    normals, a device synchronisation after each sequence) and the
    ``sequences`` count.
    """
    import time

    sequences = []
    for name in split_names(motion_path, mode):
        t0 = time.perf_counter()
        seq_dir = os.path.join(motion_path, name)
        with np.load(os.path.join(seq_dir, "object_fit_all.npz"),
                     allow_pickle=True) as f:
            obj_angles, obj_trans = f["angles"], f["trans"]
        with np.load(os.path.join(seq_dir, "smpl_fit_all.npz"),
                     allow_pickle=True) as f:
            poses, betas, trans = f["poses"], f["betas"], f["trans"]
        with np.load(os.path.join(seq_dir, "contact.npz"),
                     allow_pickle=True) as f:
            d = f["arr_0"].item()
        with open(os.path.join(seq_dir, "info.json")) as f:
            info = json.load(f)
        gender, obj_name = info["gender"], info["cat"]

        normal_file = os.path.join(seq_dir, "human_normal.npz")
        model = smpl_models[gender]
        cached = None
        if os.path.isfile(normal_file):
            with np.load(normal_file, allow_pickle=True) as f:
                cached = f["arr_0"].item()["normals"]
            if cached.shape != (poses.shape[0], model.num_verts, 3):
                cached = None  # written for another body: made anew
        t1 = time.perf_counter()
        verts, jtr, normals = body_forward(
            model, poses, betas, trans,
            normals=cached is None)
        t2 = time.perf_counter()
        if cached is None:
            try:
                np.savez(normal_file, {"normals": normals})
            except OSError:
                pass  # read-only dataset mount
        else:
            normals = cached

        sequences.append(BehaveSequence(
            seq_name=name, gender=gender, obj_name=obj_name,
            poses=poses, betas=betas, trans=trans,
            obj_angles=obj_angles, obj_trans=obj_trans,
            pelvis=np.float32(jtr[:, 0]),
            left_foot=np.float32(jtr[:, 10]),
            right_foot=np.float32(jtr[:, 11]),
            human_verts=np.concatenate(
                [verts, normals], axis=2).astype(np.float32),
            obj_points=d["object_points"],
            obj_contact_idx=list(d["object_contact_vertex_label"]),
            human_contact_idx=list(d["human_contact_vertex_label"]),
            ground_joint_label=np.asarray(d["foot_contact_joint_label"]),
        ))
        if timings is not None:
            t3 = time.perf_counter()
            timings["read"] = timings.get("read", 0.0) + (t1 - t0) + (t3 - t2)
            timings["forward"] = timings.get("forward", 0.0) + t2 - t1
            timings["sequences"] = timings.get("sequences", 0) + 1
    return sequences
