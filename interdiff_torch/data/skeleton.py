"""Skeleton-track (HO-GCN) dataset pipeline (`interdiff_tpu/data/skeleton.py`,
copied whole: it is numpy only, and the port imports nothing of the JAX
package).

Behavioural contract: `interdiff/data/dataset_skeleton.py` — per-sequence
pickles of (skeleton [N,21,3], contact [N,1], pose [N,7 = trans+quat xyzw],
object keypoints [N,12,3]); canonical zero-pose object recovered by
inverting the frame-0 pose; quaternion sign-flip fixing; 240-frame sliding
windows with step 12, downsampled ::12 into 20-frame clips; seen/unseen
split by object (chair3/chair4 unseen) and a seeded 0.7/0.2/0.1
train/valid/test split of the seen pool.

Clips are dense numpy arrays and batches stack to [B, T, ...]; the torch
`random_split(generator=manual_seed(42))` of the reference is an explicit
numpy permutation, the same as the JAX package's.  The clip cache
(``ds_*.pkl``) written by either package reads back into this module's
`SkeletonClip`.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np


UNSEEN_OBJECTS = ("chair3", "chair4")


def quat_xyzw_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """scipy-convention quaternion (x, y, z, w) -> rotation matrix [3,3]."""
    x, y, z, w = np.asarray(q, dtype=np.float64)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n < 1e-15 else 2.0 / n
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return np.array([
        [1 - yy - zz, xy - wz, xz + wy],
        [xy + wz, 1 - xx - zz, yz - wx],
        [xz - wy, yz + wx, 1 - xx - yy],
    ])


def recover_init_obj(initial_obj: np.ndarray,
                     initial_pose: np.ndarray) -> np.ndarray:
    """Invert the frame-0 pose to get the canonical zero-pose keypoints
    (`dataset_skeleton.py:40-51`). initial_obj [P,3], initial_pose [7]."""
    t = initial_pose[:3][None]
    Rinv = quat_xyzw_to_matrix_np(initial_pose[-4:]).T
    return (initial_obj - t) @ Rinv.T


def get_consistent_poses(poses: np.ndarray) -> np.ndarray:
    """Fix quaternion sign flips frame-to-frame (`:53-65`)."""
    out = poses.copy()
    for i in range(out.shape[0] - 1):
        d_pos = np.linalg.norm(out[i, -4:] - out[i + 1, -4:])
        d_neg = np.linalg.norm(out[i, -4:] + out[i + 1, -4:])
        if d_pos > d_neg:
            out[i + 1, -4:] = -out[i + 1, -4:]
    return out


def pose_to_keypoints(zero_pose_obj: np.ndarray,
                      poses: np.ndarray) -> np.ndarray:
    """Rigid reconstruction R(q) @ p0 + t (`:67-82`). poses [T,7]."""
    T = poses.shape[0]
    out = np.zeros((T, zero_pose_obj.shape[0], 3))
    for i in range(T):
        R = quat_xyzw_to_matrix_np(poses[i, -4:])
        out[i] = zero_pose_obj @ R.T + poses[i, :3]
    return out


@dataclass
class SkeletonClip:
    """One 20-frame clip: the tuple the reference stores (`:154-160`)."""

    skeleton: np.ndarray  # [T, 21, 3]
    obj_points: np.ndarray  # [T, 12, 3]
    poses: np.ndarray  # [T, 7] trans + quat xyzw
    zero_pose_obj: np.ndarray  # [12, 3]
    seq_name: str
    obj_name: str


def extract_clips(skeleton: np.ndarray, obj_points: np.ndarray,
                  poses: np.ndarray, contact: np.ndarray, *,
                  seq_name: str = "", obj_name: str = "",
                  unseen: bool = False, discard_discrep: bool = False,
                  window: int = 240, step: int = 12, down: int = 12
                  ) -> List[SkeletonClip]:
    """Sequence -> clips (`get_sequences`, `:108-162`): zero-pose recovery on
    the ::12-downsampled stream, quaternion consistency fix, sliding-window
    extraction; unseen sequences drop windows without contact."""
    n = skeleton.shape[0]
    if unseen and contact.sum() < 0.5:
        return []

    down_poses = poses[::down]
    down_obj = obj_points[::down]
    zero_pose_obj = recover_init_obj(down_obj[0], down_poses[0])

    norms = np.linalg.norm(poses[:, -4:], axis=-1)
    assert abs((norms - 1).sum()) < 1e-3, "invalid quaternions"

    if discard_discrep:
        pred = pose_to_keypoints(zero_pose_obj, down_poses)
        if np.linalg.norm(pred - down_obj, axis=-1).mean() > 1e-2:
            return []

    poses = get_consistent_poses(poses)

    clips = []
    start = 0
    while start + window < n:
        sl = slice(start, start + window, down)
        if not (unseen and contact[sl].sum() < 0.5):
            clips.append(SkeletonClip(
                skeleton=skeleton[sl].copy(),
                obj_points=obj_points[sl].copy(),
                poses=poses[sl].copy(),
                zero_pose_obj=zero_pose_obj.copy(),
                seq_name=seq_name, obj_name=obj_name))
        start += step
    return clips


def load_sequence_pickle(path: str | Path):
    """Parse one HO-GCN pickle: returns (skeleton [N,21,3], contact [N,1],
    poses [N,7], obj_keypoints [N,12,3]) (`:108-121`)."""
    with open(path, "rb") as f:
        data = pickle.load(f)[0]
    n = len(data[0])
    skeleton = np.array(data[0], dtype="float64").reshape(n, 21, 3)
    contact = np.array(data[1], dtype="float64").reshape(n, 1)
    poses = np.array(data[2], dtype="float64").reshape(n, 7)
    obj = np.array(data[3], dtype="float64").reshape(n, 12, 3)
    return skeleton, contact, poses, obj


class _ClipUnpickler(pickle.Unpickler):
    """Reads a clip cache of either package: a ``SkeletonClip`` pickled by
    `interdiff_tpu.data.skeleton` comes back as this module's, so reading
    it imports nothing of the JAX package."""

    def find_class(self, module, name):
        if name == "SkeletonClip" and module.endswith(".data.skeleton"):
            return SkeletonClip
        return super().find_class(module, name)


def load_skeleton_datasets(motion_path: str, *, discard_discrep: bool = False,
                           seed: int = 42
                           ) -> Tuple[List[SkeletonClip], List[SkeletonClip],
                                      List[SkeletonClip], List[SkeletonClip]]:
    """-> (train, valid, test_seen, test_unseen) clip lists
    (`get_datasets`, `:164-210`), with caching to ds_*.pkl beside the data."""
    cache_seen = os.path.join(motion_path, "ds_seen.pkl")
    cache_unseen = os.path.join(motion_path, "ds_test_unseen.pkl")
    if os.path.exists(cache_seen) and os.path.exists(cache_unseen):
        with open(cache_seen, "rb") as f:
            seen = _ClipUnpickler(f).load()
        with open(cache_unseen, "rb") as f:
            unseen = _ClipUnpickler(f).load()
    else:
        seen, unseen = [], []
        for p in sorted(Path(motion_path).iterdir()):
            if not p.is_dir():
                continue
            children = list(p.iterdir())
            if not children:
                continue
            f = children[0]
            obj_name = f.stem.split("_")[1]
            is_unseen = obj_name in UNSEEN_OBJECTS
            skeleton, contact, poses, obj = load_sequence_pickle(f)
            clips = extract_clips(skeleton, obj, poses, contact,
                                  seq_name=f.stem, obj_name=obj_name,
                                  unseen=is_unseen,
                                  discard_discrep=discard_discrep)
            if len(clips) > 1:
                (unseen if is_unseen else seen).extend(clips)
        try:
            with open(cache_seen, "wb") as f:
                pickle.dump(seen, f)
            with open(cache_unseen, "wb") as f:
                pickle.dump(unseen, f)
        except OSError:
            pass

    n = len(seen)
    n_train, n_valid = int(0.7 * n), int(0.2 * n)
    perm = np.random.default_rng(seed).permutation(n)
    train = [seen[i] for i in perm[:n_train]]
    valid = [seen[i] for i in perm[n_train:n_train + n_valid]]
    test = [seen[i] for i in perm[n_train + n_valid:]]
    return train, valid, test, unseen


def collate_skeleton(clips: Sequence[SkeletonClip]) -> Dict[str, np.ndarray]:
    """Stack clips to a dense batch dict [B, T, ...] (float32)."""
    return {
        "skeleton": np.stack([c.skeleton for c in clips]).astype(np.float32),
        "obj_points": np.stack([c.obj_points for c in clips]).astype(np.float32),
        "poses": np.stack([c.poses for c in clips]).astype(np.float32),
        "zero_pose_obj": np.stack(
            [c.zero_pose_obj for c in clips]).astype(np.float32),
    }
