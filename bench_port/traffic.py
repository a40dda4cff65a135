"""The one generator of every cell's inputs: clips, clouds and sampling
noise drawn from the run's seed by the parameters of the cell's file.
Every seed gives the same sizes; only the values differ."""

from __future__ import annotations

import numpy as np
import torch


def object_cloud(rng, clips: int, points: int, axes) -> np.ndarray:
    """Points and normals [clips, points, 6] on ellipsoids whose semi-axes
    are drawn from ``axes`` (low, high) metres."""
    a = rng.uniform(axes[0], axes[1], (clips, 1, 3))
    d = rng.standard_normal((clips, points, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xyz = d * a
    n = xyz / a ** 2
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.concatenate([xyz, n], -1).astype(np.float32)


def smpl_clips(rng, t: dict) -> dict:
    """A batch in the layout of the SMPL eval's loader: poses, translations
    and object angles from normals scaled by the cell's spreads."""
    B, T, P = t["clips"], t["past_len"] + t["future_len"], t["points"]
    s = t["spread"]
    pose = rng.standard_normal((B, T, 66)) * s["pose"]
    trans = rng.standard_normal((B, T, 3)) * s["trans"]
    obj_angles = rng.standard_normal((B, T, 3)) * s["obj_angle"]
    obj_trans = rng.standard_normal((B, T, 3)) * s["obj_trans"]
    pts = object_cloud(rng, B, P, t["object_axes"])
    hand = rng.standard_normal((B, T, 90)) * s["hand"]
    betas = np.broadcast_to(rng.standard_normal((B, 1, 10)) * s["betas"],
                            (B, T, 10))
    batch = {"body_pose": np.concatenate([pose, hand], -1),
             "body_trans": trans, "obj_angles": obj_angles,
             "obj_trans": obj_trans, "obj_points": pts, "body_betas": betas}
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in batch.items()}


def skeleton_clips(rng, t: dict) -> dict:
    """A batch in the layout of the skeleton eval's loader (HO-GCN)."""
    B, T = t["clips"], t["past_len"] + t["future_len"]
    J, P = t["joints"], t["keypoints"]
    quat = rng.standard_normal((B, T, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    batch = {
        "skeleton": rng.standard_normal((B, T, J, 3)),
        "obj_points": rng.standard_normal((B, T, P, 3)),
        "poses": np.concatenate([rng.standard_normal((B, T, 3)), quat], -1),
        "zero_pose_obj": rng.standard_normal((B, P, 3)),
    }
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in batch.items()}


def sampling_noise(seed: int, shape, steps: int, device):
    """(initial noise, per-step noise [steps, *shape]) of one sampler call,
    from ``seed`` by a generator on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(shape, generator=gen, device=device)
    return noise, torch.randn((steps,) + tuple(shape), generator=gen,
                              device=device)
