"""Offline contact-label generator (`interdiff_tpu/data/prepare_behave.py`,
the reference's `interdiff/data/prepare_behave.py`) on the card.

For every sequence: sample 2048 surface points and their face normals from
the mean-centred full object scan (the simplified template when the scan is
absent), run SMPL-H forward for all frames on the device, and label per
frame (i) the object points within 0.02 m signed distance of the body mesh
(`prepare_behave.py:42-45`), (ii) the body vertices within 0.02 m of any
contacting object point (`:48-52`) and (iii) the higher-foot joint id, 10
or 11 (`:104-105`); ``contact.npz`` is written in the reference's layout,
which `data/behave.py` reads.

The signed distance takes an explicit ``engine``: ``"torch"``, the exact
brute force of `ops/mesh_distance.py` on the device (2048 points against
the 13,776 faces of SMPL-H are 28.2 M point-triangle pairs a frame), or
``"native"``, the host BVH of `native/mesh_distance.cpp`
(`utils/native.py`).  Neither falls back to the other.  The object's pose
is applied in float64 on the host per frame and the body-vertex labels are
measured in float64, as in the JAX package; the signed distance takes the
points in float32.  Several frames may go through one call on the device
(``frames_per_call``); each frame's labels are those it alone gives.

Usage:
  python -m interdiff_torch.data.prepare_behave --motion_path DIR \\
      --object_path DIR --model_path <SMPLH pkl dir> [-n 2048] \\
      [--engine torch|native] [--device cpu]
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import full_f32, resolve_device
from interdiff_torch.data.constants import SIMPLIFIED_MESH
from interdiff_torch.data.mesh_io import load_mesh, sample_surface
from interdiff_torch.geometry.rotations_np import rotvec_to_matrix_np
from interdiff_torch.ops.mesh_distance import signed_distance_to_mesh
from interdiff_torch.smpl.model import SmplModel, smpl_forward

ENGINES = ("torch", "native")
FK_CHUNK = 256


def default_chunking(device: torch.device, num_faces: int
                     ) -> Tuple[int, int]:
    """(frames a call, faces a step) of the torch engine by default: on
    CUDA 4 frames over every face at once (2048 points against SMPL-H's
    13,776 faces are about 3.4 GB of intermediates a frame), elsewhere one
    frame and 2048 faces a step."""
    if device.type == "cuda":
        return 4, num_faces
    return 1, 2048


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _signed_distances(object_points: torch.Tensor, verts: torch.Tensor,
                      faces: np.ndarray, *, engine: str,
                      face_chunk: Optional[int]) -> torch.Tensor:
    """Signed distances [B, N] (float32, on the points' device) of object
    points [B, N, 3] to the body meshes [B, V, 3]."""
    if engine == "torch":
        chunk = face_chunk or default_chunking(verts.device,
                                               faces.shape[0])[1]
        return signed_distance_to_mesh(object_points.to(torch.float32),
                                       verts, faces, face_chunk=chunk)[0]
    if engine == "native":
        from interdiff_torch.utils.native import SignedDistanceMesh

        pts = object_points.cpu().numpy()
        body = verts.cpu().numpy()
        return torch.as_tensor(np.stack([
            SignedDistanceMesh(body[b], faces).query(pts[b])[0]
            for b in range(body.shape[0])]), device=object_points.device)
    raise ValueError(f"unknown engine {engine!r}: one of {ENGINES}")


def _human_contacts(object_points: torch.Tensor, verts: torch.Tensor,
                    in_contact: torch.Tensor, thres: float) -> torch.Tensor:
    """[B, V] bool: body vertices within ``thres`` of a contacting object
    point, the distance in float64 (object points [B, N, 3] float64, body
    [B, V, 3], the contacting points [B, N] bool)."""
    near = torch.zeros(verts.shape[:2], dtype=torch.bool,
                       device=verts.device)
    body = verts.to(torch.float64)
    for b in range(verts.shape[0]):
        pts = object_points[b, in_contact[b]]  # [K, 3]
        if pts.shape[0]:
            d = pts[None] - body[b, :, None]  # [V, K, 3]
            d = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                           + d[..., 2] * d[..., 2])
            near[b] = (d < thres).any(dim=1)
    return near


def _frame_labels(object_points: torch.Tensor, verts: torch.Tensor,
                  faces: np.ndarray, thres: float, *, engine: str,
                  face_chunk: Optional[int] = None,
                  clock: Optional[Dict[str, float]] = None
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per frame of a batch (object points [B, N, 3] float64, body [B, V,
    3]): (object contact indices, body contact indices), int64.  ``clock``
    adds the seconds of ``distance`` and ``labels``."""
    t0 = time.perf_counter()
    dist = _signed_distances(object_points, verts, faces, engine=engine,
                             face_chunk=face_chunk)
    _sync(dist.device)
    t1 = time.perf_counter()
    in_contact = dist < thres
    near = _human_contacts(object_points, verts, in_contact, thres)
    in_contact, near = in_contact.cpu().numpy(), near.cpu().numpy()
    labels = [(np.where(in_contact[b])[0], np.where(near[b])[0])
              for b in range(in_contact.shape[0])]
    if clock is not None:
        clock["distance"] += t1 - t0
        clock["labels"] += time.perf_counter() - t1
    return labels


def contact_labels_for_frame(object_points, smpl_verts, smpl_faces,
                             thres: float = 0.02, *, engine: str = "torch",
                             device=None) -> Tuple[np.ndarray, np.ndarray]:
    """-> (object contact point indices, body contact vertex indices) of one
    frame: object points [N, 3] (float64 keeps the body labels' distance in
    float64), body vertices [V, 3], faces [F, 3].  Runs on
    ``resolve_device(device)`` (CUDA unless named); ``engine`` picks the
    signed distance, ``"torch"`` or ``"native"``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: one of {ENGINES}")
    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(object_points, np.float64),
                          device=device)[None]
    verts = torch.as_tensor(np.asarray(smpl_verts),
                            device=device)[None]
    return _frame_labels(pts, verts, np.asarray(smpl_faces), thres,
                         engine=engine)[0]


def object_template(object_path: str, obj_name: str, num_samples: int
                    ) -> np.ndarray:
    """[num_samples, 6] surface points and face normals of the mean-centred
    object scan ``<object_path>/<cat>/<cat>.obj``, or of the simplified
    template where the scan is absent (`data/utils.py:18-62`), sampled with
    `mesh_io.sample_surface`'s default generator."""
    full = os.path.join(object_path, f"{obj_name}/{obj_name}.obj")
    if not os.path.isfile(full):
        full = os.path.join(object_path, SIMPLIFIED_MESH[obj_name])
    mesh = load_mesh(full)
    mesh.vertices = mesh.vertices - mesh.vertices.mean(0)
    pts, fidx = sample_surface(mesh, num_samples)
    return np.concatenate([pts, mesh.face_normals[fidx]], axis=1)


def prepare_sequence(seq_dir: str, object_path: str,
                     smpl_models: Dict[str, SmplModel], *,
                     num_samples: int = 2048, overwrite: bool = False,
                     out_file: Optional[str] = None, engine: str = "torch",
                     frames_per_call: Optional[int] = None,
                     face_chunk: Optional[int] = None,
                     timings: Optional[Dict[str, float]] = None) -> str:
    """Write ``contact.npz`` for one BEHAVE sequence directory; returns its
    path (an existing file is kept unless ``overwrite``).

    FK of every frame runs on the body model's device, ``FK_CHUNK`` frames
    at a time; the object's pose per frame in float64 on the host; then
    ``frames_per_call`` frames at a time through the signed distance
    (``face_chunk`` faces a step; the defaults of `default_chunking`) and
    the labels.  ``timings`` collects
    the wall seconds of ``fk``, ``distance`` and ``labels`` (a device
    synchronisation after each) and the count of ``frames``.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: one of {ENGINES}")
    out = out_file or os.path.join(seq_dir, "contact.npz")
    if os.path.isfile(out) and not overwrite:
        return out

    with np.load(os.path.join(seq_dir, "object_fit_all.npz"),
                 allow_pickle=True) as f:
        obj_angles, obj_trans = f["angles"], f["trans"]
    with np.load(os.path.join(seq_dir, "smpl_fit_all.npz"),
                 allow_pickle=True) as f:
        poses, betas, trans = f["poses"], f["betas"], f["trans"]
    with open(os.path.join(seq_dir, "info.json")) as f:
        info = json.load(f)
    object_all = object_template(object_path, info["cat"], num_samples)
    pts = object_all[:, :3]

    model = smpl_models[info["gender"]]
    device = model.v_template.device
    # FK in full float32, as the eval entry point computes it
    full_f32()
    clock = {"fk": 0.0, "distance": 0.0, "labels": 0.0}
    _sync(device)
    t0 = time.perf_counter()
    verts, jtr = [], []
    with torch.no_grad():
        for s in range(0, poses.shape[0], FK_CHUNK):
            v, j, _, _ = smpl_forward(model, *(
                torch.as_tensor(np.asarray(a[s:s + FK_CHUNK]),
                                dtype=torch.float32, device=device)
                for a in (poses, betas, trans)))
            verts.append(v)
            jtr.append(j[:, 10:12, 1])
    verts = torch.cat(verts)
    feet = torch.cat(jtr).cpu().numpy()
    _sync(device)
    clock["fk"] += time.perf_counter() - t0

    per_call = frames_per_call or default_chunking(device,
                                                   len(model.faces))[0]
    object_labels, human_labels = [], []
    for s in range(0, poses.shape[0], per_call):
        frames = range(s, min(s + per_call, poses.shape[0]))
        # the object's pose per frame in float64, as in JAX (`:96-101`)
        obj_v = np.stack([pts @ rotvec_to_matrix_np(obj_angles[i]).T
                          + obj_trans[i] for i in frames])
        for ol, hl in _frame_labels(
                torch.as_tensor(obj_v, device=device),
                verts[s:s + per_call], model.faces, 0.02, engine=engine,
                face_chunk=face_chunk, clock=clock):
            object_labels.append(ol)
            human_labels.append(hl)

    contact_dict = {
        "object_points": object_all,
        "object_contact_vertex_label": object_labels,
        "human_contact_vertex_label": human_labels,
        "foot_contact_joint_label": np.where(
            feet[:, 0] > feet[:, 1], 10, 11).tolist(),
    }
    np.savez(out, contact_dict)
    if timings is not None:
        for k, v in clock.items():
            timings[k] = timings.get(k, 0.0) + v
        timings["frames"] = timings.get("frames", 0) + poses.shape[0]
    return out


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--motion_path", required=True)
    parser.add_argument("--object_path", required=True)
    parser.add_argument("--model_path", required=True,
                        help="directory with SMPLH_{male,female}.pkl")
    parser.add_argument("-n", "--num_samples", type=int, default=2048)
    parser.add_argument("--engine", default="torch", choices=ENGINES,
                        help="signed distance: 'torch' (the exact brute "
                             "force on the device) or 'native' (the host "
                             "C++ BVH, built with g++)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def main(argv=None, *, timings: Optional[Dict[str, float]] = None
         ) -> List[str]:
    """Write every sequence's ``contact.npz`` under ``--motion_path``;
    returns their paths (``timings`` as in :func:`prepare_sequence`, over
    all sequences)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    from interdiff_torch.smpl.loader import smpl_model_from_pkl

    smpl_models = {
        g: smpl_model_from_pkl(os.path.join(args.model_path,
                                            f"SMPLH_{g}.pkl"), device=device)
        for g in ("male", "female")}
    written = []
    for name in sorted(os.listdir(args.motion_path)):
        seq_dir = os.path.join(args.motion_path, name)
        if os.path.isdir(seq_dir):
            written.append(prepare_sequence(
                seq_dir, args.object_path, smpl_models,
                num_samples=args.num_samples, engine=args.engine,
                timings=timings))
            print(written[-1], flush=True)
    return written


if __name__ == "__main__":
    main()
