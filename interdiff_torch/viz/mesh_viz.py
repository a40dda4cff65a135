"""SMPL-track mesh gif rendering — reference protocol from
`interdiff/render/mesh_viz.py:33-155` + `mesh_utils.py:20-206`.

The port's copy of `interdiff_tpu/viz/mesh_viz.py`, host numpy.  The
reference renders through pyrender/EGL; every frame here goes through the
deterministic numpy software rasterizer in :mod:`interdiff_torch.viz.
render3d`, reproducing the reference's scene protocol:

  * verts are negated and the scene floored/centered on the *body* mesh
    extent (`mesh_viz.py:63-79`);
  * two-tone gray ground planes, inner plane spanning the body extent and
    a 1.6x lighter outer plane (`mesh_utils.py:20-62`);
  * past frames (``i <= past_len``, the reference's off-by-one included)
    colored grey (object) / light-grey (body); future frames pink /
    yellow-pale — the `colors` table from `data/utils.py:288-306`;
  * ``multi_angle`` renders 4 yaw views, each +90 deg about y, tiled
    horizontally in the reference's order ``v0 | v1 | v3 | v2``
    (`mesh_viz.py:129-148`);
  * gif written at ``30 // sample_rate`` fps (`mesh_viz.py:151`) and the
    frames returned as ``[T, 3, H, W]`` uint8 (`mesh_viz.py:154`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from interdiff_torch.viz import render3d

# `data/utils.py:288-306` (RGB 0..255)
COLORS = {
    "grey": (77, 77, 77),
    "light_grey": (217, 217, 217),
    "pink": (197, 140, 133),
    "yellow_pale": (226, 215, 132),
    "black": (0, 0, 0),
    "cyan": (0, 255, 255),
    "blue": (162, 26, 15),
    "red": (26, 15, 162),
    "green": (26, 162, 15),
    "yellow": (255, 255, 0),
    "magenta": (197, 27, 125),
    "white": (255, 255, 255),
}

# `data/utils.py:273-285`
BODYPART2COLOR = {
    "head_ids": "cyan",
    "mid_body_ids": "blue",
    "left_hand_ids": "red",
    "right_hand_ids": "green",
    "left_foot_ids": "grey",
    "right_foot_ids": "black",
    "left_toe_ids": "yellow",
    "right_toe_ids": "magenta",
    "left_finger_ids": "red",
    "right_finger_ids": "green",
    "special": "light_grey",
}


def _rgb(name: str) -> np.ndarray:
    return np.asarray(COLORS[name], dtype=np.float64) / 255.0


def render_frame(body_verts: np.ndarray, body_faces: np.ndarray,
                 obj_verts: np.ndarray, obj_faces: np.ndarray,
                 ground: list, *, past: bool, h: int, w: int,
                 multi_angle: bool,
                 markers: Optional[np.ndarray] = None) -> np.ndarray:
    """One already-centered frame -> [h, w] or [h, 4w] uint8 image."""
    body_c = _rgb("light_grey") if past else _rgb("yellow_pale")
    obj_c = _rgb("grey") if past else _rgb("pink")
    # an object given as a raw point cloud (no faces — e.g. the BEHAVE
    # template points in the eval CLI) renders as small spheres; degenerate
    # placeholder faces would otherwise be culled and the object vanish
    obj_is_cloud = obj_faces is None or np.asarray(obj_faces).size == 0

    def one_view(bv, ov, mk):
        meshes = list(ground)
        if obj_is_cloud:
            meshes.append(_point_sphere_mesh(ov, obj_c))
        else:
            meshes.append((ov, obj_faces, obj_c))
        meshes.append((bv, body_faces, body_c))
        if mk is not None:
            meshes.extend(_marker_meshes(mk, past))
        return render3d.render_scene(meshes, width=w, height=h)

    if not multi_angle:
        return one_view(body_verts, obj_verts, markers)
    views = []
    bv, ov, mk = body_verts, obj_verts, markers
    rot = render3d.rot_y(90.0)
    for _ in range(4):
        views.append(one_view(bv, ov, mk))
        bv = bv @ rot.T
        ov = ov @ rot.T
        mk = None if mk is None else mk @ rot.T
    # the reference tiles v0|v1|v3|v2 (`mesh_viz.py:148`)
    return np.concatenate([views[0], views[1], views[3], views[2]], axis=1)


# 12-vertex icosahedron template for marker spheres (radius 0.01, like the
# reference's `trimesh.creation.uv_sphere(radius=0.01)` at `mesh_viz.py:165`)
_PHI = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_V = np.array(
    [[-1, _PHI, 0], [1, _PHI, 0], [-1, -_PHI, 0], [1, -_PHI, 0],
     [0, -1, _PHI], [0, 1, _PHI], [0, -1, -_PHI], [0, 1, -_PHI],
     [_PHI, 0, -1], [_PHI, 0, 1], [-_PHI, 0, -1], [-_PHI, 0, 1]])
_ICO_V = 0.01 * _ICO_V / np.linalg.norm(_ICO_V, axis=1, keepdims=True)
_ICO_F = np.array(
    [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
     [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
     [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
     [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])


def _point_sphere_mesh(pts: np.ndarray, color: np.ndarray,
                       max_points: int = 300, radius: float = 0.012):
    """Point cloud -> one mesh of small icosahedra (subsampled for speed)."""
    pts = np.asarray(pts, dtype=np.float64)
    if pts.shape[0] > max_points:
        pts = pts[:: int(np.ceil(pts.shape[0] / max_points))]
    n = pts.shape[0]
    scale = radius / 0.01  # _ICO_V is pre-scaled to radius 0.01
    verts = (pts[:, None, :] + scale * _ICO_V[None]).reshape(n * 12, 3)
    faces = (_ICO_F[None] + 12 * np.arange(n)[:, None, None]
             ).reshape(n * 20, 3)
    return (verts, faces, color)


def _marker_meshes(markers: np.ndarray, past: bool) -> list:
    """SSM-67 markers as small spheres colored per body part
    (`mesh_viz.py:158-176`; past frames all-black)."""
    from interdiff_torch.data.constants import MARKER2BODYPART

    out = []
    for bp, ids in MARKER2BODYPART.items():
        color = _rgb("black") if past else _rgb(BODYPART2COLOR[bp])
        idx = np.asarray(ids, dtype=np.int64)
        idx = idx[idx < markers.shape[0]]  # finger ids absent from SSM-67
        if idx.size == 0:
            continue
        pts = markers[idx]
        n = pts.shape[0]
        verts = (pts[:, None, :] + _ICO_V[None]).reshape(n * 12, 3)
        faces = (_ICO_F[None] + 12 * np.arange(n)[:, None, None]
                 ).reshape(n * 20, 3)
        out.append((verts, faces, color))
    return out


def visualize_body_obj(verts: np.ndarray, faces: np.ndarray,
                       obj_verts: np.ndarray, obj_faces: np.ndarray,
                       *, past_len: int = 0, save_path: Optional[str] = None,
                       sample_rate: int = 1, multi_angle: bool = True,
                       h: int = 256, w: int = 256,
                       pcd: Optional[np.ndarray] = None) -> np.ndarray:
    """Render a body+object sequence per the reference protocol.

    verts [T,V,3], obj_verts [T,P,3]; optional pcd [T,67,3] SSM markers.
    Writes ``save_path`` gif if given; returns frames [T, 3, H, W'] uint8
    (W' = 4w when ``multi_angle``), matching `mesh_viz.py:151-155`.
    """
    verts = np.asarray(verts, dtype=np.float64)
    obj_verts = np.asarray(obj_verts, dtype=np.float64)
    T = verts.shape[0]

    # `mesh_viz.py:63-79`: negate, floor on body min-y, center on body x/z
    body = -verts
    obj = -obj_verts
    minx, _, minz = body.min(axis=(0, 1))
    maxx, _, maxz = body.max(axis=(0, 1))
    height_offset = body[:, :, 1].min()
    shift = np.array([(minx + maxx) / 2.0, height_offset,
                      (minz + maxz) / 2.0])
    body = body - shift
    obj = obj - shift
    markers = None if pcd is None else (-np.asarray(pcd, np.float64)) - shift

    ex, ez = (maxx - minx) / 2.0, (maxz - minz) / 2.0
    ground = render3d.ground_planes(-ex, ex, -ez, ez)

    of = None if obj_faces is None else np.asarray(obj_faces)
    frames = []
    for i in range(T):
        frames.append(render_frame(
            body[i], np.asarray(faces), obj[i], of,
            ground, past=(i <= past_len), h=h, w=w,
            multi_angle=multi_angle,
            markers=None if markers is None else markers[i]))
    video = np.stack(frames)  # [T, H, W', 3]

    if save_path is not None:
        _write_gif(save_path, video, fps=max(1, 30 // max(1, sample_rate)))
    return np.transpose(video, (0, 3, 1, 2))


def _write_gif(path: str, frames: np.ndarray, *, fps: int) -> str:
    try:
        import imageio

        imageio.mimsave(path, list(frames), duration=1000.0 / fps, loop=0)
    except Exception:
        from PIL import Image

        ims = [Image.fromarray(f) for f in frames]
        ims[0].save(path, save_all=True, append_images=ims[1:],
                    duration=int(1000 / fps), loop=0)
    return path
