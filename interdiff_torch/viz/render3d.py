"""Tiny numpy software rasterizer, host code: the port's copy of
`interdiff_tpu/viz/render3d.py`.

The reference renders gifs through pyrender/EGL (`interdiff/render/
mesh_utils.py:64-206`), a GL stack a compute host usually lacks.  This
module draws the same scene with a z-buffered perspective rasterizer:

  * camera = the reference ``MeshViewer``'s: yfov pi/3, aspect w/h, pose
    ``translate([0, 2, 2.5]) @ rotX(-30 deg)`` (`mesh_utils.py:80-87`);
  * flat shading with a fixed 3-light raymond-style rig + ambient
    (`mesh_utils.py:156-186`), double-sided (abs(n.l)) so meshes with
    arbitrary winding still shade;
  * z-buffer via a vectorised fixed-size-tile batch over small triangles
    with a per-triangle fallback for large ones (ground planes).

Pure numpy: deterministic, unit-testable, no GL dependency.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Mesh = Tuple[np.ndarray, np.ndarray, np.ndarray]  # verts [V,3], faces [F,3], rgb [3] in 0..1

_LIGHTS = np.array([
    [0.5, 0.8, 0.6],
    [-0.6, 0.6, 0.4],
    [0.0, 0.3, -1.0],
])
_LIGHTS = _LIGHTS / np.linalg.norm(_LIGHTS, axis=1, keepdims=True)
_LIGHT_W = np.array([0.45, 0.30, 0.15])
_AMBIENT = 0.30


def view_matrix() -> np.ndarray:
    """world->camera transform of the reference MeshViewer pose."""
    c, s = np.cos(np.radians(-30.0)), np.sin(np.radians(-30.0))
    rot = np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                   dtype=np.float64)
    trans = np.eye(4)
    trans[:3, 3] = [0.0, 2.0, 2.5]
    cam_to_world = trans @ rot
    return np.linalg.inv(cam_to_world)


def rot_y(deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def _shade(normals: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Flat per-face colors [F,3]: ambient + double-sided diffuse."""
    diff = np.abs(normals @ _LIGHTS.T) @ _LIGHT_W  # [F]
    inten = np.clip(_AMBIENT + diff, 0.0, 1.0)
    return np.clip(base[None] * inten[:, None], 0.0, 1.0)


def _edge(ax, ay, bx, by, px, py):
    return (px - ax) * (by - ay) - (py - ay) * (bx - ax)


def _raster_subset(img, zbuf, p, z, col, K: int):
    """Rasterize triangles whose bbox fits a K x K tile, fully vectorised.

    p [F,3,2] pixel coords, z [F,3] positive depths, col [F,3] rgb.
    """
    H, W = zbuf.shape
    if p.shape[0] == 0:
        return
    x0 = np.floor(p[..., 0].min(axis=1)).astype(np.int64)
    y0 = np.floor(p[..., 1].min(axis=1)).astype(np.int64)
    ar = np.arange(K)
    px = (x0[:, None] + ar)[:, None, :] + 0.5  # [F,1,K] pixel centers (x)
    py = (y0[:, None] + ar)[:, :, None] + 0.5  # [F,K,1] pixel centers (y)

    a, b, c = p[:, 0], p[:, 1], p[:, 2]

    def e(u, v):
        return _edge(u[:, None, None, 0], u[:, None, None, 1],
                     v[:, None, None, 0], v[:, None, None, 1], px, py)

    area = _edge(a[:, 0], a[:, 1], b[:, 0], b[:, 1], c[:, 0], c[:, 1])
    w0, w1, w2 = e(b, c), e(c, a), e(a, b)
    sgn = np.sign(area)[:, None, None]
    inside = ((w0 * sgn >= 0) & (w1 * sgn >= 0) & (w2 * sgn >= 0)
              & (np.abs(area)[:, None, None] > 1e-12))
    denom = np.where(np.abs(area) < 1e-12, 1.0, area)[:, None, None]
    # perspective-correct depth: 1/z is affine in screen space, z is not
    inv_z = (w0 / z[:, 0, None, None] + w1 / z[:, 1, None, None]
             + w2 / z[:, 2, None, None]) / denom  # [F,K,K]
    zi = 1.0 / np.maximum(inv_z, 1e-12)

    ix = np.broadcast_to((x0[:, None] + ar)[:, None, :], zi.shape)
    iy = np.broadcast_to((y0[:, None] + ar)[:, :, None], zi.shape)
    valid = inside & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)

    flat = (iy * W + ix)[valid]
    zv = zi[valid]
    cv = np.broadcast_to(col[:, None, None, :], zi.shape + (3,))[valid]

    zflat = zbuf.reshape(-1)
    np.minimum.at(zflat, flat, zv)
    win = zv <= zflat[flat] + 1e-9
    img.reshape(-1, 3)[flat[win]] = cv[win]


def _raster_one(img, zbuf, p, z, col):
    """Single (possibly large) triangle, own bbox."""
    H, W = zbuf.shape
    x0 = max(int(np.floor(p[:, 0].min())), 0)
    x1 = min(int(np.ceil(p[:, 0].max())) + 1, W)
    y0 = max(int(np.floor(p[:, 1].min())), 0)
    y1 = min(int(np.ceil(p[:, 1].max())) + 1, H)
    if x1 <= x0 or y1 <= y0:
        return
    px = (np.arange(x0, x1) + 0.5)[None, :]
    py = (np.arange(y0, y1) + 0.5)[:, None]
    a, b, c = p
    area = _edge(a[0], a[1], b[0], b[1], c[0], c[1])
    if abs(area) < 1e-12:
        return
    w0 = _edge(b[0], b[1], c[0], c[1], px, py)
    w1 = _edge(c[0], c[1], a[0], a[1], px, py)
    w2 = _edge(a[0], a[1], b[0], b[1], px, py)
    sgn = np.sign(area)
    inside = (w0 * sgn >= 0) & (w1 * sgn >= 0) & (w2 * sgn >= 0)
    # perspective-correct depth (1/z affine in screen space)
    zi = 1.0 / np.maximum(
        (w0 / z[0] + w1 / z[1] + w2 / z[2]) / area, 1e-12)
    sub_z = zbuf[y0:y1, x0:x1]
    win = inside & (zi < sub_z)
    sub_z[win] = zi[win]
    img[y0:y1, x0:x1][win] = col


def render_scene(meshes: Sequence[Mesh], *, width: int = 256,
                 height: int = 256, bg=(1.0, 1.0, 1.0),
                 tile: int = 20) -> np.ndarray:
    """Render meshes with the MeshViewer camera -> uint8 [H, W, 3]."""
    img = np.empty((height, width, 3), dtype=np.float64)
    img[:] = np.asarray(bg, dtype=np.float64)
    zbuf = np.full((height, width), np.inf)

    view = view_matrix()
    yfov, aspect = np.pi / 3.0, width / height
    f = 1.0 / np.tan(yfov / 2.0)

    all_p: List[np.ndarray] = []
    all_z: List[np.ndarray] = []
    all_c: List[np.ndarray] = []
    for verts, faces, color in meshes:
        verts = np.asarray(verts, dtype=np.float64)
        faces = np.asarray(faces, dtype=np.int64)
        if faces.size == 0 or verts.size == 0:
            continue
        tri = verts[faces]  # [F,3,3] world
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        col = _shade(n, np.asarray(color, dtype=np.float64))

        cam = tri @ view[:3, :3].T + view[:3, 3]  # [F,3,3] camera space
        # near-clip: drop faces touching/behind the camera plane
        keep = (cam[..., 2] < -1e-3).all(axis=1)
        cam, col = cam[keep], col[keep]
        z = -cam[..., 2]  # positive depth
        u = (f / aspect) * cam[..., 0] / z
        v = f * cam[..., 1] / z
        p = np.stack([(u + 1.0) * 0.5 * width,
                      (1.0 - v) * 0.5 * height], axis=-1)  # [F,3,2]
        all_p.append(p)
        all_z.append(z)
        all_c.append(col)

    if not all_p:
        return (img * 255).astype(np.uint8)
    p = np.concatenate(all_p)
    z = np.concatenate(all_z)
    col = np.concatenate(all_c)

    bw = p[..., 0].max(axis=1) - p[..., 0].min(axis=1)
    bh = p[..., 1].max(axis=1) - p[..., 1].min(axis=1)
    # fully offscreen triangles cost nothing in the batch, but cull anyway
    on = ((p[..., 0].max(axis=1) >= 0) & (p[..., 0].min(axis=1) < width)
          & (p[..., 1].max(axis=1) >= 0) & (p[..., 1].min(axis=1) < height))
    # bucket by bbox size: a dense 14k-face body projects to ~2-4 px
    # triangles, and a fixed K x K tile would touch K*K/4 wasted pixels per
    # triangle (measured 10.7 s/frame at K=20 for the full SMPL mesh; the
    # 4/8/K buckets cut that ~8x). Output is identical to the single-bucket
    # path ABSENT exact cross-bucket depth ties: the z-buffer resolves all
    # strict depth differences, but per-bucket far-to-near sorts can flip
    # the winner between two triangles at bit-equal depth in different
    # buckets (coplanar/shared-edge faces) — all goldens pin equality
    remaining = on.copy()
    sizes = [k for k in (4, 8) if k < tile] + [tile]
    for K in sizes:
        sel = remaining & (bw < K - 1) & (bh < K - 1)
        if sel.any():
            # far-to-near ordering so equal-depth overwrites favour nearer
            order = np.argsort(-z[sel].mean(axis=1), kind="stable")
            _raster_subset(img, zbuf, p[sel][order], z[sel][order],
                           col[sel][order], K)
            remaining &= ~sel
    for i in np.where(remaining)[0]:
        _raster_one(img, zbuf, p[i], z[i], col[i])
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def ground_planes(minx: float, maxx: float, minz: float, maxz: float
                  ) -> List[Mesh]:
    """The reference's two-tone ground (`mesh_utils.py:25-62`): an inner
    gray plane spanning the scene extent over a 1.6x lighter outer plane,
    at y=0 (the reference rotates its xy boxes flat, `mesh_utils.py:100`).
    Centered on the (already centered) scene — the reference places the
    boxes at ``(max-min)/2`` which misaligns with its own scene centering;
    centering here is the intended behaviour."""
    gray = np.array([189, 195, 199]) / 255.0
    gray_l = np.array([238, 238, 238]) / 255.0
    cx, cz = (minx + maxx) / 2.0, (minz + maxz) / 2.0
    ex, ez = (maxx - minx) / 2.0, (maxz - minz) / 2.0

    def quad(ex_, ez_, y, color):
        v = np.array([[cx - ex_, y, cz - ez_], [cx + ex_, y, cz - ez_],
                      [cx + ex_, y, cz + ez_], [cx - ex_, y, cz + ez_]])
        fcs = np.array([[0, 1, 2], [0, 2, 3]])
        return (v, fcs, color)

    return [quad(1.6 * ex, 1.6 * ez, -2e-3, gray_l),
            quad(ex, ez, -1e-3, gray)]
