"""The port's host copies of the mesh loaders and the renderers
(`interdiff_torch/data/mesh_io.py`, `interdiff_torch/viz/{render3d,
mesh_viz,skeleton_viz}.py`) against the JAX package's, bitwise: OBJ (fan
triangulated, negative and slashed indices) and PLY (ascii and binary)
meshes, area-weighted surface sampling with the default and an explicit
generator, `render_scene` (small and large triangles, the ground planes),
the frames of `visualize_body_obj` (a mesh object, a point-cloud object,
markers, one view and four) and the gif frames of `visualize_skeleton`."""

import os
import struct

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("matplotlib")
PIL = pytest.importorskip("PIL.Image")

import chip_smoke  # noqa: E402  (the stand-in meshes)
from interdiff_torch.data import mesh_io as tio  # noqa: E402
from interdiff_torch.viz import mesh_viz as tmv  # noqa: E402
from interdiff_torch.viz import render3d as tr3  # noqa: E402
from interdiff_torch.viz import skeleton_viz as tsk  # noqa: E402
from interdiff_tpu.data import mesh_io as jio  # noqa: E402
from interdiff_tpu.viz import mesh_viz as jmv  # noqa: E402
from interdiff_tpu.viz import render3d as jr3  # noqa: E402
from interdiff_tpu.viz import skeleton_viz as jsk  # noqa: E402


def _same_mesh(a, b):
    for name in ("vertices", "faces", "face_normals", "face_areas"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshes")
    v, f = chip_smoke.ellipsoid_mesh((0.2, 0.3, 0.1), 40)
    paths = {}
    # OBJ: a quad (fan-triangulated), slashed indices, a negative index
    lines = [f"v {a!r} {b!r} {c!r}" for a, b, c in v.tolist()]
    lines += [f"f {a + 1}/1/1 {b + 1}//2 {c + 1}" for a, b, c in f.tolist()]
    lines += ["vn 0 0 1", "f 1 2 3 4", "f -1 -2 -3"]
    paths["obj"] = root / "m.obj"
    paths["obj"].write_text("\n".join(lines) + "\n")
    header = ["ply", "format {}", f"element vertex {len(v)}",
              "property float x", "property float y", "property float z",
              "property uchar red", f"element face {len(f) + 1}",
              "property list uchar int vertex_indices", "end_header"]
    ascii_body = [f"{a!r} {b!r} {c!r} 7" for a, b, c in v.tolist()]
    ascii_body += [f"3 {a} {b} {c}" for a, b, c in f.tolist()] + [
        "4 0 1 2 3"]
    paths["ply_ascii"] = root / "a.ply"
    paths["ply_ascii"].write_text(
        "\n".join(header).format("ascii 1.0") + "\n"
        + "\n".join(ascii_body) + "\n")
    blob = b"".join(struct.pack("<fffB", *row, 7) for row in v.tolist())
    blob += b"".join(struct.pack("<B3i", 3, *row) for row in f.tolist())
    blob += struct.pack("<B4i", 4, 0, 1, 2, 3)
    paths["ply_binary"] = root / "b.ply"
    paths["ply_binary"].write_bytes(
        ("\n".join(header).format("binary_little_endian 1.0") + "\n")
        .encode() + blob)
    return paths


@pytest.mark.parametrize("kind", ["obj", "ply_ascii", "ply_binary"])
def test_loaders_match_jax(meshes, kind):
    got, want = tio.load_mesh(meshes[kind]), jio.load_mesh(meshes[kind])
    _same_mesh(got, want)
    assert got.vertices.dtype == np.float64 and len(got.faces) > 70
    with pytest.raises(ValueError, match="unsupported mesh format"):
        tio.load_mesh(str(meshes[kind]) + ".stl")


def test_sample_surface_matches_jax(meshes):
    mesh = tio.load_mesh(meshes["obj"])
    jmesh = jio.load_mesh(meshes["obj"])
    for rng in (None, 7):
        got = tio.sample_surface(mesh, 300, rng=None if rng is None
                                 else np.random.default_rng(rng))
        want = jio.sample_surface(jmesh, 300, rng=None if rng is None
                                  else np.random.default_rng(rng))
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def _scene(rng):
    v, f = chip_smoke.ellipsoid_mesh((0.3, 0.8, 0.2), 300)
    body = (v + [0, 0.8, 0], f, np.array([0.8, 0.7, 0.5]))
    big = (np.array([[-3.0, 0.0, -3.0], [3.0, 0.0, -3.0], [0.0, 0.0, 3.0]]),
           np.array([[0, 1, 2]]), np.array([0.2, 0.4, 0.9]))
    cloud = tmv._point_sphere_mesh(rng.normal(0, 0.2, (50, 3)) + [0.5, 1, 0],
                                   np.array([0.9, 0.1, 0.1]))
    return [body, big, cloud] + tr3.ground_planes(-1.0, 1.0, -0.5, 0.5)


def test_render_scene_matches_jax():
    scene = _scene(np.random.default_rng(3))
    for size in ((64, 48), (96, 96)):
        got = tr3.render_scene(scene, width=size[0], height=size[1])
        want = jr3.render_scene(scene, width=size[0], height=size[1])
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert len(np.unique(got.reshape(-1, 3), axis=0)) > 5


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(4)
    T = 4
    v, f = chip_smoke.ellipsoid_mesh((0.25, 0.85, 0.15), 200)
    body = np.stack([v + [0.03 * t, 0.9, 0] for t in range(T)])
    ov, of = chip_smoke.ellipsoid_mesh((0.2, 0.1, 0.2), 60)
    obj = np.stack([ov + [0.4, 0.6 + 0.02 * t, 0.1] for t in range(T)])
    markers = body[:, rng.choice(len(v), 67)]
    return body, f, obj, of, markers


@pytest.mark.parametrize("variant", ["mesh", "cloud", "markers", "one_view"])
def test_visualize_body_obj_matches_jax(clip, variant, tmp_path):
    body, f, obj, of, markers = clip
    kw = dict(past_len=1, h=40, w=48)
    if variant == "cloud":
        of = None
    if variant == "markers":
        kw["pcd"] = markers
    if variant == "one_view":
        kw["multi_angle"] = False
    got = tmv.visualize_body_obj(body, f, obj, of,
                                 save_path=str(tmp_path / "t.gif"), **kw)
    want = jmv.visualize_body_obj(body, f, obj, of,
                                  save_path=str(tmp_path / "j.gif"), **kw)
    assert got.shape == want.shape == (
        4, 3, 40, 48 if variant == "one_view" else 4 * 48)
    assert np.array_equal(got, want)
    assert _gif_frames(tmp_path / "t.gif") == _gif_frames(tmp_path / "j.gif")


def _gif_frames(path):
    """Every frame of a gif as RGB bytes."""
    frames = []
    with PIL.open(path) as im:
        for k in range(im.n_frames):
            im.seek(k)
            frames.append(np.asarray(im.convert("RGB")).tobytes())
    return frames


@pytest.mark.parametrize("obj_name", ["chairblack", None])
def test_visualize_skeleton_matches_jax(obj_name, tmp_path):
    rng = np.random.default_rng(6)
    T = 5
    skel = np.cumsum(rng.normal(0, 0.05, (T, 21, 3)), axis=0)
    obj = rng.normal(0, 0.3, (T, 12, 3))
    kw = dict(obj_name=obj_name, past_len=2, fps=10)
    if obj_name:
        kw.update(pred=skel + 0.02, obj_pred=obj - 0.02)
    got = tsk.visualize_skeleton(skel, obj, str(tmp_path / "t.gif"), **kw)
    want = jsk.visualize_skeleton(skel, obj, str(tmp_path / "j.gif"), **kw)
    assert os.path.basename(got) == "t.gif" and os.path.basename(
        want) == "j.gif"
    frames = _gif_frames(got)
    assert len(frames) == T and frames == _gif_frames(want)
    assert tsk._obj_edges(obj_name) == jsk._obj_edges(obj_name)
