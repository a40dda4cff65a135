"""The port's mesh signed distance (`interdiff_torch/ops/mesh_distance.py`)
and its ctypes binding of the host BVH (`interdiff_torch/utils/native.py`)
against the JAX package's on the CPU: a closed hull, an open mesh with
boundary edges and a box whose points fall in the vertex, edge and face
regions.  |distance| within 1e-6, closest points within 1e-5, the sign
equal wherever |d| > 1e-5, the face index equal except at ties within
1e-6 (two faces' closest points then round differently in the two
packages); the result independent of ``face_chunk`` and of batching frames;
the native engine bitwise JAX's native engine; no silent fallback."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the stand-in meshes)
from interdiff_torch.ops import mesh_distance as T  # noqa: E402
from interdiff_torch.utils import native as tnative  # noqa: E402
from interdiff_tpu.ops import mesh_distance as J  # noqa: E402
from interdiff_tpu.utils import native as jnative  # noqa: E402

DIST_TOL = 1e-6
POINT_TOL = 1e-5
SIGN_MARGIN = 1e-5
TIE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hull(rng):
    verts, faces = chip_smoke.ellipsoid_mesh((0.3, 0.8, 0.2), 642)
    verts = verts * (1.0 + 0.05 * rng.standard_normal((len(verts), 1)))
    pts = (rng.standard_normal((300, 3)) * [0.3, 0.8, 0.2] * 0.7
           + rng.standard_normal((300, 3)) * 0.05)
    return pts, verts, faces


def _open_sheet(rng):
    """A bumpy height field over a 16 x 16 grid: 450 faces, a boundary of
    60 edges that belong to one face each, and the sign taken from the one
    side of the sheet."""
    n = 16
    x, z = np.meshgrid(np.linspace(-0.5, 0.5, n), np.linspace(-0.5, 0.5, n))
    y = 0.08 * np.sin(3 * x) * np.cos(4 * z)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    i = np.arange(n - 1)
    a = (i[:, None] * n + i[None, :]).reshape(-1)
    faces = np.concatenate([np.stack([a, a + n, a + 1], 1),
                            np.stack([a + 1, a + n, a + n + 1], 1)])
    pts = rng.uniform(-0.7, 0.7, (250, 3)) * [1.0, 0.3, 1.0]
    return pts, verts, faces.astype(np.int32)


def _box(rng):
    """The unit box: points off its corners (vertex regions), off its edges
    and off its faces, outside and inside."""
    verts = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                      for z in (0, 1)], np.float64)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    corner = verts + (verts - 0.5) * rng.uniform(0.1, 0.5, (8, 1))
    edge = np.array([[0.5, -0.2, -0.3], [-0.2, 0.5, 1.3], [1.3, 1.2, 0.5],
                     [0.3, 1.2, 1.1], [1.1, 0.7, -0.2], [-0.1, -0.3, 0.2]])
    face = np.array([[0.5, 0.5, -0.3], [1.2, 0.4, 0.6], [0.2, 1.1, 0.7],
                     [0.5, 0.5, 0.9], [0.1, 0.5, 0.5]])
    inside = rng.uniform(0.05, 0.95, (20, 3))
    pts = np.concatenate([corner, edge, face, inside])
    return pts, verts, faces


MESHES = {"hull": _hull, "open": _open_sheet, "box": _box}


@pytest.fixture(scope="module")
def cases():
    """Each mesh with the JAX package's brute-force answer and the JAX
    distances of every (point, face) pair, computed once."""
    out = {}
    for k, (name, make) in enumerate(MESHES.items()):
        pts, verts, faces = make(np.random.default_rng(10 + k))
        want = [np.asarray(a) for a in J.signed_distance_to_mesh(
            pts, verts, faces)]
        cp = np.asarray(J.closest_point_on_triangles(
            pts.astype(np.float32), verts.astype(np.float32)[faces]))
        pair_d = np.linalg.norm(pts.astype(np.float32)[:, None] - cp,
                                axis=-1)
        out[name] = (pts, verts, faces, want, pair_d)
    return out


def _check_against_jax(got, want, pair_d):
    d, f, cp = (a.numpy() for a in got)
    jd, jf, jcp = want
    np.testing.assert_allclose(np.abs(d), np.abs(jd), rtol=0, atol=DIST_TOL)
    np.testing.assert_allclose(cp, jcp, rtol=0, atol=POINT_TOL)
    away = np.abs(jd) > SIGN_MARGIN
    assert np.array_equal(np.sign(d[away]), np.sign(jd[away]))
    rows = np.arange(len(f))
    tie = np.abs(pair_d[rows, f] - pair_d[rows, jf]) <= TIE_TOL
    assert np.all((f == jf) | tie), np.where((f != jf) & ~tie)
    return away


@pytest.mark.parametrize("name", list(MESHES))
def test_signed_distance_matches_jax(cases, name):
    pts, verts, faces, want, pair_d = cases[name]
    got = T.signed_distance_to_mesh(pts, verts, faces, device="cpu")
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    away = _check_against_jax(got, want, pair_d)
    # the cases reach both signs away from the surface
    d = got[0].numpy()[away]
    assert (d > 0).any() and (d < 0).any()


@pytest.mark.parametrize("name", list(MESHES))
def test_face_chunk_and_frame_batch_change_nothing(cases, name):
    pts, verts, faces, _, _ = cases[name]
    whole = T.signed_distance_to_mesh(pts, verts, faces, device="cpu")
    for chunk in (5, 97, len(faces) + 1):
        part = T.signed_distance_to_mesh(pts, verts, faces,
                                         face_chunk=chunk, device="cpu")
        for a, b in zip(whole, part):
            assert torch.equal(a, b), chunk
    # a second frame: the mesh moved and scaled, the points reversed
    verts2 = verts * 1.1 + 0.02
    pts2 = pts[::-1].copy()
    both = T.signed_distance_to_mesh(np.stack([pts, pts2]),
                                     np.stack([verts, verts2]), faces,
                                     face_chunk=64, device="cpu")
    second = T.signed_distance_to_mesh(pts2, verts2, faces, device="cpu")
    for a, b, c in zip(both, whole, second):
        assert torch.equal(a[0], b) and torch.equal(a[1], c)


def test_box_regions(cases):
    """The box's closest points: corners for the corner points, points of
    an edge for the edge points, the face's plane for the face points;
    the distances the analytic ones."""
    pts, verts, faces, _, _ = cases["box"]
    d, _, cp = (a.numpy() for a in T.signed_distance_to_mesh(
        pts, verts, faces, device="cpu"))
    outside = np.linalg.norm(pts - np.clip(pts, 0, 1), axis=1)
    inside = np.min(np.concatenate([pts, 1 - pts], 1), axis=1)
    want = np.where(outside > 0, outside, -inside)
    np.testing.assert_allclose(d, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cp[:8], verts, rtol=0, atol=1e-6)
    on_edge = (np.isclose(cp[8:14], 0, atol=1e-6)
               | np.isclose(cp[8:14], 1, atol=1e-6)).sum(1)
    assert np.all(on_edge >= 2)


def test_pseudonormals_match_jax(cases):
    pts, verts, faces, _, _ = cases["hull"]
    jfn, jvn, jedge = J._pseudonormals(verts, faces)
    fn, vn, en, edge_of = T._pseudonormals(torch.as_tensor(verts),
                                           torch.as_tensor(faces).long())
    np.testing.assert_allclose(fn.numpy(), jfn, rtol=0, atol=1e-12)
    np.testing.assert_allclose(vn.numpy(), jvn, rtol=0, atol=1e-12)
    en, edge_of = en.numpy(), edge_of.numpy()
    assert len(en) == len(jedge)
    for f, face in enumerate(faces):
        for k in range(3):
            key = tuple(sorted((int(face[k]), int(face[(k + 1) % 3]))))
            np.testing.assert_allclose(en[edge_of[f, k]], jedge[key],
                                       rtol=0, atol=1e-12)


def test_native_engine_bitwise_jax_native(cases):
    """The same source built by the port (into `interdiff_torch/_build/`)
    and by the JAX package (`native/`): equal results."""
    if not jnative.native_available():
        pytest.skip("the JAX package's native library does not build here")
    for name in MESHES:
        pts, verts, faces, _, _ = cases[name]
        got = tnative.SignedDistanceMesh(verts, faces).query(pts)
        want = jnative.SignedDistanceMesh(verts, faces).query(pts)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tnative.library_path().startswith(tnative._BUILD_DIR)
    assert np.array_equal(tnative.signed_distance(pts, verts, faces,
                                                  engine="native"), want[0])
    brute = T.signed_distance_to_mesh(pts, verts, faces, device="cpu")[0]
    assert np.array_equal(tnative.signed_distance(
        pts, verts, faces, engine="torch", device="cpu"), brute.numpy())


def test_native_engine_raises_when_it_cannot_build(monkeypatch, tmp_path):
    """No fallback: a source g++ cannot compile raises, and so does every
    query through the native engine."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.SignedDistanceMesh(np.zeros((3, 3)), np.array([[0, 1, 2]]))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.signed_distance(np.zeros((1, 3)), np.zeros((3, 3)),
                                np.array([[0, 1, 2]]), engine="native")
    assert not tnative.native_available()
    with pytest.raises(ValueError, match="unknown engine"):
        tnative.signed_distance(np.zeros((1, 3)), np.zeros((3, 3)),
                                np.array([[0, 1, 2]]), engine="igl")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.signed_distance_to_mesh(np.zeros((2, 3)), np.eye(3),
                                  np.array([[0, 1, 2]]))
