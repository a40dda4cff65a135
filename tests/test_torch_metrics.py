"""Evaluation metrics of the port (`interdiff_torch/eval/metrics.py`) and
`best_of_n_metrics` against `interdiff_tpu`'s on the same numpy inputs: a
posed 128-vertex stand-in body, an object cloud that straddles its surface.
Every metric agrees within 1e-5 (diffusion-math tolerance, PARITY.md row 1);
`penetrate`, a mean of sign tests, is compared by counts, full sweep and
pruned, with no sign test within rounding of 0."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.cli.common import synthetic_smpl_body as j_body  # noqa: E402
from interdiff_tpu.eval import metrics as jm  # noqa: E402
from interdiff_tpu.parallel import sample_parallel as jsp  # noqa: E402
from interdiff_tpu.smpl.model import smpl_forward as j_forward  # noqa: E402
from interdiff_torch.eval import metrics as tm  # noqa: E402
from interdiff_torch.geometry.normals import vertex_normals  # noqa: E402
from interdiff_torch.geometry.rotations import axis_angle_to_matrix  # noqa: E402
from interdiff_torch.ops.signed_distance import signed_nearest  # noqa: E402
from interdiff_torch.parallel import sample_parallel as tsp  # noqa: E402

B, T, V, P = 3, 6, 128, 48
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def scene():
    """Predicted and gt streams of B clips of T frames, with the verts and
    joints of the posed body (computed once, by the JAX package, and handed
    to both sides)."""
    rng = np.random.default_rng(7)
    body = j_body(np.random.default_rng(3), num_verts=V)

    def fk(pose, betas, trans):
        verts, jtr, _, _ = j_forward(body, jnp.asarray(pose),
                                     jnp.asarray(betas), jnp.asarray(trans))
        return (np.asarray(verts).reshape(B, T, V, 3),
                np.asarray(jtr).reshape(B, T, -1, 3))

    def stream():
        pose = (rng.standard_normal((B * T, 156)) * 0.2).astype(np.float32)
        betas = (rng.standard_normal((B * T, 10)) * 0.5).astype(np.float32)
        trans = (rng.standard_normal((B * T, 3)) * 0.3).astype(np.float32)
        verts, jtr = fk(pose, betas, trans)
        body_vec = np.concatenate([pose, trans], -1).reshape(B, T, -1)
        # the object rides 0.05 m off the body's centre: points on both
        # sides of the surface
        obj = np.concatenate(
            [rng.standard_normal((B, T, 3)),
             trans.reshape(B, T, 3) + np.float32(0.05)], -1).astype(
                 np.float32)
        return obj, jtr, body_vec, verts

    obj_pred, jtr, body_vec, verts = stream()
    obj_gt, jtr_gt, body_gt, _ = stream()
    obj_points = rng.uniform(-0.2, 0.2, (B, P, 3)).astype(np.float32)
    return dict(obj_pred=obj_pred, jtr=jtr, body=body_vec, obj_gt=obj_gt,
                jtr_gt=jtr_gt, body_gt=body_gt, verts=verts,
                faces=np.asarray(body.faces), obj_points=obj_points)


ARGS = ("obj_pred", "jtr", "body", "obj_gt", "jtr_gt", "body_gt", "verts",
        "faces", "obj_points")


@pytest.mark.parametrize("delta", [None, 0.25])
def test_smpl_metrics_match_jax(scene, delta):
    want = jm.smpl_metrics(*(jnp.asarray(scene[k]) for k in ARGS),
                           nn_chunk=None, nn_prune_delta=delta)
    got = tm.smpl_metrics(*(scene[k] if k == "faces" else _t(scene[k])
                            for k in ARGS), nn_prune_delta=delta)
    assert set(got) == set(want) == {
        "global_mpjpe", "local_mpjpe", "body_translation",
        "obj_translation", "obj_rot_error", "penetrate"}
    for k in want:
        assert got[k].shape == (B,)
        if k != "penetrate":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=TOL, rtol=TOL)
    # penetrate by counts: the same number of negative signs per clip
    counts = np.rint(got["penetrate"].numpy() * (T * P))
    np.testing.assert_array_equal(
        counts, np.rint(np.asarray(want["penetrate"]) * (T * P)))
    assert 0 < counts.sum() < B * T * P  # some inside, some outside


def test_penetrate_signs_are_not_at_the_toss_of_a_coin(scene):
    """The comparison by counts above means something only if no sdot lies
    within rounding of 0."""
    rot = axis_angle_to_matrix(_t(scene["obj_pred"][..., :3]))
    pts = (torch.einsum("btij,bpj->btpi", rot, _t(scene["obj_points"]))
           + _t(scene["obj_pred"][..., None, 3:])).reshape(B * T, P, 3)
    verts = _t(scene["verts"]).reshape(B * T, V, 3)
    _, sdot = signed_nearest(pts, verts, vertex_normals(verts,
                                                        scene["faces"]))
    assert float(sdot.abs().min()) > 1e-6


def test_pruned_penetrate_differs_only_by_far_points(scene):
    """Full sweep and pruned sweep agree here: every object point lies
    within delta of the body."""
    args = [scene[k] if k == "faces" else _t(scene[k]) for k in ARGS]
    full = tm.smpl_metrics(*args)["penetrate"]
    pruned = tm.smpl_metrics(*args, nn_prune_delta=2.0)["penetrate"]
    torch.testing.assert_close(full, pruned, atol=0, rtol=0)


@pytest.mark.parametrize("ord", [1, 2])
def test_quat_min_error_matches_jax(ord):
    rng = np.random.default_rng(ord)
    q = rng.standard_normal((2, 5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    other = -q + np.float32(0.01) * rng.standard_normal(q.shape).astype(
        np.float32)
    want = np.asarray(jm.quat_min_error(jnp.asarray(q), jnp.asarray(other),
                                        ord=ord))
    got = tm.quat_min_error(_t(q), _t(other), ord=ord).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    assert got.max() < 0.1  # the sign flip is seen through


def test_skeleton_metrics_match_jax():
    rng = np.random.default_rng(11)
    shapes = [(2, 15, 21, 3)] * 2 + [(2, 15, 12, 3)] * 2 + [(2, 15, 7)] * 2
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jm.skeleton_metrics(*(jnp.asarray(a) for a in args), start=10)
    got = tm.skeleton_metrics(*(_t(a) for a in args), start=10)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=TOL,
                                   rtol=TOL)


def test_smooth_seam_matches_jax_and_returns_a_new_tensor():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 35, 6, 3)).astype(np.float32)
    tx = _t(x.copy())
    got = tm.smooth_seam(tx, 25)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jm.smooth_seam(jnp.asarray(x), 25)),
        atol=TOL)
    np.testing.assert_array_equal(tx.numpy(), x)  # the input is untouched
    np.testing.assert_array_equal(got.numpy()[:, :10], x[:, :10])
    # C1 at the seam: the first future frame continues the last two past
    np.testing.assert_allclose(got.numpy()[:, 10],
                               2 * x[:, 9] - x[:, 8], atol=TOL)


def test_best_of_n_metrics_matches_jax():
    rng = np.random.default_rng(13)
    m = {k: rng.standard_normal(6).astype(np.float32) for k in "ab"}
    want = jsp.best_of_n_metrics({k: jnp.asarray(v) for k, v in m.items()},
                                 3)
    got = tsp.best_of_n_metrics({k: _t(v) for k, v in m.items()}, 3)
    for k in m:
        assert got[k].shape == (2,)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
