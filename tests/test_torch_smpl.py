"""The body side of the correction path: `smpl_forward`, the stand-in body
and `vertex_normals` of `interdiff_torch` against `interdiff_tpu` on the
same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.cli.common import synthetic_smpl_body as j_body  # noqa: E402
from interdiff_tpu.geometry.normals import vertex_normals as j_normals  # noqa: E402
from interdiff_tpu.smpl.model import smpl_forward as j_forward  # noqa: E402
from interdiff_tpu.utils.fixtures import tiny_smpl_model  # noqa: E402
from interdiff_torch.cli.common import synthetic_smpl_body  # noqa: E402
from interdiff_torch.config import build_smpl_body  # noqa: E402
from interdiff_torch.geometry.normals import (  # noqa: E402
    _face_incidence,
    vertex_normals,
)
from interdiff_torch.smpl.model import SmplModel, smpl_forward  # noqa: E402

ARRAYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights")


def _from_jax(jmodel) -> SmplModel:
    """The "weights carried across": a JAX body's arrays into the port's."""
    return SmplModel.create(
        **{k: np.asarray(getattr(jmodel, k)) for k in ARRAYS},
        parents=jmodel.parents, faces=jmodel.faces, device="cpu")


def _pose_inputs(rng, B):
    pose = (rng.standard_normal((B, 156)) * 0.3).astype(np.float32)
    betas = rng.standard_normal((B, 10)).astype(np.float32)
    trans = rng.standard_normal((B, 3)).astype(np.float32)
    return pose, betas, trans


@pytest.mark.parametrize("body", ["tiny", "stand_in"])
def test_smpl_forward_matches_jax(body):
    rng = np.random.default_rng(233)
    jmodel = (tiny_smpl_model(rng) if body == "tiny"
              else j_body(rng, num_verts=128))
    model = _from_jax(jmodel)
    assert model.levels == jmodel.levels
    pose, betas, trans = _pose_inputs(rng, 5)
    offsets = (rng.standard_normal((5, model.num_verts, 3)) * 0.01
               ).astype(np.float32)
    want = j_forward(jmodel, jnp.asarray(pose), jnp.asarray(betas),
                     jnp.asarray(trans), offsets=jnp.asarray(offsets),
                     scale=1.1)
    got = smpl_forward(model, *map(torch.from_numpy, (pose, betas, trans)),
                       offsets=torch.from_numpy(offsets), scale=1.1)
    assert len(got) == 4
    for g, w in zip(got, want):  # verts, joints, v_posed, naked
        # f32 sums of 52-459 terms in another order, values of order 1
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_stand_in_body_equals_jax_for_the_same_rng():
    jmodel = j_body(np.random.default_rng(7), num_verts=128)
    model = synthetic_smpl_body(np.random.default_rng(7), num_verts=128,
                                device="cpu")
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(model, k).numpy(),
                                      np.asarray(getattr(jmodel, k)))
    np.testing.assert_array_equal(model.parents, jmodel.parents)
    np.testing.assert_array_equal(model.faces, jmodel.faces)
    assert model.faces.shape == (2 * 128 - 4, 3)  # closed surface
    assert model.num_joints == 52 and model.num_verts == 128
    again = build_smpl_body(seed=7, num_verts=128, device="cpu")
    assert torch.equal(again.v_template, model.v_template)


def test_build_smpl_body_from_arrays():
    jmodel = tiny_smpl_model(np.random.default_rng(1))
    arrays = {k: np.asarray(getattr(jmodel, k)) for k in ARRAYS}
    arrays.update(parents=np.array(jmodel.parents), faces=jmodel.faces)
    arrays["parents"][0] = -1  # as the pkls store the root
    model = build_smpl_body(arrays, device="cpu")
    assert model.parents[0] == 0
    assert model.v_template.dtype == torch.float32
    assert model.incident.dtype == torch.int64


def test_vertex_normals_match_jax_on_the_closed_mesh():
    rng = np.random.default_rng(3)
    jmodel = j_body(rng, num_verts=128)
    model = _from_jax(jmodel)
    pose, betas, trans = _pose_inputs(rng, 4)
    verts = smpl_forward(model, *map(torch.from_numpy,
                                     (pose, betas, trans)))[0]
    want = np.asarray(j_normals(jnp.asarray(verts.numpy()), jmodel.faces))
    got = vertex_normals(verts, model.faces_idx, model.incident)
    # unit vectors from sums of up to K cross products in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # outward on a closed convex-ish surface, unit length
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    # numpy faces without a table, and leading batch dims
    again = vertex_normals(verts.reshape(2, 2, 128, 3), model.faces)
    assert torch.equal(again.reshape(4, 128, 3), got)


def test_face_incidence_lists_every_corner_once():
    faces = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4]], dtype=np.int32)
    inc = _face_incidence(faces, 6)
    assert inc.shape == (6, 3)
    for v in range(6):
        want = sorted(f for f in range(3) if v in faces[f])
        assert sorted(int(f) for f in inc[v] if f != 3) == want
    # a vertex of no face gets a zero normal, not a NaN
    verts = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 6, 3)).astype(np.float32))
    n = vertex_normals(verts, faces)
    assert torch.equal(n[0, 5], torch.zeros(3))
    assert bool(torch.isfinite(n).all())
