"""The mesh regularisation losses of the port
(`interdiff_torch/geometry/mesh_losses.py`, scatter-adds by `index_add_`)
against `interdiff_tpu/geometry/mesh_losses.py` on the closed 128-vertex
stand-in body, its vertices perturbed into a batch of two: every function
within 1e-5, and the gradients of `uniform_laplacian_smoothing` and
`edge_length_loss` within 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.geometry import mesh_losses as jml  # noqa: E402
from interdiff_torch.cli.common import synthetic_smpl_body  # noqa: E402
from interdiff_torch.geometry import mesh_losses as tml  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    body = synthetic_smpl_body(np.random.default_rng(30), device="cpu")
    rng = np.random.default_rng(31)
    base = body.v_template.numpy()
    verts = (base[None] + rng.standard_normal((2,) + base.shape) * 0.01
             ).astype(np.float32)
    gt = (base[None] + rng.standard_normal((2,) + base.shape) * 0.01
          ).astype(np.float32)
    return body.faces, verts, gt


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["uniform_laplacian_smoothing",
                                  "cotcurv_laplacian_norm", "laplacian_loss",
                                  "normal_consistency_loss"])
def test_single_mesh_losses_match_jax(mesh, name):
    faces, verts, _ = mesh
    want = getattr(jml, name)(jnp.asarray(verts), faces)
    got = getattr(tml, name)(torch.from_numpy(verts), faces)
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want)


@pytest.mark.parametrize("relative", [False, True])
def test_pair_losses_match_jax(mesh, relative):
    faces, verts, gt = mesh
    _close(tml.edge_length_loss(torch.from_numpy(verts), torch.from_numpy(gt),
                                faces, relative_length=relative),
           jml.edge_length_loss(jnp.asarray(verts), jnp.asarray(gt), faces,
                                relative_length=relative))
    _close(tml.normal_vector_loss(torch.from_numpy(verts),
                                  torch.from_numpy(gt), faces),
           jml.normal_vector_loss(jnp.asarray(verts), jnp.asarray(gt), faces))


def test_gradients_match_jax(mesh):
    faces, verts, gt = mesh

    def j_total(v):
        return (jml.uniform_laplacian_smoothing(v, faces).sum()
                + jml.edge_length_loss(v, jnp.asarray(gt), faces))

    want = jax.grad(j_total)(jnp.asarray(verts))
    v = torch.from_numpy(verts).requires_grad_(True)
    (tml.uniform_laplacian_smoothing(v, faces).sum()
     + tml.edge_length_loss(v, torch.from_numpy(gt), faces)).backward()
    _close(v.grad, want)
    assert float(v.grad.abs().max()) > 1e-3


def test_degenerate_meshes():
    """A flat square of two faces: one shared edge; a lone face: none."""
    square = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    v = np.array([[[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    assert float(tml.normal_consistency_loss(torch.from_numpy(v),
                                             square)) == 0.0
    lone = square[:1]
    assert float(tml.normal_consistency_loss(torch.from_numpy(v),
                                             lone)) == 0.0
    _close(tml.cotcurv_laplacian_norm(torch.from_numpy(v), square),
           jml.cotcurv_laplacian_norm(jnp.asarray(v), square))
