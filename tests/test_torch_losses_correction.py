"""The correction losses (`interdiff_torch/train/losses_correction.py`)
against `interdiff_tpu/train/losses_correction.py` on the CPU: every term of
both losses within 1e-5 and the SMPL loss's gradient with respect to the
predicted object pose against `jax.grad` within 1e-4 of its largest entry.

The geometry puts an object cloud across the surface of a ball of body
vertices with outward normals, so that both masks are populated: object
points inside the body (the penetration term) and labelled contact vertices
farther than 0.02 m from the object (the contact term).  The JAX side runs
its plain XLA nearest-neighbour sweeps (no TPU), the port its plain
versions of K3 and K4 with their `autograd.Function`s.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.train import losses_correction as jlc  # noqa: E402
from interdiff_torch.ops import signed_distance as tsd  # noqa: E402
from interdiff_torch.train import losses_correction as tlc  # noqa: E402

B, T, PAST, V, P = 2, 6, 3, 128, 64


def correction_geometry(seed, B=B, T=T, V=V, P=P):
    """(obj_pred [B,T,9], obj_gt [B,T,9], obj_points [B,P,3], human_verts
    [B,T,V,7]): a ball of radius 0.3 m with outward normals and random
    contact labels, and a cloud of radius 0.15 m whose predicted placement
    straddles the ball's surface."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((B, T, V, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    centre = rng.standard_normal((B, T, 1, 3)) * 0.02
    verts = centre + 0.3 * d
    label = (rng.random((B, T, V, 1)) < 0.4).astype(np.float64)
    human = np.concatenate([verts, d, label], -1).astype(np.float32)
    pts = rng.standard_normal((B, P, 3))
    pts *= 0.15 / np.linalg.norm(pts, axis=-1, keepdims=True).max()

    def pose(scale):
        rot6d = np.array([1, 0, 0, 0, 1, 0], np.float64) \
            + rng.standard_normal((B, T, 6)) * scale
        trans = np.array([0.3, 0.0, 0.0]) + rng.standard_normal((B, T, 3)) \
            * 0.05
        return np.concatenate([rot6d, trans], -1).astype(np.float32)

    return pose(0.2), pose(0.2), pts.astype(np.float32), human


@pytest.fixture(scope="module")
def geometry():
    return correction_geometry(0)


def test_masks_are_populated(geometry):
    """Both terms see work: penetrating object points and far contact
    vertices."""
    obj_pred, _, pts, human = geometry
    from interdiff_torch.geometry.rotations import rotation_6d_to_matrix

    op = torch.from_numpy(obj_pred)
    rot = rotation_6d_to_matrix(op[..., :6])
    placed = (torch.einsum("btij,bpj->btpi", rot, torch.from_numpy(pts))
              + op[..., None, 6:])
    hv = torch.from_numpy(human)
    sq, dot = tsd.signed_nearest(placed, hv[..., :3], hv[..., 3:6])
    inside = float((dot < 0).float().mean())
    h2o, _ = tsd.nearest_neighbor(hv[..., :3], placed)
    far_contact = float(((h2o.sqrt() > 0.02) & (hv[..., 6] > 0.5)).float()
                        .mean())
    assert 0.05 < inside < 0.95 and far_contact > 0.05


@pytest.mark.parametrize("epoch", [5.0, 25.0])
def test_smpl_losses_and_gradient_match_jax(geometry, epoch):
    obj_pred, obj_gt, pts, human = geometry

    def jloss(op):
        return jlc.correction_smpl_losses(
            op, jnp.asarray(obj_gt), past_len=PAST,
            obj_points=jnp.asarray(pts), human_verts=jnp.asarray(human),
            epoch=jnp.asarray(epoch, jnp.float32))

    (jtotal, jterms), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(obj_pred))
    op = torch.from_numpy(obj_pred).requires_grad_(True)
    total, terms = tlc.correction_smpl_losses(
        op, torch.from_numpy(obj_gt), past_len=PAST,
        obj_points=torch.from_numpy(pts), human_verts=torch.from_numpy(human),
        epoch=epoch)
    total.backward()
    assert terms.keys() == jterms.keys() and len(terms) == 10
    for k in terms:
        np.testing.assert_allclose(float(terms[k].detach()),
                                   float(jterms[k]), atol=1e-5, err_msg=k)
    assert all(float(terms[k].detach()) > 0
               for k in ("contact", "penetration"))
    np.testing.assert_allclose(float(total.detach()), float(jtotal), atol=1e-5)
    want = np.asarray(jgrad)
    scale = np.abs(want).max()
    np.testing.assert_allclose(op.grad.numpy(), want, atol=1e-4 * scale)
    # the translation's gradient carries the contact and penetration terms
    assert np.abs(want[..., 6:]).max() > 0


def test_annealing_matches_jax():
    w = tlc.CorrectionLossWeights()
    for epoch in (0, 3, 19.5, 20, 40):
        want = jnp.clip(jnp.asarray(epoch, jnp.float32) / w.second_stage,
                        0.0, 1.0) ** 2
        assert tlc.annealing(epoch, w) == np.float32(want)
    assert tlc.annealing(3, tlc.CorrectionLossWeights(
        use_annealing=False)) == 1.0


def test_skeleton_losses_match_jax():
    rng = np.random.default_rng(4)
    pred, gt = (rng.standard_normal((B, 8, 7)).astype(np.float32)
                for _ in range(2))
    jtotal, jterms = jlc.correction_skeleton_losses(
        jnp.asarray(pred), jnp.asarray(gt), past_len=4)
    total, terms = tlc.correction_skeleton_losses(
        torch.from_numpy(pred), torch.from_numpy(gt), past_len=4)
    assert terms.keys() == jterms.keys() and len(terms) == 8
    for k in terms:
        np.testing.assert_allclose(float(terms[k].detach()),
                                   float(jterms[k]), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), atol=1e-5)


def test_safe_sqrt_gradient_is_zero_at_zero():
    x = torch.tensor([0.0, 4.0], requires_grad=True)
    tsd.safe_sqrt(x).sum().backward()
    assert x.grad.tolist() == [0.0, 0.25]
