"""Full-width `MDMSmpl` of the port (256 wide, 4 heads, ff 1024, 8 + 8
layers, PointNet++ encoder) against `interdiff_tpu` with the trained
`artifacts/smpl_real_params`, restored with orbax as in
tests/test_artifacts.py and moved over by the weight bridge.  Tolerance
1e-4 (module forwards, PARITY.md row 6).

Each framework computes its own point distances, so an in-radius pair on
the border could flip; the cloud is checked to hold no pair within 1e-6 of
any ball-query radius squared."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_tpu.models.mdm_smpl import smpl_gt_from_raw as j_gt  # noqa: E402
from interdiff_torch.config import SmplTrackConfig  # noqa: E402
from interdiff_torch.models.mdm_smpl import smpl_gt_from_raw  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMPL_REAL = os.path.join(ROOT, "artifacts", "smpl_real_params")
RADII = (0.05, 0.1, 0.2)
B, T, P = 2, 35, 64


def _inputs():
    rng = np.random.default_rng(35)
    pose = (rng.standard_normal((B, T, 66)) * 0.4).astype(np.float32)
    trans = rng.standard_normal((B, T, 3)).astype(np.float32)
    obj_aa = rng.standard_normal((B, T, 3)).astype(np.float32)
    obj_t = rng.standard_normal((B, T, 3)).astype(np.float32)
    pts = rng.uniform(-0.12, 0.12, (B, P, 6)).astype(np.float32)
    xyz = pts[..., :3].astype(np.float64)
    d2 = ((xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    for r in RADII:
        assert np.abs(d2 - np.float32(r * r)).min() > 1e-6
    return (pose, trans, obj_aa, obj_t), pts


@pytest.fixture(scope="module")
def models():
    if not os.path.isdir(SMPL_REAL):
        pytest.skip("artifacts/smpl_real_params not present")
    import orbax.checkpoint as ocp

    jmodel = JTrack().build_model()
    template = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((B, T, 144)), jnp.zeros((B, P, 6)),
        jnp.zeros((B,), jnp.int32), method=JMDM.init_forward))
    variables = ocp.StandardCheckpointer().restore(SMPL_REAL,
                                                   target=template)
    variables = jax.device_get(variables)
    tmodel = SmplTrackConfig().build_model(device="cpu")
    tmodel.load_state_dict(
        flax_to_torch_state_dict(variables), strict=True)
    return jmodel, variables, tmodel


def test_bridge_consumes_every_leaf(models):
    _, variables, tmodel = models
    n_leaves = len(jax.tree.leaves(variables))
    state = flax_to_torch_state_dict(variables)
    assert len(state) == n_leaves == len(tmodel.state_dict())
    assert set(state) == set(tmodel.state_dict())


def test_encode_and_denoise_match_full_width(models):
    jmodel, variables, tmodel = models
    raw, pts = _inputs()
    gt_j = j_gt(*map(jnp.asarray, raw))
    gt_t = smpl_gt_from_raw(*map(torch.from_numpy, raw))
    np.testing.assert_allclose(gt_t.numpy(), np.asarray(gt_j), atol=1e-6)
    gt = np.array(gt_j)

    encode = jax.jit(lambda v, g, p: jmodel.apply(v, g, p,
                                                  method=JMDM.encode))
    mem_ref = np.array(encode(variables, gt, pts))
    with torch.no_grad():
        mem = tmodel.encode(torch.from_numpy(gt), torch.from_numpy(pts))
    assert mem.shape == (B, 10, 256)
    np.testing.assert_allclose(mem.numpy(), mem_ref, atol=1e-4, rtol=1e-4)

    ts = np.array([999, 3], np.int32)
    x0_ref = np.asarray(jax.jit(jmodel.apply)(variables, gt, ts, mem_ref))
    # outside `no_grad` the call records a graph: the trainer's path
    x0 = tmodel.denoise(torch.from_numpy(gt), torch.from_numpy(ts),
                        torch.from_numpy(mem_ref))
    assert x0.requires_grad
    np.testing.assert_allclose(x0.detach().numpy(), x0_ref, atol=1e-4,
                               rtol=1e-4)
