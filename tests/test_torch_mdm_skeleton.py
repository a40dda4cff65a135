"""`MDMSkeleton` of the port (`interdiff_torch/models/mdm_skeleton.py`)
against `interdiff_tpu`'s on the CPU: a small model (2 + 2 layers, width
32) with every flax leaf redrawn and moved over by the weight bridge, and
the full-width model with the trained `artifacts/skeleton_params`, restored
with orbax as in tests/test_artifacts.py.  Tolerance 1e-4 (module
forwards, PARITY.md row 6)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import SkeletonTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.models import mdm_skeleton as jmdm  # noqa: E402
from interdiff_torch.config import SkeletonTrackConfig  # noqa: E402
from interdiff_torch.models import mdm_skeleton as tmdm  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKEL = os.path.join(ROOT, "artifacts", "skeleton_params")
SMALL = dict(embedding_dim=32, num_heads=4, ff_size=32, num_layers=2)
B, T = 2, 20


def skeleton_inputs(rng, B=B, T=T):
    """A batch in the `collate_skeleton` layout, numpy float32: unit
    quaternions, one of them flipped in sign and one near 180 degrees."""
    quat = rng.standard_normal((B, T, 4))
    quat[0, 3] = [1.0, 1e-4, 0.0, 1e-4]  # xyzw: about pi about x
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    quat[1, 2] *= -1.0
    pose = np.concatenate([rng.standard_normal((B, T, 3)), quat], -1)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.standard_normal((B, T, 21, 3)), rng.standard_normal((B, T, 12, 3)),
        pose, rng.standard_normal((B, 12, 3))))


def redrawn(variables, seed):
    """Every leaf of a fresh flax tree redrawn (biases and LayerNorm
    scales would otherwise sit at 0 and 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(
            np.float32), jax.device_get(variables))


@pytest.fixture(scope="module")
def small():
    jmodel = JTrack(**SMALL).build_model()
    inputs = skeleton_inputs(np.random.default_rng(20))
    variables = redrawn(jax.jit(lambda *a: jmodel.init(
        jax.random.PRNGKey(0), *a, jnp.zeros((B,), jnp.int32),
        method=jmdm.MDMSkeleton.init_forward))(*inputs), 1)
    tmodel = SkeletonTrackConfig(**SMALL).build_model("cpu")
    state = flax_to_torch_state_dict(variables)
    assert len(state) == len(jax.tree.leaves(variables))
    tmodel.load_state_dict(state, strict=True)
    return jmodel, variables, tmodel, inputs


def test_rigid_keypoints_from_pose_matches_jax():
    body, obj, pose, zp = skeleton_inputs(np.random.default_rng(21))
    pose = pose.copy()
    pose[1, :, 3:] *= 1.7  # not unit: the rotation normalises by |q|^2
    want = np.asarray(jmdm.rigid_keypoints_from_pose(jnp.asarray(pose),
                                                     jnp.asarray(zp)))
    got = tmdm.rigid_keypoints_from_pose(torch.from_numpy(pose),
                                         torch.from_numpy(zp))
    assert got.shape == (B, T, 12, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("cond", ["memory", "none", "force_mask"])
def test_encode_and_denoise_match_jax(small, cond):
    jmodel, variables, tmodel, inputs = small
    mem_ref, gt_ref = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=jmdm.MDMSkeleton.encode))(variables,
                                                *map(jnp.asarray, inputs))
    with torch.no_grad():
        mem, gt = tmodel.encode(*map(torch.from_numpy, inputs))
    assert mem.shape == (B, 10, 32) and gt.shape == (B, T, 106)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gt_ref))
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_ref), atol=1e-4)

    x = np.asarray(gt_ref) + np.random.default_rng(22).standard_normal(
        (B, T, 106)).astype(np.float32)
    ts = np.array([999, 3], np.int32)
    zp = inputs[3]
    memory = None if cond == "none" else np.array(mem_ref)
    force = cond == "force_mask"
    want = np.asarray(jax.jit(
        lambda v, x, t, z, m: jmodel.apply(v, x, t, z, m, force_mask=force))(
            variables, x, ts, zp, memory))
    # outside `no_grad` the call records a graph: the trainer's path
    got = tmodel.denoise(torch.from_numpy(x), torch.from_numpy(ts),
                         torch.from_numpy(zp),
                         None if memory is None else torch.from_numpy(memory),
                         force_mask=force)
    assert got.requires_grad and got.shape == (B, T, 106)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)
    # the keypoint block is the rigid image of the predicted pose block
    got = got.detach()
    kp = tmdm.rigid_keypoints_from_pose(got[..., 99:], torch.from_numpy(zp))
    torch.testing.assert_close(got[..., 63:99], kp.reshape(B, T, 36),
                               atol=0, rtol=0)


def test_mask_cond(small):
    _, _, tmodel, _ = small
    cond = torch.ones((6, 10, 32))
    assert torch.equal(tmodel.mask_cond(cond, force_mask=True),
                       torch.zeros_like(cond))
    assert tmodel.mask_cond(cond, train=True) is cond  # cond_mask_prob 0
    masked = SkeletonTrackConfig(**SMALL, cond_mask_prob=0.5).build_model(
        "cpu")
    draws = [masked.mask_cond(cond, train=True,
                              generator=torch.Generator().manual_seed(s))
             for s in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1])  # the generator decides
    for d in draws:  # whole samples are zeroed or kept
        assert set(d.flatten(1).mean(1).tolist()) <= {0.0, 1.0}
    assert masked.mask_cond(cond) is cond  # inference never masks


def test_trained_artifact_matches_jax_full_width():
    if not os.path.isdir(SKEL):
        pytest.skip("artifacts/skeleton_params not present")
    import orbax.checkpoint as ocp

    jmodel = JTrack(future_len=10).build_model()
    inputs = skeleton_inputs(np.random.default_rng(23))
    template = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs),
        jnp.zeros((B,), jnp.int32), method=jmdm.MDMSkeleton.init_forward))
    variables = jax.device_get(
        ocp.StandardCheckpointer().restore(SKEL, target=template))
    tmodel = SkeletonTrackConfig(future_len=10).build_model("cpu")
    tmodel.load_state_dict(flax_to_torch_state_dict(variables), strict=True)

    ts = np.array([500, 17], np.int32)
    want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=jmdm.MDMSkeleton.init_forward))(variables, *inputs,
                                                      ts))
    with torch.no_grad():
        got = tmodel.init_forward(*map(torch.from_numpy, inputs),
                                  torch.from_numpy(ts))
    assert got.shape == (B, T, 106) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
