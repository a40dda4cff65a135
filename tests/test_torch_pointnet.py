"""PointNet++ encoder of the port (`interdiff_torch/models/pointnet.py`, with
stage 1 grouped by K1's plain version on the CPU) against the flax encoder
of `interdiff_tpu`, with bridged weights and perturbed BatchNorm running
statistics.  Both stage-1 routes of the main path are covered: P = 2048
(grouped FPS down to 1024 centers) and P = 1024 (npoint == N keeps every
point).  Tolerance 1e-4 (module forwards, PARITY.md row 6).

Each framework computes its own distances, and a 2048-point cloud always
holds pairs within 1e-6 of a radius squared; the test checks instead that
the two frameworks' stage-1 distances select the same pairs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.models.pointnet import PointNet2Encoder as JEnc  # noqa: E402
from interdiff_tpu.ops.pointcloud import pairwise_sqdist  # noqa: E402
from interdiff_torch.models.pointnet import PointNet2Encoder  # noqa: E402
from interdiff_torch.ops import pointcloud as tpc  # noqa: E402
from interdiff_torch.ops.group import pairwise_sqdist_t  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402


def _cloud(rng, points):
    """[1, 1, P, 4] xyz on an ellipsoid surface plus ||xyz||."""
    d = rng.standard_normal((1, points, 3))
    xyz = (d / np.linalg.norm(d, axis=-1, keepdims=True)
           * [0.3, 0.2, 0.25]).astype(np.float32)
    txyz = torch.from_numpy(xyz)
    centers = (txyz if points == 1024 else tpc.gather_points(
        txyz, tpc.hierarchical_fps(txyz, 1024, 16)))
    d2_j = np.asarray(pairwise_sqdist(jnp.asarray(centers.numpy()),
                                      jnp.asarray(xyz)))
    d2_t = pairwise_sqdist_t(txyz, centers).numpy().transpose(0, 2, 1)
    for r in (0.05, 0.1):
        r2 = np.float32(r * r)
        np.testing.assert_array_equal(d2_t < r2, d2_j < r2)
    pc = np.concatenate([xyz, np.linalg.norm(xyz, axis=-1, keepdims=True)],
                        -1)
    return pc[None]


def _perturb_stats(tree, rng):
    return {k: (_perturb_stats(v, rng) if isinstance(v, dict) else
                (np.abs(v) + rng.uniform(0.5, 1.5, v.shape) if k == "var"
                 else v + rng.standard_normal(v.shape) * 0.1)
                .astype(np.float32))
            for k, v in tree.items()}


@pytest.mark.parametrize("points,seed", [(2048, 1), (1024, 2)])
def test_encoder_matches_flax(points, seed):
    rng = np.random.default_rng(seed)
    pc = _cloud(rng, points)
    enc = JEnc(c_in=1, c_out=32)
    variables = jax.device_get(jax.jit(enc.init)(jax.random.PRNGKey(seed),
                                                 pc))
    variables = {"params": variables["params"],
                 "batch_stats": _perturb_stats(variables["batch_stats"], rng)}
    ref = np.asarray(jax.jit(enc.apply)(variables, pc))

    tenc = PointNet2Encoder(c_in=1, c_out=32)
    tenc.load_state_dict(
        flax_to_torch_state_dict(variables), strict=True)
    with torch.no_grad():
        got = tenc(torch.from_numpy(pc)).numpy()
    assert got.shape == (1, 1, 1, 32)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stage1_routes_by_width_not_dtype(monkeypatch, dtype):
    """Stage 1 (4 data channels) goes through K1's wrapper whatever the
    dtype, so a non-float32 CUDA cloud raises in the wrapper instead of
    grouping off the kernel; stage 2 (99 channels) takes plain
    `query_and_group`."""
    from interdiff_torch.models import pointnet as tpn

    calls = {"k1": 0, "plain": 0}
    k1, plain = tpn.fused_query_group, tpn.query_and_group

    def spy_k1(*args, **kwargs):
        calls["k1"] += 1
        return k1(*args, **kwargs)

    def spy_plain(*args, **kwargs):
        calls["plain"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tpn, "fused_query_group", spy_k1)
    monkeypatch.setattr(tpn, "query_and_group", spy_plain)
    rng = np.random.default_rng(5)
    pc = torch.from_numpy(rng.uniform(-0.2, 0.2, (1, 1, 1024, 4))).to(dtype)
    tenc = PointNet2Encoder(c_in=1, c_out=32).to(dtype)
    with torch.no_grad():
        out = tenc(pc)
    assert out.dtype == dtype and out.shape == (1, 1, 1, 32)
    assert calls == {"k1": 2, "plain": 2}
