"""The fused set-abstraction scale of the port (`interdiff_torch/ops/sa.py`,
kernel K6's plain version on the CPU) against `interdiff_tpu/ops/pallas_sa.py`
with the Pallas kernel `_sa_pallas` run in interpret mode, on the same numpy
inputs and folded weights.  Both sides read the one shared `d2t`, so the
selection is the same bit for bit and the outputs agree within
rtol=2e-5, atol=1e-5, the numbers the interpreted kernel is held to against
the unfused JAX route (`tests/test_pallas_sa.py`).  Also: `folded_affine`,
the encoder's `INTERDIFF_FUSED_SA` route, and the kernel's gate."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import interdiff_tpu.ops.pallas_group as pg  # noqa: E402
from interdiff_tpu.models.pointnet import SAModuleMSG as JSAModule  # noqa: E402
from interdiff_tpu.models.pointnet import SharedMLP as JSharedMLP  # noqa: E402
from interdiff_tpu.ops import pallas_sa as jsa  # noqa: E402
from interdiff_tpu.ops.pointcloud import ball_query as j_ball_query  # noqa: E402
from interdiff_torch.models import pointnet as tpn  # noqa: E402
from interdiff_torch.ops import sa as tsa  # noqa: E402
from interdiff_torch.ops.group import pairwise_sqdist_t  # noqa: E402
from interdiff_torch.ops.pointcloud import ball_query  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

RTOL, ATOL = 2e-5, 1e-5


@pytest.fixture
def force_interpret():
    old = pg._FORCE_PALLAS_INTERPRET
    pg._FORCE_PALLAS_INTERPRET = True
    yield
    pg._FORCE_PALLAS_INTERPRET = old


def _params(rng, chans):
    return tuple((
        (rng.standard_normal((cin, cout)) * 0.3).astype(np.float32),
        (1.0 + 0.1 * rng.standard_normal(cout)).astype(np.float32),
        (0.1 * rng.standard_normal(cout)).astype(np.float32))
        for cin, cout in chans)


def _both(xyz, new_xyz, feats, params, radius, nsample):
    """(port's sa_plain through the wrapper, interpreted Pallas K6), both on
    the d2t that the port computed."""
    txyz, tnew = torch.from_numpy(xyz), torch.from_numpy(new_xyz)
    d2t = pairwise_sqdist_t(txyz, tnew)
    got = tsa.fused_sa_scale(
        txyz, tnew, None if feats is None else torch.from_numpy(feats),
        tuple(tuple(torch.from_numpy(t) for t in layer) for layer in params),
        radius, nsample, d2t).numpy()
    want = np.asarray(jsa.fused_sa_scale(
        jnp.asarray(xyz), jnp.asarray(new_xyz),
        None if feats is None else jnp.asarray(feats),
        tuple(tuple(jnp.asarray(t) for t in layer) for layer in params),
        radius, nsample, True, jnp.asarray(d2t.numpy())))
    return got, want, d2t


@pytest.mark.parametrize("radius,nsample", [(0.5, 4), (0.25, 8), (2.0, 4)])
def test_sa_plain_matches_interpreted_pallas(force_interpret, radius,
                                             nsample):
    rng = np.random.default_rng(0)
    B, N, M, F = 2, 64, 32, 1
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, F)).astype(np.float32)
    params = _params(rng, ((3 + F, 8), (8, 8), (8, 16)))
    got, want, d2t = _both(xyz, xyz[:, :M].copy(), feats, params, radius,
                           nsample)
    assert got.shape == (B, M, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the selection on the shared distances is the same bit for bit
    idx_t = ball_query(torch.from_numpy(xyz), torch.from_numpy(xyz[:, :M]),
                       radius, nsample, d2=d2t.transpose(1, 2)).numpy()
    idx_j = np.asarray(j_ball_query(
        jnp.asarray(xyz), jnp.asarray(xyz[:, :M]), radius, nsample,
        d2=jnp.asarray(d2t.numpy().transpose(0, 2, 1))))
    np.testing.assert_array_equal(idx_t, idx_j)


def test_zero_hit_rows(force_interpret):
    """Queries with no in-radius candidate take data row 0, recentered on
    the query: the chain sees data[0, :3] - new_xyz[m]."""
    rng = np.random.default_rng(1)
    B, N, M = 1, 32, 16
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    new_xyz = xyz[:, :M] + np.float32(100.0)
    feats = rng.standard_normal((B, N, 1)).astype(np.float32)
    params = _params(rng, ((4, 8), (8, 8)))
    got, want, d2t = _both(xyz, new_xyz, feats, params, 0.1, 4)
    assert not bool((d2t < 0.01).any())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    row0 = np.concatenate([xyz[0, 0] - new_xyz[0], np.broadcast_to(
        feats[0, 0], (M, 1))], -1)  # [M, 4]
    h = row0
    for w, a, b in params:
        h = np.maximum((h @ w) * a + b, 0.0)
    np.testing.assert_allclose(got[0], h, rtol=1e-4, atol=1e-5)


def test_no_features(force_interpret):
    rng = np.random.default_rng(2)
    B, N, M = 2, 48, 16
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    params = _params(rng, ((3, 8), (8, 8)))
    got, want, _ = _both(xyz, xyz[:, :M].copy(), None, params, 0.6, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_shared_d2t_changes_nothing():
    rng = np.random.default_rng(3)
    B, N, M = 2, 64, 32
    xyz = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32))
    feats = torch.from_numpy(
        rng.standard_normal((B, N, 1)).astype(np.float32))
    params = tuple(tuple(torch.from_numpy(t) for t in layer)
                   for layer in _params(rng, ((4, 8), (8, 16))))
    new_xyz = xyz[:, :M]
    a = tsa.fused_sa_scale(xyz, new_xyz, feats, params, 0.5, 4,
                           pairwise_sqdist_t(xyz, new_xyz))
    b = tsa.fused_sa_scale(xyz, new_xyz, feats, params, 0.5, 4)
    assert torch.equal(a, b)


def test_short_rows_repeat_the_first_hit():
    """A row with fewer hits than nsample repeats its first hit, which
    cannot move the maximum: the output equals that of an nsample cut to
    the row's hit count."""
    rng = np.random.default_rng(4)
    xyz = torch.from_numpy(rng.standard_normal((1, 40, 3)).astype(
        np.float32))
    params = tuple(tuple(torch.from_numpy(t) for t in layer)
                   for layer in _params(rng, ((3, 8), (8, 8))))
    new_xyz = xyz[:, :8]
    d2t = pairwise_sqdist_t(xyz, new_xyz)
    hits = int((d2t < 0.49).sum(dim=1).max())
    assert 1 <= int((d2t < 0.49).sum(dim=1).min()) and hits < 16
    wide = tsa.fused_sa_scale(xyz, new_xyz, None, params, 0.7, 16, d2t)
    tight = tsa.fused_sa_scale(xyz, new_xyz, None, params, 0.7, hits, d2t)
    assert torch.equal(wide, tight)


def _shared_mlp_pair(rng, c_in, channels):
    """A flax SharedMLP's variables with perturbed statistics, and the
    port's module loaded with them."""
    jmlp = JSharedMLP(channels)
    variables = jax.device_get(jmlp.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 1, 1, c_in))))
    stats = {bn: {"mean": (rng.standard_normal(v["mean"].shape) * 0.1
                           ).astype(np.float32),
                  "var": rng.uniform(0.5, 1.5, v["var"].shape).astype(
                      np.float32)}
             for bn, v in variables["batch_stats"].items()}
    variables = {"params": variables["params"], "batch_stats": stats}
    tmlp = tpn.SharedMLP(c_in, channels)
    tmlp.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    return jmlp, variables, tmlp


def test_folded_affine_matches_jax():
    rng = np.random.default_rng(5)
    jmlp, variables, tmlp = _shared_mlp_pair(rng, 4, (8, 8, 16))
    want = jmlp.apply(variables, method=lambda m: (
        m(jnp.zeros((1, 1, 1, 4))), jsa.folded_affine(m))[1])
    # part of the graph: the fused route trains through the fold
    got = tsa.folded_affine(tmlp)
    assert all(t.requires_grad for layer in got for t in layer)
    got = tuple(tuple(t.detach() for t in layer) for layer in got)
    assert len(got) == len(want) == 3
    for (w, a, b), (jw, ja, jb) in zip(got, want):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        # rsqrt may differ in the last bit between the frameworks
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-7)
    # the fold is the module's own arithmetic to rounding
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 4)).astype(
        np.float32))
    with torch.no_grad():
        h = x
        for w, a, b in got:
            h = torch.relu((h @ w) * a + b)
        torch.testing.assert_close(h, tmlp(x), rtol=RTOL, atol=ATOL)


def test_samodule_routes_fused_sa(force_interpret, monkeypatch):
    """`SAModuleMSG` with INTERDIFF_FUSED_SA set goes through
    `fused_sa_scale` per radius scale and agrees with the JAX module on the
    same route (interpreted K6) and with its own default route."""
    rng = np.random.default_rng(6)
    B, N = 2, 64
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, 1)).astype(np.float32)
    jmod = JSAModule(npoint=32, radii=(0.4, 0.8), nsamples=(4, 8),
                     mlps=((8, 8, 16), (8, 8, 16)))
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), xyz, feats))
    tmod = tpn.SAModuleMSG(1, npoint=32, radii=(0.4, 0.8), nsamples=(4, 8),
                           mlps=((8, 8, 16), (8, 8, 16)))
    tmod.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    txyz, tfeats = torch.from_numpy(xyz), torch.from_numpy(feats)

    calls = []
    real = tpn.fused_sa_scale
    monkeypatch.setattr(tpn, "fused_sa_scale", lambda *a, **k: (
        calls.append(a[4:6]), real(*a, **k))[1])
    monkeypatch.delenv("INTERDIFF_FUSED_SA", raising=False)
    with torch.no_grad():
        nx_default, f_default = tmod(txyz, tfeats)
    assert calls == []
    monkeypatch.setenv("INTERDIFF_FUSED_SA", "1")
    with torch.no_grad():
        nx_fused, f_fused = tmod(txyz, tfeats)
    assert calls == [(0.4, 4), (0.8, 8)]
    assert torch.equal(nx_default, nx_fused)
    torch.testing.assert_close(f_fused, f_default, rtol=RTOL, atol=ATOL)

    nx_ref, f_ref = jmod.apply(variables, xyz, feats)
    np.testing.assert_array_equal(nx_fused.numpy(), np.asarray(nx_ref))
    # each side computes its own distances here: 1e-4 as for the encoder
    np.testing.assert_allclose(f_fused.numpy(), np.asarray(f_ref),
                               rtol=1e-4, atol=1e-4)


def test_wide_stage_never_takes_the_fused_route(monkeypatch):
    """Stage 2 of the encoder (99 data channels) groups off the kernels
    whatever the variable says."""
    monkeypatch.setenv("INTERDIFF_FUSED_SA", "1")
    monkeypatch.setattr(tpn, "fused_sa_scale", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("fused route taken")))
    rng = np.random.default_rng(7)
    mod = tpn.SAModuleMSG(96, npoint=1, radii=(0.5,), nsamples=(4,),
                          mlps=((8, 8),))
    with torch.no_grad():
        _, out = mod(torch.from_numpy(rng.standard_normal((1, 16, 3)).astype(
            np.float32)), torch.from_numpy(rng.standard_normal(
                (1, 16, 96)).astype(np.float32)))
    assert out.shape == (1, 1, 8)


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 8, 9), torch.float32, "data channels"),
    ((1, 8, 2), torch.float32, "data channels"),
    ((1, 8, 4), torch.float64, "float32"),
    ((1, 8, 4), torch.float16, "float32"),
])
def test_gate_raises_outside_the_kernel(shape, dtype, match):
    """The gate that `sa_cuda` applies before it launches: float32 and at
    most 8 data channels.  A CUDA input outside it raises there; nothing
    groups off the kernel."""
    with pytest.raises(ValueError, match=match):
        tsa.check_gate(torch.zeros(shape, dtype=dtype))
    tsa.check_gate(torch.zeros((1, 8, 4)))
    tsa.check_gate(torch.zeros((1, 8, 8)))


def test_cuda_wrapper_refuses_cpu_tensors():
    """`sa_cuda` is the kernel's wrapper: it never computes on the CPU."""
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        tsa.sa_cuda(z((1, 8, 4)), z((1, 8, 4)), z((1, 4, 3)),
                    ((z((4, 8)), z(8), z(8)),), 0.5, 4)
