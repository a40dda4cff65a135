"""Gradients of the port's kernel wrappers (`torch.autograd.Function`s around
K1, K3, K4 and K6; on the CPU their forward is the plain version) against
`jax.grad` through `interdiff_tpu`'s custom VJPs with the Pallas kernels run
in interpret mode, on the same numpy inputs and cotangents, within 1e-5.
Both sides select on one shared `d2t`.  Also the repairs that training
needed: `encode` / `denoise` record a graph, the samplers do not, and the
`INTERDIFF_FUSED_SA` route trains stage 1's conv and BatchNorm parameters.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import interdiff_tpu.ops.pallas_group as jpg  # noqa: E402
import interdiff_tpu.ops.pallas_nn as jpn  # noqa: E402
from interdiff_tpu.models.pointnet import SAModuleMSG as JSAModule  # noqa: E402
from interdiff_tpu.ops import pallas_sa as jsa  # noqa: E402
from interdiff_tpu.ops import signed_distance as jsd  # noqa: E402
from interdiff_torch.config import DiffusionConfig, SmplTrackConfig  # noqa: E402
from interdiff_torch.eval.smpl_short import SmplEvalConfig, make_sampler  # noqa: E402
from interdiff_torch.models import pointnet as tpn  # noqa: E402
from interdiff_torch.ops import group as tgroup  # noqa: E402
from interdiff_torch.ops import sa as tsa  # noqa: E402
from interdiff_torch.ops import signed_distance as tsd  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

TOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jpg, "_FORCE_PALLAS_INTERPRET", True)
    monkeypatch.setattr(jpn, "_FORCE_INTERPRET", True)


def _leaves(*arrays):
    return [None if a is None else torch.from_numpy(a).requires_grad_(True)
            for a in arrays]


def _cloud(seed, B=2, N=64, M=32, F=1):
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    new_xyz = (xyz[:, :M] + 0.01 * rng.standard_normal((B, M, 3))).astype(
        np.float32)
    new_xyz[:, -2:] += 50.0  # zero-hit rows
    feats = rng.standard_normal((B, N, F)).astype(np.float32) if F else None
    d2t = tgroup.pairwise_sqdist_t(torch.from_numpy(xyz),
                                   torch.from_numpy(new_xyz)).numpy()
    return rng, xyz, new_xyz, feats, d2t


@pytest.mark.parametrize("with_features", [True, False])
def test_k1_gradient_matches_jax(interpret, with_features):
    """Short rows, zero-hit rows and full rows; the replay selects on the
    forward's own d2t and scatter-adds through `gather_rows`."""
    rng, xyz, new_xyz, feats, d2t = _cloud(0, F=1 if with_features else 0)
    radius, S = 0.7, 8
    hits = (d2t < radius * radius).sum(axis=1)
    assert (hits == 0).any() and ((hits > 0) & (hits < S)).any() \
        and (hits >= S).any()
    ct = rng.standard_normal((2, 32, S, 3 + with_features)).astype(
        np.float32)

    def jloss(x, nx, f):
        return jnp.sum(jpg.fused_query_group(x, nx, f, radius, S, True,
                                             jnp.asarray(d2t)) * ct)

    argnums = (0, 1, 2) if with_features else (0, 1)
    want = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(xyz), jnp.asarray(new_xyz),
        None if feats is None else jnp.asarray(feats))
    leaves = _leaves(xyz, new_xyz, feats)
    out = tgroup.fused_query_group(*leaves, radius, S,
                                   torch.from_numpy(d2t))
    out.backward(torch.from_numpy(ct))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)
    # no input asks for a gradient (every train step): no backward is built
    plain = tgroup.fused_query_group(
        torch.from_numpy(xyz), torch.from_numpy(new_xyz),
        None if feats is None else torch.from_numpy(feats), radius, S,
        torch.from_numpy(d2t))
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_k1_backward_replays_on_the_saved_distances():
    """A d2t that disagrees with the points' own distances (here: shifted so
    that other candidates are in radius) must steer the backward as it
    steered the forward."""
    rng, xyz, new_xyz, feats, d2t = _cloud(1)
    d2t = np.roll(d2t, 5, axis=1)
    ct = rng.standard_normal((2, 32, 8, 4)).astype(np.float32)
    a, b = _leaves(xyz, new_xyz, feats), _leaves(xyz, new_xyz, feats)
    tgroup.fused_query_group(*a, 0.7, 8, torch.from_numpy(d2t)).backward(
        torch.from_numpy(ct))
    tgroup.group_plain(torch.from_numpy(d2t), torch.cat([b[0], b[2]], -1),
                       b[1], 0.7, 8).backward(torch.from_numpy(ct))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=1e-6)
    c = _leaves(xyz, new_xyz, feats)
    tgroup.fused_query_group(*c, 0.7, 8).backward(torch.from_numpy(ct))
    assert float((c[0].grad - a[0].grad).abs().max()) > 1e-3


def test_k6_gradient_matches_jax(interpret):
    """With respect to the folded weights and to xyz, new_xyz and the
    features; the maximum over neighbours splits its cotangent evenly over
    tied slots on both sides (short rows repeat a slot)."""
    rng, xyz, new_xyz, feats, d2t = _cloud(2)
    radius, S = 0.7, 8
    params = tuple((
        (rng.standard_normal((cin, cout)) * 0.4).astype(np.float32),
        (1.0 + 0.1 * rng.standard_normal(cout)).astype(np.float32),
        (0.1 * rng.standard_normal(cout)).astype(np.float32))
        for cin, cout in ((4, 8), (8, 8), (8, 16)))
    ct = rng.standard_normal((2, 32, 16)).astype(np.float32)

    def jloss(x, nx, f, p):
        return jnp.sum(jsa.fused_sa_scale(x, nx, f, p, radius, S, True,
                                          jnp.asarray(d2t)) * ct)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(feats),
        tuple(tuple(jnp.asarray(t) for t in layer) for layer in params))
    inputs = _leaves(xyz, new_xyz, feats)
    tparams = tuple(tuple(_leaves(*layer)) for layer in params)
    out = tsa.fused_sa_scale(*inputs, tparams, radius, S,
                             torch.from_numpy(d2t))
    assert type(out.grad_fn).__name__.startswith("_FusedSaScale")
    out.backward(torch.from_numpy(ct))
    for leaf, w in zip(inputs, want[:3]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)
    for layer, jlayer in zip(tparams, want[3]):
        for leaf, w in zip(layer, jlayer):
            assert float(np.abs(np.asarray(w)).max()) > 0
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                       atol=TOL, rtol=TOL)


def test_k6_keeps_the_grouped_tensor_only_under_a_gradient():
    rng, xyz, new_xyz, feats, d2t = _cloud(3)
    params = ((torch.randn(4, 8), torch.ones(8), torch.zeros(8)),)
    args = (torch.from_numpy(xyz), torch.from_numpy(new_xyz),
            torch.from_numpy(feats))
    calls = []
    real = tsa.sa_plain

    def recording(*a, **k):
        calls.append(a[-1] if isinstance(a[-1], bool) else
                     k.get("with_grouped", False))
        return real(*a, **k)

    tsa.sa_plain = recording
    try:
        out = tsa.fused_sa_scale(*args, params, 0.7, 8)
        assert out.grad_fn is None
        w = params[0][0].clone().requires_grad_(True)
        with torch.no_grad():
            tsa.fused_sa_scale(*args, ((w,) + params[0][1:],), 0.7, 8)
        kept = tsa.fused_sa_scale(*args, ((w,) + params[0][1:],), 0.7, 8)
    finally:
        tsa.sa_plain = real
    assert calls == [False, False, True]
    assert torch.equal(kept.detach(), out)
    feats_out, grouped = real(
        tgroup.pairwise_sqdist_t(args[0], args[1]),
        torch.cat([args[0], args[2]], -1), args[1], params, 0.7, 8,
        with_grouped=True)
    assert torch.equal(feats_out, out)
    assert torch.equal(grouped, tgroup.fused_query_group(*args, 0.7, 8))
    del rng, d2t


def test_k3_gradient_matches_jax(interpret):
    rng = np.random.default_rng(4)
    a, b, n = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 40, 3), (2, 24, 3), (2, 24, 3)))

    def jloss(a, b, n):
        d, s = jpn.signed_nearest_pallas_diff(a, b, n)
        return jnp.sum(jnp.sin(d) + jnp.cos(s))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (a, b, n)))
    leaves = _leaves(a, b, n)
    d, s = tsd.signed_nearest(*leaves)
    (torch.sin(d) + torch.cos(s)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


def test_k4_gradient_matches_jax(interpret):
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal(s).astype(np.float32)
            for s in ((2, 40, 3), (2, 24, 3)))

    def jloss(a, b):
        return jnp.sum(jnp.sin(jpn.nearest_neighbor_pallas_diff(a, b)[0]))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    leaves = _leaves(a, b)
    d, idx = tsd.nearest_neighbor(*leaves)
    assert not idx.requires_grad
    torch.sin(d).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


def test_point2point_signed_gradient_matches_jax():
    """Broadcast surface cloud, leading batch dims, both normals."""
    rng = np.random.default_rng(6)
    x, y, xn, yn = (rng.standard_normal(s).astype(np.float32)
                    for s in ((2, 3, 30, 3), (2, 3, 20, 3), (2, 3, 30, 3),
                              (2, 3, 20, 3)))

    def jloss(x, y, xn, yn):
        y2x, x2y, _, _ = jsd.point2point_signed(x, y, xn, yn)
        return jnp.sum(jnp.sin(y2x)) + jnp.sum(jnp.cos(x2y))

    want = jax.grad(jloss, argnums=(0, 1))(*map(jnp.asarray, (x, y, xn, yn)))
    leaves = _leaves(x, y)
    y2x, x2y, _, _ = tsd.point2point_signed(
        *leaves, torch.from_numpy(xn), torch.from_numpy(yn))
    (torch.sin(y2x).sum() + torch.cos(x2y).sum()).backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


def test_pruned_sweep_has_no_gradient():
    rng = np.random.default_rng(7)
    a, b, n = _leaves(*(rng.standard_normal(s).astype(np.float32) * 0.1
                        for s in ((1, 8, 3), (1, 12, 3), (1, 12, 3))))
    d, s = tsd.signed_nearest_pruned(a.detach(), b.detach(), n.detach())
    assert d.grad_fn is None and s.grad_fn is None


# -- the repairs ---------------------------------------------------------------

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)


def test_encode_and_denoise_record_a_graph_and_samplers_do_not():
    """A loss through `encode` and `denoise` reaches the PointNet++ encoder
    (its BatchNorm statistics included), the transformer encoder and the
    denoiser; `make_sampler` outside any `no_grad` records nothing."""
    rng = np.random.default_rng(8)
    track = SmplTrackConfig(**SMALL,
                            diffusion=DiffusionConfig(timestep_respacing="3"))
    model = track.build_model("cpu")
    gt = torch.from_numpy(rng.standard_normal((2, 35, 144)).astype(
        np.float32))
    pts = torch.from_numpy(rng.uniform(-0.12, 0.12, (2, 64, 6)).astype(
        np.float32))
    memory = model.encode(gt, pts)
    assert memory.requires_grad
    out = model.denoise(gt, torch.tensor([3, 700]), memory)
    assert out.requires_grad
    out.square().mean().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for name in ("pcEmbedding.sa0.mlp0.conv0.weight",
                 "pcEmbedding.sa0.mlp1.bn2.running_var",
                 "pcEmbedding.sa1.mlp0.bn0.running_mean",
                 "pcEmbedding.Linear.weight", "bodyEmbedding.weight",
                 "encoder.layer_1.queries", "decoder.layer_0.ff.linear1.bias",
                 "decoder.layer_2.multihead_attn.in_proj_kernel",
                 "embedTimeStep.fc1.weight", "objFinalLinear.bias"):
        assert grads[name] is not None, name
        assert float(grads[name].abs().max()) > 0, name

    cfg = SmplEvalConfig()
    zeros = torch.zeros((2, 35, 90)), torch.zeros((2, 35, 10))
    x = make_sampler(cfg, model, track.diffusion.build("cpu"))(
        gt, pts, *zeros, generator=torch.Generator().manual_seed(0))
    assert not x.requires_grad and x.grad_fn is None
    run = make_sampler(cfg, model, track.diffusion.build("cpu"),
                       reuse_memory=True)
    x = run(gt, pts, *zeros, memory,
            generator=torch.Generator().manual_seed(0))
    assert not x.requires_grad


def test_fused_route_trains_stage_one(interpret, monkeypatch):
    """With INTERDIFF_FUSED_SA set, the conv weights and all four BatchNorm
    tensors of every scale get the gradients the JAX module gives them."""
    monkeypatch.setenv("INTERDIFF_FUSED_SA", "1")
    rng = np.random.default_rng(9)
    B, N = 2, 64
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, 1)).astype(np.float32)
    kw = dict(npoint=32, radii=(0.4, 0.8), nsamples=(4, 8),
              mlps=((8, 8, 16), (8, 8, 16)))
    jmod = JSAModule(**kw)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), xyz, feats))
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: (v + 0.2 * rng.standard_normal(v.shape)).astype(
            np.float32), variables["batch_stats"])}
    ct = rng.standard_normal((B, 32, 32)).astype(np.float32)
    tmod = tpn.SAModuleMSG(1, **kw)
    tmod.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    # both sides on one d2t: the JAX module computes its own, so hand it
    # the port's through the one function both call
    d2t = {}
    real = tpn.pairwise_sqdist_t
    monkeypatch.setattr(tpn, "pairwise_sqdist_t", lambda x, nx: d2t.setdefault(
        "t", real(x, nx)))
    calls = []
    real_fused = tpn.fused_sa_scale
    monkeypatch.setattr(tpn, "fused_sa_scale", lambda *a, **k: (
        calls.append(1), real_fused(*a, **k))[1])
    _, out = tmod(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert len(calls) == 2
    out.backward(torch.from_numpy(ct))
    monkeypatch.setattr(jpg, "pairwise_sqdist_t",
                        lambda x, nx: jnp.asarray(d2t["t"].numpy()))
    want = flax_to_torch_state_dict(jax.device_get(jax.grad(
        lambda v: jnp.sum(jmod.apply(v, xyz, feats)[1] * ct))(variables)))
    got = {n: p.grad for n, p in tmod.named_parameters()}
    assert set(got) == set(want) and len(got) == 30
    for name, w in want.items():
        assert got[name] is not None, name
        assert float(w.abs().max()) > 0, name
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=TOL,
                                   rtol=1e-4, err_msg=name)
    # batch statistics: the fused route folds the running ones, so it is off
    calls.clear()
    tmod(torch.from_numpy(xyz), torch.from_numpy(feats), train=True)
    assert calls == []
