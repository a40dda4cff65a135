"""The SMPL diffusion train step of the port
(`interdiff_torch/train/trainer.py::make_smpl_train_step`) against
`interdiff_tpu/train/trainer.py::make_smpl_train_step` itself, small model
(3 + 3 layers, d=32), on the CPU: the same flax-initialised weights moved
over by the weight bridge, the same numpy batches, timesteps and noise.

JAX draws its timesteps and noise from a key that PyTorch cannot reproduce,
so the JAX step's three draws (`sample_timesteps`, the resampler's `sample`,
`jax.random.normal`) are patched to hand back the test's own arrays; the
step function is otherwise the package's.  Its gradients are read from the
state of a pass-through optax stage chained before AdamW.

Tolerances: loss and metrics 1e-5; every gradient tensor within 1e-4 of its
largest entry plus 1e-6 (1e-5 on the fused route, whose forward sums in
another order).  Under
``bn_train_mode`` the metrics are held to 1e-4 and the gradients to 3e-2
(measured 8.1e-3):
flax's variance E[x^2] - E[x]^2 cancels in float32 and rsqrt(var + 1e-5)
amplifies that, and at this batch size (32 samples behind a stage-2
statistic) either package's float32 step lies that far from a float64 run
of the same step (loss terms 1.9e-5 and 5.0e-5 off, gradients up to 3.5e-3
and 1.1e-2 of their largest entry, the port the nearer of the two each
time; the test runs the port's step in float64 and prints both); after
Adam's first
step, which moves a weight by lr times the sign of its gradient however
small, the later steps' metrics are held to 1e-4 (measured 1e-5), and to
1e-3 under ``bn_train_mode``.  Parameters
after three AdamW steps: Adam turns a gradient that is rounding noise into a
step of up to lr, so every entry within 2 * steps * lr, the mean difference
within lr / 100, and entries with an exactly zero gradient unmoved on both
sides.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

torch = pytest.importorskip("torch")

import interdiff_tpu.ops.pallas_group as jpg  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.diffusion.resample import (  # noqa: E402
    LossSecondMomentResampler as JResampler,
)
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_tpu.train import trainer as jtr  # noqa: E402
from interdiff_torch.config import SmplTrackConfig  # noqa: E402
from interdiff_torch.diffusion.resample import LossSecondMomentResampler  # noqa: E402
from interdiff_torch.train import trainer as ttr  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
B, T, P, STEPS, LR = 2, 35, 64, 3, 3e-4
RADII = (0.05, 0.1, 0.2)
KEYS = ("body_pose", "body_trans", "obj_angles", "obj_trans", "obj_points")


def _batches(rng, n):
    out = []
    for _ in range(n):
        margin = 0.0
        while margin <= 1e-6:  # no pair on a radius: each side has its own d2
            pts = rng.uniform(-0.12, 0.12, (B, P, 6)).astype(np.float32)
            xyz = pts[..., :3].astype(np.float64)
            d2 = ((xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
            margin = min(np.abs(d2 - np.float32(r * r)).min() for r in RADII)
        out.append({
            "body_pose": (rng.standard_normal((B, T, 156)) * 0.3).astype(
                np.float32),
            "body_trans": rng.standard_normal((B, T, 3)).astype(np.float32),
            "obj_angles": rng.standard_normal((B, T, 3)).astype(np.float32),
            "obj_trans": rng.standard_normal((B, T, 3)).astype(np.float32),
            "obj_points": pts})
    return out


def _draws(rng, n, repeat_t=False):
    t = rng.integers(0, 1000, (n, B)).astype(np.int32)
    if repeat_t:
        t[:, 1] = t[:, 0]  # two equal t in a batch
    return t, rng.standard_normal((n, B, T, 144)).astype(np.float32)


def _capture_grads():
    """Pass-through optax stage whose state is the last gradient tree."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


class _Pair:
    """The JAX step (jitted, with its draws patched) and the port's step on
    the same initial weights."""

    def __init__(self, monkeypatch, *, bn_train_mode=False, loss_aware=False,
                 ema_rate=0.0, fused=False, seed=0):
        if fused:
            monkeypatch.setenv("INTERDIFF_FUSED_SA", "1")
            monkeypatch.setattr(jpg, "_FORCE_PALLAS_INTERPRET", True)
        else:
            monkeypatch.delenv("INTERDIFF_FUSED_SA", raising=False)
        self.bn_train_mode = bn_train_mode
        rng = np.random.default_rng(seed)
        jtrack = JTrack(**SMALL)
        jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()
        variables = jax.device_get(jmodel.init(
            jax.random.PRNGKey(1), jnp.zeros((B, T, 144)),
            jnp.zeros((B, P, 6)), jnp.zeros((B,), jnp.int32),
            method=JMDM.init_forward))
        variables = {"params": variables["params"], "batch_stats": {
            "pcEmbedding": jax.tree.map(
                lambda v: (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32), variables["batch_stats"]["pcEmbedding"])}}
        self.variables = variables

        # -- JAX side
        holder = {}
        monkeypatch.setattr(jtr, "sample_timesteps", lambda key, b, n: (
            holder["t"], jnp.ones((b,), jnp.float32)))
        real_normal = jax.random.normal
        # flax evaluates its initialisers' shapes through the same function
        monkeypatch.setattr(
            jax.random, "normal", lambda key, shape, *a, **k: (
                holder["noise"] if tuple(shape) == (B, T, 144)
                else real_normal(key, shape, *a, **k)))
        jsampler, jsampler_state = "uniform", None
        if loss_aware:
            jsampler = JResampler(jdiff.num_timesteps, history_per_term=2)
            jsampler_state = jsampler.init_state()
            monkeypatch.setattr(jsampler, "sample", lambda key, b, state: (
                holder["t"], (1.0 / (jdiff.num_timesteps * jsampler.weights(
                    state)[holder["t"]])).astype(jnp.float32)),
                raising=False)
        jparams, jms = variables, None
        if bn_train_mode:
            jparams, jms = jtr.split_bn_state(variables)
        self.jstate = jtr.TrainState.create(
            jparams, optax.chain(_capture_grads(), jtr.adamw(LR)),
            sampler_state=jsampler_state, ema_rate=ema_rate, model_state=jms)
        jstep = jtr.make_smpl_train_step(jmodel, jdiff,
                                         schedule_sampler=jsampler,
                                         bn_train_mode=bn_train_mode)

        def with_draws(state, batch, t, noise):
            holder.update(t=t, noise=noise)
            return jstep(state, batch, jax.random.PRNGKey(0))

        self.jstep = jax.jit(with_draws)

        # -- the port
        track = SmplTrackConfig(**SMALL)
        self.model = track.build_model("cpu")
        self.model.load_state_dict(flax_to_torch_state_dict(variables),
                                   strict=True)
        tsampler, tsampler_state = "uniform", None
        if loss_aware:
            tsampler = LossSecondMomentResampler(1000, history_per_term=2)
            tsampler_state = tsampler.init_state()
        if bn_train_mode:
            params, ms = ttr.split_bn_state(self.model)
        else:
            params, ms = dict(self.model.named_parameters()), None
        self.tstate = ttr.TrainState.create(
            params, ttr.adamw(LR), sampler_state=tsampler_state,
            ema_rate=ema_rate, model_state=ms)
        self.tstep = ttr.make_smpl_train_step(
            self.model, track.diffusion.build("cpu"),
            schedule_sampler=tsampler, bn_train_mode=bn_train_mode)

    def step(self, batch, t, noise):
        """One step on both sides -> (JAX metrics, port metrics)."""
        self.jstate, jm = self.jstep(
            self.jstate, {k: jnp.asarray(batch[k]) for k in KEYS},
            jnp.asarray(t), jnp.asarray(noise))
        self.tstate, tm = self.tstep(
            self.tstate, {k: torch.from_numpy(batch[k]) for k in KEYS},
            t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
        return jm, tm

    def jax_weights(self, tree=None):
        """A JAX parameter tree (the state's by default) as a state dict,
        with the BatchNorm statistics merged in under bn_train_mode."""
        tree = self.jstate.params if tree is None else tree
        return flax_to_torch_state_dict(jax.device_get(
            jtr.merge_bn_state(tree, self.jstate.model_state)))

    def jax_grads(self):
        return flax_to_torch_state_dict(
            jax.device_get(self.jstate.opt_state[0]))


def _assert_metrics(jm, tm, tol=1e-5):
    assert set(jm) == set(tm) and len(tm) == 16 + 1 + 4
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=tol,
                                   rtol=tol, err_msg=k)


def _assert_grads(pair, atol=1e-6, rtol=1e-4):
    want = pair.jax_grads()
    named = dict(pair.model.named_parameters())
    assert set(want) == set(pair.tstate.params)
    checked = 0
    for name, w in want.items():
        g = named[name].grad
        # no path to the loss: exact zeros in JAX, none or zeros here, so
        # AdamW moves such a tensor on neither side
        if g is None or not bool(w.any()):
            assert not bool(w.any()) and (g is None or not bool(g.any())), \
                name
            continue
        err = float((g - w).abs().max())
        assert err <= rtol * float(w.abs().max()) + atol, (name, err)
        checked += 1
    assert checked > 100
    return want


def _assert_weights(got, want, start, steps, moved_min=LR):
    moved_most, diffs = 0.0, []
    for name, w in want.items():
        d = (got[name] - w).abs()
        assert float(d.max()) <= 2 * steps * LR, (name, float(d.max()))
        diffs.append(d.flatten())
        moved_most = max(moved_most, float((w - start[name]).abs().max()))
    assert float(torch.cat(diffs).mean()) < LR / 100
    assert moved_most > moved_min  # the steps did move the weights


def _float64_step(model, batch, t, noise):
    """One step's metrics and gradients of the port in float64, on a copy
    of ``model`` (bn_train_mode): the yardstick for float32's own error."""
    import copy

    from interdiff_torch.train.losses import smpl_diffusion_losses

    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():
        if hasattr(mod, "pe"):
            mod.pe = mod.pe.double()
    diffusion = SmplTrackConfig(**SMALL).diffusion.build("cpu")
    for name, value in vars(diffusion).items():
        if isinstance(value, torch.Tensor) and value.is_floating_point():
            setattr(diffusion, name, value.double())
    gt, pts = ttr.smpl_cond_inputs(
        {k: torch.from_numpy(batch[k]).double() for k in KEYS})
    memory = m64.encode(gt, pts, train_encoder=True)
    pred, target = diffusion.training_losses(
        lambda x, ts: m64.denoise(x, ts, memory), gt,
        torch.from_numpy(t).long(), noise=torch.from_numpy(noise).double())
    per_sample, terms = smpl_diffusion_losses(pred, target, past_len=10)
    per_sample.mean().backward()
    return ({k: float(v.detach().mean()) for k, v in terms.items()},
            {n: p.grad for n, p in m64.named_parameters()
             if p.grad is not None})


CASES = {
    "default_ema": dict(ema_rate=0.9),
    "bn_train_mode": dict(bn_train_mode=True, ema_rate=0.9),
    "loss_second_moment": dict(loss_aware=True),
    "fused_route": dict(fused=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(monkeypatch, case):
    """One step: loss, every metric and every gradient.  Three steps:
    parameters, BatchNorm statistics, EMA shadow and resampler state."""
    opts = CASES[case]
    pair = _Pair(monkeypatch, **opts)
    rng = np.random.default_rng(10)
    batches = _batches(rng, STEPS)
    ts, noises = _draws(rng, STEPS, repeat_t=opts.get("loss_aware", False))
    start = pair.jax_weights()

    wide = 10 if opts.get("bn_train_mode") else 1
    if wide > 1:
        terms64, grads64 = _float64_step(pair.model, batches[0], ts[0],
                                         noises[0])
    jm, tm = pair.step(batches[0], ts[0], noises[0])
    _assert_metrics(jm, tm, 1e-5 * wide)
    grads = _assert_grads(pair, atol=(1e-5 if opts.get("fused") else 1e-6)
                          * wide, rtol=3e-2 if wide > 1 else 1e-4)
    stats = [n for n in grads if n.endswith(("running_mean", "running_var"))]
    if opts.get("bn_train_mode"):
        # out of the optimiser: no gradient, moved by momentum
        assert not stats and set(pair.tstate.model_state) == {
            n for n in start if n.endswith(("running_mean", "running_var"))}
        # float32's own error in this mode, against the float64 step (the
        # JAX package's is printed beside it: it is why this case is wide)
        named = dict(pair.model.named_parameters())
        off = {"port": 0.0, "jax": 0.0}
        for k, v in terms64.items():
            off["port"] = max(off["port"], abs(float(tm[k]) - v))
            off["jax"] = max(off["jax"], abs(float(jm[k]) - v))
        goff = {"port": 0.0, "jax": 0.0}
        for n, g64 in grads64.items():
            if n in grads and float(g64.abs().max()) > 0:
                scale = float(g64.abs().max())
                goff["port"] = max(goff["port"], float(
                    (named[n].grad - g64).abs().max()) / scale)
                goff["jax"] = max(goff["jax"], float(
                    (grads[n] - g64).abs().max()) / scale)
        print(f"bn_train_mode, float32 against float64: loss terms {off}, "
              f"gradients (of each tensor's largest entry) {goff}")
        assert off["port"] < 1e-4 and goff["port"] < 2e-2
        # the first step's statistics come from one forward on equal weights
        want = pair.jax_weights()
        for n, v in pair.tstate.model_state.items():
            np.testing.assert_allclose(v.numpy(), want[n].numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=n)
            assert float((want[n] - start[n]).abs().max()) > 1e-3, n
    else:
        # inside the optimised tree: differentiated and stepped
        assert len(stats) == 24
        assert all(float(grads[n].abs().max()) > 0 for n in stats)

    for i in range(1, STEPS):
        jm, tm = pair.step(batches[i], ts[i], noises[i])
        _assert_metrics(jm, tm, 1e-3 if wide > 1 else 1e-4)
    assert pair.tstate.step == int(pair.jstate.step) == STEPS

    want = pair.jax_weights()
    got = pair.model.state_dict()
    _assert_weights(got, want, start, STEPS)
    for n in want:
        if n.endswith(("running_mean", "running_var")):
            moved = float((want[n] - start[n]).abs().max())
            if opts.get("bn_train_mode"):
                assert moved > 1e-3, n  # by momentum, far beyond Adam's lr
            else:
                assert 0 < moved <= STEPS * LR * 1.01, n  # Adam-sized steps
    if opts.get("ema_rate"):
        shadow = pair.jax_weights(pair.jstate.ema_params)
        ema = ttr.merge_bn_state(pair.tstate.ema_params,
                                 pair.tstate.model_state)
        assert set(ema) == set(shadow)
        _assert_weights(ema, shadow, start, STEPS, moved_min=LR / 10)
        name = "bodyFinalLinear.weight"
        assert pair.tstate.ema_params[name].data_ptr() != \
            pair.tstate.params[name].data_ptr()
        assert float((ema[name] - got[name]).abs().max()) > 0
    else:
        assert pair.tstate.ema_params is None
    if opts.get("loss_aware"):
        jss, tss = pair.jstate.sampler_state, pair.tstate.sampler_state
        np.testing.assert_array_equal(tss.loss_counts.numpy(),
                                      np.asarray(jss.loss_counts))
        np.testing.assert_allclose(tss.loss_history.numpy(),
                                   np.asarray(jss.loss_history), atol=1e-5,
                                   rtol=1e-5)
        assert int(tss.loss_counts.sum()) == STEPS * B
        assert int(tss.loss_counts.max()) == 2  # the repeated t


def test_bn_train_mode_normalises_with_batch_statistics():
    """`BatchNorm(train=True)` against flax: output, and running statistics
    moved to 0.9 * running + 0.1 * batch with the biased variance."""
    from flax import linen as nn

    from interdiff_torch.models.layers import BatchNorm

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 7, 6)) * 2 + 1).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), x)
    want, new = jbn.apply(variables, x, mutable=["batch_stats"])
    bn = BatchNorm(6)
    got = bn(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.detach().numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.detach().numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               atol=1e-6)
    biased = x.reshape(-1, 6).var(axis=0)
    np.testing.assert_allclose(bn.running_var.detach().numpy(),
                               0.9 + 0.1 * biased, rtol=1e-5)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean",
                                     "running_var"]
    assert len(list(bn.parameters())) == 4 and not list(bn.buffers())


def _tiny_state(**kw):
    model = SmplTrackConfig(**SMALL).build_model("cpu")
    diffusion = SmplTrackConfig(**SMALL).diffusion.build("cpu")
    return model, diffusion, ttr.TrainState.create(
        dict(model.named_parameters()), ttr.adamw(LR), **kw)


def test_step_refuses_a_state_that_does_not_fit():
    model, diffusion, state = _tiny_state()
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(np.random.default_rng(2), 1)[0].items()}
    with pytest.raises(ValueError, match="sampler_state"):
        ttr.make_smpl_train_step(
            model, diffusion, schedule_sampler="loss-second-moment")(
                state, batch)
    with pytest.raises(ValueError, match="model_state"):
        ttr.make_smpl_train_step(model, diffusion, bn_train_mode=True)(
            state, batch)
    with pytest.raises(ValueError, match="unknown schedule sampler"):
        ttr.make_smpl_train_step(model, diffusion, schedule_sampler="nope")
    with pytest.raises(ValueError, match="unknown schedule sampler"):
        jtr.make_smpl_train_step(None, diffusion, schedule_sampler="nope")


def test_adamw_has_no_weight_decay():
    opt = ttr.adamw(1e-3)([torch.nn.Parameter(torch.ones(2))])
    group = opt.param_groups[0]
    assert group["weight_decay"] == 0.0 and group["eps"] == 1e-8
    assert tuple(group["betas"]) == (0.9, 0.999) and group["lr"] == 1e-3


def test_chain_steps_equals_sequential_steps():
    """K steps over the leading axis of a stacked batch are K sequential
    steps: same parameters, metrics stacked [K]; draws from a generator
    advance as in the sequential run."""
    rng = np.random.default_rng(3)
    K = 3
    batches = _batches(rng, K)
    ts, noises = _draws(rng, K)
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
               for k in KEYS}
    results = []
    for chained in (False, True):
        torch.manual_seed(0)
        model, diffusion, state = _tiny_state(ema_rate=0.5)
        step = ttr.make_smpl_train_step(model, diffusion)
        if chained:
            state, metrics = ttr.chain_steps(step)(
                state, stacked, t=torch.from_numpy(ts).long(),
                noise=torch.from_numpy(noises))
        else:
            rows = []
            for i in range(K):
                state, m = step(
                    state, {k: v[i] for k, v in stacked.items()},
                    t=torch.from_numpy(ts[i]).long(),
                    noise=torch.from_numpy(noises[i]))
                rows.append(m)
            metrics = {k: torch.stack([m[k] for m in rows]) for k in rows[0]}
        results.append((state, metrics, model.state_dict()))
    (s0, m0, w0), (s1, m1, w1) = results
    assert s0.step == s1.step == K
    assert m1["loss"].shape == (K,) and set(m0) == set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k

    # and with its own draws: two generators in the same state
    outs = []
    for chained in (False, True):
        torch.manual_seed(0)
        model, diffusion, state = _tiny_state()
        step = ttr.make_smpl_train_step(model, diffusion)
        gen = torch.Generator().manual_seed(7)
        if chained:
            ttr.chain_steps(step)(state, stacked, gen)
        else:
            for i in range(K):
                step(state, {k: v[i] for k, v in stacked.items()}, gen)
        outs.append(model.state_dict())
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_sample_timesteps_and_cond_inputs():
    gen = torch.Generator().manual_seed(0)
    t, w = ttr.sample_timesteps(gen, 4000, 1000)
    assert t.dtype == torch.int64 and 0 <= int(t.min()) and int(t.max()) < 1000
    assert torch.equal(w, torch.ones(4000))
    batch = _batches(np.random.default_rng(4), 1)[0]
    gt, pts = ttr.smpl_cond_inputs({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    jgt, jpts = jtr.smpl_cond_inputs({k: jnp.asarray(v)
                                      for k, v in batch.items()})
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), atol=1e-6)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
