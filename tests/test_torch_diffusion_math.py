"""The rest of the diffusion engine (`interdiff_torch/diffusion/gaussian.py`,
`diffusion/losses.py`) against `interdiff_tpu`'s on the CPU, within 1e-5
(diffusion math; a whole trajectory of an eps model or under guidance
within 1e-4, the tolerance of sampled trajectories): the likelihood
helpers; x_{t-1} prediction (PREVIOUS_X),
learned variances (LEARNED, LEARNED_RANGE) and ``clip_denoised`` through
``p_mean_variance``, ``training_losses`` and the ancestral loop, with a
toy ``model_fn`` whose numpy weights both sides share; classifier guidance
(``cond_fn``) through ``p_sample`` and ``ddim_sample``; ``const_noise``,
``skip_timesteps`` and ``init_image`` with explicit noise;
``ddim_reverse_sample`` against JAX and round-tripped through
``ddim_sample``; and ``calc_bpd_loop`` with explicit per-step noise at T=20
on the small `MDMSmpl` with bridged weights."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.config import DiffusionConfig as JDiffCfg  # noqa: E402
from interdiff_tpu.diffusion import gaussian as jg  # noqa: E402
from interdiff_tpu.diffusion import losses as jl  # noqa: E402
from interdiff_tpu.diffusion import nn as jnn  # noqa: E402
from interdiff_tpu.diffusion.schedule import (  # noqa: E402
    get_named_beta_schedule,
)
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_torch.config import DiffusionConfig, SmplTrackConfig  # noqa: E402
from interdiff_torch.diffusion import gaussian as tg  # noqa: E402
from interdiff_torch.diffusion import losses as tl  # noqa: E402
from interdiff_torch.diffusion import nn as tnn  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

TOL = 1e-5
# the decoder's term at t = 0 is the log of a difference of two float32
# CDFs, each a tanh, far in their tails (the untrained model's mean lies
# many of its scales from x0): there XLA's tanh and PyTorch's, which differ
# by a unit in the last place, part by 2.3e-4 relative on this case
DECODER_TOL = 1e-3
B, C, L = 2, 4, 6
STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=tol, atol=tol)


def test_losses_match_jax():
    """The likelihood on data in [-1, 1] within 1.5 scales of the means,
    where it is well conditioned in float32 (see DECODER_TOL), and on the
    edge bins, which take one CDF each."""
    rng = np.random.default_rng(1)
    m1, m2 = (rng.standard_normal((3, 5)).astype(np.float32)
              for _ in range(2))
    lv1, lv2 = (rng.uniform(-3, 1, (3, 5)).astype(np.float32)
                for _ in range(2))
    means = rng.uniform(-0.9, 0.9, (4, 5)).astype(np.float32)
    scales = rng.uniform(-3.0, -1.0, (4, 5)).astype(np.float32)
    x = np.clip(means + rng.uniform(-1.5, 1.5, (4, 5)) * np.exp(scales),
                -0.99, 0.99).astype(np.float32)
    x[3] = [-1.0, 1.0, -0.9995, 0.9995, 0.0]
    means[3] = [-0.9, 0.95, -1.0, 1.0, 0.01]
    t = {k: torch.from_numpy(v) for k, v in dict(
        m1=m1, m2=m2, lv1=lv1, lv2=lv2, x=x, means=means,
        scales=scales).items()}
    close(tl.normal_kl(t["m1"], t["lv1"], t["m2"], t["lv2"]),
          jl.normal_kl(m1, lv1, m2, lv2))
    close(tl.normal_kl(t["m1"], t["lv1"], 0.0, 0.0),
          jl.normal_kl(m1, lv1, 0.0, 0.0))
    close(tl.approx_standard_normal_cdf(t["x"]),
          jl.approx_standard_normal_cdf(x))
    got = tl.discretized_gaussian_log_likelihood(
        t["x"], means=t["means"], log_scales=t["scales"])
    assert got.dtype == torch.float32
    close(got, jl.discretized_gaussian_log_likelihood(x, means=means,
                                                      log_scales=scales))
    y = rng.standard_normal((2, 3, 4)).astype(np.float32)
    for fn in ("mean_flat", "sum_flat"):
        close(getattr(tl, fn)(torch.from_numpy(y)), getattr(jl, fn)(y))
        assert getattr(tnn, fn) is getattr(tl, fn)
        assert getattr(jnn, fn) is getattr(jl, fn)


def _pair(mean="START_X", var="FIXED_SMALL", steps=STEPS):
    betas = get_named_beta_schedule("cosine", steps)
    jd = jg.GaussianDiffusion.create(
        betas, model_mean_type=jg.ModelMeanType[mean],
        model_var_type=jg.ModelVarType[var])
    td = tg.GaussianDiffusion.create(
        betas, model_mean_type=tg.ModelMeanType[mean],
        model_var_type=tg.ModelVarType[var], device="cpu")
    return jd, td


def _toy_models(out_channels, seed=2):
    """The same toy denoiser in both frameworks: a channel mix over axis 1
    of x [B, C, L], a tanh, a timestep-dependent offset."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((C, out_channels)) * 0.4).astype(np.float32)
    b = (rng.standard_normal(out_channels) * 0.2).astype(np.float32)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)

    def jmodel(x, ts):
        h = (x[:, :, None, :] * w[None, :, :, None]).sum(1)
        return jnp.tanh(h + b[None, :, None]
                        * (ts.astype(jnp.float32)[:, None, None] / 10.0))

    def tmodel(x, ts):
        h = (x[:, :, None, :] * tw[None, :, :, None]).sum(1)
        return torch.tanh(h + tb[None, :, None]
                          * (ts.to(torch.float32)[:, None, None] / 10.0))

    return jmodel, tmodel


VARIANTS = [("PREVIOUS_X", "FIXED_SMALL", False),
            ("PREVIOUS_X", "LEARNED_RANGE", True),
            ("EPSILON", "LEARNED", False),
            ("START_X", "LEARNED_RANGE", True),
            ("EPSILON", "FIXED_LARGE", True)]


@pytest.mark.parametrize("mean,var,clip", VARIANTS)
def test_model_types_match_jax(mean, var, clip):
    jd, td = _pair(mean, var)
    learned = var.startswith("LEARNED")
    jmodel, tmodel = _toy_models(2 * C if learned else C)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, C, L)).astype(np.float32)
    x0 = (rng.standard_normal((B, C, L)) * 0.5).astype(np.float32)
    noise = rng.standard_normal((B, C, L)).astype(np.float32)
    for step in (0, 3, STEPS - 1):
        t = np.full((B,), step, np.int32)
        tt = torch.from_numpy(t).long()
        want = jd.p_mean_variance(jmodel, jnp.asarray(x), jnp.asarray(t),
                                  clip_denoised=clip)
        got = td.p_mean_variance(tmodel, torch.from_numpy(x), tt,
                                 clip_denoised=clip)
        for k in ("mean", "variance", "log_variance", "pred_xstart"):
            close(got[k], np.broadcast_to(want[k], got[k].shape))
        if not learned:
            jo, jt = jd.training_losses(jmodel, jnp.asarray(x0),
                                        jnp.asarray(t),
                                        noise=jnp.asarray(noise))
            to, tt_ = td.training_losses(tmodel, torch.from_numpy(x0), tt,
                                         noise=torch.from_numpy(noise))
            close(to, jo)
            close(tt_, jt)
    if mean == "PREVIOUS_X":
        close(td.predict_xstart_from_xprev(torch.from_numpy(x), tt,
                                           torch.from_numpy(x0)),
              jd.predict_xstart_from_xprev(jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(x0)))
    step_noise = rng.standard_normal((STEPS, B, C, L)).astype(np.float32)
    want = jd.p_sample_loop(jmodel, jax.random.PRNGKey(0),
                            noise=jnp.asarray(noise), clip_denoised=clip,
                            step_noise=jnp.asarray(step_noise))
    got = td.p_sample_loop(tmodel, noise=torch.from_numpy(noise),
                           clip_denoised=clip,
                           step_noise=torch.from_numpy(step_noise))
    assert np.isfinite(got.numpy()).all()
    close(got, want, 1e-4 if mean == "EPSILON" else TOL)


def _guidance(scale=0.3, seed=4):
    """d/dx of -scale/2 |x - target|^2 * (1 + t/100): JAX by `jax.grad`, the
    port by autograd under `torch.enable_grad()` (its loops run without
    autograd), each from its own framework's model timesteps."""
    target = np.random.default_rng(seed).standard_normal(
        (B, C, L)).astype(np.float32)
    ttarget = torch.from_numpy(target)

    def logp_j(x, ts):
        w = 1.0 + ts.astype(jnp.float32)[:, None, None] / 100.0
        return (-0.5 * scale * w * (x - target) ** 2).sum()

    def jcond(x, ts):
        return jax.grad(logp_j)(x, ts)

    def tcond(x, ts):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            w = 1.0 + ts.to(torch.float32)[:, None, None] / 100.0
            logp = (-0.5 * scale * w * (xx - ttarget) ** 2).sum()
            return torch.autograd.grad(logp, xx)[0]

    return jcond, tcond


@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
def test_cond_fn_matches_jax(loop):
    jd, td = _pair("EPSILON", "FIXED_SMALL")
    jmodel, tmodel = _toy_models(C)
    jcond, tcond = _guidance()
    rng = np.random.default_rng(5)
    noise = rng.standard_normal((B, C, L)).astype(np.float32)
    extra_j, extra_t = {}, {}
    if loop == "p_sample_loop":
        sn = rng.standard_normal((STEPS, B, C, L)).astype(np.float32)
        extra_j["step_noise"] = jnp.asarray(sn)
        extra_t["step_noise"] = torch.from_numpy(sn)
    want = getattr(jd, loop)(jmodel, jax.random.PRNGKey(0),
                             noise=jnp.asarray(noise), cond_fn=jcond,
                             **extra_j)
    got = getattr(td, loop)(tmodel, noise=torch.from_numpy(noise),
                            cond_fn=tcond, **extra_t)
    plain = getattr(td, loop)(tmodel, noise=torch.from_numpy(noise),
                              **extra_t)
    close(got, want, 1e-4)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-2
    # one step each, the conditioning functions themselves
    t = np.full((B,), 5, np.int32)
    x = torch.from_numpy(noise)
    for name, kw in (("p_sample", dict(noise=x)), ("ddim_sample", {})):
        jout = getattr(jd, name)(jmodel, jnp.asarray(noise), jnp.asarray(t),
                                 jax.random.PRNGKey(1), cond_fn=jcond,
                                 **({"noise": jnp.asarray(noise)}
                                    if name == "p_sample" else {}))
        tout = getattr(td, name)(tmodel, x, torch.from_numpy(t).long(),
                                 cond_fn=tcond, **kw)
        close(tout["sample"], jout["sample"])
        close(tout["pred_xstart"], jout["pred_xstart"])


@pytest.mark.parametrize("skip,init,const", [(0, False, True),
                                             (5, False, False),
                                             (4, True, True)])
def test_loop_options_match_jax(skip, init, const):
    jd, td = _pair()
    jmodel, tmodel = _toy_models(C, seed=6)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((B, C, L)).astype(np.float32)
    sn = rng.standard_normal((STEPS - skip, B, C, L)).astype(np.float32)
    image = rng.standard_normal((B, C, L)).astype(np.float32) if init \
        else None
    want = jd.p_sample_loop(
        jmodel, jax.random.PRNGKey(0), noise=jnp.asarray(noise),
        step_noise=jnp.asarray(sn), skip_timesteps=skip,
        init_image=None if image is None else jnp.asarray(image),
        const_noise=const)
    seen = []

    def tmodel_seen(x, ts):
        seen.append(int(ts[0]))
        return tmodel(x, ts)

    got = td.p_sample_loop(
        tmodel_seen, noise=torch.from_numpy(noise),
        step_noise=torch.from_numpy(sn), skip_timesteps=skip,
        init_image=None if image is None else torch.from_numpy(image),
        const_noise=const)
    close(got, want)
    assert seen == list(range(STEPS - 1, skip - 1, -1))
    # const_noise: every row takes the first row's draw
    t = torch.full((B,), 3, dtype=torch.int64)
    x = torch.from_numpy(noise)
    one = td.p_sample(tmodel, x, t, noise=torch.from_numpy(sn[0]),
                      const_noise=True)["sample"]
    rows = td.p_sample(tmodel, x, t, noise=torch.from_numpy(
        np.broadcast_to(sn[0][:1], sn[0].shape).copy()))["sample"]
    assert torch.equal(one, rows)


def test_ddim_reverse_sample_round_trip():
    jd, td = _pair()
    rng = np.random.default_rng(8)
    c = (rng.standard_normal((B, C, L)) * 0.3).astype(np.float32)
    tc = torch.from_numpy(c)

    def jmodel(x, ts):  # an x0 model that ignores x: DDIM is exact then
        return jnp.broadcast_to(jnp.asarray(c), x.shape)

    def tmodel(x, ts):
        return tc.expand(x.shape)

    x = torch.from_numpy(rng.standard_normal((B, C, L)).astype(np.float32))
    for step in (1, 4, 8):
        t = torch.full((B,), step, dtype=torch.int64)
        up = td.ddim_reverse_sample(tmodel, x, t)
        want = jd.ddim_reverse_sample(jmodel, jnp.asarray(x.numpy()),
                                      jnp.asarray(t.numpy()))
        close(up["sample"], want["sample"])
        close(up["pred_xstart"], want["pred_xstart"])
        down = td.ddim_sample(tmodel, up["sample"], t + 1)["sample"]
        close(down, x, 1e-4)
    # through a model that reads x, against JAX
    jmodel, tmodel = _toy_models(C, seed=9)
    t = torch.full((B,), 6, dtype=torch.int64)
    close(td.ddim_reverse_sample(tmodel, x, t, clip_denoised=True)["sample"],
          jd.ddim_reverse_sample(jmodel, jnp.asarray(x.numpy()),
                                 jnp.asarray(t.numpy()),
                                 clip_denoised=True)["sample"])


def test_masked_l2_and_learn_sigma_match_jax():
    rng = np.random.default_rng(10)
    a, b = (rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
            for _ in range(2))
    mask = (rng.random((2, 1, 1, 5)) > 0.4).astype(np.float32)
    mask[1] = 0.0
    close(tg.GaussianDiffusion.masked_l2(*(torch.from_numpy(v)
                                           for v in (a, b, mask))),
          jg.GaussianDiffusion.masked_l2(a, b, mask))
    td = tg.GaussianDiffusion.create_named(learn_sigma=True, steps=50,
                                           device="cpu")
    jd = jg.GaussianDiffusion.create_named(learn_sigma=True, steps=50)
    assert td.model_var_type.name == jd.model_var_type.name == \
        "LEARNED_RANGE"


def test_calc_bpd_loop_small_mdm():
    """The whole bound of the small MDM at T=20, the same per-step noise on
    both sides (ordered t = T-1 .. 0): every output within 1e-5, the
    decoder's term at t = 0 (the last column) within DECODER_TOL."""
    small = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
    rng = np.random.default_rng(11)
    Bm, Tm, P = 2, 35, 64
    gt = (rng.standard_normal((Bm, Tm, 144)) * 0.5).astype(np.float32)
    pts = rng.uniform(-0.12, 0.12, (Bm, P, 6)).astype(np.float32)
    jtrack = JTrack(**small, diffusion=JDiffCfg(timestep_respacing="20"))
    jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()
    variables = jax.jit(lambda g, p: jmodel.init(
        jax.random.PRNGKey(1), g, p, jnp.zeros((Bm,), jnp.int32),
        method=JMDM.init_forward))(gt, pts)
    track = SmplTrackConfig(
        **small, diffusion=DiffusionConfig(timestep_respacing="20"))
    model, diffusion = track.build_model("cpu"), track.diffusion.build("cpu")
    model.load_state_dict(flax_to_torch_state_dict(
        jax.device_get(variables)), strict=True)
    T = diffusion.num_timesteps
    assert T == 20
    step_noise = rng.standard_normal((T, Bm, Tm, 144)).astype(np.float32)

    jmem = jmodel.apply(variables, jnp.asarray(gt), jnp.asarray(pts),
                        method=JMDM.encode)
    want = jax.jit(lambda v, m, sn: jdiff.calc_bpd_loop(
        lambda x, ts: jmodel.apply(v, x, ts, m, method=JMDM.denoise),
        jnp.asarray(gt), step_noise=sn))(variables, jmem,
                                         jnp.asarray(step_noise))
    with torch.no_grad():
        mem = model.encode(torch.from_numpy(gt), torch.from_numpy(pts))
    got = diffusion.calc_bpd_loop(
        lambda x, ts: model.denoise(x, ts, mem), torch.from_numpy(gt),
        step_noise=torch.from_numpy(step_noise))
    assert got["vb"].shape == (Bm, T)
    for k in ("total_bpd", "prior_bpd", "xstart_mse", "mse"):
        close(got[k], want[k])
    close(got["vb"][:, :-1], np.asarray(want["vb"])[:, :-1])
    close(got["vb"][:, -1], np.asarray(want["vb"])[:, -1], DECODER_TOL)
    # the per-step terms are each timestep's: column j is t = T-1-j
    j = 7
    t = torch.full((Bm,), T - 1 - j, dtype=torch.int64)
    x_t = diffusion.q_sample(torch.from_numpy(gt), t,
                             torch.from_numpy(step_noise[j]))
    with torch.no_grad():
        one = diffusion.vb_terms_bpd(lambda x, ts: model.denoise(x, ts, mem),
                                     torch.from_numpy(gt), x_t, t)
    assert torch.equal(one["output"], got["vb"][:, j])
    with pytest.raises(ValueError, match="generator"):
        diffusion.calc_bpd_loop(lambda x, ts: x, torch.from_numpy(gt))
    drawn = diffusion.calc_bpd_loop(
        lambda x, ts: model.denoise(x, ts, mem), torch.from_numpy(gt),
        generator=torch.Generator().manual_seed(0))
    assert np.isfinite(drawn["total_bpd"].numpy()).all()
