"""DDIM and PLMS of the port (`interdiff_torch/diffusion/gaussian.py`,
`eval/smpl_short.py::make_sampler(sampler=...)`) against `interdiff_tpu`'s
loops with the same initial noise: trajectories within 1e-4 (sampled
trajectories, PARITY.md), with and without a ``denoised_fn`` hook, and the
hook's firings counted on both sides.  At engine level the denoiser is a
closed formula written once per framework; at sampler level it is the small
MDM (3 layers, d=32, "10" respacing) with bridged weights."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import DiffusionConfig as JDiffCfg  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.diffusion.gaussian import Inpaint as JInpaint  # noqa: E402
from interdiff_tpu.eval import smpl_short as jss  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_torch.config import DiffusionConfig, SmplTrackConfig  # noqa: E402
from interdiff_torch.diffusion.gaussian import Inpaint  # noqa: E402
from interdiff_torch.eval import smpl_short as tss  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

B, T, C = 3, 12, 8
STEPS = 10
TOL = 1e-4


def _engine_inputs():
    rng = np.random.default_rng(21)
    noise = rng.standard_normal((B, T, C)).astype(np.float32)
    motion = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.zeros((B, T, C), bool)
    mask[:, :4] = True
    return noise, motion, mask


def _j_model(x, ts):
    return jnp.tanh(0.8 * x) * jnp.cos(ts.astype(jnp.float32) / 300.0
                                       )[:, None, None] + 0.1


def _t_model(x, ts):
    return torch.tanh(0.8 * x) * torch.cos(ts.to(torch.float32) / 300.0
                                           )[:, None, None] + 0.1


def _fires(step):
    """The toy hook is active at t <= 8, every 4th step: at 8, 4 and 0."""
    return step <= 8 and step % 4 == 0


def _run_jax(loop, hook):
    noise, motion, mask = _engine_inputs()
    jdiff = JDiffCfg(timestep_respacing=str(STEPS)).build()
    fired = []

    def denoised_fn(x0, t):
        t0 = t[0]

        def active(x):
            jax.debug.callback(lambda v: fired.append(int(v)), t0,
                               ordered=True)
            return 0.5 * x + 0.25

        return jax.lax.cond(jnp.logical_and(t0 <= 8, t0 % 4 == 0), active,
                            lambda x: x, x0)

    out = getattr(jdiff, loop)(
        _j_model, jax.random.PRNGKey(0), noise=jnp.asarray(noise),
        inpaint=JInpaint(jnp.asarray(mask), jnp.asarray(motion)),
        denoised_fn=denoised_fn if hook else None)
    out = np.asarray(jax.block_until_ready(out))
    jax.effects_barrier()
    return out, fired


def _run_torch(loop, hook, with_step=True):
    noise, motion, mask = _engine_inputs()
    diffusion = DiffusionConfig(timestep_respacing=str(STEPS)).build("cpu")
    fired = []

    def by_step(x0, t, step=None):
        assert step is not None and bool((t == step).all())
        if not _fires(step):
            return x0
        fired.append(step)
        return 0.5 * x0 + 0.25

    def by_t(x0, t):  # a hook without the keyword reads t itself
        return by_step(x0, t, step=int(t[0]))

    extra = {}
    if loop == "p_sample_loop":  # the ancestral loop's draws, fixed
        extra["step_noise"] = torch.from_numpy(np.random.default_rng(
            23).standard_normal((STEPS, B, T, C)).astype(np.float32))
    out = getattr(diffusion, loop)(
        _t_model, noise=torch.from_numpy(noise),
        inpaint=Inpaint(torch.from_numpy(mask), torch.from_numpy(motion)),
        denoised_fn=(by_step if with_step else by_t) if hook else None,
        **extra)
    return out.numpy(), fired


@pytest.mark.parametrize("hook", [False, True])
@pytest.mark.parametrize("loop", ["ddim_sample_loop", "plms_sample_loop"])
def test_loop_matches_jax(loop, hook):
    want, fired_jax = _run_jax(loop, hook)
    got, fired = _run_torch(loop, hook)
    assert got.shape == (B, T, C) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert fired == fired_jax
    if hook:
        # PLMS calls the model twice on its first step: at t = 9 and, for
        # the Euler warm-up, at t = 8, where the hook fires once more
        assert fired == ([8, 8, 4, 0] if loop == "plms_sample_loop"
                         else [8, 4, 0])
        plain, _ = _run_torch(loop, False)
        assert np.abs(plain - got).max() > 1e-3  # the hook did act


@pytest.mark.parametrize("loop", ["ddim_sample_loop", "plms_sample_loop",
                                  "p_sample_loop"])
def test_hook_without_step_keyword_gives_the_same(loop):
    a, fired_a = _run_torch(loop, True, with_step=True)
    b, fired_b = _run_torch(loop, True, with_step=False)
    np.testing.assert_array_equal(a, b)
    assert fired_a == fired_b


def test_ddim_eta_draws_noise_and_plms_orders():
    noise, motion, mask = _engine_inputs()
    diffusion = DiffusionConfig(timestep_respacing=str(STEPS)).build("cpu")
    x = torch.from_numpy(noise)
    det = diffusion.ddim_sample_loop(_t_model, noise=x)
    assert torch.equal(det, diffusion.ddim_sample_loop(_t_model, noise=x))
    gen = torch.Generator().manual_seed(0)
    noisy = diffusion.ddim_sample_loop(_t_model, noise=x, eta=1.0,
                                       generator=gen)
    assert float((noisy - det).abs().max()) > 1e-3
    jdiff = JDiffCfg(timestep_respacing=str(STEPS)).build()
    for order in (1, 3, 4):
        want = np.asarray(jdiff.plms_sample_loop(
            _j_model, jax.random.PRNGKey(0), noise=jnp.asarray(noise),
            order=order))
        got = diffusion.plms_sample_loop(_t_model, noise=x, order=order)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="order"):
        diffusion.plms_sample_loop(_t_model, noise=x, order=5)


def test_predict_eps_from_xstart_matches_jax():
    rng = np.random.default_rng(22)
    x_t = rng.standard_normal((B, T, C)).astype(np.float32)
    x0 = rng.standard_normal((B, T, C)).astype(np.float32)
    t = np.array([0, 4, 9])
    want = JDiffCfg(timestep_respacing=str(STEPS)).build() \
        .predict_eps_from_xstart(jnp.asarray(x_t), jnp.asarray(t),
                                 jnp.asarray(x0))
    diffusion = DiffusionConfig(timestep_respacing=str(STEPS)).build("cpu")
    got = diffusion.predict_eps_from_xstart(
        torch.from_numpy(x_t), torch.from_numpy(t), torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the inverse of predict_xstart_from_eps (not held at t = 9, where
    # alpha_bar is about 1e-9 and the round trip loses every digit)
    back = diffusion.predict_xstart_from_eps(
        torch.from_numpy(x_t), torch.from_numpy(t), got)
    np.testing.assert_allclose(back.numpy()[:2], x0[:2], atol=1e-4)


SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)


@pytest.fixture(scope="module")
def small_models():
    rng = np.random.default_rng(35)
    Bm, Tm, P = 2, 35, 64
    gt = (rng.standard_normal((Bm, Tm, 144)) * 0.5).astype(np.float32)
    pts = rng.uniform(-0.12, 0.12, (Bm, P, 6)).astype(np.float32)
    xyz = pts[..., :3].astype(np.float64)
    d2 = ((xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    for r in (0.05, 0.1, 0.2):  # each side computes its own distances
        assert np.abs(d2 - np.float32(r * r)).min() > 1e-6
    jtrack = JTrack(**SMALL, diffusion=JDiffCfg(timestep_respacing="10"))
    jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()
    variables = jax.jit(lambda g, p: jmodel.init(
        jax.random.PRNGKey(1), g, p, jnp.zeros((Bm,), jnp.int32),
        method=JMDM.init_forward))(gt, pts)
    track = SmplTrackConfig(**SMALL,
                            diffusion=DiffusionConfig(timestep_respacing="10"))
    model, diffusion = track.build_model("cpu"), track.diffusion.build("cpu")
    model.load_state_dict(
        flax_to_torch_state_dict(jax.device_get(variables)), strict=True)
    noise = rng.standard_normal((Bm, Tm, 144)).astype(np.float32)
    zeros = [np.zeros((Bm, Tm, 90), np.float32),
             np.zeros((Bm, Tm, 10), np.float32)]
    return dict(gt=gt, pts=pts, noise=noise, zeros=zeros, jmodel=jmodel,
                jdiff=jdiff, variables=variables, model=model,
                diffusion=diffusion)


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_make_sampler_matches_jax(small_models, sampler):
    s = small_models
    jrun = jax.jit(jss.make_sampler(jss.SmplEvalConfig(), s["jmodel"],
                                    s["jdiff"], sampler=sampler))
    ref = np.asarray(jrun(
        s["variables"], jax.random.PRNGKey(0), jnp.asarray(s["gt"]),
        jnp.asarray(s["pts"]), *(jnp.asarray(z) for z in s["zeros"]),
        noise=jnp.asarray(s["noise"])))
    run = tss.make_sampler(tss.SmplEvalConfig(), s["model"], s["diffusion"],
                           sampler=sampler)
    got = run(torch.from_numpy(s["gt"]), torch.from_numpy(s["pts"]),
              *(torch.from_numpy(z) for z in s["zeros"]),
              noise=torch.from_numpy(s["noise"])).numpy()
    assert got.shape == s["gt"].shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    # the last step returns the inpainted x0 prediction: past frames are gt
    np.testing.assert_array_equal(got[:, :10], s["gt"][:, :10])
    ddpm = tss.make_sampler(tss.SmplEvalConfig(), s["model"],
                            s["diffusion"])(
        torch.from_numpy(s["gt"]), torch.from_numpy(s["pts"]),
        *(torch.from_numpy(z) for z in s["zeros"]),
        noise=torch.from_numpy(s["noise"]),
        step_noise=torch.zeros((10,) + s["gt"].shape)).numpy()
    assert np.abs(ddpm - got).max() > 1e-3  # another sampler, another path
