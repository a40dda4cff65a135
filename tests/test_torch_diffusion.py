"""Diffusion engine of the port (`interdiff_torch/diffusion/gaussian.py`)
against `interdiff_tpu/diffusion/gaussian.py`: schedule constants under
respacing, and the inpainting DDPM loop with a fixed linear model and the
same explicit noise.  Tolerance 1e-5 (diffusion math, PARITY.md row 1)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.diffusion.gaussian import GaussianDiffusion as JG  # noqa: E402
from interdiff_tpu.diffusion.gaussian import Inpaint as JInpaint  # noqa: E402
from interdiff_torch.diffusion import gaussian as tg  # noqa: E402

FIELDS = tg._SCHEDULE_FIELDS + ("timestep_map",)


@pytest.mark.parametrize("respacing", ["", "100", "10"])
def test_schedule_constants_match(respacing):
    ref = JG.create_named(timestep_respacing=respacing or None)
    got = tg.GaussianDiffusion.create_named(
        timestep_respacing=respacing or None, device="cpu")
    assert got.num_timesteps == ref.num_timesteps
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    t = np.arange(0, ref.num_timesteps, 3)
    np.testing.assert_array_equal(
        got.model_timesteps(torch.from_numpy(t)).numpy(),
        np.asarray(ref.model_timesteps(jnp.asarray(t))))

    rng = np.random.default_rng(4)
    x0, xt, eps = (rng.standard_normal((len(t), 5, 3)).astype(np.float32)
                   for _ in range(3))
    tt = torch.from_numpy(t)
    np.testing.assert_allclose(
        got.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(eps)).numpy(),
        np.asarray(ref.q_sample(x0, t, eps)), atol=1e-5, rtol=1e-5)
    for a, b in zip(got.q_posterior_mean_variance(
            torch.from_numpy(x0), torch.from_numpy(xt), tt),
            ref.q_posterior_mean_variance(x0, xt, t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sigma_small,predict_xstart",
                         [(True, True), (False, True), (True, False)])
def test_p_sample_loop_matches(sigma_small, predict_xstart):
    """x0 prediction with inpainting and a denoised_fn hook; epsilon
    prediction without inpainting (which needs an x0 model)."""
    rng = np.random.default_rng(5)
    B, T, C = 2, 12, 6
    w = (rng.standard_normal((C, C)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    gt = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.zeros((B, T, C), bool)
    mask[:, :4] = True
    noise = rng.standard_normal((B, T, C)).astype(np.float32)
    kw = dict(timestep_respacing="10", sigma_small=sigma_small,
              predict_xstart=predict_xstart)
    jd = JG.create_named(**kw)
    td = tg.GaussianDiffusion.create_named(**kw, device="cpu")
    step_noise = rng.standard_normal(
        (td.num_timesteps, B, T, C)).astype(np.float32)

    def j_model(x, ts):
        return jnp.tanh(x @ w + bias * (ts[:, None, None] / 1000.0))

    def t_model(x, ts):
        return torch.tanh(x @ torch.from_numpy(w) + torch.from_numpy(bias)
                          * (ts[:, None, None] / 1000.0))

    j_kw, t_kw = {}, {}
    if predict_xstart:
        j_kw = dict(inpaint=JInpaint(jnp.asarray(mask), jnp.asarray(gt)),
                    denoised_fn=lambda x, t: 0.9 * x)
        t_kw = dict(inpaint=tg.Inpaint(torch.from_numpy(mask),
                                       torch.from_numpy(gt)),
                    denoised_fn=lambda x, t: 0.9 * x)
    ref = jd.p_sample_loop(j_model, jax.random.PRNGKey(0),
                           noise=jnp.asarray(noise),
                           step_noise=jnp.asarray(step_noise), **j_kw)
    got = td.p_sample_loop(t_model, noise=torch.from_numpy(noise),
                           step_noise=torch.from_numpy(step_noise), **t_kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_inpainted_frames_end_at_gt():
    """The last step (t = 0) returns the inpainted x0: past frames are gt."""
    rng = np.random.default_rng(6)
    gt = torch.from_numpy(rng.standard_normal((2, 8, 3)).astype(np.float32))
    mask = torch.zeros(2, 8, 3, dtype=torch.bool)
    mask[:, :3] = True
    td = tg.GaussianDiffusion.create_named(timestep_respacing="10",
                                           device="cpu")
    got = td.p_sample_loop(lambda x, ts: torch.tanh(x), noise=torch.randn(
        2, 8, 3, generator=torch.Generator().manual_seed(0)),
        generator=torch.Generator().manual_seed(1),
        inpaint=tg.Inpaint(mask, gt))
    assert torch.equal(got[:, :3], gt[:, :3])


def test_generated_noise_applies_initial_inpaint():
    """Without explicit noise the first sample is overwritten on the mask;
    the draw comes from the given generator, so two runs agree."""
    td = tg.GaussianDiffusion.create_named(timestep_respacing="10",
                                           device="cpu")
    gt = torch.ones(1, 5, 3)
    mask = torch.zeros(1, 5, 3, dtype=torch.bool)
    mask[:, :2] = True
    seen = []

    def model(x, ts):
        seen.append(x.clone())
        return torch.zeros_like(x)

    inpaint = tg.Inpaint(mask, gt)
    a = td.p_sample_loop(model, (1, 5, 3), inpaint=inpaint,
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(seen[0][:, :2], gt[:, :2])
    b = td.p_sample_loop(model, (1, 5, 3), inpaint=inpaint,
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
