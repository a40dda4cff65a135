"""The SMPL-track losses of the port (`interdiff_torch/train/losses.py`) and
`training_losses` / `q_mean_variance` of its diffusion engine against
`interdiff_tpu`, on the same numpy inputs, term by term within 1e-5
(diffusion math, PARITY.md row 1); plus the helpers of `diffusion/nn.py`."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import DiffusionConfig as JDiffusionConfig  # noqa: E402
from interdiff_tpu.diffusion import nn as jnn  # noqa: E402
from interdiff_tpu.diffusion.gaussian import Inpaint as JInpaint  # noqa: E402
from interdiff_tpu.train import losses as jl  # noqa: E402
from interdiff_torch.config import DiffusionConfig  # noqa: E402
from interdiff_torch.diffusion import nn as tnn  # noqa: E402
from interdiff_torch.diffusion.gaussian import Inpaint  # noqa: E402
from interdiff_torch.train import losses as tl  # noqa: E402

TOL = 1e-5
B, T, P = 3, 35, 10


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("faithful", [True, False])
def test_smpl_diffusion_losses(faithful):
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((B, T, 144)).astype(np.float32)
    gt = rng.standard_normal((B, T, 144)).astype(np.float32)
    weights = dict(smplx_rot=1.3, smplx_nonrot=0.2, obj_rot=0.1,
                   obj_nonrot=0.4, past=0.7, v=0.2)
    loss, terms = tl.smpl_diffusion_losses(
        torch.from_numpy(pred), torch.from_numpy(gt), past_len=P,
        weights=tl.SmplLossWeights(**weights), faithful=faithful)
    jloss, jterms = jl.smpl_diffusion_losses(
        jnp.asarray(pred), jnp.asarray(gt), past_len=P,
        weights=jl.SmplLossWeights(**weights), faithful=faithful)
    assert loss.shape == (B,) and list(terms) == list(jterms)
    assert len(terms) == 16
    _close(loss, jloss)
    for k in terms:
        _close(terms[k], jterms[k])
    assert tl.SmplLossWeights() == tl.SmplLossWeights(
        **jl.SmplLossWeights().__dict__)


def _axis_angle_pair(rng, lead):
    return (rng.standard_normal(lead + (T, 69)).astype(np.float32) * 0.5,
            rng.standard_normal((B, T, 69)).astype(np.float32) * 0.5,
            rng.standard_normal(lead + (T, 6)).astype(np.float32),
            rng.standard_normal((B, T, 6)).astype(np.float32))


def test_smpl_val_losses():
    args = _axis_angle_pair(np.random.default_rng(1), (B,))
    loss, terms = tl.smpl_val_losses(*map(torch.from_numpy, args),
                                     past_len=P)
    jloss, jterms = jl.smpl_val_losses(*map(jnp.asarray, args), past_len=P)
    assert list(terms) == list(jterms) and len(terms) == 16
    _close(loss, jloss)
    for k in terms:
        _close(terms[k], jterms[k])


def test_smpl_diverse_test_losses():
    """Mean and per-clip-min terms; the future velocity's slice differs from
    the validation loss's."""
    N = 4
    args = _axis_angle_pair(np.random.default_rng(2), (N, B))
    loss, terms, weighted = tl.smpl_diverse_test_losses(
        *map(torch.from_numpy, args), past_len=P)
    jloss, jterms, jweighted = jl.smpl_diverse_test_losses(
        *map(jnp.asarray, args), past_len=P)
    assert list(terms) == list(jterms) and len(terms) == 32
    assert list(weighted) == list(jweighted) and len(weighted) == 16
    _close(loss, jloss)
    for k in terms:
        _close(terms[k], jterms[k])
    for k in weighted:
        _close(weighted[k], jweighted[k])
    # not the validation loss's slice
    one = tuple(torch.from_numpy(a[0] if a.ndim == 4 else a) for a in args)
    val = tl.smpl_val_losses(*one, past_len=P)[1]["body_rot_v_future"]
    single = tl.smpl_diverse_test_losses(
        one[0][None], one[1], one[2][None], one[3], past_len=P)[2]
    assert abs(float(val) - float(single["body_rot_v_future"])) > 1e-6


@pytest.mark.parametrize("predict_xstart", [True, False])
def test_training_losses_and_q_mean_variance(predict_xstart):
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((B, T, 144)).astype(np.float32)
    noise = rng.standard_normal((B, T, 144)).astype(np.float32)
    t = np.array([0, 517, 999], np.int32)
    w = rng.standard_normal((144, 144)).astype(np.float32) * 0.1
    jd = JDiffusionConfig(predict_xstart=predict_xstart).build()
    td = DiffusionConfig(predict_xstart=predict_xstart).build("cpu")

    seen = {}

    def t_model(x, ts):
        seen["t"] = (x, ts)
        return x @ torch.from_numpy(w) + ts[:, None, None] * 1e-3

    def j_model(x, ts):
        seen["j"] = (x, ts)
        return x @ jnp.asarray(w) + ts[:, None, None] * 1e-3

    mask = np.zeros((B, T, 144), bool)
    mask[:, :P] = True
    for inpaint in (False, True) if predict_xstart else (False,):
        out, target = td.training_losses(
            t_model, torch.from_numpy(x0), torch.from_numpy(t).long(),
            noise=torch.from_numpy(noise),
            inpaint=Inpaint(torch.from_numpy(mask), torch.from_numpy(x0))
            if inpaint else None)
        jout, jtarget = jd.training_losses(
            j_model, jnp.asarray(x0), jnp.asarray(t), noise=jnp.asarray(noise),
            inpaint=JInpaint(jnp.asarray(mask), jnp.asarray(x0))
            if inpaint else None)
        _close(out, jout)
        _close(target, jtarget)
        _close(seen["t"][0], seen["j"][0])
        np.testing.assert_array_equal(seen["t"][1].numpy(),
                                      np.asarray(seen["j"][1]))
        np.testing.assert_array_equal(target.numpy(),
                                      x0 if predict_xstart else noise)
    for got, want in zip(
            td.q_mean_variance(torch.from_numpy(x0),
                               torch.from_numpy(t).long()),
            jd.q_mean_variance(jnp.asarray(x0), jnp.asarray(t))):
        _close(got, np.broadcast_to(np.asarray(want), got.shape))


def test_timestep_embedding_cos_first():
    t = np.array([0, 1, 250, 999], np.int32)
    for dim in (32, 33):
        got = tnn.timestep_embedding(torch.from_numpy(t), dim)
        _close(got, jnn.timestep_embedding(jnp.asarray(t), dim))
        assert got.shape == (4, dim)
    assert float(tnn.timestep_embedding(torch.tensor([0]), 8)[0, 0]) == 1.0


def test_ema_zero_scale_and_flat_reductions():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    new = {"a": rng.standard_normal((3, 4)).astype(np.float32),
           "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    want = jnn.update_ema(tree, new, rate=0.9)
    ema = {"a": torch.from_numpy(tree["a"].copy()),
           "b.c": torch.from_numpy(tree["b"]["c"].copy())}
    params = {"a": torch.from_numpy(new["a"]).requires_grad_(True),
              "b.c": torch.from_numpy(new["b"]["c"]).requires_grad_(True)}
    assert tnn.update_ema(ema, params, rate=0.9) is ema
    _close(ema["a"], want["a"])
    _close(ema["b.c"], want["b"]["c"])
    assert not ema["a"].requires_grad
    with pytest.raises(ValueError, match="shadow"):
        tnn.update_ema(ema, [params["a"]])

    scaled = tnn.scale_params([ema["a"].clone()], 0.5)[0]
    _close(scaled, np.asarray(jnn.scale_params(want, 0.5)["a"]))
    zeroed = tnn.zero_params({"a": ema["a"].clone()})["a"]
    assert not bool(zeroed.any())

    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    _close(tnn.mean_flat(torch.from_numpy(x)), jnn.mean_flat(jnp.asarray(x)))
    _close(tnn.sum_flat(torch.from_numpy(x)), jnn.sum_flat(jnp.asarray(x)))
