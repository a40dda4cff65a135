"""The timestep samplers of the port (`interdiff_torch/diffusion/resample.py`)
against `interdiff_tpu/diffusion/resample.py`: the loss-aware sampler's
probabilities, its importance weights for given timesteps and its history
update, on the same numpy (t, loss) batches.  Random draws cannot be matched
across the frameworks, so draws are checked by their distribution."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.diffusion import resample as jr  # noqa: E402
from interdiff_torch.diffusion import resample as tr  # noqa: E402

T, H = 12, 3


def _fold(batches):
    """Both resamplers after the same batches of (t, loss)."""
    js, ts = jr.LossSecondMomentResampler(T, H), \
        tr.LossSecondMomentResampler(T, H)
    jstate, tstate = js.init_state(), ts.init_state()
    for t, loss in batches:
        jstate = js.update(jstate, jnp.asarray(t), jnp.asarray(loss))
        tstate = ts.update(tstate, torch.from_numpy(t),
                           torch.from_numpy(loss))
    return js, jstate, ts, tstate


def _same_state(jstate, tstate):
    np.testing.assert_array_equal(tstate.loss_history.numpy(),
                                  np.asarray(jstate.loss_history))
    np.testing.assert_array_equal(tstate.loss_counts.numpy(),
                                  np.asarray(jstate.loss_counts))
    assert tstate.loss_history.dtype == torch.float32
    assert tstate.loss_counts.dtype == torch.int32


def test_update_folds_repeated_timesteps_in_order():
    """Two equal t in one batch land as in the JAX scan: the second after
    the first, and a full ring drops its oldest entry."""
    rng = np.random.default_rng(0)
    batches = [(np.array([3, 3, 5, 3, 3], np.int32),
                rng.random(5).astype(np.float32)),
               (np.array([3, 5, 5, 5, 0], np.int32),
                rng.random(5).astype(np.float32))]
    _, jstate, _, tstate = _fold(batches)
    _same_state(jstate, tstate)
    first, second = batches
    # t = 3 saw five losses: the ring holds the last three, oldest first
    np.testing.assert_array_equal(
        tstate.loss_history[3].numpy(),
        np.array([first[1][3], first[1][4], second[1][0]], np.float32))
    assert tstate.loss_counts.tolist()[:6] == [1, 0, 0, 3, 0, 3]


def test_update_returns_a_new_state():
    ts = tr.LossSecondMomentResampler(T, H)
    state = ts.init_state()
    new = ts.update(state, torch.tensor([1]), torch.tensor([2.0]))
    assert int(state.loss_counts.sum()) == 0
    assert int(new.loss_counts.sum()) == 1


@pytest.mark.parametrize("warm", [False, True])
def test_weights_and_importance_weights(warm):
    rng = np.random.default_rng(1)
    rounds = H if warm else H - 1
    batches = [(rng.permutation(T).astype(np.int32),
                rng.random(T).astype(np.float32) * (1 + np.arange(T)))
               for _ in range(rounds)]
    js, jstate, ts, tstate = _fold(batches)
    _same_state(jstate, tstate)
    p, jp = ts.weights(tstate), np.asarray(js.weights(jstate))
    np.testing.assert_allclose(p.numpy(), jp, rtol=1e-6)
    assert abs(float(p.sum()) - 1.0) < 1e-5
    assert (float(p.max() - p.min()) > 1e-3) == warm  # uniform until warm
    t = np.array([0, 7, 7, 11], np.int64)
    np.testing.assert_allclose(
        ts.importance_weights(tstate, torch.from_numpy(t)).numpy(),
        1.0 / (T * jp[t]), rtol=1e-6)


def test_samples_follow_the_weights():
    rng = np.random.default_rng(2)
    batches = [(np.arange(T, dtype=np.int32),
                np.where(np.arange(T) < 2, 5.0, 0.01).astype(np.float32))
               for _ in range(H)]
    _, _, ts, tstate = _fold(batches)
    gen = torch.Generator().manual_seed(0)
    t, w = ts.sample(gen, 4000, tstate)
    assert t.dtype == torch.int64 and w.dtype == torch.float32
    p = ts.weights(tstate)
    np.testing.assert_allclose(w.numpy(), 1.0 / (T * p[t].numpy()),
                               rtol=1e-6)
    share = np.bincount(t.numpy(), minlength=T) / 4000
    np.testing.assert_allclose(share, p.numpy(), atol=0.03)
    assert share[:2].sum() > 0.9
    del rng


def test_uniform_sampler_and_factory():
    gen = torch.Generator().manual_seed(0)
    t, w = tr.UniformSampler(1000).sample(gen, 5000)
    assert t.shape == (5000,) and int(t.min()) >= 0 and int(t.max()) < 1000
    assert abs(float(t.float().mean()) - 499.5) < 20
    assert torch.equal(w, torch.ones(5000))
    assert isinstance(tr.create_named_schedule_sampler("uniform", 10),
                      tr.UniformSampler)
    assert isinstance(
        tr.create_named_schedule_sampler("loss-second-moment", 10),
        tr.LossSecondMomentResampler)
    with pytest.raises(NotImplementedError):
        tr.create_named_schedule_sampler("nope", 10)
    with pytest.raises(NotImplementedError):
        jr.create_named_schedule_sampler("nope", 10)
