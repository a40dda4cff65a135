"""The correction train steps of the port (`interdiff_torch/train/
trainer.py::make_correction_{smpl,skeleton}_train_step`) against `interdiff_tpu/train/trainer.py`'s, three steps each on the CPU
from one flax-initialised state moved over by the weight bridge: the SMPL
step in both phases (``initialize``, the mean over nodes, and the main
phase with the marker draw), the skeleton step.

The JAX step draws the marker from its key; the test draws the same
categorical from the same key and hands it to the port as ``marker_idx``.
Tolerances: the loss and every term within 1e-5, the parameters after three
Adam steps within 1e-4 (optax's and torch's Adam round differently), the
BatchNorm running statistics within 1e-5.  One family of parameters is held
apart: the bias of each 1x1 conv ahead of a BatchNorm in train mode
(``res_conv.bias``, ``tcn_conv.bias``).  The batch mean subtracts it again,
so its gradient is exactly zero and both packages compute rounding noise
(under 1e-6 of the largest gradient, asserted here); Adam normalises that
noise into a step of up to lr in either direction.  So after every step
these biases are held to 2 * lr of the JAX step's and then set to its
values (the next forward's batch mean, and so the running mean, contains
them); every other parameter is held to 1e-4 after the three steps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.data.constants import hand_bias_vector  # noqa: E402
from interdiff_tpu.models import correction as jcorr  # noqa: E402
from interdiff_tpu.train import trainer as jtr  # noqa: E402
from interdiff_torch.models import correction as tcorr  # noqa: E402
from interdiff_torch.train import trainer as ttr  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

from test_torch_losses_correction import correction_geometry  # noqa: E402

STEPS, LR = 3, 3e-4
B, PAST, FUTURE, M = 3, 4, 6, 67


def smpl_batches(seed, steps=STEPS):
    """Correction batches on the ball geometry of the losses' test: object
    poses as axis-angle, 67 markers picked from the body vertices with
    random contact labels (one sample without any)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        _, _, pts, human = correction_geometry(seed + i, B=B, T=PAST + FUTURE,
                                               V=96, P=48)
        markers = human[:, :, rng.integers(0, 96, M)].copy()
        markers[..., 6] = rng.random(markers.shape[:3]) < 0.2
        markers[1, ..., 6] = 0.0
        out.append({
            "obj_angles": (rng.standard_normal((B, PAST + FUTURE, 3))
                           * 0.5).astype(np.float32),
            "obj_trans": (np.array([0.3, 0.0, 0.0]) + rng.standard_normal(
                (B, PAST + FUTURE, 3)) * 0.05).astype(np.float32),
            "markers": markers, "human_verts": human, "obj_points": pts})
    return out


def _shadowed(name):
    """A bias that a train-mode BatchNorm subtracts again."""
    return name.endswith(("res_conv.bias", "tcn_conv.bias"))


def _sync_shadowed(tproj, jstate):
    """Hold each shadowed bias to 2 * lr of the JAX step's, then copy the
    JAX value over."""
    grads = {n: p.grad for n, p in tproj.named_parameters()}
    largest = max(float(g.abs().max()) for g in grads.values())
    want = flax_to_torch_state_dict({"params": jax.device_get(
        jstate.params)})
    with torch.no_grad():
        for name, p in tproj.named_parameters():
            if _shadowed(name):
                assert float(grads[name].abs().max()) <= 1e-6 * largest
                torch.testing.assert_close(p, want[name], rtol=0,
                                           atol=2 * LR, msg=name)
                p.copy_(want[name])


def _compare(jstate, tproj, jlosses, tlosses):
    for jm, tm in zip(jlosses, tlosses):
        assert jm.keys() == tm.keys()
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=1e-5, err_msg=k)
    want = flax_to_torch_state_dict({
        "params": jax.device_get(jstate.params),
        "batch_stats": jax.device_get(jstate.batch_stats)})
    got = tproj.state_dict()
    params = dict(tproj.named_parameters())
    assert got.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0,
                                   atol=1e-4 if name in params else 1e-5,
                                   msg=name)


@pytest.mark.parametrize("initialize", [True, False])
def test_smpl_correction_steps_match_jax(initialize):
    batches = smpl_batches(10)
    kw = dict(num_markers=M, n_pre=6, past_len=PAST, future_len=FUTURE)
    jproj = jcorr.ObjProjectorSmpl(**kw)
    variables = jax.device_get(jproj.init(
        jax.random.PRNGKey(1), jnp.zeros((2, PAST + FUTURE, 9)),
        jnp.zeros((2, PAST + FUTURE, M, 3)), jnp.zeros((2, M))))
    jstate = jtr.CorrectionTrainState.create(variables, optax.adam(LR))
    jstep = jax.jit(jtr.make_correction_smpl_train_step(
        jproj, initialize=initialize))

    tproj = tcorr.ObjProjectorSmpl(**kw, device="cpu")
    tproj.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    tstate = ttr.CorrectionTrainState.create(tproj, ttr.adam(LR))
    assert tstate.params.keys() == flax_to_torch_state_dict(
        {"params": variables["params"]}).keys()
    tstep = ttr.make_correction_smpl_train_step(tproj, initialize=initialize)

    jlosses, tlosses = [], []
    key = jax.random.PRNGKey(5)
    for i, batch in enumerate(batches):
        epoch = 8.0 + 6 * i  # annealing 0.16, then 0.49, then 1
        key, k = jax.random.split(key)
        jstate, jm = jstep(jstate, {n: jnp.asarray(v) for n, v in
                                    batch.items()}, k,
                           jnp.asarray(epoch, jnp.float32))
        contact = batch["markers"][:, PAST:, :, 6].sum(1)
        draw = jax.random.categorical(
            k, jnp.log(jnp.asarray(contact) + hand_bias_vector(M)))
        tstate, tm = tstep(tstate, {n: torch.from_numpy(v) for n, v in
                                    batch.items()}, epoch=epoch,
                           marker_idx=torch.from_numpy(np.array(draw)))
        _sync_shadowed(tproj, jstate)
        jlosses.append(jm)
        tlosses.append(tm)
    # the contact and penetration terms (and so K3's and K4's gradients)
    # take part
    assert all(float(m["contact"]) > 0 for m in tlosses)
    assert any(float(m["penetration"]) > 0 for m in tlosses)
    assert tstate.step == STEPS
    _compare(jstate, tproj, jlosses, tlosses)


def test_skeleton_correction_steps_match_jax():
    from interdiff_tpu.cli.common import synthetic_skeleton_batches

    rng = np.random.default_rng(12)
    batches = list(synthetic_skeleton_batches(rng, batch_size=B,
                                              seq_len=PAST + FUTURE,
                                              steps=STEPS))
    kw = dict(num_joints=21, past_len=PAST, future_len=FUTURE)
    jproj = jcorr.ObjProjectorSkeleton(**kw)
    ex = batches[0]
    variables = jax.device_get(jproj.init(
        jax.random.PRNGKey(2), jnp.asarray(ex["poses"][..., 3:7]),
        jnp.asarray(ex["poses"][..., :3]), jnp.asarray(ex["skeleton"])))
    jstate = jtr.CorrectionTrainState.create(variables, optax.adam(LR))
    jstep = jax.jit(jtr.make_correction_skeleton_train_step(jproj))

    tproj = tcorr.ObjProjectorSkeleton(**kw, device="cpu")
    tproj.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    tstate = ttr.CorrectionTrainState.create(tproj, ttr.adam(LR))
    tstep = ttr.make_correction_skeleton_train_step(tproj)
    jlosses, tlosses = [], []
    for batch in batches:
        b = {k: batch[k] for k in ("skeleton", "poses")}
        jstate, jm = jstep(jstate, {n: jnp.asarray(v) for n, v in b.items()},
                           jax.random.PRNGKey(0), jnp.asarray(0.0))
        tstate, tm = tstep(tstate, {n: torch.from_numpy(v) for n, v in
                                    b.items()})
        _sync_shadowed(tproj, jstate)
        jlosses.append(jm)
        tlosses.append(tm)
    _compare(jstate, tproj, jlosses, tlosses)
