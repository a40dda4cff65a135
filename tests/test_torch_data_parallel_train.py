"""The port's data-parallel train step
(`interdiff_torch/train/trainer.py::data_parallel_step`) at two gloo ranks
on the CPU against `interdiff_tpu/train/trainer.py::data_parallel_step` on
a 2-device mesh, and against the port's own step at one rank on the whole
batch: the SMPL diffusion step (default route with EMA, ``bn_train_mode``,
the loss-second-moment resampler, and `chain_steps` at one and two ranks)
and both correction steps, three steps each from the same weights.

The two ranks are spawned once for the module (`tests/_torch_dp_ranks.py`
runs on them); the JAX side runs here.  The global batch of 4 has halves
whose statistics differ (the second half's object cloud, and the skeleton,
scaled and shifted), so a rank that normalised by its own half could not
pass: the module also runs that copy (the BatchNorm all-reduce taken out)
and asserts that it falls outside the tolerances.  The draws are the
test's own: JAX's are patched as in `tests/test_torch_trainer.py`, the
port's are handed in (each rank its rows), and the SMPL projector's marker
choice is JAX's categorical from the step's key, as in
`tests/test_torch_correction_trainer.py`.

Tolerances, and why: loss and metrics 1e-5 at the first step and 1e-4
after it (the statistics of the mesh come from all-reduced sums, the
gradients from two halves: float32 rounding); under ``bn_train_mode``
1e-4 and 1e-3, that file's wider ones (flax's E[x^2] - E[x]^2 cancels in
float32 at this batch size).  Parameters after three AdamW steps: every
entry within 2 * steps * lr and the mean difference within lr / 100, as
in `tests/test_torch_trainer.py` (Adam turns a gradient that is rounding
noise into a step of up to lr).  Correction steps: parameters within 1e-4,
BatchNorm statistics within 1e-5, the biases a train-mode BatchNorm
subtracts again held to 2 * lr and then set to JAX's values after each
step (their gradient is zero; asserted to be under 1e-6 of the largest).
The resampler's counts equal and its history within 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

torch = pytest.importorskip("torch")

import _torch_dp_ranks as ranks  # noqa: E402
from interdiff_tpu.cli.common import synthetic_skeleton_batches  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.data.constants import hand_bias_vector  # noqa: E402
from interdiff_tpu.diffusion.resample import (  # noqa: E402
    LossSecondMomentResampler as JResampler,
)
from interdiff_tpu.models import correction as jcorr  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from interdiff_tpu.train import trainer as jtr  # noqa: E402
from interdiff_torch.parallel.mesh import launch, make_mesh  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

from test_torch_losses_correction import correction_geometry  # noqa: E402

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=2,
             past_len=4, future_len=6)
B, T, P, STEPS, LR = 4, 10, 64, 3, 3e-4
M, N_PRE = 67, 6
RADII = (0.05, 0.1, 0.2)
KEYS = ("body_pose", "body_trans", "obj_angles", "obj_trans", "obj_points")
SMPL_CASES = {
    "default_ema": dict(ema_rate=0.9),
    "bn_train_mode": dict(bn_train_mode=True, ema_rate=0.9),
    "loss_second_moment": dict(loss_aware=True),
}
JAX_CASES = list(SMPL_CASES) + ["correction_smpl", "correction_skeleton"]
LOCAL = ("bn_train_mode", "correction_smpl")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replicated(state, mesh):
    """The initial state placed as the step returns it (replicated), so
    that JAX compiles the step once, not once more at the second call."""
    return jax.device_put(state, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))


def _np(tree):
    return {k: v.numpy() for k, v in flax_to_torch_state_dict(
        jax.device_get(tree)).items()}


def _smpl_batches(rng):
    out = []
    for _ in range(STEPS):
        margin = 0.0
        while margin <= 1e-6:  # no pair on a radius: each side its own d2
            pts = rng.uniform(-0.12, 0.12, (B, P, 6)).astype(np.float32)
            pts[B // 2:, :, :3] = pts[B // 2:, :, :3] * 1.6 + 0.05
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


def _jax_smpl(variables, opts, batches, ts, noises):
    jtrack = JTrack(**SMALL)
    jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()
    holder = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "sample_timesteps", lambda key, b, n: (
            holder["t"], jnp.ones((b,), jnp.float32)))
        real_normal = jax.random.normal
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: (
            holder["noise"] if tuple(shape) == (B, T, 144)
            else real_normal(key, shape, *a, **k)))
        sampler, sampler_state = "uniform", None
        if opts.get("loss_aware"):
            sampler = JResampler(jdiff.num_timesteps, history_per_term=2)
            sampler_state = sampler.init_state()
            mp.setattr(sampler, "sample", lambda key, b, state: (
                holder["t"], (1.0 / (jdiff.num_timesteps * sampler.weights(
                    state)[holder["t"]])).astype(jnp.float32)),
                raising=False)
        params, model_state = variables, None
        if opts.get("bn_train_mode"):
            params, model_state = jtr.split_bn_state(variables)
        state = jtr.TrainState.create(
            params, jtr.adamw(LR), sampler_state=sampler_state,
            ema_rate=opts.get("ema_rate", 0.0), model_state=model_state)
        step = jtr.make_smpl_train_step(
            jmodel, jdiff, schedule_sampler=sampler,
            bn_train_mode=bool(opts.get("bn_train_mode")))

        def with_draws(state, batch, t, noise):
            holder.update(t=t, noise=noise)
            return step(state, batch, jax.random.PRNGKey(0))

        mesh = jmake_mesh(data=2)
        dp = jtr.data_parallel_step(with_draws, mesh, extra_args=2)
        state = _replicated(state, mesh)
        metrics = []
        for i, b in enumerate(batches):
            state, m = dp(state, dp.place_batch(
                {k: jnp.asarray(b[k]) for k in KEYS}),
                jnp.asarray(ts[i]), jnp.asarray(noises[i]))
            metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "weights": _np(jtr.merge_bn_state(
        state.params, state.model_state))}
    if state.ema_params is not None:
        out["ema"] = _np(jtr.merge_bn_state(state.ema_params,
                                            state.model_state))
    if state.sampler_state is not None:
        out["sampler"] = (np.asarray(state.sampler_state.loss_counts),
                          np.asarray(state.sampler_state.loss_history))
    return out


def _correction_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        _, _, pts, human = correction_geometry(seed + i, B=B, T=T, V=96,
                                               P=48)
        human[B // 2:, ..., :3] *= 1.5
        markers = human[:, :, rng.integers(0, 96, M)].copy()
        markers[..., 6] = rng.random(markers.shape[:3]) < 0.2
        markers[1, ..., 6] = 0.0
        out.append({
            "obj_angles": (rng.standard_normal((B, T, 3))
                           * 0.5).astype(np.float32),
            "obj_trans": (np.array([0.3, 0.0, 0.0]) + rng.standard_normal(
                (B, T, 3)) * 0.05).astype(np.float32),
            "markers": markers, "human_verts": human, "obj_points": pts})
    return out


def _jax_correction(kind):
    mesh = jmake_mesh(data=2)
    shadowed = ranks.SHADOWED
    if kind == "correction_smpl":
        kw = dict(num_markers=M, n_pre=N_PRE, past_len=4, future_len=6)
        proj = jcorr.ObjProjectorSmpl(**kw)
        variables = jax.device_get(jax.jit(lambda: proj.init(
            jax.random.PRNGKey(1), jnp.zeros((2, T, 9)),
            jnp.zeros((2, T, M, 3)), jnp.zeros((2, M))))())
        step = jtr.make_correction_smpl_train_step(proj)
        batches = _correction_batches(10)
        epochs = [8.0 + 6 * i for i in range(STEPS)]
    else:
        kw = dict(num_joints=21, past_len=4, future_len=6)
        proj = jcorr.ObjProjectorSkeleton(**kw)
        rng = np.random.default_rng(12)
        batches = []
        for b in synthetic_skeleton_batches(rng, batch_size=B, seq_len=T,
                                            steps=STEPS):
            b = {k: b[k].copy() for k in ("skeleton", "poses")}
            b["skeleton"][B // 2:] = b["skeleton"][B // 2:] * 2.0 + 0.5
            batches.append(b)
        ex = batches[0]
        variables = jax.device_get(jax.jit(lambda: proj.init(
            jax.random.PRNGKey(2), jnp.asarray(ex["poses"][..., 3:7]),
            jnp.asarray(ex["poses"][..., :3]),
            jnp.asarray(ex["skeleton"])))())
        step = jtr.make_correction_skeleton_train_step(proj)
        epochs = [0.0] * STEPS
    state = _replicated(jtr.CorrectionTrainState.create(
        variables, optax.adam(LR)), mesh)
    dp = jtr.data_parallel_step(step, mesh, extra_args=2)
    key = jax.random.PRNGKey(5)
    metrics, draws, shadows = [], [], []
    for i, b in enumerate(batches):
        key, k = jax.random.split(key)
        state, m = dp(state, dp.place_batch(
            {n: jnp.asarray(v) for n, v in b.items()}), k,
            jnp.asarray(epochs[i], jnp.float32))
        metrics.append({n: float(v) for n, v in m.items()})
        if kind == "correction_smpl":
            contact = b["markers"][:, kw["past_len"]:, :, 6].sum(1)
            draws.append(np.asarray(jax.random.categorical(
                k, jnp.log(jnp.asarray(contact) + hand_bias_vector(M)))))
        now = _np({"params": state.params})
        shadows.append({n: v for n, v in now.items()
                        if n.endswith(shadowed)})
    case = {"kind": kind, "kw": kw, "init": _np(variables),
            "batches": batches, "epochs": epochs, "shadow": shadows}
    if draws:
        case["marker_idx"] = np.stack(draws).astype(np.int64)
    return case, {"metrics": metrics, "weights": _np(
        {"params": state.params, "batch_stats": state.batch_stats})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on the 2-device mesh, the port at one rank here and at two
    spawned ranks, every case."""
    rng = np.random.default_rng(10)
    jmodel = JTrack(**SMALL).build_model()
    variables = jax.device_get(jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((B, T, 144)),
        jnp.zeros((B, P, 6)), jnp.zeros((B,), jnp.int32),
        method=JMDM.init_forward))())
    variables = {"params": variables["params"], "batch_stats": {
        "pcEmbedding": jax.tree.map(
            lambda v: (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32), variables["batch_stats"]["pcEmbedding"])}}
    batches = _smpl_batches(rng)
    ts = rng.integers(0, 1000, (STEPS, B)).astype(np.int32)
    ts[:, 3] = ts[:, 0]  # two equal t across the ranks' halves
    noises = rng.standard_normal((STEPS, B, T, 144)).astype(np.float32)

    jax_out, cases = {}, {}
    for name, opts in SMPL_CASES.items():
        jax_out[name] = _jax_smpl(variables, opts, batches, ts, noises)
        cases[name] = dict(kind="smpl", track=SMALL,
                           init=_np(variables), batches=[
                               {k: b[k] for k in KEYS} for b in batches],
                           t=ts, noise=noises, **opts)
    cases["chain"] = dict(cases["default_ema"], chain=True)
    for name in ("correction_smpl", "correction_skeleton"):
        cases[name], jax_out[name] = _jax_correction(name)

    one = make_mesh(device="cpu")
    world1 = {name: ranks.run_case(case, one) for name, case in cases.items()}
    two = launch(ranks.train_cases, 2, args=({"cases": cases,
                                             "local": LOCAL},),
                 device="cpu", init_dir=str(tmp_path_factory.mktemp("rdv")),
                 timeout=600, collective_timeout=60)
    return {"jax": jax_out, "world1": world1, "world2": two, "cases": cases}


def _tols(name):
    if name == "bn_train_mode":
        return 1e-4, 1e-3
    return 1e-5, 1e-4


def _close_metrics(got, want, name):
    first, later = _tols(name)
    assert len(got) == len(want) == STEPS
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        tol = first if i == 0 else later
        for k in w:
            err = abs(g[k] - w[k])
            worst = max(worst, err / tol)
            assert err <= tol * max(1.0, abs(w[k])), (name, i, k, g[k], w[k])
    return worst


def _close_weights(got, want, name, start=None):
    assert set(got) == set(want)
    if name.startswith("correction"):
        for k, w in want.items():
            tol = 1e-5 if k.endswith(("running_mean", "running_var")) \
                else 1e-4
            np.testing.assert_allclose(got[k], w, rtol=0, atol=tol,
                                       err_msg=f"{name}: {k}")
        return
    diffs = []
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * STEPS * LR, (name, k, float(d.max()))
        diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() < LR / 100, name


@pytest.mark.parametrize("name", JAX_CASES)
def test_two_ranks_match_jax_data_parallel_step(runs, name):
    """Rank 0 of the port's two against JAX's 2-device mesh: metrics of
    every step, the weights after three steps (BatchNorm statistics
    included), the EMA shadow, the resampler's state."""
    want, got = runs["jax"][name], runs["world2"][0][name]
    _close_metrics(got["metrics"], want["metrics"], name)
    _close_weights(got["weights"], want["weights"], name)
    assert got["step"] == STEPS
    if "ema" in want:
        _close_weights(got["ema"], want["ema"], name)
    if "sampler" in want:
        np.testing.assert_array_equal(got["sampler"][0], want["sampler"][0])
        np.testing.assert_allclose(got["sampler"][1], want["sampler"][1],
                                   atol=1e-5, rtol=1e-5)
        # every rank's pairs folded in: 4 a step, t repeated across ranks
        assert int(got["sampler"][0].sum()) == STEPS * B
        assert int(got["sampler"][0].max()) == 2
    if name.startswith("correction"):
        assert got["shadow_dev"] <= 2 * LR and got["shadow_grad"] < 1e-6


@pytest.mark.parametrize("name", JAX_CASES + ["chain"])
def test_two_ranks_match_one_rank(runs, name):
    """Two ranks on their halves against one rank on the whole batch."""
    want, got = runs["world1"][name], runs["world2"][0][name]
    _close_metrics(got["metrics"], want["metrics"], name)
    _close_weights(got["weights"], want["weights"], name)
    for part in ("ema", "sampler"):
        assert (part in got) == (part in want)


def test_chain_steps_is_three_steps(runs):
    """`chain_steps` under the mesh (batch axis 1) is three sequential
    steps under it."""
    a, b = runs["world2"][0]["chain"], runs["world2"][0]["default_ema"]
    _close_metrics(a["metrics"], b["metrics"], "chain")
    for k, v in b["weights"].items():
        np.testing.assert_array_equal(a["weights"][k], v, err_msg=k)


def test_ranks_hold_equal_state(runs):
    """Parameters, statistics, shadow and resampler bitwise equal on both
    ranks, and the same global metrics."""
    r0, r1 = runs["world2"]
    for name in JAX_CASES + ["chain"]:
        assert r0[name]["metrics"] == r1[name]["metrics"], name
        for part in ("weights", "ema"):
            for k, v in r0[name].get(part, {}).items():
                np.testing.assert_array_equal(r1[name][part][k], v,
                                              err_msg=f"{name} {part} {k}")
        if "sampler" in r0[name]:
            for a, b in zip(r0[name]["sampler"], r1[name]["sampler"]):
                np.testing.assert_array_equal(a, b)


@pytest.fixture
def one_rank_group(tmp_path):
    """A process group of one gloo rank in this process, for the test's
    span alone: a mesh that has a group and nobody to talk to."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.size == 1 and mesh.group is not None
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", JAX_CASES + ["chain", "dropout"])
def test_one_rank_mesh_is_the_plain_step(runs, one_rank_group, monkeypatch,
                                         name):
    """A data mesh of one rank, with its process group, computes the step
    without a mesh bit for bit: the BatchNorm statistics are the local ones
    (no sum goes through the all-reduce: on the CPU the sums would give the
    same bits, on the card they do not), the dropout masks come from the
    step's generator (case ``dropout``: the skeleton correction step with
    dropout 0.25 and a seeded generator), the loss and metrics are
    undivided."""
    from interdiff_torch.models import layers

    if name == "dropout":
        case = runs["cases"]["correction_skeleton"]
        case = dict(case, kw=dict(case["kw"], dropout=0.25), seed=5)
    else:
        case = runs["cases"][name]
    summed = []
    real = layers.all_reduce_sum
    monkeypatch.setattr(layers, "all_reduce_sum", lambda x, mesh: (
        summed.append(x.shape), real(x, mesh))[1])
    got = ranks.run_case(case, one_rank_group)
    assert summed == [], summed
    want = ranks.run_case(case, None)
    assert got["metrics"] == want["metrics"], name
    for k, v in want["weights"].items():
        np.testing.assert_array_equal(got["weights"][k], v, err_msg=k)
    assert set(got) == set(want)
    for k, v in want.get("ema", {}).items():
        np.testing.assert_array_equal(got["ema"][k], v, err_msg=k)
    for a, b in zip(got.get("sampler", ()), want.get("sampler", ())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", LOCAL)
def test_local_statistics_fall_outside(runs, name):
    """The copy whose ranks normalise by their own halves misses JAX's
    step by far more than the tolerances: the chosen batches can tell
    global statistics from local ones."""
    want, got = runs["jax"][name], runs["world2"][0]["local_" + name]
    first, _ = _tols(name)
    err = max(abs(g[k] - w[k]) for g, w in zip(got["metrics"],
                                               want["metrics"]) for k in w)
    assert err > 100 * first, err
    stats = [k for k in want["weights"]
             if k.endswith(("running_mean", "running_var"))]
    assert stats
    moved = max(float(np.abs(got["weights"][k] - want["weights"][k]).max())
                for k in stats)
    assert moved > 100 * 1e-5, moved
