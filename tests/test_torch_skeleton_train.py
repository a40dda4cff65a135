"""Skeleton-track training of the port against `interdiff_tpu` on the CPU,
and both skeleton entry points end to end.

`skeleton_diffusion_losses` (13 terms) within 1e-5.  One
`make_skeleton_train_step` of a small model (2 + 2 layers, width 32) from
the same flax weights, moved over by the weight bridge, with the same batch,
timesteps and noise: JAX draws those from a key PyTorch cannot reproduce, so
the JAX step's two draws (`sample_timesteps`, `jax.random.normal`) are
patched to hand back the test's arrays, and its gradients are read from the
state of a pass-through optax stage chained before AdamW.  Loss and terms
within 1e-5; every gradient tensor within 1e-4 of its largest entry plus
1e-6; the weights after the AdamW step within 2 * lr (Adam turns a gradient
that is rounding noise into a step of up to lr).

The entry points run with ``--device cpu --synthetic 2`` (the trainer at
width 32, the evaluator at full width on a 10-step respacing) and on HO-GCN
pickles written to `tmp_path`."""

import ast
import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import SkeletonTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.models.mdm_skeleton import MDMSkeleton as JMDM  # noqa: E402
from interdiff_tpu.train import losses as jlosses  # noqa: E402
from interdiff_tpu.train import trainer as jtr  # noqa: E402
from interdiff_torch.cli import eval_skeleton, train_diffusion_skeleton  # noqa: E402
from interdiff_torch.config import (  # noqa: E402
    CorrectionConfig,
    SkeletonTrackConfig,
)
from interdiff_torch.data.skeleton import pose_to_keypoints  # noqa: E402
from interdiff_torch.train import losses as tlosses  # noqa: E402
from interdiff_torch.train import trainer as ttr  # noqa: E402
from interdiff_torch.utils.convert import (  # noqa: E402
    flax_to_torch_state_dict,
    save_state_dict,
)
from interdiff_torch.utils.train_io import CheckpointManager  # noqa: E402
from test_torch_mdm_skeleton import redrawn, skeleton_inputs  # noqa: E402

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=32, num_layers=2)
B, T, LR = 2, 20, 3e-4
KEYS = ("skeleton", "obj_points", "poses", "zero_pose_obj")


@pytest.mark.parametrize("weights", [
    {}, dict(past=1.0, body=0.5, obj=3.0, obj_rot=0.2, obj_nonrot=2.0,
             quat_reg=0.1, v=0.3)])
def test_skeleton_losses_match_jax(weights):
    rng = np.random.default_rng(50)
    pred, gt = (rng.standard_normal((3, T, 106)).astype(np.float32)
                for _ in range(2))
    want, want_terms = jlosses.skeleton_diffusion_losses(
        jnp.asarray(pred), jnp.asarray(gt), past_len=10,
        weights=jlosses.SkeletonLossWeights(**weights))
    got, terms = tlosses.skeleton_diffusion_losses(
        torch.from_numpy(pred), torch.from_numpy(gt), past_len=10,
        weights=tlosses.SkeletonLossWeights(**weights))
    assert list(terms) == list(want_terms) and len(terms) == 13
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(want_terms[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def _capture_grads():
    """Pass-through optax stage whose state is the last gradient tree."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def test_train_step_matches_jax(monkeypatch):
    rng = np.random.default_rng(51)
    batch = dict(zip(KEYS, skeleton_inputs(rng)))
    t = np.array([917, 4], np.int32)
    noise = rng.standard_normal((B, T, 106)).astype(np.float32)
    jtrack = JTrack(**SMALL)
    jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()
    variables = redrawn(jax.jit(lambda *a: jmodel.init(
        jax.random.PRNGKey(0), *a, jnp.zeros((B,), jnp.int32),
        method=JMDM.init_forward))(*(batch[k] for k in KEYS)), 52)

    monkeypatch.setattr(jtr, "sample_timesteps", lambda key, b, n: (
        jnp.asarray(t), jnp.ones((b,), jnp.float32)))
    real_normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: (
        jnp.asarray(noise) if tuple(shape) == (B, T, 106)
        else real_normal(key, shape, *a, **k)))
    jstate = jtr.TrainState.create(
        variables, optax.chain(_capture_grads(), jtr.adamw(LR)))
    jstate, jm = jax.jit(jtr.make_skeleton_train_step(jmodel, jdiff))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))

    track = SkeletonTrackConfig(**SMALL)
    model = track.build_model("cpu")
    start = flax_to_torch_state_dict(variables)
    model.load_state_dict(start, strict=True)
    state = ttr.TrainState.create(dict(model.named_parameters()),
                                  ttr.adamw(LR))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_array_equal(
        ttr.skeleton_gt_from_batch(tb).numpy(),
        np.asarray(jtr.skeleton_gt_from_batch(
            {k: jnp.asarray(v) for k, v in batch.items()})))
    state, tm = ttr.make_skeleton_train_step(
        model, track.diffusion.build("cpu"))(
            state, tb, t=torch.from_numpy(t).long(),
            noise=torch.from_numpy(noise))

    assert state.step == 1 and set(tm) == set(jm) and len(tm) == 14
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    want = flax_to_torch_state_dict(jax.device_get(jstate.opt_state[0]))
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        g = named[name].grad
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-6, (name, err)
    after = flax_to_torch_state_dict(jax.device_get(jstate.params))
    for name, w in after.items():
        assert float((named[name].detach() - w).abs().max()) <= 2 * LR, name
    assert max(float((after[n] - start[n]).abs().max()) for n in after) > LR / 2


def _rows(path):
    rows = [json.loads(line) for line in open(path)]
    assert rows and all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
    return rows


def test_train_cli_synthetic(tmp_path, capsys):
    state, summary = train_diffusion_skeleton.main([
        "--device", "cpu", "--synthetic", "2", "--batch_size", "2",
        "--embedding_dim", "32", "--ff_size", "32", "--num_layers", "2",
        "--val_respacing", "5", "--ema_decay", "0.5", "--results_dir",
        str(tmp_path)])
    out = capsys.readouterr().out
    assert "step 0 loss" in out and "done: 2 steps" in out
    assert state.step == summary["steps"] == 2
    val = [r for r in _rows(tmp_path / "metrics.jsonl") if "mpjpe_h" in r]
    assert len(val) == 1 and val[0]["split"] == "valid"
    assert all(np.isfinite(val[0][k]) for k in (
        "mpjpe_h", "mpjpe_o", "translation_error", "rotation_error"))
    for sub in ("ckpt", "ckpt_ema"):
        mgr = CheckpointManager(str(tmp_path / sub))
        saved = mgr.restore()
        assert mgr.latest_step == 2
        model = SkeletonTrackConfig(**SMALL).build_model("cpu")
        model.load_state_dict(saved, strict=True)
    name = "bodyFinalLinear.weight"
    assert torch.equal(saved[name], state.ema_params[name])
    assert not torch.equal(saved[name], state.params[name].detach())

    # --steps_per_dispatch stacks batches; --resume_checkpoint reads ckpt/
    resume = str(tmp_path / "ckpt" / "step_2.pt")
    state, summary = train_diffusion_skeleton.main([
        "--device", "cpu", "--synthetic", "4", "--batch_size", "2",
        "--embedding_dim", "32", "--ff_size", "32", "--num_layers", "2",
        "--val_respacing", "5", "--steps_per_dispatch", "2",
        "--resume_checkpoint", resume, "--results_dir",
        str(tmp_path / "resumed")])
    assert "resumed parameters" in capsys.readouterr().out
    assert summary["steps"] == 4 and state.step == 4


def test_eval_cli_synthetic(tmp_path, capsys):
    ckpts = []
    for seed, build in enumerate((
            SkeletonTrackConfig(future_len=10).build_model,
            CorrectionConfig(track="skeleton", num_nodes=21,
                             future_len=10).build_model)):
        torch.manual_seed(100 + seed)  # weights other than the CLI's own
        ckpts.append(str(tmp_path / f"{seed}.pt"))
        save_state_dict(ckpts[-1], build("cpu").state_dict())
    totals, n = eval_skeleton.main([
        "--device", "cpu", "--synthetic", "2", "--batch_size", "2",
        "--respacing", "10", "--rollouts", "1", "--diffusion_ckpt",
        ckpts[0], "--correction_ckpt", ckpts[1]])
    lines = capsys.readouterr().out.splitlines()
    assert n == 2 and set(totals) == {"mpjpe_h", "mpjpe_o",
                                      "translation_error", "rotation_error"}
    assert all(np.isfinite(v) and v >= 0 for v in totals.values())
    assert lines.count("rollout: 30 frames total") == 2
    # the running mean, printed as the JAX CLI prints it
    running = ast.literal_eval(lines[-1])
    assert running == {k: round(v / n, 5) for k, v in totals.items()}


def test_evaluate_counts_firings_and_rollout(capsys):
    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.eval.skeleton import SkeletonEvalConfig

    model = SkeletonTrackConfig(**SMALL).build_model("cpu")
    projector = CorrectionConfig(track="skeleton", num_nodes=21,
                                 future_len=10).build_model("cpu")
    batch = dict(zip(KEYS, skeleton_inputs(np.random.default_rng(53))))
    trace, timings, out = [], {}, []
    totals, n = eval_skeleton.evaluate(
        SkeletonEvalConfig(), model,
        DiffusionConfig(diffusion_steps=100).build("cpu"), [batch],
        projector=projector, rollouts=2, trace=trace, timings=timings,
        forecasts=out, generator=torch.Generator().manual_seed(0))
    capsys.readouterr()
    assert n == 1 and [e["t"] for e in trace] == [50, 0] * 3
    assert set(timings) == {"encode", "sampler", "metrics"}
    assert out[0]["body"].shape == (B, 40, 21, 3)
    assert out[0]["pose"].shape == (B, 40, 7)
    assert all(bool(torch.isfinite(v).all()) for v in out[0].values())


def _write_sequences(root, rng):
    for i, (name, n) in enumerate((("box1", 330), ("chair3", 330))):
        d = root / f"seq{i}"
        d.mkdir(parents=True)
        q = rng.standard_normal((n, 4)) * 0.05 + [0.0, 0.0, 0.0, 1.0]
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        poses = np.concatenate([rng.standard_normal((n, 3)) * 0.1, q], -1)
        obj = pose_to_keypoints(rng.standard_normal((12, 3)) * 0.2, poses)
        with open(d / f"subj_{name}_take{i}.pkl", "wb") as f:
            pickle.dump([[rng.standard_normal((n, 21, 3)).tolist(),
                          np.ones((n, 1)).tolist(), poses.tolist(),
                          obj.tolist()]], f)


def test_entry_points_on_pickles(tmp_path, capsys):
    """``--motion_path``: the trainer on the train split with a validation
    batch of the valid split, the evaluator on the seen and unseen test
    splits (8 clips of each object; the seen ones split 5 / 1 / 2)."""
    data = tmp_path / "data"
    _write_sequences(data, np.random.default_rng(54))
    state, summary = train_diffusion_skeleton.main([
        "--device", "cpu", "--motion_path", str(data), "--batch_size", "2",
        "--embedding_dim", "32", "--ff_size", "32", "--num_layers", "2",
        "--epochs", "1", "--val_every", "1", "--val_respacing", "5",
        "--results_dir", str(tmp_path / "train")])
    assert summary["steps"] == 2 and len(summary["val"]) == 1
    totals, n = eval_skeleton.main([
        "--device", "cpu", "--motion_path", str(data), "--batch_size", "2",
        "--respacing", "5", "--mode", "no_correction"])
    out = capsys.readouterr().out
    assert "only 1 clip windows" in out  # the valid split, one batch of 1
    assert "--- seen split: 2 clips ---" in out
    assert "--- unseen split: 8 clips ---" in out
    assert n == 5 and all(np.isfinite(v) for v in totals.values())
    assert os.path.exists(data / "ds_seen.pkl")
