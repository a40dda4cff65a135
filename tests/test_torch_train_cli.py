"""The port's training entry point
(`interdiff_torch/cli/train_diffusion_smpl.py`) on the CPU with tiny models,
driven as `tests/test_cli_train_smoke.py` drives the JAX package's: argument
wiring, synthetic batches, the train loop, validation, the checkpoints and
`metrics.jsonl`; and `utils/train_io.py`."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from interdiff_torch.cli import train_diffusion_smpl as cli  # noqa: E402
from interdiff_torch.config import SmplTrackConfig  # noqa: E402
from interdiff_torch.utils import train_io  # noqa: E402
from interdiff_torch.utils.convert import load_state_dict  # noqa: E402

TINY = ["--device", "cpu", "--batch_size", "2", "--embedding_dim", "32",
        "--ff_size", "64", "--num_layers", "2", "--synthetic_points", "64",
        "--val_respacing", "4"]


def _rows(results_dir):
    path = os.path.join(results_dir, "metrics.jsonl")
    rows = [json.loads(line) for line in open(path)]
    assert rows and all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
    return rows


def _latest(results_dir, sub="ckpt"):
    mgr = train_io.CheckpointManager(os.path.join(results_dir, sub))
    return mgr.latest_step, mgr.restore()


def test_synthetic_run_trains_validates_and_saves(tmp_path, capsys):
    state, summary = cli.main(TINY + ["--synthetic", "3", "--results_dir",
                                      str(tmp_path)])
    out = capsys.readouterr().out
    assert "step 0 loss" in out and "val_loss" in out
    assert "done: 3 steps" in out
    assert state.step == summary["steps"] == 3
    rows = _rows(str(tmp_path))
    val = [r for r in rows if "val_loss" in r]
    assert len(val) == 1 and val[0]["step"] == 3
    assert np.isfinite(val[0]["val_loss"]) and len(summary["val_terms"][0]) == 16
    step, saved = _latest(str(tmp_path))
    assert step == 3 and not os.path.exists(tmp_path / "ckpt_ema")
    # the checkpoint is the trained weights, and every entry point loads it
    model = SmplTrackConfig(embedding_dim=32, ff_size=64,
                            num_layers=2).build_model("cpu")
    model.load_state_dict(saved, strict=True)
    for name, p in state.params.items():
        assert torch.equal(saved[name], p.detach()), name
    # default mode: the BatchNorm statistics are optimised parameters
    assert "pcEmbedding.sa0.mlp0.bn0.running_var" in state.params
    assert state.model_state is None


def test_val_diverse_logs_min_terms(tmp_path, capsys):
    cli.main(TINY + ["--synthetic", "2", "--val_diverse", "2",
                     "--results_dir", str(tmp_path)])
    capsys.readouterr()
    val = [r for r in _rows(str(tmp_path)) if "val_loss" in r][-1]
    assert "body_rot_future_min" in val and "obj_nonrot_v_past_min" in val
    assert val["body_rot_future_min"] <= val["body_rot_future"] + 1e-6


def test_ema_decay_saves_a_distinct_shadow(tmp_path, capsys):
    state, _ = cli.main(TINY + ["--synthetic", "2", "--ema_decay", "0.5",
                                "--results_dir", str(tmp_path)])
    capsys.readouterr()
    step, raw = _latest(str(tmp_path))
    step_ema, ema = _latest(str(tmp_path), "ckpt_ema")
    assert step == step_ema == 2 and set(raw) == set(ema)
    assert any(float((raw[k] - ema[k]).abs().max()) > 1e-7 for k in raw)
    name = "bodyFinalLinear.weight"
    assert torch.equal(ema[name], state.ema_params[name])


def test_steps_per_dispatch_chains_and_drops_a_partial_stack(tmp_path,
                                                             capsys):
    state, _ = cli.main(TINY + ["--synthetic", "3", "--steps_per_dispatch",
                                "2", "--results_dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out and state.step == 2
    assert "WARNING: steps_per_dispatch=2: dropped trailing partial stack " \
           "of 1 batch(es)" in out
    _rows(str(tmp_path / "a"))
    with pytest.raises(SystemExit, match="NO full stack"):
        cli.main(TINY + ["--synthetic", "1", "--steps_per_dispatch", "2",
                         "--results_dir", str(tmp_path / "b")])


def test_bn_train_mode_keeps_statistics_out_of_the_optimiser(tmp_path,
                                                             capsys):
    state, _ = cli.main(TINY + ["--synthetic", "2", "--bn_train_mode", "1",
                                "--ema_decay", "0.5", "--results_dir",
                                str(tmp_path)])
    assert "val_loss" in capsys.readouterr().out
    stats = [n for n in state.model_state]
    assert len(stats) == 24 and not any(
        n.endswith(("running_mean", "running_var")) for n in state.params)
    assert not any(p.requires_grad for p in state.model_state.values())
    optimised = {id(p) for g in state.optimizer.param_groups
                 for p in g["params"]}
    assert not optimised & {id(p) for p in state.model_state.values()}
    fresh = SmplTrackConfig(embedding_dim=32, ff_size=64,
                            num_layers=2).build_model("cpu").state_dict()
    assert any(float((state.model_state[n] - fresh[n]).abs().max()) > 1e-3
               for n in stats)  # moved by momentum
    # both checkpoints are whole state dicts, statistics included
    _, raw = _latest(str(tmp_path))
    _, ema = _latest(str(tmp_path), "ckpt_ema")
    assert set(raw) == set(ema) == set(fresh)
    assert torch.equal(ema[stats[0]], raw[stats[0]])


def test_loss_aware_sampler_and_resume(tmp_path, capsys):
    state, _ = cli.main(TINY + ["--synthetic", "2", "--schedule_sampler",
                                "loss-second-moment", "--results_dir",
                                str(tmp_path / "a")])
    assert int(state.sampler_state.loss_counts.sum()) == 2 * 2
    step, saved = _latest(str(tmp_path / "a"))
    path = os.path.join(tmp_path, "a", "ckpt", f"step_{step}.pt")
    assert set(load_state_dict(path)) == set(saved)
    seen = {}
    real = cli.train

    def spy(model, *args, **kwargs):
        seen["start"] = {k: v.detach().clone()
                         for k, v in model.state_dict().items()}
        return real(model, *args, **kwargs)

    cli.train = spy
    try:
        cli.main(TINY + ["--synthetic", "1", "--resume_checkpoint", path,
                         "--results_dir", str(tmp_path / "b")])
    finally:
        cli.train = real
    assert "resumed parameters from" in capsys.readouterr().out
    for k, v in saved.items():
        assert torch.equal(seen["start"][k], v), k


def test_flags_of_unported_routes_are_unknown(tmp_path):
    # data parallel (--mesh_devices) is not ported; the validation renders
    # are, and a negative interval stops
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--mesh_devices", "2"])
    assert cli.build_parser().parse_args(
        ["--render_interval", "2"]).render_interval == 2
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--synthetic", "1", "--render_interval",
                  "-1", "--results_dir", str(tmp_path)])
    # the linear object encoder is ported
    assert cli.build_parser().parse_args(
        ["--use_pointnet2", "0"]).use_pointnet2 == 0
    # the dataset route's flags are known; an incomplete route stops
    for argv in ([], ["--motion_path", "x"], ["--model_path", "x"],
                 ["--synthetic_body"], ["--synthetic", "1", "--config", "x"]):
        with pytest.raises(SystemExit):
            cli.main(["--device", "cpu", "--results_dir", str(tmp_path)]
                     + argv)
    assert not os.path.exists(tmp_path / "ckpt")


def test_checkpoint_manager_keeps_the_best(tmp_path):
    mgr = train_io.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step, loss in ((1, 0.5), (2, 0.9), (3, 0.7), (4, 0.7)):
        mgr.save(step, {"w": torch.full((2,), float(step))}, val_loss=loss)
    kept = sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt"))
    assert kept == ["step_1.pt", "step_4.pt"]  # lowest losses, newer at a tie
    assert mgr.latest_step == 4
    assert torch.equal(mgr.restore()["w"], torch.full((2,), 4.0))
    assert torch.equal(mgr.restore(1)["w"], torch.full((2,), 1.0))
    again = train_io.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert again.latest_step == 4
    again.save(5, {"w": torch.zeros(2)})  # no val_loss: ranked last
    assert not os.path.exists(tmp_path / "step_5.pt")
    mgr.wait()


def test_metrics_logger_and_quartiles(tmp_path):
    import jax.numpy as jnp

    from interdiff_tpu.utils.train_io import quartile_metrics as j_quartiles

    log = train_io.MetricsLogger(str(tmp_path / "sub" / "m.jsonl"))
    log.log(3, {"loss": torch.tensor(0.25), "vec": np.arange(2)}, epoch=1,
            tag="x")
    log.close()
    row = json.loads(open(tmp_path / "sub" / "m.jsonl").read())
    assert row["step"] == 3 and row["loss"] == 0.25 and row["vec"] == [0, 1]
    assert row["epoch"] == 1 and row["tag"] == "x" and "t" in row

    t = np.array([0, 249, 250, 999, 600, 10], np.int32)
    loss = np.arange(6, dtype=np.float32)
    got = train_io.quartile_metrics(torch.from_numpy(t).long(),
                                    torch.from_numpy(loss), 1000)
    want = j_quartiles(jnp.asarray(t), jnp.asarray(loss), 1000)
    assert set(got) == set(want) == {"q0", "q1", "q2", "q3"}
    for k in got:
        assert abs(float(got[k]) - float(want[k])) < 1e-6
