"""The dataset routes of the port's SMPL entry points on the CPU, on a tiny
corpus written by `chip_smoke.write_behave_corpus` (one train and one test
sequence of 80 frames, 128 object points) with the 128-vertex stand-in body
as its SMPLH pkls: `eval_smpl_short`, `train_diffusion_smpl`,
`train_correction_smpl` (every field of a clip, so on the 6890-vertex
stand-in body of ``--synthetic_body``), `optimization` (ground-truth clips,
and generate-then-refine) and `eval_smpl_long`, each through `main`; the
long eval's synthetic route writes 60-frame rollouts and a 2-window
`drift_metrics.json`; the flags still unported, a missing object mesh and
a negative render interval stop with a clear error."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the writer of the card's corpus)
from interdiff_torch.cli import eval_smpl_long  # noqa: E402
from interdiff_torch.cli import eval_smpl_short  # noqa: E402
from interdiff_torch.cli import optimization  # noqa: E402
from interdiff_torch.cli import train_correction_smpl  # noqa: E402
from interdiff_torch.cli import train_diffusion_smpl  # noqa: E402
from interdiff_torch.cli.common import synthetic_smpl_body  # noqa: E402


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    body = synthetic_smpl_body(np.random.default_rng(40), device="cpu")
    motion_path, model_path = chip_smoke.write_behave_corpus(
        str(root), body, np.random.default_rng(41), sequences=1, frames=80,
        points=128)
    return motion_path, model_path


def _data(corpus):
    return ["--device", "cpu", "--motion_path", corpus[0], "--model_path",
            corpus[1]]


def test_eval_short_dataset_route(corpus):
    totals, nb = eval_smpl_short.main(_data(corpus) + [
        "--batch_size", "2", "--diverse_samples", "2", "--respacing", "3"])
    # 80 frames: two windows of 35 in the Date03 sequence, one batch
    assert nb == 1 and len(totals) == 6
    assert all(np.isfinite(v) for v in totals.values())


def test_eval_short_reads_a_path_config(corpus, tmp_path):
    cfg = tmp_path / "BEHAVE.yml"
    cfg.write_text(f"MOTION_PATH: {corpus[0]}\nMODEL_PATH: {corpus[1]}\n")
    totals, nb = eval_smpl_short.main([
        "--device", "cpu", "--config", str(cfg), "--batch_size", "2",
        "--diverse_samples", "2", "--respacing", "2", "--mode",
        "no_correction"])
    assert nb == 1 and np.isfinite(totals["penetrate"])


def test_train_diffusion_dataset_route(corpus, tmp_path):
    state, summary = train_diffusion_smpl.main(_data(corpus) + [
        "--batch_size", "2", "--epochs", "2", "--val_every", "2",
        "--embedding_dim", "32", "--ff_size", "32", "--num_layers", "2",
        "--val_respacing", "3", "--results_dir", str(tmp_path)])
    # one batch of the 2 train windows an epoch, one validation (on the
    # test split's first batch) after the second epoch
    assert summary["steps"] == 2 and len(summary["val_loss"]) == 1
    assert np.isfinite(summary["val_loss"][0])
    assert os.listdir(tmp_path / "ckpt")
    with open(tmp_path / "metrics.jsonl") as f:
        assert any("val_loss" in json.loads(line) for line in f)


def test_train_correction_dataset_route(corpus, tmp_path):
    state, summary = train_correction_smpl.main([
        "--device", "cpu", "--motion_path", corpus[0], "--synthetic_body",
        "--batch_size", "4", "--epochs", "1", "--past_len", "4",
        "--future_len", "4", "--dct", "4", "--results_dir", str(tmp_path)])
    # 80 frames in windows of 8: 10 clips, 2 full batches of 4
    assert summary["steps"] == 2 and np.isfinite(summary["loss"])
    assert os.listdir(tmp_path / "ckpt")


def test_refine_dataset_route(corpus, tmp_path):
    summary = optimization.main(_data(corpus) + [
        "--iters", "3", "--limit", "3", "--batch_size", "2", "--past_len",
        "3", "--future_len", "3", "--out_dir", str(tmp_path)])
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == summary
    assert summary["clips"] == 3 and summary["mode"] == "dataset"
    assert all(np.isfinite(summary[k]) for k in optimization.PENETRATION_KEYS)
    assert sorted(os.listdir(tmp_path)) == [
        "clip_0.npz", "clip_1.npz", "clip_2.npz", "summary.json"]
    clip = np.load(tmp_path / "clip_2.npz")
    assert clip["pose"].shape == (6, 156) and clip["terms"].shape == (3, 6)


def test_generate_then_refine_dataset_route(corpus, tmp_path):
    summary = optimization.main(_data(corpus) + [
        "--diffusion_ckpt", "", "--iters", "2", "--respacing", "2",
        "--batch_size", "2", "--limit", "1", "--out_dir", str(tmp_path)])
    assert summary["batches"] == 1
    assert np.load(tmp_path / "refined_1.npz")["pose"].shape == (2, 20, 156)


def test_eval_long_dataset_route(corpus, tmp_path):
    assert eval_smpl_long.main(_data(corpus) + [
        "--rollouts", "1", "--respacing", "2", "--mode", "correction",
        "--out_dir", str(tmp_path)]) is None
    # horizon 10 + 2 * 25 = 60 of 80 frames: one clip, the batch shrunk
    assert np.load(tmp_path / "rollout_0.npy").shape == (1, 60, 144)
    with open(tmp_path / "drift_metrics.json") as f:
        assert len(json.load(f)) == 2


def test_eval_long_synthetic_route(tmp_path):
    eval_smpl_long.main(["--device", "cpu", "--synthetic", "1",
                         "--rollouts", "1", "--batch_size", "2",
                         "--respacing", "2", "--out_dir", str(tmp_path)])
    full = np.load(tmp_path / "rollout_0.npy")
    assert full.shape == (2, 60, 144) and np.isfinite(full).all()
    with open(tmp_path / "drift_metrics.json") as f:
        drift = json.load(f)
    assert len(drift) == 2
    assert all(set(w) == set(eval_smpl_long.WINDOW_METRICS) and all(
        np.isfinite(v) for v in w.values()) for w in drift)


@pytest.mark.parametrize("module,argv,message", [
    (eval_smpl_short, ["--synthetic", "1", "--render_dir", "x",
                       "--obj_mesh", "x.stl"], "not an .obj or .ply file"),
    (eval_smpl_short, ["--synthetic", "1", "--obj_mesh", "x.ply"],
     "no such file"),
    (eval_smpl_long, ["--synthetic", "1", "--render_dir", "x",
                      "--obj_mesh", "x.stl"], "not an .obj or .ply file"),
    (eval_smpl_long, ["--synthetic", "1", "--obj_mesh", "x.ply"],
     "no such file"),
    (train_correction_smpl, ["--synthetic", "1", "--render_interval", "-1"],
     "--render_interval must be 0 or more"),
    (optimization, ["--synthetic", "1", "--dispatch_chunk", "2"],
     "no bounded dispatches"),
    (eval_smpl_long, ["--synthetic", "1", "--motion_path", "x"],
     "two data routes"),
    (train_diffusion_smpl, ["--motion_path", "x"],
     "--model_path are required"),
    (optimization, ["--model_path", "x"], "--model_path are required"),
])
def test_unported_flags_and_incomplete_routes_stop(module, argv, message,
                                                   capsys):
    with pytest.raises(SystemExit) as stop:
        module.main(["--device", "cpu"] + argv)
    assert stop.value.code == 2
    assert message in capsys.readouterr().err
