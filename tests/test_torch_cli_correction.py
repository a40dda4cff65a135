"""The entry points of the correction trainers and of the refiner on the
CPU at tiny sizes: `cli/train_correction_smpl.py` and
`cli/train_correction_skeleton.py` (``main`` under ``--synthetic`` and
``train`` through both phases; a finite loss, a checkpoint that restores
into a fresh projector, BatchNorm statistics included), and
`cli/optimization.py` in both modes (per-clip refinement, and
generate-then-refine with ``summary.json``)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from interdiff_torch.cli import optimization as cli_opt  # noqa: E402
from interdiff_torch.cli import train_correction_skeleton as cli_skel  # noqa: E402
from interdiff_torch.cli import train_correction_smpl as cli_smpl  # noqa: E402
from interdiff_torch.cli.common import synthetic_smpl_batches  # noqa: E402
from interdiff_torch.models.correction import (  # noqa: E402
    ObjProjectorSkeleton,
    ObjProjectorSmpl,
)
from interdiff_torch.utils.train_io import CheckpointManager  # noqa: E402


def _restores(results_dir, fresh, trained):
    ckpt = CheckpointManager(os.path.join(results_dir, "ckpt"))
    fresh.load_state_dict(ckpt.restore(), strict=True)
    for k, v in trained.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_smpl_correction_main_synthetic(tmp_path):
    state, summary = cli_smpl.main([
        "--device", "cpu", "--synthetic", "2", "--batch_size", "2",
        "--past_len", "4", "--future_len", "6", "--dct", "6",
        "--synthetic_verts", "32", "--synthetic_points", "40",
        "--w_penetration", "0.05", "--results_dir", str(tmp_path)])
    assert summary["steps"] == 2 == state.step
    assert np.isfinite(summary["loss"])
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["step"] == 0
    trained = ObjProjectorSmpl(n_pre=6, past_len=4, future_len=6,
                               device="cpu")
    trained.load_state_dict({**trained.state_dict(),
                             **state.params,
                             **state.batch_stats})
    _restores(str(tmp_path), ObjProjectorSmpl(n_pre=6, past_len=4,
                                              future_len=6, device="cpu"),
              trained)


def test_smpl_correction_train_both_phases(tmp_path):
    """Two epochs, the first in the ``initialize`` phase: the annealed
    contact and penetration terms are 0 at epoch 0 and weigh in at epoch
    1; the BatchNorm statistics move."""
    rng = np.random.default_rng(5)
    projector = ObjProjectorSmpl(n_pre=4, past_len=3, future_len=5,
                                 device="cpu")
    stats0 = {k: v.clone() for k, v in projector.state_dict().items()
              if k.endswith("running_mean")}
    seen = []
    batches = list(synthetic_smpl_batches(rng, batch_size=2, seq_len=8,
                                          num_points=32, num_verts=24,
                                          steps=2))
    state, summary = cli_smpl.train(
        projector, lambda: batches, results_dir=str(tmp_path), epochs=2,
        initialize_epochs=1, on_step=lambda i, s, m: seen.append(
            {k: float(v) for k, v in m.items()}))
    assert summary["steps"] == 4 and len(seen) == 4
    assert all(np.isfinite(list(m.values())).all() for m in seen)
    assert seen[0]["contact"] == 0.0 and seen[0]["penetration"] == 0.0
    assert any(m["contact"] > 0 for m in seen[2:])
    assert any(not torch.equal(projector.state_dict()[k], v)
               for k, v in stats0.items())
    _restores(str(tmp_path), ObjProjectorSmpl(n_pre=4, past_len=3,
                                              future_len=5, device="cpu"),
              projector)


def test_skeleton_correction_main_synthetic(tmp_path):
    state, summary = cli_skel.main([
        "--device", "cpu", "--synthetic", "2", "--batch_size", "2",
        "--past_len", "4", "--future_len", "4",
        "--results_dir", str(tmp_path)])
    assert summary["steps"] == 2 and np.isfinite(summary["loss"])
    trained = ObjProjectorSkeleton(past_len=4, future_len=4, device="cpu")
    trained.load_state_dict({**trained.state_dict(), **state.params,
                             **state.batch_stats})
    _restores(str(tmp_path), ObjProjectorSkeleton(past_len=4, future_len=4,
                                                  device="cpu"), trained)


@pytest.mark.parametrize("module,argv", [
    (cli_smpl, ["--motion_path", "x", "--synthetic", "1"]),
    (cli_smpl, ["--synthetic", "1", "--synthetic_body"]),
    (cli_smpl, []),
    # a path config that names no motion path: the route is incomplete
    (cli_skel, ["--config", os.devnull]),
    (cli_opt, ["--motion_path", "x"]),
    (cli_opt, ["--synthetic", "1", "--synthetic_body"]),
])
def test_unported_modes_stop_with_an_error(module, argv, capsys):
    with pytest.raises(SystemExit):
        module.main(["--device", "cpu"] + argv)
    assert "error" in capsys.readouterr().err


def test_refine_cli_synthetic_clips(tmp_path):
    outs = cli_opt.main(["--device", "cpu", "--synthetic", "2", "--iters",
                         "4", "--past_len", "3", "--future_len", "3",
                         "--out_dir", str(tmp_path)])
    assert len(outs) == 2
    for out in outs:
        assert np.isfinite(float(out["best_loss"]))  # keep_after = iters-2
        assert out["pose"].shape == (6, 156)
        assert torch.isfinite(out["terms"]).all()
    assert sorted(os.listdir(tmp_path)) == ["synthetic_0.npz",
                                            "synthetic_1.npz"]


def test_refine_cli_generate_then_refine(tmp_path):
    summary = cli_opt.main([
        "--device", "cpu", "--synthetic", "2", "--diffusion_ckpt", "",
        "--batch_size", "2", "--respacing", "3", "--iters", "3",
        "--past_len", "3", "--future_len", "3", "--limit", "1",
        "--pen_fix_body", "--out_dir", str(tmp_path)])
    with open(tmp_path / "summary.json") as f:
        written = json.load(f)
    assert written == summary
    assert set(cli_opt.PENETRATION_KEYS) <= written.keys()
    assert written["batches"] == 1 and written["iters"] == 3
    assert all(np.isfinite(written[k]) for k in cli_opt.PENETRATION_KEYS)
    assert sorted(os.listdir(tmp_path)) == ["refined_1.npz", "summary.json"]
    refined = np.load(tmp_path / "refined_1.npz")
    assert refined["pose"].shape == (2, 6, 156)
    assert np.isfinite(refined["terms"]).all()
