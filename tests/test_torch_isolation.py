"""`interdiff_torch` stands alone: importing every module of it loads
neither jax, flax, optax, orbax, tensorstore nor `interdiff_tpu` (nor
PyYAML, which only reading a path config needs), nor does a run of its
eval, training or checkpoint-conversion entry point (an eval at two spawned
ranks included, JAX blocked from import in every process; an eval on the
trained orbax saves of `artifacts/` with JAX, flax, orbax and tensorstore
blocked), nor does `chip_smoke.py` import any of them,
and an entry point asked for the default device with no CUDA device present
raises instead of running on the CPU."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
import interdiff_torch
names = [m.name for m in pkgutil.walk_packages(interdiff_torch.__path__,
                                               "interdiff_torch.")]
for name in names:
    importlib.import_module(name)
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                 "tensorstore", "interdiff_tpu", "yaml")]
print(len(names), banned)
assert not banned, banned
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 75
    for module in ("cli.eval_smpl_short", "eval.metrics", "ops.sa",
                   "cli.train_diffusion_smpl", "train.trainer",
                   "train.losses", "diffusion.resample", "diffusion.nn",
                   "ops.gather", "utils.train_io", "cli.eval_skeleton",
                   "cli.train_diffusion_skeleton", "eval.skeleton",
                   "models.mdm_skeleton", "data.skeleton",
                   "geometry.rotations_np", "train.losses_correction",
                   "eval.optimization", "cli.train_correction_smpl",
                   "cli.train_correction_skeleton", "cli.optimization",
                   "smpl.loader", "data.behave", "data.paths",
                   "eval.smpl_long", "cli.eval_smpl_long",
                   "geometry.mesh_losses", "utils.prefetch",
                   "utils.profiling", "utils.checkpoint",
                   "cli.convert_checkpoint", "data.mesh_io",
                   "data.prepare_behave", "ops.mesh_distance",
                   "utils.native", "viz.render3d", "viz.mesh_viz",
                   "viz.skeleton_viz", "diffusion.losses", "parallel.mesh",
                   "parallel.sample_parallel", "utils.fixtures",
                   "utils.zstd", "utils.ocdbt", "utils.orbax_read"):
        assert os.path.exists(os.path.join(
            ROOT, "interdiff_torch", *module.split(".")) + ".py")


_RUN_CLI = r"""
import sys
from interdiff_torch.cli.eval_smpl_short import main
totals, batches = main(["--device", "cpu", "--synthetic", "1", "--batch_size",
                        "2", "--diverse_samples", "2", "--respacing", "5",
                        "--sampler", "plms"])
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax",
                                 "tensorstore", "interdiff_tpu")]
assert batches == 1 and len(totals) == 6 and not banned, (totals, banned)
"""


def test_eval_entry_point_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _RUN_CLI], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "'penetrate':" in out.stdout.splitlines()[-1]


_RUN_TRAIN = r"""
import sys, tempfile
from interdiff_torch.cli.train_diffusion_smpl import main
with tempfile.TemporaryDirectory() as results:
    state, summary = main([
        "--device", "cpu", "--synthetic", "2", "--batch_size", "2",
        "--embedding_dim", "32", "--ff_size", "64", "--num_layers", "2",
        "--synthetic_points", "64", "--val_respacing", "4", "--ema_decay",
        "0.9", "--schedule_sampler", "loss-second-moment", "--results_dir",
        results])
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                 "tensorstore", "interdiff_tpu")]
assert summary["steps"] == 2 and not banned, (summary, banned)
"""


def test_train_entry_point_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _RUN_TRAIN], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 2 steps" in out.stdout


def test_chip_smoke_imports_nothing_of_jax():
    """By its source: the script needs a card to run."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "interdiff_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "orbax",
                        "tensorstore", "interdiff_tpu"}


def test_train_entry_point_stops_without_a_card():
    """`python -m interdiff_torch.cli.train_diffusion_smpl` with no
    `--device` and no CUDA device ends with an error before any step."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "interdiff_torch.cli.train_diffusion_smpl",
         "--synthetic", "1", "--batch_size", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "loss" not in out.stdout


def test_eval_entry_point_stops_without_a_card():
    """`python -m interdiff_torch.cli.eval_smpl_short` with no `--device` and
    no CUDA device ends with an error, not with a run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "interdiff_torch.cli.eval_smpl_short",
         "--synthetic", "1", "--batch_size", "2", "--respacing", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "penetrate" not in out.stdout


def test_default_device_without_cuda_raises(monkeypatch):
    from interdiff_torch import resolve_device
    from interdiff_torch.config import (
        CorrectionConfig,
        DiffusionConfig,
        SmplTrackConfig,
        build_smpl_body,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SmplTrackConfig(embedding_dim=32, ff_size=64,
                        num_layers=3).build_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionConfig(timestep_respacing="10").build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CorrectionConfig(num_nodes=8, dct=4).build_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_smpl_body(num_verts=16)
    assert resolve_device("cpu") == torch.device("cpu")


def test_skeleton_entry_points_stop_without_a_card(monkeypatch, tmp_path):
    """The skeleton CLIs and objects asked for the default device with no
    CUDA device present raise before any step; ``--device cpu`` runs."""
    from interdiff_torch.cli import eval_skeleton, train_diffusion_skeleton
    from interdiff_torch.config import CorrectionConfig, SkeletonTrackConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_skeleton.main(["--synthetic", "1", "--batch_size", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_diffusion_skeleton.main(["--synthetic", "1", "--batch_size",
                                       "2", "--results_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SkeletonTrackConfig(embedding_dim=32, ff_size=32,
                            num_layers=2).build_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CorrectionConfig(track="skeleton", num_nodes=21,
                         future_len=10).build_model()
    _, n = eval_skeleton.main(["--device", "cpu", "--synthetic", "1",
                               "--batch_size", "2", "--respacing", "2",
                               "--mode", "no_correction"])
    assert n == 1


_RUN_CORRECTION = r"""
import sys, tempfile
from interdiff_torch.cli import optimization, train_correction_smpl
with tempfile.TemporaryDirectory() as results:
    _, summary = train_correction_smpl.main([
        "--device", "cpu", "--synthetic", "1", "--batch_size", "2",
        "--past_len", "3", "--future_len", "3", "--dct", "4",
        "--synthetic_verts", "16", "--synthetic_points", "16",
        "--results_dir", results])
    refined = optimization.main([
        "--device", "cpu", "--synthetic", "1", "--diffusion_ckpt", "",
        "--batch_size", "1", "--respacing", "2", "--iters", "2",
        "--past_len", "3", "--future_len", "3", "--out_dir", results])
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                 "tensorstore", "interdiff_tpu")]
assert summary["steps"] == 1 and refined["batches"] == 1 and not banned, (
    summary, refined, banned)
"""


def test_correction_and_refine_entry_points_run_without_jax():
    out = subprocess.run([sys.executable, "-c", _RUN_CORRECTION], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 1 steps" in out.stdout


def test_correction_and_refine_entry_points_stop_without_a_card(
        monkeypatch, tmp_path):
    """The two correction trainers and the refiner, asked for the default
    device with no CUDA device present, raise before any step."""
    from interdiff_torch.cli import (
        optimization,
        train_correction_skeleton,
        train_correction_smpl,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    results = str(tmp_path / "results")
    for main, argv in (
            (train_correction_smpl.main, ["--results_dir", results]),
            (train_correction_skeleton.main, ["--results_dir", results]),
            (optimization.main, ["--out_dir", results]),
            (optimization.main, ["--out_dir", results,
                                 "--diffusion_ckpt", ""])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--synthetic", "1", "--batch_size", "2"] + argv)
    assert not os.path.exists(results)


_RUN_LONG = r"""
import sys, tempfile
from interdiff_torch.cli import eval_smpl_long
from interdiff_torch.data.paths import load_paths
assert "yaml" not in sys.modules
with tempfile.TemporaryDirectory() as out:
    assert eval_smpl_long.main([
        "--device", "cpu", "--synthetic", "1", "--batch_size", "1",
        "--rollouts", "1", "--respacing", "2", "--out_dir", out]) is None
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                 "tensorstore", "interdiff_tpu")]
assert not banned, banned
"""


def test_long_eval_entry_point_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _RUN_LONG], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "rollout drift summary" in out.stdout


def test_long_eval_entry_point_stops_without_a_card(monkeypatch, tmp_path):
    from interdiff_torch.cli import eval_smpl_long

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_smpl_long.main(["--synthetic", "1", "--batch_size", "1",
                             "--out_dir", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


_RUN_CONVERT = r"""
import sys, tempfile, os
import chip_smoke
from interdiff_torch.cli import convert_checkpoint
from interdiff_torch.config import CorrectionConfig
from interdiff_torch.utils.convert import torch_to_flax_variables
proj = CorrectionConfig(num_nodes=8, dct=4).build_model("cpu")
with tempfile.TemporaryDirectory() as root:
    path = os.path.join(root, "correction.ckpt")
    chip_smoke.write_lightning_ckpt(
        path, torch_to_flax_variables(proj.state_dict()), "correction_smpl",
        {})
    convert_checkpoint.main(["--ckpt", path, "--kind", "correction_smpl",
                             "--out", os.path.join(root, "out")])
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                 "tensorstore", "interdiff_tpu", "yaml")]
assert not banned, banned
"""


def test_convert_checkpoint_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _RUN_CONVERT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "state_dict.pt" in out.stdout


_RUN_TWO_RANKS = r"""
import importlib.abc, sys

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
          "interdiff_tpu")


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked: {name}")
        return None


# at the top of the file, so that each spawned rank (which imports this
# file as its main module) blocks them too
sys.meta_path.insert(0, _Block())

if __name__ == "__main__":
    from interdiff_torch.cli import eval_skeleton
    totals, n = eval_skeleton.main([
        "--device", "cpu", "--synthetic", "1", "--batch_size", "2",
        "--respacing", "2", "--mode", "no_correction", "--mesh_devices",
        "2"])
    banned = [m for m in sys.modules if m.split(".")[0] in BANNED]
    assert n == 1 and len(totals) == 4 and not banned, (totals, banned)
    print("two ranks done")
"""


def test_two_rank_entry_point_runs_without_jax(tmp_path):
    """`eval_skeleton --mesh_devices 2 --device cpu`: two spawned gloo
    ranks, JAX blocked from import in the parent and in both ranks."""
    script = tmp_path / "two_ranks.py"
    script.write_text(_RUN_TWO_RANKS)
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert "two ranks done" in out.stdout
    assert "blocked" not in out.stderr


_RUN_ORBAX = r"""
import importlib.abc, sys

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
          "interdiff_tpu")


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Block())
from interdiff_torch.cli.eval_smpl_short import main
totals, batches = main([
    "--device", "cpu", "--synthetic", "1", "--batch_size", "2",
    "--diverse_samples", "2", "--respacing", "3",
    "--diffusion_ckpt", "artifacts/smpl_real_params",
    "--correction_ckpt", "artifacts/correction_real_params"])
banned = [m for m in sys.modules if m.split(".")[0] in BANNED]
assert batches == 1 and len(totals) == 6 and not banned, (totals, banned)
print("trained weights read")
"""


def test_eval_on_the_orbax_saves_runs_without_jax_or_tensorstore():
    if not os.path.isdir(os.path.join(ROOT, "artifacts", "smpl_real_params")):
        pytest.skip("artifacts/ not present")
    out = subprocess.run([sys.executable, "-c", _RUN_ORBAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "trained weights read" in out.stdout
    assert "blocked" not in out.stderr
