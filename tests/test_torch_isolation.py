"""`interdiff_torch` stands alone: importing every module of it loads
neither jax, flax nor `interdiff_tpu`, and an entry point asked for the
default device with no CUDA device present raises instead of running on
the CPU."""

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
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "interdiff_tpu")]
print(len(names), banned)
assert not banned, banned
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 32


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
