"""`interdiff_torch/ops/_build.py`'s cache of built libraries: a library is
named by the hash of its source, the shared headers and nvcc's flags, and
one without ptxas's report beside it is built again.  nvcc is replaced by a
stand-in that writes the output file, so nothing here needs a compiler or a
card."""

import os
import subprocess

import pytest

pytest.importorskip("torch")

from interdiff_torch.ops import _build  # noqa: E402

REPORT = """ptxas info    : Function properties for _Z1kPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 400 bytes cmem[0]
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Builds into ``tmp_path``; returns the list of command lines run."""
    calls = []

    def run(cmd, capture_output, text):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")
        return subprocess.CompletedProcess(cmd, 0, REPORT, "")

    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    return calls


@pytest.mark.parametrize("source", ["nn", "gather", "ball_group", "sa"])
def test_cache_key_follows_the_defines(source):
    plain = _build.library_path(source)
    assert plain == _build.library_path(source, ())
    assert os.path.basename(plain).startswith(f"{source}_")
    other = _build.library_path(source, ["K2_THREADS=128"])
    assert other != plain
    assert other != _build.library_path(source, ["K2_THREADS=256"])


def test_cache_key_follows_the_flags(monkeypatch):
    before = _build.library_path("nn")
    flags = _build.nvcc_flags()
    monkeypatch.setattr(_build, "nvcc_flags",
                        lambda defines=(): flags + ["-lineinfo"])
    assert _build.library_path("nn") != before


def test_defines_reach_nvcc(fake_nvcc):
    _build.build("nn", ["K2_GROUP=4"])
    assert "-DK2_GROUP=4" in fake_nvcc[0]
    assert fake_nvcc[0][-1] == _build.source_path("nn")


def test_a_library_is_built_once(fake_nvcc):
    path = _build.build("gather")
    assert _build.build("gather") == path
    assert len(fake_nvcc) == 1
    assert _build.ptxas_report("gather")[0]["registers"] == 32


def test_a_library_without_its_report_is_built_again(fake_nvcc):
    path = _build.library_path("sa")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:  # a library left by a build without a report
        f.write("library")
    assert _build.ptxas_report("sa")[0]["kernel"] == "_Z1kPf"
    assert len(fake_nvcc) == 1 and os.path.exists(f"{path}.log")
