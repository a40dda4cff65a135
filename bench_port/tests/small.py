"""Cells cut to a size that a CPU test can hold: the widths and steps of
the configuration reduced, a few clips, a small stand-in body."""

from __future__ import annotations

import importlib.util
import os

from bench_port import harness

SMALL = {"embedding_dim": 32, "num_heads": 4, "ff_size": 64,
         "num_layers": 3, "diffusion_steps": 60, "checked_steps": 3,
         "correction_t_max": 50, "correction_every": 25,
         "profiled_steps": 10}
EVAL_CELLS = ("smpl_eval_ddpm1000", "skeleton_eval_ddpm1000")


def cell(name: str, clips: int = 2, **over):
    wl = harness.workload(name)
    cfg = {**harness.config(wl["config"]), **SMALL, **over}
    if "body" in cfg:
        cfg["body"] = {"num_verts": 512, "num_joints": 52}
    wl["traffic_params"] = {**wl["traffic_params"], "clips": clips}
    return wl, cfg


def run_module():
    """bench_port/run.py as a module (its `measure` drives a run without
    the look for a chip)."""
    path = os.path.join(harness.HERE, "run.py")
    spec = importlib.util.spec_from_file_location("bench_port_run", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
