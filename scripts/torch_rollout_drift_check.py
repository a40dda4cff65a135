"""Hold the port's long-term rollout against the JAX package's at full width.

    JAX_PLATFORMS=cpu python scripts/torch_rollout_drift_check.py [--out F] \
        [--diffusion_ckpt artifacts/smpl_real_params] \
        [--correction_ckpt artifacts/correction_real_params]

On the CPU only: it imports both packages.  It builds the serving models of
`chip_smoke.full_width_models` (the seeded `MDMSmpl` and `ObjProjectorSmpl`
at their default widths, the V=6890 stand-in body), carries the weights into
flax with `utils/convert.py::torch_to_flax_variables` (with
``--diffusion_ckpt`` / ``--correction_ckpt``, an orbax save of the JAX
package, each package reads it its own way: the port through
`cli/common.py::load_mdm` / `load_correction_variables`, JAX through
`interdiff_tpu/cli/common.py::restore_params` / `load_correction_variables`),
and runs
`interdiff_tpu/eval/smpl_long.py::rollout` and
`interdiff_torch/eval/smpl_long.py::rollout` for the first window and
``--chunks`` (4) chunks after it: correction in the loop, ``--respacing``
("10"), ``--clips`` (2) clips.  Each side feeds its sampler the same
explicit noise and step noise per call, indexed by the count of calls (the
JAX rollout splits a key per chunk, the port's draws from one generator).

The ground truth is a smooth seeded walk of 10 + 5 x 25 frames: the body
near its rest pose, the object 0.25 m to its side.  Printed (and written
to ``--out`` as JSON): the per-window drift of both sides
(`cli/eval_smpl_long.py::make_window_metrics`), their largest difference,
the largest difference of the trajectories, and whether the two agree
within the trajectory tolerance of the parity tests (1e-4, absolute plus
relative).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from interdiff_tpu.cli import common as jcommon  # noqa: E402
from interdiff_tpu.cli import eval_smpl_long as jcli  # noqa: E402
from interdiff_tpu.cli.common import synthetic_smpl_body as j_body  # noqa: E402
from interdiff_tpu.config import DiffusionConfig as JDiffCfg  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.eval import smpl_long as jlong  # noqa: E402
from interdiff_tpu.eval import smpl_short as jss  # noqa: E402
from interdiff_tpu.models.correction import ObjProjectorSmpl as JProj  # noqa: E402
from interdiff_torch.cli import eval_smpl_long as tcli  # noqa: E402
from interdiff_torch.cli.common import (  # noqa: E402
    load_correction_variables,
    load_mdm,
)
from interdiff_torch.config import DiffusionConfig  # noqa: E402
from interdiff_torch.eval import smpl_long as tlong  # noqa: E402
from interdiff_torch.eval import smpl_short as tss  # noqa: E402
from interdiff_torch.geometry.rotations import (  # noqa: E402
    axis_angle_to_matrix,
    matrix_to_rotation_6d,
)
from interdiff_torch.utils.convert import torch_to_flax_variables  # noqa: E402

TOL = 1e-4  # trajectories, absolute plus relative (ROADMAP, parity)
D = 135


def ground_truth(rng, clips: int, frames: int):
    """(gt state [clips, frames, 144], hand [clips, frames, 90], betas
    [clips, frames, 10]): a smooth walk near the rest pose, the object
    0.25 m to the side of the pelvis."""
    t = np.arange(frames)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, (clips, 1, 66))
    pose = 0.15 * np.sin(0.1 * t + phase)
    heading = rng.uniform(-1, 1, (clips, 1, 3)) * np.array([1.0, 0.0, 1.0])
    trans = 0.02 * t * heading
    obj_angles = 0.2 * np.sin(0.05 * t + phase[..., :3])
    obj_trans = trans + np.array([0.25, 0.1, 0.0])
    to6d = lambda aa: matrix_to_rotation_6d(axis_angle_to_matrix(  # noqa: E731
        torch.from_numpy(aa.reshape(clips, frames, -1, 3)).float())
    ).reshape(clips, frames, -1).numpy()
    gt = np.concatenate([to6d(pose), trans, to6d(obj_angles), obj_trans],
                        -1).astype(np.float32)
    hand = (rng.standard_normal((clips, 1, 90)) * 0.1).repeat(frames, 1)
    betas = (rng.standard_normal((clips, 1, 10)) * 0.5).repeat(frames, 1)
    return gt, hand.astype(np.float32), betas.astype(np.float32)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chunks", type=int, default=4)
    parser.add_argument("--respacing", default="10")
    parser.add_argument("--clips", type=int, default=2)
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--out", default=None, help="JSON file to write")
    parser.add_argument("--diffusion_ckpt", default=None,
                        help="orbax save of MDMSmpl (e.g. artifacts/"
                             "smpl_real_params) in place of the seeded "
                             "weights")
    parser.add_argument("--correction_ckpt", default=None,
                        help="orbax save of ObjProjectorSmpl (e.g. "
                             "artifacts/correction_real_params)")
    args = parser.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    cfg_t, cfg_j = tss.SmplEvalConfig(), jss.SmplEvalConfig()
    T, B, n = cfg_t.seq_len, args.clips, 1 + args.chunks
    H = cfg_t.past_len + n * cfg_t.future_len

    model, projector, body = chip_smoke.full_width_models(device="cpu")
    diffusion = DiffusionConfig(timestep_respacing=args.respacing).build(
        "cpu")
    jtrack = JTrack(diffusion=JDiffCfg(timestep_respacing=args.respacing))
    jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()
    model = load_mdm(args.diffusion_ckpt, "smpl", model,
                     past_len=cfg_t.past_len, future_len=cfg_t.future_len)
    load_correction_variables(projector, args.correction_ckpt)
    variables = (jcommon.restore_params(args.diffusion_ckpt)
                 if args.diffusion_ckpt
                 else torch_to_flax_variables(model.state_dict()))
    proj_vars = (jcommon.load_correction_variables(args.correction_ckpt)
                 if args.correction_ckpt
                 else torch_to_flax_variables(projector.state_dict()))
    jproj = JProj()
    jbody = j_body(np.random.default_rng(chip_smoke.SEED),
                   num_verts=chip_smoke.VERTS)
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor",
                 "weights"):
        same = np.array_equal(np.asarray(getattr(jbody, name)),
                              getattr(body, name).cpu().numpy().astype(
                                  np.asarray(getattr(jbody, name)).dtype))
        if not same:
            raise AssertionError(f"the two stand-in bodies differ in {name}")

    gt_long, hand_long, betas_long = ground_truth(rng, B, H)
    gt, hand, betas = gt_long[:, :T], hand_long[:, :T], betas_long[:, :T]
    pts = chip_smoke.object_cloud(rng, B, chip_smoke.POINTS)
    steps = diffusion.num_timesteps
    noise = rng.standard_normal((n, B, T, 144)).astype(np.float32)
    step_noise = rng.standard_normal((n, steps, B, T, 144)).astype(
        np.float32)

    jrun = jax.jit(jss.make_sampler(
        cfg_j, jmodel, jdiff, smpl=jbody, projector=jproj,
        projector_params=proj_vars, use_correction=True))
    trun = tss.make_sampler(cfg_t, model, diffusion, smpl=body,
                            projector=projector)
    jcalls, tcalls = [], []

    def j_sample(key, g, p, h, b):
        i = len(jcalls)
        jcalls.append(i)
        return jrun(variables, key, g, p, h, b,
                    noise=jnp.asarray(noise[i]),
                    step_noise=jnp.asarray(step_noise[i]))

    def t_sample(gen, g, p, h, b):
        i = len(tcalls)
        tcalls.append(i)
        return trun(g, p, h, b, noise=torch.from_numpy(noise[i]),
                    step_noise=torch.from_numpy(step_noise[i]))

    t0 = time.perf_counter()
    want = np.asarray(jlong.rollout(
        j_sample, lambda x, h, b: jss.postprocess_sample(
            cfg_j, jbody, x, h, b)["pelvis"], jax.random.PRNGKey(0),
        jnp.asarray(gt), jnp.asarray(pts), jnp.asarray(hand),
        jnp.asarray(betas), num_chunks=args.chunks, cfg=cfg_j))
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        got = tlong.rollout(
            t_sample, lambda x, h, b: tss.postprocess_sample(
                cfg_t, body, x, h, b)["pelvis"],
            torch.Generator().manual_seed(0), torch.from_numpy(gt),
            torch.from_numpy(pts), torch.from_numpy(hand),
            torch.from_numpy(betas), num_chunks=args.chunks,
            cfg=cfg_t).numpy()
    torch_s = time.perf_counter() - t0

    drift_j = jcli._make_window_metrics(cfg_j, jbody, args.chunks)(
        jnp.asarray(want), jnp.asarray(gt_long), jnp.asarray(hand_long),
        jnp.asarray(betas_long))
    drift_t = tcli.make_window_metrics(cfg_t, body, args.chunks)(
        torch.from_numpy(got), torch.from_numpy(gt_long),
        torch.from_numpy(hand_long), torch.from_numpy(betas_long))
    drift_j = [{k: float(v) for k, v in w.items()} for w in drift_j]
    diff = np.abs(got - want)
    report = {
        "weights": {"diffusion": args.diffusion_ckpt or "seeded",
                    "correction": args.correction_ckpt or "seeded"},
        "clips": B, "windows": n, "respacing": args.respacing,
        "horizon": H, "calls": [len(jcalls), len(tcalls)],
        "drift_jax": drift_j, "drift_torch": drift_t,
        "drift_max_abs_diff": max(abs(a[k] - b[k]) for a, b in
                                  zip(drift_t, drift_j) for k in a),
        "trajectory_max_abs_diff": float(diff.max()),
        "trajectory_max_abs_diff_per_window": [
            float(diff[:, :cfg_t.past_len + (w + 1) * cfg_t.future_len]
                  .max()) for w in range(n)],
        "within_tolerance": bool(np.allclose(got, want, atol=TOL,
                                             rtol=TOL)),
        "tolerance": TOL, "finite": bool(np.isfinite(got).all()),
        "seconds": {"jax": jax_s, "torch": torch_s}}
    for side, drift in (("jax", drift_j), ("torch", drift_t)):
        print(side, "obj_translation per window:",
              [round(w["obj_translation"], 4) for w in drift])
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
