"""The reference of the skeleton eval cell: the corrected DDPM step of
`eval_skeleton.py` (the projector blended into every row) and its four
metrics."""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference import diffusion as diff
from bench_port.reference import nets


def correct(cfg, proj_sd, x, step, ctx):
    bd, od = cfg["num_joints"] * 3, cfg["num_points"] * 3
    B, T = x.shape[:2]
    body = x[..., :bd]
    pose_gt = ctx["gt"][..., bd + od:]
    quat, trans = nets.projector_skeleton(
        proj_sd, cfg, pose_gt[..., 3:7], pose_gt[..., :3],
        body.reshape(B, T, -1, 3))
    pose = torch.cat([trans, quat], -1)
    obj = nets.rigid_keypoints(pose, ctx["zero_pose_obj"]).reshape(B, T, od)
    frac = np.float32(step) / np.float32(1000.0)
    return float(frac) * x + float(np.float32(1.0) - frac) * torch.cat(
        [body, obj, pose], -1)


def prepare(cfg, sd, batch):
    memory, gt = nets.skeleton_encode(sd, cfg, batch["skeleton"],
                                      batch["obj_points"], batch["poses"],
                                      batch["zero_pose_obj"])
    mask = torch.zeros_like(gt, dtype=torch.bool)
    mask[:, :cfg["past_len"]] = True
    return {"gt": gt, "memory": memory, "mask": mask,
            "zero_pose_obj": batch["zero_pose_obj"], "batch": batch}


def denoise(cfg, sd, ctx, x_t, t):
    ts = torch.full((x_t.shape[0],), t, dtype=torch.long, device=x_t.device)
    return nets.skeleton_denoise(sd, cfg, x_t, ts, ctx["zero_pose_obj"],
                                 ctx["memory"])


def finish_step(cfg, proj_sd, ctx, sched, x_t, t, x0, noise):
    x0 = torch.where(ctx["mask"], ctx["gt"], x0)
    if diff.fires(cfg, t):
        x0 = correct(cfg, proj_sd, x0, t, ctx)
    return diff.step(sched, x_t, t, x0, noise)


def batch_means(cfg, ctx, final):
    """mpjpe of joints and keypoints, translation and rotation errors over
    the future frames of the batch."""
    bd, od, p = cfg["num_joints"] * 3, cfg["num_points"] * 3, cfg["past_len"]
    B, T = final.shape[:2]
    b = ctx["batch"]
    body = final[..., :bd].reshape(B, T, -1, 3)[:, p:]
    obj = final[..., bd:bd + od].reshape(B, T, -1, 3)[:, p:]
    pose, pose_gt = final[:, p:, bd + od:], b["poses"][:, p:]
    q, qg = pose[..., -4:], pose_gt[..., -4:]
    return {
        "mpjpe_h": float(torch.linalg.norm(
            body - b["skeleton"][:, p:], dim=-1).mean()),
        "mpjpe_o": float(torch.linalg.norm(
            obj - b["obj_points"][:, p:], dim=-1).mean()),
        "translation_error": float(torch.linalg.norm(
            pose[..., :3] - pose_gt[..., :3], dim=-1).mean()),
        "rotation_error": float(torch.minimum(
            torch.linalg.norm(q - qg, dim=-1),
            torch.linalg.norm(q + qg, dim=-1)).mean()),
    }


METRIC_FLOOR = 1e-3


@torch.no_grad()
def check_batch(cfg, sd, proj_sd, batch, record, noise_at):
    """As `smpl_eval.check_batch`: the denoiser's x0, the rest of the step
    in x0's units; but the metrics are held against those of the
    reference's own sample (its last step from the program's x_1): this
    track's metrics are norms and means, which no lower precision of the
    products would change, so only the step before them can tell."""
    sched = diff.cosine_schedule(cfg["diffusion_steps"])
    with diff.precision("f32"):
        ctx = prepare(cfg, sd, batch)
        gaps = {"denoise_gap": 0.0, "step_gap": 0.0, "metric_gap": 0.0}
        for t, (x_t, x0, x_prev) in sorted(record["steps"].items()):
            ref = denoise(cfg, sd, ctx, x_t, t)
            gaps["denoise_gap"] = max(gaps["denoise_gap"], float(
                (ref - x0).abs().max() / ref.abs().max()))
            # the rest of the step from the program's own x0
            want = finish_step(cfg, proj_sd, ctx, sched, x_t, t, x0,
                               noise_at(t))
            gaps["step_gap"] = max(gaps["step_gap"], float(
                (want - x_prev).abs().max()) / float(sched["coef1"][t]))
            if t == 0:  # the reference's own last step and sample
                own = finish_step(cfg, proj_sd, ctx, sched, x_t, t, ref,
                                  noise_at(t))
        ref = batch_means(cfg, ctx, own)
    for k, v in ref.items():
        gaps["metric_gap"] = max(gaps["metric_gap"], abs(
            record["means"][k] - v) / max(abs(v), METRIC_FLOOR))
    return gaps


@torch.no_grad()
def control_record(cfg, sd, proj_sd, batch, record, noise_at):
    """The reference in TF32 in the program's place, its steps from the
    program's states and its metrics from its own sample."""
    sched = diff.cosine_schedule(cfg["diffusion_steps"])
    with diff.precision("tf32"):
        ctx = prepare(cfg, sd, batch)
        steps = {}
        for t, (x_t, _, _) in record["steps"].items():
            x0 = denoise(cfg, sd, ctx, x_t, t)
            steps[t] = (x_t, x0, finish_step(cfg, proj_sd, ctx, sched, x_t,
                                             t, x0, noise_at(t)))
        means = batch_means(cfg, ctx, steps[0][2])
    return {"steps": steps, "means": means}
