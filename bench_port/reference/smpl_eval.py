"""The reference of the SMPL eval cell: the corrected DDPM step, the
post-processing and the six metrics of `eval_smpl_short.py`."""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference import diffusion as diff
from bench_port.reference import geometry as geo
from bench_port.reference import nets


def pad_idx(cfg):
    p, f = cfg["past_len"], cfg["future_len"]
    return np.concatenate([np.arange(p), np.full(f, p - 1)])


def body_aa(x, D):
    B, T = x.shape[:2]
    return geo.matrix_to_aa(geo.sixd_to_matrix(
        x[..., :D - 3].reshape(B, T, -1, 6))).reshape(B, T, -1)


# The program's nearest-neighbour kernels take |b|^2 - 2 a.b + |a|^2, which
# at the metres of these scenes rounds a 2 cm distance by up to about
# 2e-5 m (a few float32 ulps of |a|^2 over 2 d); the reference takes
# |a - b|^2.  A contact label or a gate decision whose quantity lies this
# near its threshold may go either way: such a decision is not judged.
CONTACT_TIE_M = 1e-4
PENETRATION_TIE = 1e-5


def correct(cfg, proj_sd, body, x, step, ctx, flip: bool = False):
    """The correction hook at ``step``: FK, normals, the object->body
    signed sweep (queries beyond ``nn_prune_delta`` forced to
    (delta^2, +1)), the marker->object nearest neighbour, the gate, the
    contact labels, the projector and the blend.  Returns (x, whether a
    decision lay within a tie of its threshold); ``flip`` takes every such
    decision the other way."""
    D, p = cfg["smpl_dim"] + 3, cfg["past_len"]
    B, T = x.shape[:2]
    bd, obj = x[..., :D], x[..., D:]
    pose = torch.cat([body_aa(x, D), ctx["hand_padded"]], -1)
    verts, _ = geo.smpl_fk(body, pose.reshape(B * T, -1),
                           ctx["betas"].reshape(B * T, -1),
                           bd[..., -3:].reshape(B * T, 3))
    verts = verts.reshape(B, T, -1, 3)
    markers = verts[:, :, body["markers"]]
    pts = torch.einsum("btij,bpj->btpi", geo.sixd_to_matrix(obj[..., :6]),
                       ctx["obj_points"]) + obj[..., None, 6:]
    Tf = T - p
    vf = verts[:, p:].reshape(B * Tf, -1, 3)
    of = pts[:, p:].reshape(B * Tf, -1, 3)
    normals = geo.vertex_normals(vf, body["faces_t"], body["incident"])
    sq, dot = geo.signed_nearest(of, vf, normals)
    delta = np.float32(cfg["nn_prune_delta"])
    far = sq >= float(delta * delta)
    sq = torch.where(far, float(delta * delta), sq)
    dot = torch.where(far, 1.0, dot)
    signed = (torch.sqrt(sq) * torch.sign(dot)).reshape(B, Tf, -1)
    penetration = (signed.abs() * torch.where(signed < 0, 20.0, 0.0)
                   ).mean((1, 2))
    md2, _ = geo.nearest(markers.reshape(B * T, -1, 3),
                         pts.reshape(B * T, -1, 3))
    marker_d = torch.sqrt(md2.clamp(min=0.0)).reshape(B, T, -1)
    distance = marker_d.amin(2).mean(1)
    fix = ~((penetration < 0.002) & (distance < 0.02))
    labels = marker_d < 0.02
    tied_rows = (((penetration - 0.002).abs() < PENETRATION_TIE)
                 | ((distance - 0.02).abs() < CONTACT_TIE_M))
    tied_labels = (marker_d - 0.02).abs() < CONTACT_TIE_M
    if flip:
        fix = fix ^ tied_rows
        labels = labels ^ tied_labels
    contact = labels[:, p:].sum(1).float()
    proj = nets.projector_smpl(proj_sd, cfg, ctx["gt"][..., D:], markers,
                               contact)
    frac = float(np.float32(step) / np.float32(1000.0))
    blend = frac * x + (1.0 - frac) * torch.cat([bd, proj], -1)
    tied = bool(tied_rows.any() or tied_labels[:, p:].any())
    return torch.where(fix[:, None, None], blend, x), tied


def postprocess(cfg, body, x, hand, betas):
    D = cfg["smpl_dim"] + 3
    B, T = x.shape[:2]
    obj_aa = geo.matrix_to_aa(geo.sixd_to_matrix(x[..., D:D + 6]))
    body_pred = torch.cat([body_aa(x, D), hand[:, pad_idx(cfg)],
                           x[..., D - 3:D]], -1)
    verts, jtr = geo.smpl_fk(body, body_pred[..., :-3].reshape(B * T, -1),
                             betas.reshape(B * T, -1),
                             body_pred[..., -3:].reshape(B * T, 3))
    return {"body_pred": body_pred,
            "obj_pred": torch.cat([obj_aa, x[..., D + 6:]], -1),
            "verts": verts.reshape(B, T, -1, 3),
            "jtr": jtr.reshape(B, T, -1, 3)}


def quat_err(a, b):
    return torch.minimum((a - b).abs().sum(-1), (a + b).abs().sum(-1))


def metrics(cfg, body, out, gt, obj_points):
    """Per-row metrics over the future frames."""
    p = cfg["past_len"]
    o, g = out["obj_pred"][:, p:], gt["obj_pred"][:, p:]
    B, T = o.shape[:2]
    pts = torch.einsum("btij,bpj->btpi", geo.aa_to_matrix(o[..., :3]),
                       obj_points) + o[..., None, 3:]
    v = out["verts"][:, p:].reshape(B * T, -1, 3)
    n = geo.vertex_normals(v, body["faces_t"], body["incident"])
    _, dot = geo.signed_nearest(pts.reshape(B * T, -1, 3), v, n)
    j, jg = out["jtr"][:, p:], gt["jtr"][:, p:]
    return {
        "global_mpjpe": torch.linalg.norm(j - jg, dim=-1).mean((1, 2)),
        "local_mpjpe": torch.linalg.norm(
            (j - j[:, :, :1]) - (jg - jg[:, :, :1]), dim=-1).mean((1, 2)),
        "body_translation": torch.linalg.norm(
            out["body_pred"][:, p:, -3:] - gt["body_pred"][:, p:, -3:],
            dim=-1).mean(1),
        "obj_translation": torch.linalg.norm(o[..., 3:] - g[..., 3:],
                                             dim=-1).mean(1),
        "obj_rot_error": quat_err(geo.aa_to_quat(o[..., :3]),
                                  geo.aa_to_quat(g[..., :3])).mean(1),
        "penetrate": (dot < 0).reshape(B, -1).float().mean(1),
    }


METRIC_FLOOR = 1e-3  # scale under which a metric's gap is taken absolute


def prepare(cfg, sd, body, batch):
    """What the reference derives from a raw batch (tensors on the
    device): the tiled gt state, memory, hands, betas and template points,
    and the ground truth's post-processing."""
    fold = cfg["diverse_fold"]
    gt = nets.smpl_gt(batch["body_pose"][..., :66], batch["body_trans"],
                      batch["obj_angles"], batch["obj_trans"])
    pts6 = batch["obj_points"][..., :6]
    memory = nets.smpl_encode(sd, cfg, gt, pts6)
    hand, betas = batch["body_pose"][..., 66:], batch["body_betas"]
    gt_post = postprocess(cfg, body, gt, hand, betas)

    def tile(v):
        return v.repeat((fold,) + (1,) * (v.ndim - 1))

    gt_t, hand_t = tile(gt), tile(hand)
    mask = torch.zeros_like(gt_t, dtype=torch.bool)
    mask[:, :cfg["past_len"]] = True
    return {"gt": gt_t, "memory": tile(memory), "hand": hand_t,
            "hand_padded": hand_t[:, pad_idx(cfg)], "betas": tile(betas),
            "obj_points": tile(pts6[..., :3]), "mask": mask,
            "gt_post": {k: tile(v) for k, v in gt_post.items()}}


def denoise(cfg, sd, ctx, x_t, t):
    ts = torch.full((x_t.shape[0],), t, dtype=torch.long, device=x_t.device)
    return nets.smpl_denoise(sd, cfg, x_t, ts, ctx["memory"])


def finish_step(cfg, proj_sd, body, ctx, sched, x_t, t, x0, noise,
                flip=False):
    """Inpaint the past, correct where the hook fires, sample x_{t-1}.
    Returns (x_{t-1}, whether a hook decision was tied)."""
    x0 = torch.where(ctx["mask"], ctx["gt"], x0)
    tied = False
    if diff.fires(cfg, t):
        x0, tied = correct(cfg, proj_sd, body, x0, t, ctx, flip)
    return diff.step(sched, x_t, t, x0, noise), tied


def batch_means(cfg, body, ctx, final):
    """The batch's means of the six metrics, best of the diverse samples."""
    fold = cfg["diverse_fold"]
    m = metrics(cfg, body, postprocess(cfg, body, final, ctx["hand"],
                                       ctx["betas"]),
                ctx["gt_post"], ctx["obj_points"])
    return {k: float(v.reshape(fold, -1).amin(0).mean()) for k, v in m.items()}


@torch.no_grad()
def check_batch(cfg, sd, proj_sd, body, batch, record, noise_at):
    """Hold one batch of the program against the reference, step by step
    from the program's own states.

    ``batch``: the raw inputs (tensors on the device); ``record``: the
    program's ``{"steps": {t: (x_t, x0, x_prev)}, "means": {metric: batch
    mean}}`` (x_prev at t = 0 its sample), x0 being the denoiser's output
    before inpainting and correction; ``noise_at(t)`` the step noise the program
    was given.  Returns three gaps: of the denoiser's x0 (over the largest
    |x0|), of the rest of the step (x_{t-1}, over the posterior's weight of
    x0, so in x0's units), and of the metric means (relative above
    METRIC_FLOOR) against the reference's post-processing and metrics of
    the program's sample (the x_{t-1} of t = 0, which the step gap
    holds)."""
    sched = diff.cosine_schedule(cfg["diffusion_steps"])
    with diff.precision("f32"):
        ctx = prepare(cfg, sd, body, batch)
        gaps = {"denoise_gap": 0.0, "step_gap": 0.0, "metric_gap": 0.0}
        for t, (x_t, x0, x_prev) in sorted(record["steps"].items()):
            ref = denoise(cfg, sd, ctx, x_t, t)
            gaps["denoise_gap"] = max(gaps["denoise_gap"], float(
                (ref - x0).abs().max() / ref.abs().max()))
            # the rest of the step from the program's own x0, a row's tied
            # decisions taken the way that comes nearer the program
            want, tied = finish_step(cfg, proj_sd, body, ctx, sched, x_t, t,
                                     x0, noise_at(t))
            err = (want - x_prev).abs().flatten(1).amax(1)
            if tied:
                alt, _ = finish_step(cfg, proj_sd, body, ctx, sched, x_t, t,
                                     x0, noise_at(t), flip=True)
                err = torch.minimum(err, (alt - x_prev).abs().flatten(1)
                                    .amax(1))
            gaps["step_gap"] = max(gaps["step_gap"], float(err.max())
                                   / float(sched["coef1"][t]))
        ref = batch_means(cfg, body, ctx, record["steps"][0][2])
    for k, v in ref.items():
        gaps["metric_gap"] = max(gaps["metric_gap"], abs(
            record["means"][k] - v) / max(abs(v), METRIC_FLOOR))
    return gaps


@torch.no_grad()
def control_record(cfg, sd, proj_sd, body, batch, record, noise_at):
    """The control: the reference in TF32 put in the program's place, its
    steps from the program's states x_t, its metrics from the program's
    sample; a record shaped as the program's."""
    sched = diff.cosine_schedule(cfg["diffusion_steps"])
    with diff.precision("tf32"):
        ctx = prepare(cfg, sd, body, batch)
        steps = {}
        for t, (x_t, _, _) in record["steps"].items():
            x0 = denoise(cfg, sd, ctx, x_t, t)
            steps[t] = (x_t, x0, finish_step(cfg, proj_sd, body, ctx, sched,
                                             x_t, t, x0, noise_at(t))[0])
        means = batch_means(cfg, body, ctx, record["steps"][0][2])
    return {"steps": steps, "means": means}
