"""The reference of MDM's text-to-motion sampling: CLIP ViT-B/32's text
tower (`clip/model.py`), MDM's ``trans_enc`` denoiser (`model/mdm.py`),
classifier-free guidance as the source's two separate calls
(`model/cfg_sampler.py`), the cosine DDPM step (`diffusion.py`) and
HumanML3D's ``recover_from_ric`` with its quaternions (`motion_process.py`,
`quaternion.py`), as functions of the port's state dict (keys of
`MDMText`, the tower under ``clip.``).  The tower stays in float32 where
MDM casts it to float16.

The control (``diff.precision("tf32")``) computes every product in TF32:
the matrix products by cuBLAS's TF32 mode, and the elementwise products of
the guidance, the DDPM step and ``recover_from_ric``, which have none, by
rounding both factors to TF32's 10-bit mantissa (:func:`mul`), as the
tensor cores round a product's inputs."""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.reference import diffusion as diff
from bench_port.reference import nets


# -- precision ----------------------------------------------------------------

def tf32_products() -> bool:
    return torch.backends.cuda.matmul.allow_tf32


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest) in float32."""
    if not isinstance(x, torch.Tensor):
        return float(tf32(torch.tensor([x], dtype=torch.float32))[0])
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mul(a, b):
    """a * b, its factors rounded to TF32 under the control."""
    if tf32_products():
        return tf32(a) * tf32(b)
    return a * b


# -- networks -----------------------------------------------------------------

def mha(sd, p, x, heads, mask=None):
    """Self-attention with the packed ``in_proj_kernel`` [D, 3D], the
    additive ``mask`` on the scores."""
    w, b = sd[p + ".in_proj_kernel"], sd[p + ".in_proj_bias"]
    D = w.shape[0]
    B, T, hd = x.shape[0], x.shape[1], D // heads
    q, k, v = (((x @ w[:, i * D:(i + 1) * D]) + b[i * D:(i + 1) * D])
               .reshape(B, T, heads, hd).transpose(1, 2) for i in range(3))
    s = q @ k.transpose(-1, -2) / math.sqrt(hd)
    if mask is not None:
        s = s + mask
    a = torch.softmax(s, -1) @ v
    return nets.linear(sd, p + ".out_proj", a.transpose(1, 2).reshape(B, T, D))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def tower(sd, cfg, ids, p="clip"):
    """CLIP's ``encode_text``: ids [B, T] -> the EOT row [B, clip_dim]."""
    B, T = ids.shape
    x = sd[p + ".token_embedding.weight"][ids] \
        + sd[p + ".position_embedding.weight"][:T]
    mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
    for i in range(cfg["transformer_layers"]):
        q = f"{p}.layer_{i}"
        x = x + mha(sd, q + ".self_attn", nets.layer_norm(sd, q + ".norm1", x),
                    cfg["transformer_heads"], mask)
        h = nets.layer_norm(sd, q + ".norm2", x)
        x = x + nets.linear(sd, q + ".ff.linear2", quick_gelu(
            nets.linear(sd, q + ".ff.linear1", h)))
    x = nets.layer_norm(sd, p + ".ln_final", x)
    eot = x[torch.arange(B, device=x.device), ids.argmax(-1)]
    return eot @ sd[p + ".text_projection.weight"].T


def mdm(sd, cfg, x, t, cond):
    """One of MDM's calls: x [B, F, njoints] at timestep t (an int), the
    condition [B, clip_dim] (zeros: the null condition) -> x0."""
    B, F = x.shape[:2]
    D = cfg["latent_dim"]
    pe = nets.sin_table(max(1000, F + 1), D, x.device)
    h = nets.linear(sd, "embed_timestep.fc1", pe[t].expand(B, D))
    temb = nets.linear(sd, "embed_timestep.fc2", h * torch.sigmoid(h))
    emb = temb + nets.linear(sd, "embed_text", cond)
    h = torch.cat([emb[:, None], nets.linear(sd, "input_process", x)], 1)
    h = nets.stack(sd, "seqTransEncoder", ("enc",) * cfg["num_layers"],
                   h + pe[:F + 1], None, cfg["num_heads"])
    return nets.linear(sd, "output_process", h[:, 1:])


def guided(sd, cfg, x, t, text):
    """`ClassifierFreeSampleModel`: the conditioned and the null call, then
    ``null + scale (cond - null)``."""
    out = mdm(sd, cfg, x, t, text)
    null = mdm(sd, cfg, x, t, torch.zeros_like(text))
    return null + mul(float(np.float32(cfg["guidance_param"])), out - null)


def step(sched, x_t, t, x0, noise):
    """x_{t-1} from x0 (`diff.step`; its products in TF32 under the
    control)."""
    if not tf32_products():
        return diff.step(sched, x_t, t, x0, noise)
    mean = mul(float(sched["coef1"][t]), x0) \
        + mul(float(sched["coef2"][t]), x_t)
    if t == 0:
        return mean
    return mean + mul(float(np.exp(np.float32(0.5) * sched["log_var"][t])),
                      noise)


# -- HumanML3D ----------------------------------------------------------------

def cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([mul(a1, b2) - mul(a2, b1), mul(a2, b0) - mul(a0, b2),
                        mul(a0, b1) - mul(a1, b0)], -1)


def qrot(q, v):
    """v rotated by the unit quaternion q (w, x, y, z)."""
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2 * (mul(q[..., :1], uv) + cross(u, uv))


def qinv(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def recover_from_ric(data, joints_num):
    """`motion_process.py::recover_from_ric` on data [..., F, 263]."""
    rot_vel = data[..., 0]
    ang = torch.zeros_like(rot_vel)
    ang[..., 1:] = rot_vel[..., :-1]
    ang = torch.cumsum(ang, -1)
    quat = torch.zeros(data.shape[:-1] + (4,), device=data.device)
    quat[..., 0] = torch.cos(ang)
    quat[..., 2] = torch.sin(ang)
    r_pos = torch.zeros(data.shape[:-1] + (3,), device=data.device)
    r_pos[..., 1:, 0] = data[..., :-1, 1]
    r_pos[..., 1:, 2] = data[..., :-1, 2]
    r_pos = torch.cumsum(qrot(qinv(quat), r_pos), -2)
    r_pos[..., 1] = data[..., 3]
    pos = data[..., 4:(joints_num - 1) * 3 + 4]
    pos = pos.reshape(pos.shape[:-1] + (-1, 3))
    pos = qrot(qinv(quat[..., None, :]).expand(pos.shape[:-1] + (4,)), pos)
    pos[..., 0] += r_pos[..., 0:1]
    pos[..., 2] += r_pos[..., 2:3]
    return torch.cat([r_pos[..., None, :], pos], -2)


# -- the check ----------------------------------------------------------------

def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@torch.no_grad()
def check_batch(cfg, sd, batch, record, noise_at):
    """The gaps of one batch, each layer held alone:

    * ``text_gap``: the pooled text against the reference tower's, over the
      latter's largest value;
    * ``denoise_gap``: at each checked step, the guided x0 against the
      reference's from the program's x_t and its own pooled text, over the
      latter's largest value;
    * ``step_gap``: x_{t-1} against the reference's step from the
      program's x_t and x0, in x0's units (over the posterior's weight of
      x0);
    * ``joints_gap``: the joints against the reference's
      ``recover_from_ric`` of the program's sample, over their largest.

    ``batch`` holds the ids and the program's ``text`` and ``joints``; a
    record that holds its own (the control's) is read in their place."""
    sched = diff.cosine_schedule(cfg["diffusion_steps"])
    text = record.get("text", batch["text"])
    joints = record.get("joints", batch["joints"])
    with diff.precision("f32"):
        gaps = {"text_gap": _rel(text, tower(sd, cfg, batch["ids"])),
                "denoise_gap": 0.0, "step_gap": 0.0}
        for t, (x_t, x0, x_prev) in sorted(record["steps"].items()):
            gaps["denoise_gap"] = max(gaps["denoise_gap"], _rel(
                x0, guided(sd, cfg, x_t, t, text)))
            want = step(sched, x_t, t, x0, noise_at(t))
            gaps["step_gap"] = max(gaps["step_gap"], float(
                (want - x_prev).abs().max()) / float(sched["coef1"][t]))
        sample = record["steps"][0][2]
        gaps["joints_gap"] = _rel(joints, recover_from_ric(
            sample, cfg["num_joints"]))
    return gaps


@torch.no_grad()
def control_record(cfg, sd, batch, record, noise_at):
    """The reference in TF32 in the program's place: its pooled text, its
    steps from the program's states with its own x0, the joints of its own
    sample."""
    sched = diff.cosine_schedule(cfg["diffusion_steps"])
    with diff.precision("tf32"):
        text = tower(sd, cfg, batch["ids"])
        steps = {}
        for t, (x_t, _, _) in record["steps"].items():
            x0 = guided(sd, cfg, x_t, t, text)
            steps[t] = (x_t, x0, step(sched, x_t, t, x0, noise_at(t)))
        joints = recover_from_ric(steps[0][2], cfg["num_joints"])
    return {"steps": steps, "means": record["means"], "text": text,
            "joints": joints}
