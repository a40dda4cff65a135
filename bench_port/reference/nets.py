"""The networks of both tracks as functions of a state dict: the MDM
encoders and denoisers (vanilla and QaN layers), PointNet++ with a
brute-force ball query, and the ST-GCNN object projectors."""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.reference import geometry as geo

NEG = -0.5 * torch.finfo(torch.float32).max


def linear(sd, p, x):
    y = x @ sd[p + ".weight"].T
    b = sd.get(p + ".bias")
    return y if b is None else y + b


def layer_norm(sd, p, x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * sd[p + ".weight"] \
        + sd[p + ".bias"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def sin_table(n, d, device):
    pos = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * (-np.log(10000.0) / d))
    pe = np.zeros((n, d), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def mha(sd, p, q_in, kv, heads):
    w, b = sd[p + ".in_proj_kernel"], sd[p + ".in_proj_bias"]
    D = w.shape[0]
    q = q_in @ w[:, :D] + b[:D]
    k = kv @ w[:, D:2 * D] + b[D:2 * D]
    v = kv @ w[:, 2 * D:] + b[2 * D:]
    B, Tq, Tk, hd = q.shape[0], q.shape[1], k.shape[1], D // heads
    q = q.reshape(B, Tq, heads, hd).transpose(1, 2)
    k = k.reshape(B, Tk, heads, hd).transpose(1, 2)
    v = v.reshape(B, Tk, heads, hd).transpose(1, 2)
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1) @ v
    return linear(sd, p + ".out_proj", a.transpose(1, 2).reshape(B, Tq, D))


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], -1)


def qan(sd, p, x, heads):
    """Learned queries, unit per head and depth-scaled, over a band of
    |t - j| <= 1 with rotary positions on q and k, mixed by ``wk``."""
    Q, wk = sd[p + ".queries"], sd[p + ".wk"]
    B, T, D = x.shape
    hd = D // heads
    q = Q.reshape(-1, heads, hd)
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-6)
    q = (q / math.sqrt(hd)).reshape(-1, D)
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    f = torch.outer(torch.arange(T, dtype=torch.float32, device=x.device),
                    inv)
    f = torch.cat([f, f], -1)
    cos, sin = f.cos(), f.sin()
    q_rot = q[:, None] * cos + rotate_half(q)[:, None] * sin  # [N, T, D]
    k_rot = x * cos + rotate_half(x) * sin
    s = torch.einsum("ntd,bjd->bntj", q_rot, k_rot) * D ** -0.5
    i = torch.arange(T, device=x.device)
    s = s.masked_fill((i[:, None] - i[None]).abs() > 1, NEG)
    out = torch.einsum("bntj,bjd->bntd", torch.softmax(s, -1), x)
    return torch.einsum("bntd,nk->bktd", out, wk)[:, 0]


def ff(sd, p, x):
    return linear(sd, p + ".linear2", gelu(linear(sd, p + ".linear1", x)))


def stack(sd, p, kinds, x, memory, heads):
    for i, kind in enumerate(kinds):
        q = f"{p}.layer_{i}"
        if kind == "enc":
            x = layer_norm(sd, q + ".norm1", x + mha(sd, q + ".self_attn", x,
                                                     x, heads))
            x = layer_norm(sd, q + ".norm2", x + ff(sd, q + ".ff", x))
        elif kind == "dec":
            x = layer_norm(sd, q + ".norm1", x + mha(sd, q + ".self_attn", x,
                                                     x, heads))
            x = layer_norm(sd, q + ".norm2", x + mha(
                sd, q + ".multihead_attn", x, memory, heads))
            x = layer_norm(sd, q + ".norm3", x + ff(sd, q + ".ff", x))
        else:
            h = layer_norm(sd, q + ".norm1", x + qan(sd, q, x, heads))
            if kind == "qan_dec":
                h = layer_norm(sd, q + ".norm2", h + mha(
                    sd, q + ".multihead_attn", h, memory, heads))
                h = layer_norm(sd, q + ".norm3", h + ff(sd, q + ".ff", h))
            else:
                h = layer_norm(sd, q + ".norm2", h + ff(sd, q + ".ff", h))
            x = h
    return x


def kinds(n, cross):
    a, m = ("dec", "qan_dec") if cross else ("enc", "qan_enc")
    return (a,) + (m,) * (n - 2) + (a,)


def t_embed(sd, t, E, device):
    h = sin_table(5000, E, device)[t.long()][:, None]
    h = linear(sd, "embedTimeStep.fc1", h)
    return linear(sd, "embedTimeStep.fc2", h * torch.sigmoid(h))


# -- PointNet++ -------------------------------------------------------------

def sqdist(a, b):
    """|a|^2 + |b|^2 - 2 a.b, clamped at 0: a [B, N, 3], b [B, M, 3] ->
    [B, N, M] (the distance the encoder's ball query is defined on)."""
    return ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
            - 2.0 * (a @ b.transpose(-1, -2))).clamp(min=0.0)


def fps(xyz, npoint):
    """Greedy furthest-point sampling from point 0, lowest index on ties."""
    B, N, _ = xyz.shape
    dist = torch.full((B, N), float("inf"), device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    picks = [last]
    for _ in range(npoint - 1):
        p = xyz.gather(1, last[:, None, None].expand(B, 1, 3))
        dist = torch.minimum(dist, ((xyz - p) ** 2).sum(-1))
        last = dist.argmax(-1)
        picks.append(last)
    return torch.stack(picks, 1)


def grouped_fps(xyz, npoint, groups):
    """Exact FPS inside each strided partition g, g + groups, ..."""
    B, N, _ = xyz.shape
    per, k = N // groups, npoint // groups
    sub = fps(xyz.reshape(B, per, groups, 3).transpose(1, 2)
              .reshape(B * groups, per, 3), k).reshape(B, groups, k)
    return (sub * groups + torch.arange(groups, device=xyz.device)[
        None, :, None]).reshape(B, npoint)


def ball_group(xyz, centres, data, radius, nsample, d2):
    """The first ``nsample`` points inside the radius in index order (the
    first hit repeated, point 0 where none), recentred: [B, M, S, C]."""
    N = xyz.shape[1]
    inside = d2 < float(np.float32(radius * radius))
    j = torch.arange(N, dtype=torch.float32, device=xyz.device)
    idx = torch.topk(torch.where(inside, -j, float("-inf")), nsample,
                     -1).indices
    count = inside.sum(-1, keepdim=True)
    idx = torch.where(torch.arange(nsample, device=xyz.device) < count, idx,
                      idx[..., :1])
    idx = torch.where(count > 0, idx, 0)
    B, M, S = idx.shape
    g = data.gather(1, idx.reshape(B, M * S, 1).expand(
        B, M * S, data.shape[-1])).reshape(B, M, S, -1)
    return torch.cat([g[..., :3] - centres[:, :, None], g[..., 3:]], -1)


def shared_mlp(sd, p, x, depth=3):
    for i in range(depth):
        bn = f"{p}.bn{i}"
        x = x @ sd[f"{p}.conv{i}.weight"].T
        x = (x - sd[bn + ".running_mean"]) * (
            torch.rsqrt(sd[bn + ".running_var"] + 1e-5) * sd[bn + ".weight"]) \
            + sd[bn + ".bias"]
        x = torch.relu(x)
    return x


def sa_stage(sd, p, xyz, features, npoint, radii, nsamples, groups):
    N = xyz.shape[1]
    if groups > 1 and npoint == N:
        centres = xyz
    elif groups > 1:
        centres = xyz.gather(1, grouped_fps(xyz, npoint, groups)[..., None]
                             .expand(-1, -1, 3))
    else:
        centres = xyz.gather(1, fps(xyz, npoint)[..., None].expand(-1, -1, 3))
    data = xyz if features is None else torch.cat([xyz, features], -1)
    d2 = sqdist(xyz, centres).transpose(1, 2)  # [B, M, N]
    outs = [shared_mlp(sd, f"{p}.mlp{s}", ball_group(
        xyz, centres, data, r, ns, d2)).amax(2)
        for s, (r, ns) in enumerate(zip(radii, nsamples))]
    return centres, torch.cat(outs, -1)


def pointnet(sd, cfg, cloud):
    """[B, P, 4] (xyz | norm) -> [B, 1, E]."""
    xyz, f = cloud[..., :3], cloud[..., 3:]
    xyz, f = sa_stage(sd, "pcEmbedding.sa0", xyz, f, 1024, (0.05, 0.1),
                      (16, 32), cfg["fps_groups"])
    xyz, f = sa_stage(sd, "pcEmbedding.sa1", xyz, f, 1, (0.1, 0.2), (16, 32),
                      1)
    return torch.cat([xyz, linear(sd, "pcEmbedding.Linear", f)], -1)


# -- MDM, SMPL track ------------------------------------------------------

def smpl_encode(sd, cfg, gt, obj_points):
    p, D = cfg["past_len"], cfg["smpl_dim"] + 3
    xyz = obj_points[..., :3]
    pc = pointnet(sd, cfg, torch.cat(
        [xyz, torch.linalg.norm(xyz, dim=-1, keepdim=True)], -1))
    emb = (linear(sd, "bodyEmbedding", gt[:, :p, :D])
           + linear(sd, "objEmbedding", gt[:, :p, D:]) + pc)
    emb = emb + sin_table(5000, cfg["embedding_dim"], gt.device)[:p]
    return stack(sd, "encoder", kinds(cfg["num_layers"], False), emb, None,
                 cfg["num_heads"])


def smpl_denoise(sd, cfg, x, t, memory):
    D, E, T = cfg["smpl_dim"] + 3, cfg["embedding_dim"], x.shape[1]
    h = (linear(sd, "bodyEmbedding", x[..., :D])
         + linear(sd, "objEmbedding", x[..., D:]) + t_embed(sd, t, E,
                                                            x.device))
    h = h + sin_table(5000, E, x.device)[:T]
    h = stack(sd, "decoder", kinds(cfg["num_layers"], True), h, memory,
              cfg["num_heads"])
    return torch.cat([linear(sd, "bodyFinalLinear", h),
                      linear(sd, "objFinalLinear", h)], -1)


def smpl_gt(pose66, trans, obj_aa, obj_trans):
    B, T = pose66.shape[:2]
    body = geo.matrix_to_6d(geo.aa_to_matrix(pose66.reshape(B, T, -1, 3)))
    obj = geo.matrix_to_6d(geo.aa_to_matrix(obj_aa))
    return torch.cat([body.reshape(B, T, -1), trans, obj, obj_trans], -1)


# -- MDM, skeleton track ---------------------------------------------------

def rigid_keypoints(pose, zero_pose_obj):
    rot = geo.quat_to_matrix(geo.xyzw_to_wxyz(pose[..., 3:7]))
    return torch.einsum("btij,bpj->btpi", rot, zero_pose_obj) \
        + pose[:, :, None, :3]


def skeleton_encode(sd, cfg, skeleton, obj_points, poses, zero_pose_obj):
    B, T = skeleton.shape[:2]
    p = cfg["past_len"]
    body = skeleton.reshape(B, T, -1)
    obj = obj_points.reshape(B, T, -1)
    gt = torch.cat([body, obj, poses], -1)
    emb = (linear(sd, "bodyEmbedding", body[:, :p])
           + linear(sd, "objEmbedding", obj[:, :p])
           + linear(sd, "shapeEmbedding", zero_pose_obj.reshape(B, 1, -1)))
    emb = emb + sin_table(5000, cfg["embedding_dim"], body.device)[:p]
    return stack(sd, "encoder", kinds(cfg["num_layers"], False), emb, None,
                 cfg["num_heads"]), gt


def skeleton_denoise(sd, cfg, x, t, zero_pose_obj, memory):
    bd = cfg["num_joints"] * 3
    od = cfg["num_points"] * 3
    E, (B, T) = cfg["embedding_dim"], x.shape[:2]
    h = (linear(sd, "bodyEmbedding", x[..., :bd])
         + linear(sd, "objEmbedding", x[..., bd:bd + od])
         + t_embed(sd, t, E, x.device))
    h = h + sin_table(5000, E, x.device)[:T]
    h = stack(sd, "decoder", kinds(cfg["num_layers"], True), h, memory,
              cfg["num_heads"])
    pose = linear(sd, "objFinalLinear", h)
    return torch.cat([linear(sd, "bodyFinalLinear", h),
                      rigid_keypoints(pose, zero_pose_obj).reshape(B, T, od),
                      pose], -1)


# -- the object projectors ------------------------------------------------

def dct(n):
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None]
    w = np.full((n, 1), np.sqrt(2.0 / n))
    w[0, 0] = np.sqrt(1.0 / n)
    return (w * np.cos(np.pi * (i + 0.5) * k / n)).astype(np.float32)


def batch_norm(sd, p, x):
    return (x - sd[p + ".running_mean"]) * (
        torch.rsqrt(sd[p + ".running_var"] + 1e-5) * sd[p + ".weight"]) \
        + sd[p + ".bias"]


def st_gcnn(sd, p, x, version):
    """[B, K, V, C] -> [B, K, V, C']: graph conv, 1x1 conv, BatchNorm, a
    residual through its own conv and BatchNorm, one PReLU slope."""
    if version == 0:
        g = torch.einsum("btvc,tq->bqvc", x, sd[p + ".gcn.T"])
    else:
        g = torch.einsum("btvc,vtq->bqvc", x, sd[p + ".gcn.T"])
        g = torch.einsum("btvc,tvw->btwc", g, sd[p + ".gcn.A"])
    h = batch_norm(sd, p + ".tcn_bn", linear(sd, p + ".tcn_conv", g))
    res = x
    if p + ".res_conv.weight" in sd:
        res = batch_norm(sd, p + ".res_bn", linear(sd, p + ".res_conv", x))
    h = h + res
    return torch.where(h >= 0, h, sd[p + ".prelu"] * h)


def st_stack(sd, p, x, version):
    for i in range(4):
        x = st_gcnn(sd, f"{p}.gcn{i}", x, version)
    return x


def projector_core(sd, obj9, markers, past_len, n_pre):
    T = obj9.shape[1]
    m = torch.from_numpy(dct(T)[:n_pre]).to(obj9.device)  # [K, T]
    pad = np.concatenate([np.arange(past_len),
                          np.full(T - past_len, past_len - 1)])

    def fwd(v):
        return torch.einsum("kt,bt...->bk...", m, v)

    rel = torch.cat([obj9[:, :, None, :6].expand(markers.shape[:3] + (6,)),
                     obj9[:, :, None, 6:9] - markers], -1)
    rel = fwd(rel[:, pad])
    rel = rel + st_stack(sd, "core.st_gcnns_relative", rel, 0)
    multi = torch.cat([rel[..., :6], rel[..., 6:9] + fwd(markers)], -1)
    absn = fwd(obj9[:, pad])[:, :, None]
    absn = absn + st_stack(sd, "core.st_gcnns", absn, 0)
    fused = torch.cat([absn, multi], 2)
    fused = fused + st_stack(sd, "core.st_gcnns_all", fused, 2)
    return torch.einsum("tk,bk...->bt...", m.T, fused)


def projector_smpl(sd, cfg, obj9, markers, contact):
    """The corrected object [B, T, 9]: the marker of most contacts (hand
    markers biased by 0.5, the first on ties), the absolute node where no
    marker is in contact."""
    res = projector_core(sd, obj9, markers, cfg["past_len"], cfg["dct"])
    bias = torch.zeros(markers.shape[2], device=obj9.device)
    bias[cfg["hand_markers"]] = 0.5
    idx = (contact + bias).argmax(-1)
    B, T = res.shape[:2]
    pick = res.gather(2, (idx + 1)[:, None, None, None].expand(B, T, 1, 9))
    return torch.where((contact.sum(-1) > 0)[:, None, None], pick[:, :, 0],
                       res[:, :, 0])


def projector_skeleton(sd, cfg, quat_xyzw, trans, joints):
    T = quat_xyzw.shape[1]
    obj9 = torch.cat([geo.matrix_to_6d(geo.quat_to_matrix(
        geo.xyzw_to_wxyz(quat_xyzw))), trans], -1)
    res = projector_core(sd, obj9, joints, cfg["past_len"],
                         min(cfg["dct"], T))[:, :, 0]
    q = geo.matrix_to_quat(geo.sixd_to_matrix(res[..., :6]))
    return geo.wxyz_to_xyzw(q), res[..., 6:9]
