"""Operations and bytes from shapes: the denoisers' and encoders' FLOPs
(two a multiply-add, matrix products only), and the hand-written kernels'
operations and bytes, each input read once and each output written once.
The roofline shares and the MFU of the per-layer metrics divide these by
the published H100 SXM peaks (`harness.F32_FLOP_PER_S`,
`harness.HBM_BYTES_PER_S`)."""

from __future__ import annotations

# K2-K4, a pair: 3 products and 2 sums for a.b, a product and a difference
# for the score, one comparison
NN_OPS_PER_PAIR = 8
SEGMENT = 256  # K2's pruning segment: surface points a tile
F32 = 4


def linear(tokens: int, c_in: int, c_out: int) -> int:
    return 2 * tokens * c_in * c_out


def mha(B: int, T: int, M: int, D: int) -> int:
    """Projections of T queries and M keys/values, scores, the weighted
    sum and the output projection."""
    return (linear(B * T, D, D) + linear(B * M, D, 2 * D)
            + 4 * B * T * M * D + linear(B * T, D, D))


def qan(B: int, T: int, D: int, queries: int = 10) -> int:
    """Scores and weighted sums of every learned query over the T x T
    band matrix as the layer computes it, then the mix over queries."""
    return 4 * B * queries * T * T * D + 2 * B * queries * T * D


def ff(tokens: int, D: int, F: int) -> int:
    return linear(tokens, D, F) + linear(tokens, F, D)


def stack(B: int, T: int, D: int, F: int, layers: int, memory: int) -> int:
    """First and last vanilla, QaN between; with ``memory`` > 0 the
    decoder's cross-attention over that many tokens."""
    n = 0
    for i in range(layers):
        vanilla = i in (0, layers - 1)
        n += mha(B, T, T, D) if vanilla else qan(B, T, D)
        if memory:
            n += mha(B, T, memory, D)
        n += ff(B * T, D, F)
    return n


def timestep(B: int, D: int) -> int:
    return 2 * linear(B, D, D)


def smpl_denoise(cfg: dict, rows: int, frames: int) -> int:
    D, F = cfg["embedding_dim"], cfg["ff_size"]
    S = cfg["smpl_dim"] + 12
    tok = rows * frames
    return (linear(tok, S, D) + timestep(rows, D)
            + stack(rows, frames, D, F, cfg["num_layers"], cfg["past_len"])
            + linear(tok, D, S))


def shared_mlp(rows: int, c_in: int, widths) -> int:
    n = 0
    for c in widths:
        n += linear(rows, c_in, c)
        c_in = c
    return n


def pointnet(clips: int, points: int) -> int:
    """Stage 1: the distance matrix of 1024 centres, two scales of 16 and
    32 neighbours; stage 2: one centre, 16 and 32 of the 1024."""
    M = 1024
    n = 2 * 3 * clips * points * M
    n += shared_mlp(clips * M * 16, 4, (16, 16, 32))
    n += shared_mlp(clips * M * 32, 4, (32, 32, 64))
    n += 2 * 3 * clips * M
    n += shared_mlp(clips * 16, 99, (64, 64, 128))
    n += shared_mlp(clips * 32, 99, (64, 96, 128))
    return n + linear(clips, 256, 253)


def smpl_encode(cfg: dict, clips: int, points: int) -> int:
    D, F, p = cfg["embedding_dim"], cfg["ff_size"], cfg["past_len"]
    S = cfg["smpl_dim"] + 12
    return (pointnet(clips, points) + linear(clips * p, S, D)
            + stack(clips, p, D, F, cfg["num_layers"], 0))


def skeleton_denoise(cfg: dict, rows: int, frames: int) -> int:
    D, F = cfg["embedding_dim"], cfg["ff_size"]
    bd, od = 3 * cfg["num_joints"], 3 * cfg["num_points"]
    tok = rows * frames
    return (linear(tok, bd + od, D) + timestep(rows, D)
            + stack(rows, frames, D, F, cfg["num_layers"], cfg["past_len"])
            + linear(tok, D, bd + 7)
            + 2 * tok * cfg["num_points"] * 9)


def skeleton_encode(cfg: dict, clips: int) -> int:
    D, F, p = cfg["embedding_dim"], cfg["ff_size"], cfg["past_len"]
    bd, od = 3 * cfg["num_joints"], 3 * cfg["num_points"]
    return (linear(clips, od, D) + linear(clips * p, bd + od, D)
            + stack(clips, p, D, F, cfg["num_layers"], 0))


# -- the hand-written kernels -------------------------------------------------

def k1(clips: int, points: int, centres: int, channels: int,
       nsample: int) -> tuple:
    """Ball query and grouping of one radius scale: a comparison a pair;
    the transposed distances, the data rows and the centres read, the
    grouped rows written."""
    ops = clips * points * centres
    nbytes = F32 * (clips * points * centres + clips * points * channels
                    + clips * centres * 3
                    + clips * centres * nsample * channels)
    return ops, nbytes


def nn_sweep(frames: int, queries: int, surface: int, signed: bool,
             pairs: int = None) -> tuple:
    """K2-K4: 8 operations a visited pair; queries, surface (and normals)
    read once; distance, index (and sign) written."""
    if pairs is None:
        pairs = frames * queries * surface
    nbytes = F32 * frames * (3 * queries + (6 if signed else 3) * surface
                             + (3 if signed else 2) * queries)
    return NN_OPS_PER_PAIR * pairs, nbytes


def k2_pairs(a, b, delta: float) -> int:
    """The pairs K2 visits on these inputs: every query of a frame against
    each surface segment that has a point within delta (and the flags'
    1 % slack on its square) of the box of the frame's queries."""
    import numpy as np
    import torch

    lo = a.amin(1, keepdim=True)
    hi = a.amax(1, keepdim=True)
    e = torch.maximum(lo - b, b - hi).clamp(min=0.0)
    e2 = e * e
    d2 = (e2[..., 0] + e2[..., 1]) + e2[..., 2]
    M = b.shape[1]
    n_seg = -(-M // SEGMENT)
    d2 = torch.nn.functional.pad(d2, (0, n_seg * SEGMENT - M),
                                 value=float("inf"))
    d = np.float32(delta)
    threshold = float(np.float32(float(d * d) * 1.01))
    near = d2.reshape(b.shape[0], n_seg, SEGMENT).amin(-1) < threshold
    size = torch.full((n_seg,), SEGMENT, device=b.device)
    size[-1] = M - (n_seg - 1) * SEGMENT
    return int((near * size).sum()) * a.shape[1]


def least_s(ops: int, nbytes: int) -> float:
    from bench_port.harness import F32_FLOP_PER_S, HBM_BYTES_PER_S

    return max(ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
