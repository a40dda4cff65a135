"""`flops.py` against counts by hand on small shapes."""

import torch

from bench_port import flops


def test_linear_and_ff():
    assert flops.linear(3, 4, 5) == 2 * 3 * 4 * 5
    assert flops.ff(2, 4, 8) == 2 * 2 * 4 * 8 * 2


def test_mha_by_hand():
    B, T, M, D = 1, 2, 3, 4
    proj_q, proj_kv, out = 2 * T * D * D, 2 * M * D * 2 * D, 2 * T * D * D
    scores, weighted = 2 * T * M * D, 2 * T * M * D
    assert flops.mha(B, T, M, D) == proj_q + proj_kv + scores + weighted \
        + out


def test_stack_kinds():
    B, T, D, F = 1, 3, 4, 8
    vanilla = flops.mha(B, T, T, D) + flops.ff(T, D, F)
    qan = flops.qan(B, T, D) + flops.ff(T, D, F)
    assert flops.stack(B, T, D, F, 3, 0) == 2 * vanilla + qan
    assert flops.stack(B, T, D, F, 3, 2) == 2 * vanilla + qan \
        + 3 * flops.mha(B, T, 2, D)


def test_nn_sweep_counts_pairs_and_bytes():
    ops, nbytes = flops.nn_sweep(2, 3, 5, True)
    assert ops == 8 * 2 * 3 * 5
    assert nbytes == 4 * 2 * (3 * 3 + 6 * 5 + 3 * 3)
    assert flops.nn_sweep(2, 3, 5, True, pairs=7)[0] == 56


def test_k2_pairs_flags_segments_near_the_box():
    a = torch.zeros(1, 4, 3)  # every query at the origin
    b = torch.full((1, 600, 3), 10.0)
    b[0, 300] = 0.1  # one point of segment 1 within delta
    b[0, 599] = 0.0  # one of the last, partial segment (88 points)
    assert flops.k2_pairs(a, b, 0.25) == 4 * (256 + 88)


def test_least_time_takes_the_larger_bound():
    assert flops.least_s(67e12, 0) == 1.0
    assert flops.least_s(0, 3.35e12) == 1.0
