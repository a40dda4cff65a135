"""K1 grouping of the port (`interdiff_torch/ops/group.py`, plain version on
the CPU) against the JAX reference: the XLA `query_and_group` and the Pallas
`fused_query_group` run in interpret mode.  Every side gets the same numpy
distances, so the selection must agree bit for bit.  FPS indices of the
port match `interdiff_tpu/ops/pointcloud.py` exactly."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (numpy builders of the card's edge clouds)
import interdiff_tpu.ops.pallas_group as pgr  # noqa: E402
from interdiff_tpu.ops import pointcloud as jpc  # noqa: E402
from interdiff_torch.ops import _build  # noqa: E402
from interdiff_torch.ops import group as tgroup  # noqa: E402
from interdiff_torch.ops import sa as tsa  # noqa: E402
from interdiff_torch.ops import pointcloud as tpc  # noqa: E402

B, N, M, C = 2, 256, 128, 4
SCALES = [(0.05, 16), (0.1, 32)]


def _cloud():
    """A tight cluster (full rows), a sparse shell (short rows) and centers
    far away from every point (zero-hit rows)."""
    rng = np.random.default_rng(7)
    dense = rng.normal(0.0, 0.015, (B, N // 4, 3))
    sparse = rng.uniform(-0.4, 0.4, (B, N - N // 4, 3))
    xyz = np.concatenate([dense, sparse], axis=1).astype(np.float32)
    xyz = xyz[:, rng.permutation(N)]
    new_xyz = xyz[:, :M].copy()
    new_xyz[:, -8:] = 3.0 + rng.uniform(0, 1, (B, 8, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, C - 3)).astype(np.float32)
    d2 = np.array(jpc.pairwise_sqdist(jnp.asarray(new_xyz),
                                        jnp.asarray(xyz)))  # [B, M, N]
    return xyz, new_xyz, feats, d2


@pytest.mark.parametrize("radius,nsample", SCALES)
def test_group_plain_matches_jax_bitwise(monkeypatch, radius, nsample):
    xyz, new_xyz, feats, d2 = _cloud()
    hits = (d2 < np.float32(radius * radius)).sum(-1)
    assert (hits >= nsample).any() and (hits == 0).any()
    assert ((hits > 0) & (hits < nsample)).any()

    ref_xla = np.asarray(jpc.query_and_group(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(feats), radius,
        nsample, d2=jnp.asarray(d2)))
    monkeypatch.setattr(pgr, "_FORCE_PALLAS_INTERPRET", True)
    d2t = np.ascontiguousarray(d2.transpose(0, 2, 1))
    ref_pallas = np.asarray(pgr.fused_query_group(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(feats), radius,
        nsample, True, jnp.asarray(d2t)))

    got = tgroup.fused_query_group(
        torch.from_numpy(xyz), torch.from_numpy(new_xyz),
        torch.from_numpy(feats), radius, nsample,
        torch.from_numpy(d2t)).numpy()
    assert got.shape == (B, M, nsample, C)
    np.testing.assert_array_equal(got, ref_xla)
    np.testing.assert_array_equal(got, ref_pallas)


@pytest.mark.parametrize("with_features", [True, False])
@pytest.mark.parametrize("radius,nsample", SCALES)
def test_group_plain_matches_jax_on_word_and_round_boundaries(
        monkeypatch, radius, nsample, with_features):
    """`chip_smoke.k1_edge_cloud`, the cloud that `chip_smoke.py` holds K1
    and K6 to on the card: hits on both sides of a 32-candidate word and of
    a 256-candidate round of K1's walk, the S-th hit at candidate N-1, a
    block of 32 queries full in the first round beside one that never
    fills, N=300 and M=120 ragged.  The plain version against the XLA
    reference and the interpreted Pallas kernel, bit for bit."""
    xyz, new_xyz = chip_smoke.k1_edge_cloud()
    feats = (np.linalg.norm(xyz, axis=-1, keepdims=True) if with_features
             else None)
    d2 = np.array(jpc.pairwise_sqdist(jnp.asarray(new_xyz),
                                        jnp.asarray(xyz)))  # [B, M, N]
    d2t = np.ascontiguousarray(d2.transpose(0, 2, 1))
    kinds = chip_smoke.k1_row_kinds(torch.from_numpy(d2t),
                                    tpc.radius_sq(radius), nsample)
    assert min(kinds.values()) > 0, kinds

    jfeats = None if feats is None else jnp.asarray(feats)
    ref_xla = np.asarray(jpc.query_and_group(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jfeats, radius, nsample,
        d2=jnp.asarray(d2)))
    monkeypatch.setattr(pgr, "_FORCE_PALLAS_INTERPRET", True)
    ref_pallas = np.asarray(pgr.fused_query_group(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jfeats, radius, nsample,
        True, jnp.asarray(d2t)))

    got = tgroup.fused_query_group(
        torch.from_numpy(xyz), torch.from_numpy(new_xyz),
        None if feats is None else torch.from_numpy(feats), radius, nsample,
        torch.from_numpy(d2t)).numpy()
    assert got.shape == (2, 120, nsample, 4 if with_features else 3)
    np.testing.assert_array_equal(got, ref_xla)
    np.testing.assert_array_equal(got, ref_pallas)


def test_k1_and_k6_share_one_walk():
    """K1 (`csrc/ball_group.cu`) and K6 (`csrc/sa.cu`) walk and select by
    the one header `csrc/hit_words.cuh`, each calling its walk and its
    selection, and it is the only header of the sources."""
    csrc = os.path.dirname(_build.source_path(tgroup.SOURCE))
    for module in (tgroup, tsa):
        with open(_build.source_path(module.SOURCE)) as f:
            text = f.read()
        assert '#include "hit_words.cuh"' in text
        assert "hit_word_walk<" in text and "select_hits(" in text
    assert sorted(f for f in os.listdir(csrc) if f.endswith(".cuh")) == [
        "hit_words.cuh"]


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """The wrapper routes by device: a CPU tensor runs the plain version and
    the kernel counter stays put."""
    xyz, new_xyz, feats, d2 = _cloud()
    monkeypatch.setattr(tgroup, "launches", 0)
    tgroup.fused_query_group(torch.from_numpy(xyz), torch.from_numpy(new_xyz),
                             torch.from_numpy(feats), 0.1, 32)
    assert tgroup.launches == 0
    meta = torch.empty((B, N, M), device="meta")
    with pytest.raises(ValueError, match="no K1 path"):
        tgroup.fused_query_group(torch.from_numpy(xyz),
                                 torch.from_numpy(new_xyz),
                                 torch.from_numpy(feats), 0.1, 32, meta)


@pytest.mark.parametrize("npoint,groups", [(64, 1), (128, 16)])
def test_fps_indices_match_jax(npoint, groups):
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    if groups == 1:
        ref = jpc.furthest_point_sample(jnp.asarray(xyz), npoint)
        got = tpc.furthest_point_sample(torch.from_numpy(xyz), npoint)
    else:
        ref = jpc.hierarchical_fps(jnp.asarray(xyz), npoint, groups)
        got = tpc.hierarchical_fps(torch.from_numpy(xyz), npoint, groups)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tpc.gather_points(torch.from_numpy(xyz), got).numpy(),
        np.asarray(jpc.gather_points(jnp.asarray(xyz), jnp.asarray(ref))))
