"""Kernels K2, K3, K4: the port's plain versions (`interdiff_torch/ops/nn.py`)
against the interpreted Pallas kernels and the XLA fallbacks of
`interdiff_tpu`, the pruned sweep's contract, ties, batch flattening and
the routing of `ops/signed_distance.py`.  On the CPU the port takes the
plain versions; the CUDA kernels repeat their arithmetic step by step and
are held against them bit for bit on the card."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.ops import pallas_nn as jpn  # noqa: E402
from interdiff_tpu.ops import signed_distance as jsd  # noqa: E402
from interdiff_torch.ops import nn as tnn  # noqa: E402
from interdiff_torch.ops import signed_distance as tsd  # noqa: E402


def _clouds(seed, B, N, M, scale=0.3):
    rng = np.random.default_rng(seed)
    a, b, n = (rng.standard_normal((B, k, 3)).astype(np.float32) * scale
               for k in (N, M, M))
    return a, b, n


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _pruned_clouds(seed=5, B=2, N=96, M=700):
    """A long thin surface: half of the queries hover over its start, half
    float beyond delta above it (as `tests/test_pallas_nn.py` builds it)."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((B, M, 3)).astype(np.float32) * 0.1
    b[..., 0] += np.linspace(0.0, 4.0, M, dtype=np.float32)
    a = rng.standard_normal((B, N, 3)).astype(np.float32) * 0.15
    a[..., 0] += rng.uniform(0.0, 1.0, (B, N)).astype(np.float32)
    a[:, : N // 2, 1] += 3.0
    n = rng.standard_normal((B, M, 3)).astype(np.float32)
    return a, b, n


def test_nearest_neighbor_plain_matches_pallas_and_xla():
    a, b, _ = _clouds(1, 2, 200, 257)  # unaligned sizes
    sq, idx = tnn.nearest_neighbor_plain(*_t(a, b))
    d_pal, i_pal = jpn.nearest_neighbor_pallas(jnp.asarray(a), jnp.asarray(b),
                                               interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_pal))
    # same operations in the same order; XLA:CPU may contract a*b+c into an
    # FMA where PyTorch rounds twice: a few ulp of values of order 1-10
    np.testing.assert_allclose(sq.numpy(), np.asarray(d_pal), atol=1e-6)
    d_ref, i_ref = jsd.nearest_neighbor(jnp.asarray(a), jnp.asarray(b),
                                        chunk=None, use_pallas=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    # the fallback computes a^2 + b^2 - 2ab by einsum: the JAX tests' 1e-4
    np.testing.assert_allclose(sq.numpy(), np.asarray(d_ref), atol=1e-4)


def test_signed_nearest_plain_matches_pallas_and_xla():
    a, b, n = _clouds(2, 3, 150, 130)
    sq, sdot, idx = tnn.signed_nearest_plain(*_t(a, b, n))
    ja, jb, jn = (jnp.asarray(x) for x in (a, b, n))
    d_pal, s_pal, i_pal = jpn.signed_nearest_pallas(ja, jb, jn,
                                                    interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_pal))
    np.testing.assert_allclose(sq.numpy(), np.asarray(d_pal), atol=1e-6)
    np.testing.assert_allclose(sdot.numpy(), np.asarray(s_pal), atol=1e-6)
    d_ref, s_ref = jsd.signed_nearest(ja, jb, jn, use_pallas=False)
    np.testing.assert_allclose(sq.numpy(), np.asarray(d_ref), atol=1e-4)
    np.testing.assert_allclose(sdot.numpy(), np.asarray(s_ref), atol=1e-4)


def test_signed_nearest_pruned_plain_matches_pallas_and_xla():
    a, b, n = _pruned_clouds()
    delta = 0.5
    sq, sdot, idx = tnn.signed_nearest_pruned_plain(*_t(a, b, n), delta)
    ja, jb, jn = (jnp.asarray(x) for x in (a, b, n))
    d_pal, s_pal, i_pal = jpn.signed_nearest_pruned_pallas(
        ja, jb, jn, delta=delta, seg=256, interpret=True)
    near = np.asarray(d_pal) < delta * delta
    assert near.any() and (~near).any()
    # no query sits within 1e-5 of the threshold, where the two could
    # force differently
    full = tnn.signed_nearest_plain(*_t(a, b, n))[0].numpy()
    assert np.abs(full - delta * delta).min() > 1e-5
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_pal))
    np.testing.assert_allclose(sq.numpy(), np.asarray(d_pal), atol=1e-6)
    np.testing.assert_allclose(sdot.numpy(), np.asarray(s_pal), atol=1e-6)
    d_ref, s_ref = jsd.signed_nearest_pruned(ja, jb, jn, delta=delta,
                                             use_pallas=False)
    np.testing.assert_allclose(sq.numpy(), np.asarray(d_ref), atol=1e-4)
    np.testing.assert_allclose(sdot.numpy(), np.asarray(s_ref), atol=1e-4)


def test_pruned_contract_bit_equal_inside_forced_beyond():
    a, b, n = _t(*_pruned_clouds())
    delta = 0.5
    d_full, s_full, i_full = tnn.signed_nearest_plain(a, b, n)
    d_pr, s_pr, i_pr = tnn.signed_nearest_pruned_plain(a, b, n, delta)
    near = d_full < tnn.delta_squared(delta)
    assert near.any() and (~near).any()
    for got, want in ((d_pr, d_full), (s_pr, s_full), (i_pr, i_full)):
        assert torch.equal(got[near], want[near])
    assert torch.equal(d_pr[~near], torch.full_like(d_pr[~near],
                                                    delta * delta))
    assert torch.equal(s_pr[~near], torch.ones_like(s_pr[~near]))
    assert torch.equal(i_pr[~near], torch.zeros_like(i_pr[~near]))


def test_segment_flags_keep_every_segment_a_near_query_needs():
    """What the CUDA kernel relies on: the segment of the nearest point of
    every query inside delta is flagged, far segments are not."""
    a, b, n = _t(*_pruned_clouds(M=1500))
    delta = 0.5
    flags = tnn.segment_flags(a, b, delta)
    assert flags.shape == (2, -(-1500 // tnn.SEGMENT))
    assert flags.dtype == torch.int32
    d_full, _, i_full = tnn.signed_nearest_plain(a, b, n)
    near = d_full < tnn.delta_squared(delta)
    seg_of = (i_full // tnn.SEGMENT).long()
    assert bool(flags.gather(1, seg_of)[near].all())
    assert 0 < int(flags.sum()) < flags.numel()  # some segments are skipped


def test_pruned_all_far_and_single_point_cloud():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((1, 64, 3)).astype(np.float32)
    b = rng.standard_normal((1, 512, 3)).astype(np.float32) + 50.0
    n = rng.standard_normal((1, 512, 3)).astype(np.float32)
    d, s, i = tnn.signed_nearest_pruned_plain(*_t(a, b, n), 0.25)
    assert torch.equal(d, torch.full_like(d, 0.0625))
    assert torch.equal(s, torch.ones_like(s))
    assert torch.equal(i, torch.zeros_like(i))
    assert int(tnn.segment_flags(*_t(a, b), 0.25).sum()) == 0
    # a frame whose cloud is one point: its box is that point
    a1 = b[:, 100:101] + np.float32(0.01)
    d, s, i = tnn.signed_nearest_pruned_plain(*_t(a1, b, n), 0.25)
    d_f, s_f, i_f = tnn.signed_nearest_plain(*_t(a1, b, n))
    assert float(d_f) < 0.0625
    assert torch.equal(d, d_f) and torch.equal(s, s_f) and torch.equal(i, i_f)
    flags = tnn.segment_flags(*_t(a1, b), 0.25)
    assert int(flags[0, int(i_f) // tnn.SEGMENT]) == 1


def test_exact_ties_take_the_first_index():
    a = torch.zeros((1, 8, 3))
    b = torch.zeros((1, 16, 3))
    sq, idx = tnn.nearest_neighbor_plain(a, b)
    assert torch.equal(idx, torch.zeros_like(idx))
    assert torch.equal(sq, torch.zeros_like(sq))
    # duplicated surface rows: every query's winner appears twice
    qa, qb, qn = _clouds(3, 2, 40, 30)
    dup = np.concatenate([qb, qb], axis=1)
    _, _, idx = tnn.signed_nearest_plain(*_t(qa, dup, np.concatenate(
        [qn, qn], axis=1)))
    _, _, idx_single = tnn.signed_nearest_plain(*_t(qa, qb, qn))
    assert torch.equal(idx, idx_single) and int(idx.max()) < 30
    _, i_pal = jpn.nearest_neighbor_pallas(jnp.asarray(qa), jnp.asarray(dup),
                                           interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_pal))


def test_routing_flattens_batch_dims_and_broadcasts_shared_surface():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 20, 3)).astype(np.float32)
    b = rng.standard_normal((25, 3)).astype(np.float32)  # shared surface
    n = rng.standard_normal((25, 3)).astype(np.float32)
    ta, tb, tn_ = _t(a, b, n)
    sq, sdot = tsd.signed_nearest(ta, tb, tn_, chunk=512)
    assert sq.shape == sdot.shape == (2, 3, 20)
    flat = tnn.signed_nearest_plain(ta.reshape(6, 20, 3),
                                    tb.expand(6, 25, 3), tn_.expand(6, 25, 3))
    assert torch.equal(sq.reshape(6, 20), flat[0])
    assert torch.equal(sdot.reshape(6, 20), flat[1])
    d_ref, s_ref = jsd.signed_nearest(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(n), use_pallas=False)
    np.testing.assert_allclose(sq.numpy(), np.asarray(d_ref), atol=1e-4)
    np.testing.assert_allclose(sdot.numpy(), np.asarray(s_ref), atol=1e-4)
    d, i = tsd.nearest_neighbor(ta, tb)
    assert d.shape == i.shape == (2, 3, 20) and i.dtype == torch.int32
    assert torch.equal(d.reshape(6, 20), flat[0])
    dp, sp = tsd.signed_nearest_pruned(ta, tb, tn_, delta=0.6)
    want = tnn.signed_nearest_pruned_plain(
        ta.reshape(6, 20, 3), tb.expand(6, 25, 3), tn_.expand(6, 25, 3), 0.6)
    assert torch.equal(dp.reshape(6, 20), want[0])
    assert torch.equal(sp.reshape(6, 20), want[1])


def test_plain_sweep_blocks_over_frames(monkeypatch):
    a, b, n = _t(*_clouds(6, 5, 30, 40))
    want = tnn.signed_nearest_plain(a, b, n)
    monkeypatch.setattr(tnn, "_PLAIN_SCORE_ELEMS", 2 * 30 * 40)
    got = tnn.signed_nearest_plain(a, b, n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("entry", ["nearest_neighbor_cuda",
                                   "signed_nearest_cuda",
                                   "signed_nearest_pruned_cuda"])
def test_cuda_entries_raise_on_what_the_kernels_do_not_take(entry):
    """The argument checks run before the library is loaded, so they can be
    exercised without a card: a CPU, non-f32 or strided tensor raises."""
    a, b, n = _t(*_clouds(8, 2, 10, 12))
    fn = getattr(tnn, entry)
    args = (a, b) if entry == "nearest_neighbor_cuda" else (a, b, n)
    before = dict(tnn.launches)
    with pytest.raises(ValueError, match="contiguous float32 CUDA"):
        fn(*args)
    with pytest.raises(ValueError, match="contiguous float32 CUDA"):
        fn(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="strided"):
        fn(a[:, ::2], *args[1:])
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        fn(a[..., :2], *args[1:])
    assert tnn.launches == before


def test_point2point_signed_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 40, 3)).astype(np.float32)
    y = rng.standard_normal((2, 30, 3)).astype(np.float32)
    xn = rng.standard_normal((2, 40, 3)).astype(np.float32)
    got = tsd.point2point_signed(*_t(x, y, xn), return_vector=True)
    want = jsd.point2point_signed(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(xn), return_vector=True)
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    z = torch.tensor([0.0, 4.0])
    assert torch.equal(tsd.safe_sqrt(z), torch.tensor([0.0, 2.0]))
