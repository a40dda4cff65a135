"""The batched row gather of the port (`interdiff_torch/ops/gather.py`, kernel
K5's plain version on the CPU) against `interdiff_tpu/ops/pallas_gather.py`:
the XLA gather, the Pallas kernel in interpret mode as
`tests/test_pallas_gather.py` runs it, and the gradient of `gather_rows`.
A gather only copies values, so everything is compared exactly (the Pallas
select-sum by value: it turns -0.0 into +0.0, a copy keeps it)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import interdiff_tpu.ops.pallas_gather as jpg  # noqa: E402
from interdiff_tpu.ops.pointcloud import query_and_group as j_qag  # noqa: E402
from interdiff_torch.ops import gather as tg  # noqa: E402
from interdiff_torch.ops import group as tgroup  # noqa: E402
from interdiff_torch.ops import pointcloud as tpc  # noqa: E402


def _case(seed, B, N, C, K):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, C)).astype(np.float32),
            rng.integers(0, N, size=(B, K)).astype(np.int32))


@pytest.mark.parametrize("B,N,C,K", [(3, 50, 4, 37), (2, 33, 1, 65),
                                     (2, 33, 3, 65), (2, 33, 8, 65),
                                     (1, 17, 4, 1)])
def test_plain_matches_xla_and_interpreted_pallas(B, N, C, K):
    data, idx = _case(0, B, N, C, K)
    got = tg.gather_rows_plain(torch.from_numpy(data),
                               torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpg._xla_gather_rows(jnp.asarray(data),
                                             jnp.asarray(idx))))
    np.testing.assert_array_equal(
        got, np.asarray(jpg.gather_rows_pallas(
            jnp.asarray(data), jnp.asarray(idx), tile_k=16, interpret=True)))


def test_edge_indices_and_index_types():
    """Repeated indices and both ends of the row range, int32 and int64."""
    N = 17
    data, _ = _case(1, 1, N, 4, 1)
    idx = np.array([[0, N - 1, 0, 5, 5, N - 1, 2]], np.int32)
    want = np.asarray(jpg.gather_rows_pallas(
        jnp.asarray(data), jnp.asarray(idx), tile_k=8, interpret=True))
    for dtype in (torch.int32, torch.int64):
        got = tg.gather_rows(torch.from_numpy(data),
                             torch.from_numpy(idx).to(dtype))
        np.testing.assert_array_equal(got.numpy(), want)


def test_negative_zero_is_kept_where_the_select_sum_drops_it():
    data = np.full((1, 4, 3), -0.0, np.float32)
    idx = np.array([[2, 0]], np.int32)
    got = tg.gather_rows_plain(torch.from_numpy(data), torch.from_numpy(idx))
    want = np.asarray(jpg.gather_rows_pallas(
        jnp.asarray(data), jnp.asarray(idx), tile_k=8, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)  # equal by value
    assert bool(torch.signbit(got).all()) and not np.signbit(want).any()


def test_out_of_range_index():
    """The Pallas kernel yields a zero row (no row matches), XLA's gather
    clamps, and the port's plain version raises; the CUDA kernel writes the
    Pallas kernel's zero row (checked on the card by chip_smoke.py)."""
    data, _ = _case(2, 1, 5, 4, 1)
    idx = np.array([[1, 5, 2]], np.int32)
    pallas = np.asarray(jpg.gather_rows_pallas(
        jnp.asarray(data), jnp.asarray(idx), tile_k=8, interpret=True))
    np.testing.assert_array_equal(pallas[0, 1], np.zeros(4, np.float32))
    xla = np.asarray(jpg._xla_gather_rows(jnp.asarray(data),
                                          jnp.asarray(idx)))
    np.testing.assert_array_equal(xla[0, 1], data[0, 4])
    with pytest.raises(IndexError):
        tg.gather_rows(torch.from_numpy(data), torch.from_numpy(idx))


def test_gradient_matches_jax(monkeypatch):
    """The `Function`'s backward (a scatter-add at idx) against `jax.grad`
    through `gather_rows` with the Pallas kernel forced on."""
    monkeypatch.setattr(jpg, "_FORCE_PALLAS_INTERPRET", True)
    data, idx = _case(3, 2, 29, 4, 51)
    ct = np.random.default_rng(4).standard_normal((2, 51, 4)).astype(
        np.float32)
    want = jax.grad(lambda d: jnp.sum(
        jpg.gather_rows(d, jnp.asarray(idx)) * ct))(jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_(True)
    out = tg.gather_rows(d, torch.from_numpy(idx))
    assert type(out.grad_fn).__name__.startswith("_GatherRows")
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want), atol=1e-6)


def test_query_and_group_routes_narrow_float32_through_k5(monkeypatch):
    """C <= 8 float32 goes through `gather_rows`, wider or other data does
    not, and the plain versions of K1 and K6 never do."""
    calls = []
    real = tpc.gather_rows
    monkeypatch.setattr(tpc, "gather_rows", lambda d, i: (
        calls.append(tuple(d.shape)), real(d, i))[1])
    rng = np.random.default_rng(5)
    B, N, M, S = 2, 64, 32, 8
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, 1)).astype(np.float32)
    txyz, tfeats = torch.from_numpy(xyz), torch.from_numpy(feats)
    got = tpc.query_and_group(txyz, txyz[:, :M], tfeats, 0.9, S)
    assert calls == [(B, N, 4)]
    want = j_qag(jnp.asarray(xyz), jnp.asarray(xyz[:, :M]),
                 jnp.asarray(feats), 0.9, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    wide = torch.from_numpy(rng.standard_normal((B, N, 96)).astype(
        np.float32))
    tpc.query_and_group(txyz, txyz[:, :M], wide, 0.9, S)
    tpc.query_and_group(txyz.double(), txyz[:, :M].double(), None, 0.9, S)
    d2t = tgroup.pairwise_sqdist_t(txyz, txyz[:, :M])
    plain = tgroup.group_plain(d2t, torch.cat([txyz, tfeats], -1),
                               txyz[:, :M], 0.9, S)
    assert calls == [(B, N, 4)]
    assert torch.equal(plain, got)


def test_gate_and_cuda_wrapper():
    assert tg.in_gate(torch.zeros((1, 4, 8)))
    assert not tg.in_gate(torch.zeros((1, 4, 9)))
    assert not tg.in_gate(torch.zeros((1, 4, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        tg.gather_rows_cuda(torch.zeros((1, 4, 4)),
                            torch.zeros((1, 2), dtype=torch.int64))
