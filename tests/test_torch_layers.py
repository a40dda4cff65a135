"""Transformer layers of the port (`interdiff_torch/models/layers.py`,
`ops/attention.py`) against the flax layers of `interdiff_tpu`, with the
flax weights moved over by the weight bridge (`utils/convert.py`).
Tolerance 1e-4 (module forwards, PARITY.md row 6)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.models import layers as jl  # noqa: E402
from interdiff_tpu.ops import attention as ja  # noqa: E402
from interdiff_torch.models import layers as tl  # noqa: E402
from interdiff_torch.ops import attention as ta  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

D, H, FF, T, TM, B = 32, 4, 64, 35, 10, 2


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mem = rng.standard_normal((B, TM, D)).astype(np.float32)
    return x, mem


def _check(flax_mod, torch_mod, cross):
    x, mem = _inputs()
    args = (jnp.asarray(x), jnp.asarray(mem)) if cross else (jnp.asarray(x),)
    variables = flax_mod.init(jax.random.PRNGKey(3), *args)
    ref = np.asarray(flax_mod.apply(variables, *args))
    torch_mod.load_state_dict(
        flax_to_torch_state_dict(jax.device_get(variables)), strict=True)
    with torch.no_grad():
        got = torch_mod(torch.from_numpy(x),
                        torch.from_numpy(mem) if cross else None).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["enc", "dec", "qan_enc", "qan_dec",
                                  "enc_packed"])
def test_layer_matches_flax(kind):
    flax_cls = {"enc": jl.EncoderLayer, "enc_packed": jl.EncoderLayer,
                "dec": jl.DecoderLayer,
                "qan_enc": jl.QaNEncoderLayer,
                "qan_dec": jl.QaNDecoderLayer}[kind]
    _check(flax_cls(D, H, FF), tl._KINDS[kind](D, H, FF),
           cross=kind.endswith("dec"))


@pytest.mark.parametrize("cross", [False, True])
def test_transformer_stack_matches_flax(cross):
    kinds = jl.mdm_stack_kinds(4, cross=cross)
    assert tl.mdm_stack_kinds(4, cross=cross) == kinds
    _check(jl.TransformerStack(D, H, FF, kinds),
           tl.TransformerStack(D, H, FF, kinds), cross=cross)


def test_embeddings_and_attention_math():
    rng = np.random.default_rng(12)
    np.testing.assert_array_equal(tl.sinusoidal_table(64, D),
                                  jl.sinusoidal_table(64, D))
    q = rng.standard_normal((TM, D)).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    np.testing.assert_allclose(
        ta.banded_qan_attention(torch.from_numpy(q), torch.from_numpy(x),
                                num_heads=H).numpy(),
        np.asarray(ja.banded_qan_attention(jnp.asarray(q), jnp.asarray(x),
                                           num_heads=H)),
        atol=1e-5, rtol=1e-5)

    ts = np.array([0, 999], np.int32)
    emb = jl.TimestepEmbedder(D)
    variables = emb.init(jax.random.PRNGKey(0), jnp.asarray(ts))
    t_emb = tl.TimestepEmbedder(D)
    t_emb.load_state_dict(
        flax_to_torch_state_dict(jax.device_get(variables)), strict=True)
    with torch.no_grad():
        got = t_emb(torch.from_numpy(ts)).numpy()
    np.testing.assert_allclose(got, np.asarray(emb.apply(variables,
                                                         jnp.asarray(ts))),
                               atol=1e-5, rtol=1e-5)
