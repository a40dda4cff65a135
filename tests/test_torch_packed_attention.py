"""MDM's packed self-attention (`interdiff_torch/ops/packed_attention.py`,
kernel K7, and `models/layers.py::PackedEncoderLayer`).

On the CPU, in seconds: the plain packed attention against
`multi_head_attention` on the q, k and v slices of the same packed tensor,
with and without an additive mask; the new layer kind off the card is
`EncoderLayer` bit for bit with its state-dict keys; a CPU ``denoise`` of
MDM counts its 8 layers and none served by K7.

On the card (marked ``chip``; skipped without one, run there with
``python -m pytest --noconftest tests/test_torch_packed_attention.py -m
chip``): K7 against its plain version at the MDM cell's shape (B = 64,
T = 197, H = 4, hd = 128), at ragged T (35, 200, 97 at 8 heads, 1),
under a mask; what it refuses; a head size it is not built for raising
in the layer and in MDM's ``denoise``; the layer's packed path against
`EncoderLayer`; and 8 launches on an eager guided call of MDM.

Tolerances: the plain version and `multi_head_attention` run the same
float32 products in other groupings (einsum against matmul on transposed
views), K7 sums in another order again and keeps an online softmax; each
agrees to a few float32 roundings of the largest output, inside 1e-6
relative on the CPU and 2e-6 on the card (sums of up to 200 terms).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from interdiff_torch.config import TextTrackConfig  # noqa: E402
from interdiff_torch.models import layers  # noqa: E402
from interdiff_torch.ops import packed_attention as k7  # noqa: E402
from interdiff_torch.ops.attention import (  # noqa: E402
    causal_mask,
    multi_head_attention,
)
from interdiff_torch.utils import profiling  # noqa: E402

REL_CPU = 1e-6
REL_CARD = 2e-6
SMALL = dict(latent_dim=64, ff_size=128, num_layers=8, num_heads=2,
             clip_dim=64, vocab_size=100, context_length=77,
             transformer_width=64, transformer_layers=2, transformer_heads=2)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _qkv(B, T, D, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, T, 3 * D)).astype(
        np.float32)).to(device)


def _sliced(qkv, num_heads, mask=None):
    D = qkv.shape[-1] // 3
    return multi_head_attention(qkv[..., :D], qkv[..., D:2 * D],
                                qkv[..., 2 * D:], num_heads=num_heads,
                                mask=mask)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("T", [5, 35, 197])
def test_plain_packed_attention_is_multi_head_attention(T, masked):
    qkv = _qkv(2, T, 32, T)
    mask = None
    if masked:  # causal, and a finite additive bias on the rest
        rng = np.random.default_rng(T + 1)
        mask = causal_mask(T) + torch.from_numpy(
            rng.standard_normal((T, T)).astype(np.float32))
    got = k7.packed_attention(qkv, 4, mask)
    want = _sliced(qkv, 4, mask)
    assert got.shape == (2, T, 32)
    assert _rel(got, want) < REL_CPU
    if masked:  # the first query sees only itself
        assert torch.allclose(got[:, 0], qkv[:, 0, 64:], rtol=0, atol=1e-6)


def test_the_packed_layer_off_the_card_is_the_encoder_layer():
    torch.manual_seed(0)
    plain = layers.EncoderLayer(64, 2, 128)
    packed = layers.PackedEncoderLayer(64, 2, 128)
    assert list(packed.state_dict()) == list(plain.state_dict())
    packed.load_state_dict(plain.state_dict(), strict=True)
    x = torch.randn(3, 11, 64, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        assert not packed.packed_path(x, train=False)
        assert torch.equal(packed(x), plain(x))
    assert torch.equal(packed(x), plain(x))  # with a gradient
    dropped = packed(x, train=True, generator=g)
    assert torch.equal(dropped, plain(x, train=True,
                                      generator=torch.Generator()
                                      .manual_seed(2)))


def test_mdm_builds_the_packed_kind_with_its_keys():
    model = TextTrackConfig(**SMALL).build_model("cpu")
    assert model.seqTransEncoder.kinds == ("enc_packed",) * 8
    keys = [k for k in model.state_dict() if k.startswith("seqTransEncoder.")]
    assert "seqTransEncoder.layer_7.self_attn.in_proj_kernel" in keys
    assert len(keys) == 8 * len(layers.EncoderLayer(64, 2, 128).state_dict())


def test_a_cpu_denoise_counts_eight_layers_and_none_fused():
    model = TextTrackConfig(**SMALL).build_model("cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 263, generator=g)
    text = torch.randn(2, 64, generator=g)
    with torch.no_grad(), profiling.session() as s:
        model.denoise(x, torch.tensor([3, 1]), text, torch.full((2,), 2.5))
    assert s.counters["attention.layers"] == 8
    assert s.counters["attention.fused_layers"] == 0
    assert s.counters["guidance.calls"] == 1


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("B,T,H,hd", [(64, 197, 4, 128), (3, 35, 4, 128),
                                      (2, 200, 4, 128), (4, 97, 8, 128),
                                      (1, 1, 4, 128)])
def test_the_kernel_is_its_plain_version(B, T, H, hd, cuda):
    qkv = _qkv(B, T, H * hd, T, cuda)
    with torch.no_grad():
        before = k7.launches
        got = k7.packed_attention(qkv, H)
        assert k7.launches == before + 1
        want = k7.packed_attention_plain(qkv, H)
        torch.cuda.synchronize()
        assert _rel(got, want) <= REL_CARD
        mask = causal_mask(T).to(cuda)
        assert _rel(k7.packed_attention(qkv, H, mask),
                    k7.packed_attention_plain(qkv, H, mask)) <= REL_CARD


@pytest.mark.chip
def test_the_kernel_refuses_what_it_does_not_take(cuda):
    qkv = _qkv(2, 9, 256, 0, cuda)  # hd 64 at 4 heads
    with pytest.raises(ValueError):
        k7.packed_attention(qkv, 4)
    with pytest.raises(ValueError):
        k7.packed_attention(_qkv(2, 9, 512, 0, cuda).transpose(0, 1), 4)
    leaf = _qkv(2, 9, 512, 0, cuda).requires_grad_()
    with pytest.raises(ValueError):
        k7.packed_attention(leaf, 4)


@pytest.mark.chip
def test_a_head_size_the_kernel_lacks_raises_on_the_card(cuda):
    packed = layers.PackedEncoderLayer(256, 4, 512).to(cuda)  # hd 64
    x = torch.randn(2, 9, 256, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError):
        packed(x)
    assert packed(x).shape == x.shape  # a gradient: EncoderLayer's path
    model = TextTrackConfig(**SMALL).build_model(cuda)  # hd 32
    g = torch.Generator(device=cuda).manual_seed(5)
    with torch.no_grad(), pytest.raises(ValueError):
        model.denoise(torch.randn(2, 6, 263, device=cuda, generator=g),
                      torch.tensor([3, 1], device=cuda),
                      torch.randn(2, 64, device=cuda, generator=g),
                      torch.full((2,), 2.5, device=cuda))


@pytest.mark.chip
def test_the_packed_layer_on_the_card(cuda):
    torch.manual_seed(0)
    plain = layers.EncoderLayer(512, 4, 1024).to(cuda)
    packed = layers.PackedEncoderLayer(512, 4, 1024).to(cuda)
    packed.load_state_dict(plain.state_dict(), strict=True)
    x = torch.randn(8, 197, 512, device=cuda)
    with torch.no_grad():
        before = k7.launches
        got = packed(x)
        assert k7.launches == before + 1
        assert _rel(got, plain(x)) <= REL_CARD
    graded = packed(x)  # a gradient is recorded: EncoderLayer's own path
    assert k7.launches == before + 1
    assert torch.equal(graded.detach(), plain(x).detach())


@pytest.mark.chip
def test_an_eager_guided_call_launches_eight_times(cuda):
    model = TextTrackConfig().build_model(cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(4, 196, 263, device=cuda, generator=g)
    ts = torch.randint(0, 1000, (4,), device=cuda, generator=g)
    text = torch.randn(4, 512, device=cuda, generator=g)
    scale = torch.full((4,), 2.5, device=cuda)
    with torch.no_grad(), profiling.session() as s:
        before = k7.launches
        model._denoise(x, ts, text, scale)
        assert k7.launches == before + 8
        model.denoise(x, ts, text, scale)
    assert s.counters["attention.layers"] == 8
    assert s.counters["attention.fused_layers"] == 8
