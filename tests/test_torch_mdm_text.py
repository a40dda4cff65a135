"""MDM text-to-motion in the port (`models/clip_text.py`,
`models/mdm_text.py`, `geometry/humanml.py`, `eval/text.py`,
`cli/eval_text.py`) against the plain reference of the benchmark,
`bench_port/reference/mdm_text.py`, on the CPU at small widths with seeded
weights; and the additive mask of `ops/attention.py`, which the two
InterDiff denoisers do not pass: their outputs stay bit for bit those of
the attention without the mask.

Tolerances: the port and the reference run the same float32 operations in
other orders and groupings (a fused 2B-row guided call against two calls,
``nn.Embedding`` against indexing, `TorchMHA` against its plain copy), so
they agree to a few float32 roundings of the largest value, which a
relative 1e-5 covers; what must not change at all (the padding behind the
causal mask, an unmasked attention) is held bitwise."""

import math

import numpy as np
import pytest
import torch

from bench_port import weights
from bench_port.reference import diffusion as ref_diff
from bench_port.reference import mdm_text as ref
from interdiff_torch.cli import eval_text
from interdiff_torch.config import (
    DiffusionConfig,
    SkeletonTrackConfig,
    SmplTrackConfig,
    TextTrackConfig,
)
from interdiff_torch.eval.text import TextEvalConfig, caption_ids
from interdiff_torch.geometry.humanml import recover_from_ric
from interdiff_torch.models import layers
from interdiff_torch.ops.attention import causal_mask, multi_head_attention

SMALL = dict(latent_dim=64, ff_size=128, num_layers=2, num_heads=2,
             clip_dim=64, vocab_size=100, context_length=77,
             transformer_width=64, transformer_layers=2, transformer_heads=2)
FRAMES = 12
REL = 1e-5  # a few float32 roundings of the largest value (module docstring)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    model = TextTrackConfig(**SMALL).build_model("cpu")
    sd = weights.seeded_state(model, 5)
    model.load_state_dict(sd)
    cfg = {**SMALL, "num_frames": FRAMES, "njoints": 263, "num_joints": 22,
           "guidance_param": 2.5, "diffusion_steps": 5}
    rng = np.random.default_rng(3)
    ids = torch.as_tensor(caption_ids(
        [rng.integers(1, 97, n) for n in (6, 20, 13)], vocab_size=100))
    return model, sd, cfg, ids


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@torch.no_grad()
def test_the_tower_pools_the_eot_row(small):
    model, sd, cfg, ids = small
    pooled = model.encode_text(ids)
    assert pooled.shape == (3, 64)
    assert _rel(pooled, ref.tower(sd, cfg, ids)) < REL


@torch.no_grad()
def test_ids_after_eot_leave_the_pooled_text_unchanged(small):
    model, _, _, ids = small
    noisy = ids.clone()
    eot = ids.argmax(-1)
    for i, e in enumerate(eot.tolist()):
        noisy[i, e + 1:] = torch.randint(1, 98, (77 - e - 1,))
    assert not torch.equal(noisy, ids)
    assert torch.equal(model.encode_text(noisy), model.encode_text(ids))


@pytest.mark.parametrize("t", [0, 1, 2, 4])
@torch.no_grad()
def test_the_guided_x0_is_the_sources_two_calls(small, t):
    model, sd, cfg, ids = small
    g = torch.Generator().manual_seed(t)
    x = torch.randn(3, FRAMES, 263, generator=g)
    text = model.encode_text(ids)
    ts = torch.full((3,), t)
    scale = torch.full((3,), 2.5)
    x0 = model.denoise(x, ts, text, scale)
    assert _rel(x0, ref.guided(sd, cfg, x, t, text)) < REL
    # the halves alone are MDM's calls
    assert _rel(model.denoise(x, ts, text), ref.mdm(sd, cfg, x, t, text)) \
        < REL
    assert not torch.equal(x0, model.denoise(x, ts, text))


@torch.no_grad()
def test_a_null_row_carries_the_text_embeddings_bias(small):
    model, sd, cfg, ids = small
    x = torch.randn(3, FRAMES, 263, generator=torch.Generator().manual_seed(9))
    ts = torch.tensor([3, 1, 0])
    text = model.encode_text(ids)
    null = model.denoise(x, ts, text, force_mask=True)
    zeros = torch.zeros_like(text)
    assert torch.equal(null, model.denoise(x, ts, zeros))
    assert _rel(null, torch.stack([ref.mdm(sd, cfg, x[i:i + 1], int(t),
                                           zeros[i:i + 1])[0]
                                   for i, t in enumerate(ts.tolist())])) < REL
    nobias = {**sd, "embed_text.bias": torch.zeros_like(
        sd["embed_text.bias"])}
    assert _rel(null, ref.mdm(nobias, cfg, x, 3, zeros)) > 1e-3


def test_recover_from_ric_is_humanml3ds():
    g = torch.Generator().manual_seed(4)
    data = torch.randn(2, 30, 263, generator=g)
    joints = recover_from_ric(data, 22)
    assert joints.shape == (2, 30, 22, 3)
    want = ref.recover_from_ric(data, 22)
    assert _rel(joints, want) < REL
    # the first frame: heading 0, the root at (0, y, 0)
    assert torch.equal(joints[:, 0, 0, 1], data[:, 0, 3])
    assert torch.equal(joints[:, 0, 0, [0, 2]], torch.zeros(2, 2))


@torch.no_grad()
def test_a_five_step_guided_evaluate_is_the_reference_loop(small):
    model, sd, cfg, ids = small
    diffusion = DiffusionConfig(diffusion_steps=5).build("cpu")
    ecfg = TextEvalConfig(num_frames=FRAMES)
    g = torch.Generator().manual_seed(11)
    noise = torch.randn(3, FRAMES, 263, generator=g)
    step_noise = torch.randn(5, 3, FRAMES, 263, generator=g)
    motions = []
    totals, nb = eval_text.evaluate(
        ecfg, model, diffusion, [{"ids": ids.numpy()}],
        noises=iter([(noise, step_noise)]), report=lambda n, m: None,
        motions=motions)
    assert nb == 1 and set(totals) == {"root_travel", "joint_speed"}
    sched = ref_diff.cosine_schedule(5)
    text = ref.tower(sd, cfg, ids)
    x = noise
    for n, t in enumerate(range(4, -1, -1)):
        x = ref.step(sched, x, t, ref.guided(sd, cfg, x, t, text),
                     step_noise[n])
    assert _rel(motions[0]["sample"], x) < REL
    assert _rel(motions[0]["joints"], ref.recover_from_ric(x, 22)) < REL


def test_caption_ids_keep_clips_layout():
    ids = caption_ids([[5, 6], list(range(1, 30))], vocab_size=100,
                      context_length=24)
    assert ids[0, :4].tolist() == [98, 5, 6, 99] and not ids[0, 4:].any()
    assert ids[1, 0] == 98 and ids[1, 21] == 99  # 20 tokens kept
    assert ids[1, 1:21].tolist() == list(range(1, 21))
    with pytest.raises(ValueError):
        caption_ids([[98]], vocab_size=100)


# -- the additive mask of ops/attention.py ------------------------------------

def _attention_before(q, k, v, *, num_heads):
    """`multi_head_attention` as it was before it took a mask."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = num_heads
    hd = D // H
    qh = q.reshape(B, Tq, H, hd).transpose(1, 2)
    kh = k.reshape(B, Tk, H, hd).transpose(1, 2)
    vh = v.reshape(B, Tk, H, hd).transpose(1, 2)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, vh)
    return out.transpose(1, 2).reshape(B, Tq, D)


def test_a_masked_attention_is_a_masked_softmax():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 7, 8, generator=g) for _ in range(3))
    out = multi_head_attention(q, k, v, num_heads=2, mask=causal_mask(7))
    want = torch.empty_like(out)
    for h in range(2):
        s = slice(4 * h, 4 * h + 4)
        scores = q[..., s] @ k[..., s].transpose(-1, -2) / 2.0
        scores = scores.masked_fill(
            torch.ones(7, 7, dtype=torch.bool).triu(1), float("-inf"))
        want[..., s] = torch.softmax(scores, -1) @ v[..., s]
    assert _rel(out, want) < REL
    assert torch.equal(out[:, 0], v[:, 0])  # the first query sees itself
    assert torch.equal(multi_head_attention(q, k, v, num_heads=2),
                       _attention_before(q, k, v, num_heads=2))


@pytest.mark.parametrize("track", ["smpl", "skeleton"])
@torch.no_grad()
def test_the_interdiff_denoisers_are_unchanged_bitwise(track, monkeypatch):
    small = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
    g = torch.Generator().manual_seed(7)
    if track == "smpl":
        model = SmplTrackConfig(**small).build_model("cpu")
        inputs = (torch.randn(2, 35, 144, generator=g), torch.tensor([5, 700]),
                  torch.randn(2, 10, 32, generator=g))
    else:
        model = SkeletonTrackConfig(**small).build_model("cpu")
        inputs = (torch.randn(2, 20, 106, generator=g), torch.tensor([5, 700]),
                  torch.randn(2, 12, 3, generator=g),
                  torch.randn(2, 10, 32, generator=g))
    now = model.denoise(*inputs)
    monkeypatch.setattr(
        layers, "multi_head_attention",
        lambda q, k, v, *, num_heads, mask=None: _attention_before(
            q, k, v, num_heads=num_heads))
    assert torch.equal(now, model.denoise(*inputs))
