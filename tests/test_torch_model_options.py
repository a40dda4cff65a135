"""The train-time options of the port's denoisers
(`interdiff_torch/models/{layers,mdm_smpl,mdm_skeleton}.py`) against
`interdiff_tpu`'s, at small widths (3 layers, d=32):

* the linear object encoder (``use_pointnet2=False``): ``encode`` and
  ``denoise`` within 1e-4 of JAX, one train step's loss within 1e-5 and
  its encoder gradient within 1e-5, clouds without normals refused;
* dropout and the condition mask where the draw cannot matter: eval mode
  with ``dropout`` > 0, ``cond_mask_prob = 1`` and ``force_mask`` in train
  mode, within 1e-4 of JAX (flax's masks cannot be matched bit for bit);
* where it does, by statistics: the kept share of `layers.dropout` and of
  the condition mask within 4 sigma of their rates, the kept values scaled
  by exactly 1 / (1 - p), one generator state giving one output;
* at rate 0 a module in train mode is bitwise the default module and draws
  nothing from its generator;
* the train steps, which run the denoiser in eval mode as JAX's do, refuse
  a model built with either rate above 0 instead of ignoring it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import SkeletonTrackConfig as JSkelTrack  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.models.mdm_skeleton import MDMSkeleton as JSkel  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_tpu.train import losses as jlosses  # noqa: E402
from interdiff_tpu.train import trainer as jtr  # noqa: E402
from interdiff_torch.config import (  # noqa: E402
    SkeletonTrackConfig,
    SmplTrackConfig,
)
from interdiff_torch.models.layers import dropout  # noqa: E402
from interdiff_torch.train import trainer as ttr  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
B, T, P = 2, 35, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smpl_inputs(rng):
    gt = (rng.standard_normal((B, T, 144)) * 0.5).astype(np.float32)
    pts = rng.uniform(-0.2, 0.2, (B, P, 6)).astype(np.float32)
    return gt, pts, np.array([500, 17], np.int32)


def _init(linear: bool):
    jmodel = JTrack(**SMALL, use_pointnet2=not linear).build_model()
    return jax.device_get(jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((B, T, 144)), jnp.zeros((B, P, 6)),
        jnp.zeros((B,), jnp.int32), method=JMDM.init_forward))())


@pytest.fixture(scope="module")
def smpl_variables():
    """The small PointNet++ model's variables, made once: the options
    change no parameter."""
    return _init(linear=False)


def _pair(variables, linear: bool = False, **options):
    """(JAX model, its variables, the port's model on the same weights)."""
    jmodel = JTrack(**SMALL, use_pointnet2=not linear,
                    **options).build_model()
    model = SmplTrackConfig(**SMALL, use_pointnet2=not linear,
                            **options).build_model("cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    return jmodel, variables, model


@pytest.fixture(scope="module")
def linear_pair():
    return _pair(_init(linear=True), linear=True)


def test_linear_encoder_matches_jax(linear_pair):
    jmodel, variables, model = linear_pair
    assert isinstance(model.pcEmbedding, torch.nn.Linear)
    assert tuple(model.pcEmbedding.weight.shape) == (32, 6)
    gt, pts, ts = _smpl_inputs(np.random.default_rng(0))

    def encode_denoise(v, g, p, t):
        memory = jmodel.apply(v, g, p, method=JMDM.encode)
        return memory, jmodel.apply(v, g, t, memory)

    want_mem, want = jax.jit(encode_denoise)(variables, gt, pts, ts)
    with torch.no_grad():
        mem = model.encode(torch.from_numpy(gt), torch.from_numpy(pts))
        got = model.denoise(torch.from_numpy(gt), torch.from_numpy(ts), mem)
    np.testing.assert_allclose(mem.numpy(), np.asarray(want_mem), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="6"):  # xyz without normals
        model.encode(torch.from_numpy(gt), torch.from_numpy(pts[..., :3]))


def test_linear_encoder_train_step_matches_jax(linear_pair):
    jmodel, variables, _ = linear_pair
    model = SmplTrackConfig(**SMALL, use_pointnet2=False).build_model("cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    rng = np.random.default_rng(1)
    batch = {
        "body_pose": (rng.standard_normal((B, T, 156)) * 0.2).astype(
            np.float32),
        "body_trans": rng.standard_normal((B, T, 3)).astype(np.float32),
        "obj_angles": rng.standard_normal((B, T, 3)).astype(np.float32),
        "obj_trans": rng.standard_normal((B, T, 3)).astype(np.float32),
        "obj_points": rng.uniform(-0.2, 0.2, (B, P, 6)).astype(np.float32)}
    t = np.array([3, 640], np.int64)
    noise = rng.standard_normal((B, T, 144)).astype(np.float32)
    jdiff = JTrack(**SMALL).diffusion.build()

    def jloss(v):
        gt, pts = jtr.smpl_cond_inputs({k: jnp.asarray(x)
                                        for k, x in batch.items()})
        memory = jmodel.apply(v, gt, pts, method=JMDM.encode)
        pred, target = jdiff.training_losses(
            lambda x, ts: jmodel.apply(v, x, ts, memory), gt,
            jnp.asarray(t), noise=jnp.asarray(noise))
        per_sample, _ = jlosses.smpl_diffusion_losses(
            pred, target, past_len=10, smpl_dim=132)
        return jnp.mean(per_sample)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(variables)
    state = ttr.TrainState.create(dict(model.named_parameters()),
                                  ttr.adamw(3e-4))
    before = model.pcEmbedding.weight.detach().clone()
    step = ttr.make_smpl_train_step(
        model, SmplTrackConfig(**SMALL).diffusion.build("cpu"))
    _, metrics = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()},
                      t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    # losses: PARITY.md's 1e-5
    assert abs(float(metrics["loss"]) - float(want)) <= 1e-5 * max(
        1.0, abs(float(want)))
    grads = flax_to_torch_state_dict(jax.device_get(jgrads))
    for name in ("pcEmbedding.weight", "pcEmbedding.bias"):
        g = dict(model.named_parameters())[name].grad
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    assert float((model.pcEmbedding.weight.detach() - before).abs().max()) > 0


def test_eval_mode_with_dropout_matches_jax(smpl_variables):
    jmodel, variables, model = _pair(smpl_variables, dropout=0.1,
                                     cond_mask_prob=1.0)
    gt, pts, ts = _smpl_inputs(np.random.default_rng(2))
    want = jax.jit(lambda v, g, p, t: jmodel.apply(
        v, g, p, t, method=JMDM.init_forward))(variables, gt, pts, ts)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with torch.no_grad():
        g, p, t = map(torch.from_numpy, (gt, pts, ts))
        got = model.denoise(g, t, model.encode(g, p, generator=gen),
                            generator=gen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(gen.get_state(), state)  # eval mode draws nothing


@pytest.fixture(scope="module")
def masking(smpl_variables):
    """The port's model with cond_mask_prob 1 on the small inputs, its
    memory, and JAX's train-mode denoise with and without ``force_mask``
    (one compile for both)."""
    jmodel, variables, model = _pair(smpl_variables, cond_mask_prob=1.0)
    gt, pts, ts = map(torch.from_numpy, _smpl_inputs(
        np.random.default_rng(3)))
    with torch.no_grad():
        mem = model.encode(gt, pts)

    def both(v, g, t, m):
        return {force: jmodel.apply(
            v, g, t, m, force_mask=force, train=True,
            rngs={"cond_mask": jax.random.PRNGKey(5)})
            for force in (False, True)}

    want = jax.jit(both)(variables, gt.numpy(), ts.numpy(), mem.numpy())
    return model, (gt, ts, mem), want


@pytest.mark.parametrize("force_mask", [False, True])
def test_train_mode_condition_mask_matches_jax(masking, force_mask):
    """``cond_mask_prob = 1`` (every sample masked) or ``force_mask``, in
    train mode at dropout 0: the null condition on both sides."""
    model, (gt, ts, mem), want = masking
    with torch.no_grad():
        got = model.denoise(gt, ts, mem, force_mask=force_mask, train=True,
                            generator=torch.Generator().manual_seed(0))
        null = model.denoise(gt, ts, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[force_mask]),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(got, null)


def test_skeleton_eval_mode_dropout_and_mask_match_jax():
    kw = dict(SMALL, dropout=0.2, cond_mask_prob=1.0)
    jmodel = JSkelTrack(**kw).build_model()
    jmasking = JSkelTrack(**dict(kw, dropout=0.0)).build_model()
    rng = np.random.default_rng(4)
    Ts = 20
    quat = rng.standard_normal((B, Ts, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    inputs = tuple(np.asarray(a, np.float32) for a in (
        rng.standard_normal((B, Ts, 21, 3)),
        rng.standard_normal((B, Ts, 12, 3)),
        np.concatenate([rng.standard_normal((B, Ts, 3)), quat], -1),
        rng.standard_normal((B, 12, 3))))
    ts = np.array([999, 3], np.int32)
    variables = jax.device_get(jax.jit(lambda *a: jmodel.init(
        jax.random.PRNGKey(0), *a, method=JSkel.init_forward))(*inputs, ts))
    model = SkeletonTrackConfig(**kw).build_model("cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    # dropout 0.2 in train mode would draw: the mask alone at rate 0
    masking = SkeletonTrackConfig(**dict(kw, dropout=0.0)).build_model("cpu")
    masking.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        got = model.init_forward(*map(torch.from_numpy, inputs + (ts,)))
        m, x = masking.encode(*map(torch.from_numpy, inputs))
        got_masked = masking.denoise(x, torch.from_numpy(ts),
                                     torch.from_numpy(inputs[3]), m,
                                     train=True, generator=torch.Generator())

    def forwards(v, inputs, x, m):
        return (jmodel.apply(v, *inputs, ts, method=JSkel.init_forward),
                jmasking.apply(v, x, ts, inputs[3], m, train=True, rngs={
                    "cond_mask": jax.random.PRNGKey(1)}))

    want, want_masked = jax.jit(forwards)(variables, inputs, x.numpy(),
                                          m.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got_masked.numpy(), np.asarray(want_masked),
                               atol=1e-4, rtol=1e-4)


def _within_4_sigma(share: float, p: float, n: int) -> bool:
    return abs(share - p) <= 4 * np.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_its_share_and_scales(rate):
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    out = dropout(x, rate, True, gen)
    kept = out != 0
    assert _within_4_sigma(float(kept.float().mean()), 1 - rate, x.numel())
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / (1 - rate)))
    again = dropout(x, rate, True, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)  # one generator state, one mask
    assert dropout(x, rate, False, gen) is x
    assert dropout(x, 0.0, True, gen) is x


def test_condition_mask_share_and_model_dropout_draws():
    model = SmplTrackConfig(**SMALL, dropout=0.25,
                            cond_mask_prob=0.3).build_model("cpu")
    n = 20_000
    cond = torch.ones(n, 1, 4)
    masked = model.mask_cond(cond, train=True,
                             generator=torch.Generator().manual_seed(1))
    dropped = (masked[:, 0, 0] == 0).float().mean()
    assert _within_4_sigma(float(dropped), 0.3, n)
    assert set(masked.unique().tolist()) <= {0.0, 1.0}
    assert model.mask_cond(cond) is cond  # inference never masks
    gt, pts, ts = map(torch.from_numpy, _smpl_inputs(
        np.random.default_rng(5)))
    with torch.no_grad():
        mem = model.encode(gt, pts)
        outs = [model.denoise(gt, ts, mem, train=True,
                              generator=torch.Generator().manual_seed(s))
                for s in (0, 0, 1)]
        plain = model.denoise(gt, ts, mem)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], plain)


@pytest.mark.parametrize("track", ["smpl", "skeleton"])
def test_rate_zero_is_bitwise_the_default_module(track):
    if track == "smpl":
        default = SmplTrackConfig(**SMALL).build_model("cpu")
        zero = SmplTrackConfig(**SMALL, dropout=0.0,
                               cond_mask_prob=0.0).build_model("cpu")
        gt, pts, ts = map(torch.from_numpy, _smpl_inputs(
            np.random.default_rng(6)))
        inputs = (gt, pts)
    else:
        default = SkeletonTrackConfig(**SMALL).build_model("cpu")
        zero = SkeletonTrackConfig(**SMALL, dropout=0.0,
                                   cond_mask_prob=0.0).build_model("cpu")
        rng = np.random.default_rng(6)
        inputs = tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in (
            rng.standard_normal((B, 20, 21, 3)),
            rng.standard_normal((B, 20, 12, 3)),
            rng.standard_normal((B, 20, 7)),
            rng.standard_normal((B, 12, 3))))
        ts = torch.tensor([5, 700])
    zero.load_state_dict(default.state_dict(), strict=True)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    with torch.no_grad():
        if track == "smpl":
            want = default.denoise(gt, ts, default.encode(*inputs))
            got = zero.denoise(gt, ts, zero.encode(*inputs, train=True,
                                                   generator=gen),
                               train=True, generator=gen)
        else:
            mem, x = default.encode(*inputs)
            want = default.denoise(x, ts, inputs[3], mem)
            mem0, _ = zero.encode(*inputs, train=True, generator=gen)
            got = zero.denoise(x, ts, inputs[3], mem0, train=True,
                               generator=gen)
    assert torch.equal(got, want)
    assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("track", ["smpl", "skeleton"])
@pytest.mark.parametrize("rate", ["dropout", "cond_mask_prob"])
def test_train_steps_refuse_train_mode_rates(track, rate):
    config = SmplTrackConfig if track == "smpl" else SkeletonTrackConfig
    make = (ttr.make_smpl_train_step if track == "smpl"
            else ttr.make_skeleton_train_step)
    track_config = config(**SMALL, **{rate: 0.1})
    model = track_config.build_model("cpu")
    with pytest.raises(ValueError, match="eval mode"):
        make(model, track_config.diffusion.build("cpu"))
