"""The long-term autoregressive eval (`interdiff_torch/eval/smpl_long.py`,
`cli/eval_smpl_long.py::make_window_metrics`) against `interdiff_tpu`'s:
the recanonicalize/denormalize round trip within 1e-6, the centroid sum
that keeps a constant-velocity rollout straight, a rollout of two chunks
after the first of the small sampler (3 layers, d=32, "10" respacing)
without and with the correction in the loop against JAX within 1e-4
(sampled trajectories), and the per-window drift metrics within 1e-4.

The JAX rollout splits a key per chunk and the port draws from a
generator, so each side's ``sample_fn`` ignores its key or generator and
feeds the sampler the same explicit noise and step noise per call, indexed
by the count of calls."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.cli import eval_smpl_long as jcli  # noqa: E402
from interdiff_tpu.cli.common import synthetic_smpl_body as j_body  # noqa: E402
from interdiff_tpu.config import DiffusionConfig as JDiffCfg  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.eval import smpl_long as jlong  # noqa: E402
from interdiff_tpu.eval import smpl_short as jss  # noqa: E402
from interdiff_tpu.models.correction import ObjProjectorSmpl as JProj  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_torch.cli import eval_smpl_long as tcli  # noqa: E402
from interdiff_torch.config import DiffusionConfig, SmplTrackConfig  # noqa: E402
from interdiff_torch.eval import smpl_long as tlong  # noqa: E402
from interdiff_torch.eval import smpl_short as tss  # noqa: E402
from interdiff_torch.models.correction import ObjProjectorSmpl  # noqa: E402
from interdiff_torch.smpl.model import SmplModel  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

B, T, P, V, M = 2, 35, 64, 64, 40
D = 135
CHUNKS = 2
SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
MARKERS = np.arange(M)
CFG = dict(correction_t_max=9, correction_every=3, nn_chunk=None)
ARRAYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_recanonicalize_denormalize_round_trip_matches_jax():
    rng = np.random.default_rng(20)
    cfg_j, cfg_t = jss.SmplEvalConfig(), tss.SmplEvalConfig()
    x = rng.standard_normal((3, T, 144)).astype(np.float32)
    pelvis = rng.standard_normal((3, T, 3)).astype(np.float32)
    want = jlong.recanonicalize_state(jnp.asarray(x), jnp.asarray(pelvis),
                                      cfg_j)
    got = tlong.recanonicalize_state(_t(x), _t(pelvis), cfg_t)
    for k in ("gt", "centroid"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0)
    # the new past is the old tail with its translations shifted, the
    # future repeats its last frame
    np.testing.assert_array_equal(got["centroid"].numpy(), pelvis[:, -10])
    assert torch.equal(got["gt"][:, 10:], got["gt"][:, 9:10].expand(
        -1, T - 10, -1))
    back_j = jlong.denormalize_chunk(want["gt"], want["centroid"], cfg_j)
    back_t = tlong.denormalize_chunk(got["gt"], got["centroid"], cfg_t)
    np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(back_t[:, :10].numpy(), x[:, -10:],
                               atol=1e-6, rtol=0)


def test_constant_velocity_rollout_is_globally_straight():
    """Chunk k >= 2 is sampled in chunk k-1's canonical frame; its global
    placement is the sum of the centroids subtracted so far, so a perfect
    constant-velocity sampler gives a straight line (the JAX package's
    `test_rollout_global_frame_accumulates_centroids`)."""
    cfg = tss.SmplEvalConfig(past_len=2, future_len=3)
    Tw = cfg.seq_len
    v = torch.tensor([1.0, 0.5, -0.25])
    calls = []

    def stub_sampler(gen, gt, pts, hand, betas):
        calls.append(gen)

        def extend(tr):
            vel = tr[:, cfg.past_len - 1] - tr[:, cfg.past_len - 2]
            steps = torch.arange(1, cfg.future_len + 1, dtype=tr.dtype)
            fut = tr[:, cfg.past_len - 1][:, None] \
                + steps[None, :, None] * vel[:, None]
            return torch.cat([tr[:, :cfg.past_len], fut], dim=1)

        x = torch.zeros_like(gt)
        x[..., D - 3:D] = extend(gt[..., D - 3:D])
        x[..., D + 6:D + 9] = extend(gt[..., D + 6:D + 9])
        return x

    ramp = torch.arange(Tw, dtype=torch.float32)[None, :, None] * v
    gt = torch.zeros((1, Tw, 144))
    gt[..., D - 3:D] = ramp
    gt[..., D + 6:D + 9] = ramp
    gen = torch.Generator().manual_seed(0)
    full = tlong.rollout(stub_sampler, lambda x, h, b: x[..., D - 3:D], gen,
                         gt, torch.zeros((1, 4, 6)), torch.zeros((1, Tw, 90)),
                         torch.zeros((1, Tw, 10)), num_chunks=2, cfg=cfg,
                         seam_smooth=False)
    expect = torch.arange(Tw + 2 * cfg.future_len,
                          dtype=torch.float32)[None, :, None] * v
    torch.testing.assert_close(full[..., D - 3:D], expect, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(full[..., D + 6:D + 9], expect, atol=1e-5,
                               rtol=0)
    assert calls == [gen] * 3  # every chunk draws from the one generator


@pytest.fixture(scope="module")
def setup():
    """The small sampler on both sides, bridged weights, a 64-vertex body
    with 40 markers, and explicit noise for each of the 1 + CHUNKS calls;
    the object of clip 0 rides on hand marker 10 of the gt body."""
    rng = np.random.default_rng(21)
    gt = (rng.standard_normal((B, T, 144)) * 0.5).astype(np.float32)
    gt[1, :, D + 6:] = gt[1, :, D - 3:D] + np.float32(1.2)
    pts = rng.uniform(-0.12, 0.12, (B, P, 6)).astype(np.float32)
    hand = (rng.standard_normal((B, T, 90)) * 0.1).astype(np.float32)
    betas = (rng.standard_normal((B, T, 10)) * 0.5).astype(np.float32)

    jtrack = JTrack(**SMALL, diffusion=JDiffCfg(timestep_respacing="10"))
    jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()
    variables = jax.jit(lambda g, p: jmodel.init(
        jax.random.PRNGKey(1), g, p, jnp.zeros((B,), jnp.int32),
        method=JMDM.init_forward))(gt, pts)
    jsmpl = j_body(np.random.default_rng(3), num_verts=V)
    jproj = JProj(num_markers=M, n_pre=4)
    proj_vars = jproj.init(jax.random.PRNGKey(2), jnp.asarray(gt[..., D:]),
                           jnp.zeros((B, T, M, 3)), jnp.zeros((B, M)))

    track = SmplTrackConfig(**SMALL,
                            diffusion=DiffusionConfig(timestep_respacing="10"))
    model, diffusion = track.build_model("cpu"), track.diffusion.build("cpu")
    model.load_state_dict(
        flax_to_torch_state_dict(jax.device_get(variables)), strict=True)
    smpl = SmplModel.create(
        **{k: np.asarray(getattr(jsmpl, k)) for k in ARRAYS},
        parents=jsmpl.parents, faces=jsmpl.faces, device="cpu")
    proj = ObjProjectorSmpl(num_markers=M, n_pre=4, device="cpu")
    proj.load_state_dict(
        flax_to_torch_state_dict(jax.device_get(proj_vars)), strict=True)
    with torch.no_grad():
        pose = torch.cat([tss._body_axis_angle(_t(gt[:1, :, :D])),
                          _t(hand[:1])], dim=-1)
        verts = tss.smpl_forward(smpl, pose.reshape(T, -1), _t(betas[0]),
                                 _t(gt[0, :, D - 3:D]))[0]
    gt[0, :, D + 6:] = verts[:, MARKERS[10]].numpy()
    noise = rng.standard_normal((1 + CHUNKS, B, T, 144)).astype(np.float32)
    step_noise = rng.standard_normal(
        (1 + CHUNKS, 10, B, T, 144)).astype(np.float32)
    return dict(gt=gt, pts=pts, hand=hand, betas=betas, noise=noise,
                step_noise=step_noise, jmodel=jmodel, jdiff=jdiff,
                variables=variables, jsmpl=jsmpl, jproj=jproj,
                proj_vars=proj_vars, model=model, diffusion=diffusion,
                smpl=smpl, proj=proj)


def _rollouts(s, corrected: bool):
    cfg_j = jss.SmplEvalConfig(**CFG)
    cfg_t = tss.SmplEvalConfig(**CFG)
    extra_j = dict(smpl=s["jsmpl"], projector=s["jproj"],
                   projector_params=s["proj_vars"], use_correction=True,
                   markers_idx=MARKERS) if corrected else {}
    extra_t = dict(smpl=s["smpl"], projector=s["proj"], use_correction=True,
                   markers_idx=MARKERS) if corrected else {}
    jrun = jax.jit(jss.make_sampler(cfg_j, s["jmodel"], s["jdiff"],
                                    **extra_j))
    trun = tss.make_sampler(cfg_t, s["model"], s["diffusion"], **extra_t)
    jcalls, tcalls = [], []

    def j_sample(key, gt, pts, hand, betas):
        i = len(jcalls)
        jcalls.append(key)
        return jrun(s["variables"], key, gt, pts, hand, betas,
                    noise=jnp.asarray(s["noise"][i]),
                    step_noise=jnp.asarray(s["step_noise"][i]))

    def t_sample(gen, gt, pts, hand, betas):
        i = len(tcalls)
        tcalls.append(gen)
        return trun(gt, pts, hand, betas, noise=_t(s["noise"][i]),
                    step_noise=_t(s["step_noise"][i]))

    want = np.asarray(jlong.rollout(
        j_sample, lambda x, h, b: jss.postprocess_sample(
            cfg_j, s["jsmpl"], x, h, b)["pelvis"], jax.random.PRNGKey(0),
        jnp.asarray(s["gt"]), jnp.asarray(s["pts"]), jnp.asarray(s["hand"]),
        jnp.asarray(s["betas"]), num_chunks=CHUNKS, cfg=cfg_j))
    with torch.no_grad():
        got = tlong.rollout(
            t_sample, lambda x, h, b: tss.postprocess_sample(
                cfg_t, s["smpl"], x, h, b)["pelvis"],
            torch.Generator().manual_seed(0), _t(s["gt"]), _t(s["pts"]),
            _t(s["hand"]), _t(s["betas"]), num_chunks=CHUNKS,
            cfg=cfg_t).numpy()
    assert len(jcalls) == len(tcalls) == 1 + CHUNKS
    return got, want


@pytest.mark.parametrize("corrected", [False, True])
def test_rollout_matches_jax(setup, corrected):
    got, want = _rollouts(setup, corrected)
    assert got.shape == want.shape == (B, 10 + (1 + CHUNKS) * 25, 144)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # the first window's past is the conditioning's, body block exact
    np.testing.assert_array_equal(got[:, :10, :D], setup["gt"][:, :10, :D])
    if corrected:  # the correction did act on the rollout
        plain, _ = _rollouts(setup, False)
        assert np.abs(plain - got).max() > 1e-3


def test_window_metrics_match_jax(setup):
    s = setup
    rng = np.random.default_rng(22)
    H = 10 + (1 + CHUNKS) * 25
    full = (rng.standard_normal((B, H, 144)) * 0.3).astype(np.float32)
    gt_long = full + (rng.standard_normal((B, H, 144)) * 0.05).astype(
        np.float32)
    hand = (rng.standard_normal((B, H + 5, 90)) * 0.1).astype(np.float32)
    betas = (rng.standard_normal((B, H + 5, 10)) * 0.5).astype(np.float32)
    gt_long = np.concatenate([gt_long, gt_long[:, -5:]], axis=1)
    want = jcli._make_window_metrics(jss.SmplEvalConfig(), s["jsmpl"],
                                     CHUNKS)(
        jnp.asarray(full), jnp.asarray(gt_long), jnp.asarray(hand),
        jnp.asarray(betas))
    got = tcli.make_window_metrics(tss.SmplEvalConfig(), s["smpl"], CHUNKS)(
        _t(full), _t(gt_long), _t(hand), _t(betas))
    assert len(got) == len(want) == 1 + CHUNKS
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(tcli.WINDOW_METRICS)
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-4, (k, g[k], w[k])
    assert got[0]["global_mpjpe"] > 0
