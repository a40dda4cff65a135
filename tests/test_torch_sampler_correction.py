"""Slice 2 end to end: the correction hook and the sampler with correction
in the loop (`interdiff_torch/eval/smpl_short.py`) against `interdiff_tpu`'s,
on a small set-up: a 3-layer d=32 denoiser, "10" respacing, a closed 64-vertex
stand-in body with 40 markers, a 40-marker projector with 4 DCT coefficients,
bridged weights, the same noise and step noise.  Trajectories agree within
1e-4 (sampled trajectories, PARITY.md); the gate's decisions are compared on
their own, with the distance of every gate value from its threshold
asserted, since a decision that flips moves a sample by far more than any
tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.cli.common import synthetic_smpl_body as j_body  # noqa: E402
from interdiff_tpu.config import DiffusionConfig as JDiffCfg  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.eval import smpl_short as jss  # noqa: E402
from interdiff_tpu.models.correction import ObjProjectorSmpl as JProj  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_torch.config import DiffusionConfig, SmplTrackConfig  # noqa: E402
from interdiff_torch.eval import smpl_short as tss  # noqa: E402
from interdiff_torch.models.correction import ObjProjectorSmpl  # noqa: E402
from interdiff_torch.smpl.model import SmplModel  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

B, T, P, V, M = 2, 35, 64, 64, 40
D = 135
SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
MARKERS = np.arange(M)
CFG = dict(correction_t_max=9, correction_every=3, nn_chunk=None)
ARRAYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(35)
    gt = (rng.standard_normal((B, T, 144)) * 0.5).astype(np.float32)
    gt[1, :, D + 6:] = gt[1, :, D - 3:D] + np.float32(1.2)
    pts = rng.uniform(-0.12, 0.12, (B, P, 6)).astype(np.float32)
    pts[:, 0, :3] = 0.0  # one object point at the object's origin
    xyz = pts[..., :3].astype(np.float64)
    d2 = ((xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    for r in (0.05, 0.1, 0.2):
        assert np.abs(d2 - np.float32(r * r)).min() > 1e-6
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
    # the object of clip 0 rides on hand marker 10 of the gt body
    # (penetrating points, contact); clip 1's is 1.2 m away (beyond delta)
    with torch.no_grad():
        pose = torch.cat([tss._body_axis_angle(torch.from_numpy(gt[:1, :, :D])),
                          torch.from_numpy(hand[:1])], dim=-1)
        verts = tss.smpl_forward(smpl, pose.reshape(T, -1),
                                 torch.from_numpy(betas[0]),
                                 torch.from_numpy(gt[0, :, D - 3:D]))[0]
    gt[0, :, D + 6:] = verts[:, MARKERS[10]].numpy()
    noise = rng.standard_normal((B, T, 144)).astype(np.float32)
    step_noise = rng.standard_normal((10, B, T, 144)).astype(np.float32)
    return dict(gt=gt, pts=pts, hand=hand, betas=betas, noise=noise,
                step_noise=step_noise, jmodel=jmodel, jdiff=jdiff,
                variables=variables, jsmpl=jsmpl, jproj=jproj,
                proj_vars=proj_vars, model=model, diffusion=diffusion,
                smpl=smpl, proj=proj)


def _least(t: "torch.Tensor") -> float:
    return float(t.min()) if t.numel() else float("inf")


def _assert_margins(entry, delta):
    """No gate value within reach of its threshold: the two packages round
    differently (up to 1e-4 on distances), and so may the card."""
    assert _least((entry["penetration"] - 0.002).abs()) > 1e-4
    assert _least((entry["distance"] - 0.02).abs()) > 1e-4
    assert _least((entry["marker_d"] - 0.02).abs()) > 1e-5
    swept = entry["o2h_dot"].flatten()
    if delta is not None:
        d2 = np.float32(delta) ** 2
        near = entry["o2h_sq"].flatten() != d2  # the queries not forced
        assert _least((entry["o2h_sq"].flatten() - d2).abs()[near]) > 1e-5
        swept = swept[near]
    assert _least(swept.abs()) > 1e-6  # no sign at the toss of a coin


def _hooks(s, delta, trace):
    jcfg = jss.SmplEvalConfig(**CFG, nn_prune_delta=delta)
    tcfg = tss.SmplEvalConfig(**CFG, nn_prune_delta=delta)
    jhook = jss.make_correction_denoised_fn(
        jcfg, s["jsmpl"], s["jproj"], s["proj_vars"],
        gt=jnp.asarray(s["gt"]), hand_pose=jnp.asarray(s["hand"]),
        betas=jnp.asarray(s["betas"]),
        obj_points=jnp.asarray(s["pts"][..., :3]), markers_idx=MARKERS)
    thook = tss.make_correction_denoised_fn(
        tcfg, s["smpl"], s["proj"], gt=torch.from_numpy(s["gt"]),
        hand_pose=torch.from_numpy(s["hand"]),
        betas=torch.from_numpy(s["betas"]),
        obj_points=torch.from_numpy(s["pts"][..., :3]), markers_idx=MARKERS,
        trace=trace)
    return jhook, thook


@pytest.mark.parametrize("delta", [0.25, None])
def test_correct_call_matches_jax(setup, delta):
    s = setup
    trace = []
    jhook, thook = _hooks(s, delta, trace)
    x = s["gt"] + np.float32(0.001) * s["noise"]
    t = np.full((B,), 6, np.int32)
    want = np.asarray(jax.jit(jhook)(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = thook(torch.from_numpy(x), torch.from_numpy(t).long())
        by_step = thook(torch.from_numpy(x), torch.from_numpy(t).long(),
                        step=6)
    # the same call twice: threaded BLAS may round the last bits otherwise
    torch.testing.assert_close(got, by_step, atol=1e-4, rtol=0)
    assert len(trace) == 2
    _assert_margins(trace[0], delta)
    # the gate's decisions on their own: a corrected row differs from x
    cond_jax = (want != x).any(axis=(1, 2))
    np.testing.assert_array_equal(trace[0]["condition"].numpy(), cond_jax)
    assert cond_jax.all()
    # clip 0 penetrates and touches, clip 1 is beyond delta
    assert float(trace[0]["penetration"][0]) > 0.002
    assert bool((trace[0]["marker_d"][0] < 0.02).any())
    assert float(trace[0]["penetration"][1]) == 0.0 or delta is None
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # the body block blends with itself (an ulp), the object block moves
    np.testing.assert_allclose(got.numpy()[..., :D], x[..., :D], atol=1e-6)
    assert np.abs(got.numpy()[..., D:] - x[..., D:]).max() > 1e-3


def test_hook_is_inactive_off_its_steps(setup):
    trace = []
    _, thook = _hooks(setup, 0.25, trace)
    x = torch.from_numpy(setup["gt"])
    for step in (10, 7, 1):  # above t_max, or not a multiple of 3
        t = torch.full((B,), step, dtype=torch.int64)
        assert thook(x, t, step=step) is x
        assert thook(x, t) is x
    assert trace == []


@pytest.mark.parametrize("delta", [0.25, None])
def test_sampler_with_correction_matches_jax(setup, delta):
    s = setup
    jcfg = jss.SmplEvalConfig(**CFG, nn_prune_delta=delta)
    tcfg = tss.SmplEvalConfig(**CFG, nn_prune_delta=delta)
    jrun = jax.jit(jss.make_sampler(
        jcfg, s["jmodel"], s["jdiff"], smpl=s["jsmpl"],
        projector=s["jproj"], projector_params=s["proj_vars"],
        use_correction=True, markers_idx=MARKERS))
    ref = np.asarray(jrun(
        s["variables"], jax.random.PRNGKey(0), jnp.asarray(s["gt"]),
        jnp.asarray(s["pts"]), jnp.asarray(s["hand"]),
        jnp.asarray(s["betas"]), noise=jnp.asarray(s["noise"]),
        step_noise=jnp.asarray(s["step_noise"])))

    trace = []
    run = tss.make_sampler(tcfg, s["model"], s["diffusion"], smpl=s["smpl"],
                           projector=s["proj"], use_correction=True,
                           markers_idx=MARKERS, trace=trace)
    got = run(*(torch.from_numpy(s[k])
                for k in ("gt", "pts", "hand", "betas")),
              noise=torch.from_numpy(s["noise"]),
              step_noise=torch.from_numpy(s["step_noise"])).numpy()
    assert [e["t"] for e in trace] == [9, 6, 3, 0]
    for entry in trace:
        _assert_margins(entry, delta)
    assert got.shape == (B, T, 144) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    # the blend comes after the inpainting overwrite: the body block of
    # the past frames equals gt, the object block need not
    np.testing.assert_array_equal(got[:, :10, :D], s["gt"][:, :10, :D])
    plain = tss.make_sampler(tcfg, s["model"], s["diffusion"])(
        *(torch.from_numpy(s[k]) for k in ("gt", "pts", "hand", "betas")),
        noise=torch.from_numpy(s["noise"]),
        step_noise=torch.from_numpy(s["step_noise"])).numpy()
    assert np.abs(plain - got).max() > 1e-3  # the correction did act


def test_postprocess_sample_matches_jax(setup):
    s = setup
    x = s["gt"] + np.float32(0.01) * s["noise"]
    want = jss.postprocess_sample(
        jss.SmplEvalConfig(), s["jsmpl"], jnp.asarray(x),
        jnp.asarray(s["hand"]), jnp.asarray(s["betas"]))
    got = tss.postprocess_sample(
        tss.SmplEvalConfig(), s["smpl"], torch.from_numpy(x),
        torch.from_numpy(s["hand"]), torch.from_numpy(s["betas"]))
    assert set(got) == set(want) == {"body_pred", "obj_pred", "verts", "jtr",
                                     "pelvis"}
    assert got["body_pred"].shape == (B, T, 66 + 90 + 3)
    assert got["verts"].shape == (B, T, V, 3)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4)


def test_correction_needs_body_and_projector(setup):
    with pytest.raises(ValueError, match="needs the body model"):
        tss.make_sampler(tss.SmplEvalConfig(), setup["model"],
                         setup["diffusion"], use_correction=True)
