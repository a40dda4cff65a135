"""The skeleton sampler of the port (`interdiff_torch/eval/skeleton.py`)
against `interdiff_tpu/eval/skeleton.py` on the CPU: a small denoiser (2 + 2
layers, width 32) and the skeleton projector, every flax leaf redrawn and
moved over by the weight bridge, the same noise and step noise.

On `DiffusionConfig(diffusion_steps=100)` the correction gate (t <= 500,
t % 50 == 0) fires at t = 50 and t = 0; on "25" respacing of 100 steps it
reads the loop's own t (24 .. 0) and fires at t = 0 only, where
`timestep_map[t]` would also fire at t = 12 (map value 50).  Trajectories
within 1e-4 (sampled trajectories, PARITY.md); the helpers exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import CorrectionConfig as JCorrection  # noqa: E402
from interdiff_tpu.config import DiffusionConfig as JDiffCfg  # noqa: E402
from interdiff_tpu.config import SkeletonTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.eval import skeleton as jsk  # noqa: E402
from interdiff_tpu.models.mdm_skeleton import MDMSkeleton as JMDM  # noqa: E402
from interdiff_torch.config import (  # noqa: E402
    CorrectionConfig,
    DiffusionConfig,
    SkeletonTrackConfig,
)
from interdiff_torch.eval import skeleton as tsk  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402
from test_torch_mdm_skeleton import redrawn, skeleton_inputs  # noqa: E402

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=32, num_layers=2)
B, T = 2, 20
SCHEDULES = {"100 steps": dict(diffusion_steps=100),
             "'25' of 100": dict(diffusion_steps=100,
                                 timestep_respacing="25")}
FIRES = {"100 steps": [50, 0], "'25' of 100": [0]}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(30)
    inputs = skeleton_inputs(rng)
    jmodel = JTrack(**SMALL).build_model()
    variables = redrawn(jax.jit(lambda *a: jmodel.init(
        jax.random.PRNGKey(0), *a, jnp.zeros((B,), jnp.int32),
        method=JMDM.init_forward))(*inputs), 31)
    model = SkeletonTrackConfig(**SMALL).build_model("cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)

    jproj = JCorrection(track="skeleton", num_nodes=21,
                        future_len=10).build_model()
    proj_vars = redrawn(jax.jit(lambda q, t, j: jproj.init(
        jax.random.PRNGKey(1), q, t, j))(
            inputs[2][..., 3:], inputs[2][..., :3], inputs[0]), 32)
    proj = CorrectionConfig(track="skeleton", num_nodes=21,
                            future_len=10).build_model("cpu")
    proj.load_state_dict(flax_to_torch_state_dict(proj_vars), strict=True)
    noise = rng.standard_normal((B, T, 106)).astype(np.float32)
    step_noise = rng.standard_normal((100, B, T, 106)).astype(np.float32)
    return dict(inputs=inputs, jmodel=jmodel, variables=variables,
                model=model, jproj=jproj, proj_vars=proj_vars, proj=proj,
                noise=noise, step_noise=step_noise, refs={})


def _jax_run(s, schedule, correction, sampler):
    key = (schedule, correction, sampler)
    if key not in s["refs"]:
        diffusion = JDiffCfg(**SCHEDULES[schedule]).build()
        run = jax.jit(jsk.make_skeleton_sampler(
            jsk.SkeletonEvalConfig(), s["jmodel"], diffusion,
            projector=s["jproj"], projector_params=s["proj_vars"],
            use_correction=correction, sampler=sampler))
        n = diffusion.num_timesteps
        s["refs"][key] = np.asarray(run(
            s["variables"], jax.random.PRNGKey(0),
            *map(jnp.asarray, s["inputs"]), noise=jnp.asarray(s["noise"]),
            step_noise=jnp.asarray(s["step_noise"][:n])))
    return s["refs"][key]


def _port_run(s, schedule, correction, sampler, trace=None,
              reuse_memory=False):
    diffusion = DiffusionConfig(**SCHEDULES[schedule]).build("cpu")
    run = tsk.make_skeleton_sampler(
        tsk.SkeletonEvalConfig(), s["model"], diffusion,
        projector=s["proj"] if correction else None, sampler=sampler,
        trace=trace, reuse_memory=reuse_memory)
    args = tuple(map(torch.from_numpy, s["inputs"]))
    if reuse_memory:
        with torch.no_grad():
            args += s["model"].encode(*args)
    return run(*args, noise=torch.from_numpy(s["noise"]),
               step_noise=torch.from_numpy(
                   s["step_noise"][:diffusion.num_timesteps])).numpy()


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("correction", [False, True])
def test_ddpm_matches_jax(setup, schedule, correction):
    trace = []
    got = _port_run(setup, schedule, correction, "ddpm", trace)
    want = _jax_run(setup, schedule, correction, "ddpm")
    assert [e["t"] for e in trace] == (FIRES[schedule] if correction
                                       else [])
    if schedule != "100 steps":
        diffusion = DiffusionConfig(**SCHEDULES[schedule]).build("cpu")
        assert int(diffusion.timestep_map[12]) == 50
    assert got.shape == (B, T, 106) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    gt = np.concatenate([a.reshape(B, T, -1) for a in setup["inputs"][:3]],
                        -1)
    # past frames inpainted: the whole state without correction, the body
    # block with it (the blend moves the past object too)
    past = 63 if correction else 106
    np.testing.assert_array_equal(got[:, :10, :past], gt[:, :10, :past])
    if correction:  # the object block of the last firing is rigid
        kp = tsk.rigid_keypoints_from_pose(
            torch.from_numpy(got[..., 99:]),
            torch.from_numpy(setup["inputs"][3]))
        np.testing.assert_allclose(got[..., 63:99],
                                   kp.reshape(B, T, 36).numpy(), atol=1e-5)


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_ddim_and_plms_with_correction_match_jax(setup, sampler):
    trace = []
    got = _port_run(setup, "100 steps", True, sampler, trace)
    want = _jax_run(setup, "100 steps", True, sampler)
    fired = [e["t"] for e in trace]
    # PLMS's warm-up calls the model a second time at t - 1 = 98
    assert fired == [50, 0]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_reuse_memory_is_the_same_sampler(setup):
    got = _port_run(setup, "100 steps", True, "ddpm", reuse_memory=True)
    np.testing.assert_array_equal(
        got, _port_run(setup, "100 steps", True, "ddpm"))
    np.testing.assert_allclose(got, _jax_run(setup, "100 steps", True,
                                             "ddpm"), atol=1e-4, rtol=1e-4)


def test_body_obj_contact_matches_jax():
    rng = np.random.default_rng(33)
    body = rng.uniform(-0.3, 0.3, (3, 4, 21, 3)).astype(np.float32)
    obj = rng.uniform(-0.3, 0.3, (3, 4, 12, 3)).astype(np.float32)
    obj[0, 0] += 5.0  # no joint within the threshold
    body[1, 1, 7] = body[1, 1, 3] = obj[1, 1, 2]  # a tie: the first joint
    want = np.asarray(jsk.body_obj_contact(jnp.asarray(body),
                                           jnp.asarray(obj)))
    got = tsk.body_obj_contact(torch.from_numpy(body), torch.from_numpy(obj))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0].sum() == 0 and got[1, 1, 3] == 1 and got[1, 1, 7] == 0


def test_split_and_rollout_batch_match_jax():
    rng = np.random.default_rng(34)
    x = rng.standard_normal((B, T, 106)).astype(np.float32)
    zp = rng.standard_normal((B, 12, 3)).astype(np.float32)
    cfg_j, cfg_t = jsk.SkeletonEvalConfig(), tsk.SkeletonEvalConfig()
    for got, want in ((tsk.split_skeleton_state(torch.from_numpy(x), cfg_t),
                       jsk.split_skeleton_state(jnp.asarray(x), cfg_j)),
                      (tsk.rollout_batch(torch.from_numpy(x),
                                         torch.from_numpy(zp), cfg_t),
                       jsk.rollout_batch(jnp.asarray(x), jnp.asarray(zp),
                                         cfg_j))):
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    nb = tsk.rollout_batch(torch.from_numpy(x), torch.from_numpy(zp), cfg_t)
    assert nb["skeleton"].shape == (B, T, 21, 3)
    assert torch.equal(nb["poses"][:, 10:], nb["poses"][:, 9:10].expand(
        B, 10, 7))
