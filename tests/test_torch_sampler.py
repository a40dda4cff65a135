"""Slice 1 end to end: the port's no-correction sampler
(`interdiff_torch/eval/smpl_short.py::make_sampler`) against
`interdiff_tpu`'s, with bridged weights of a small model (3 layers, d=32),
"10" respacing, 2 clips folded 2-fold for diverse samples, and the same
noise and step noise on both sides.  Trajectories agree within 1e-4
(sampled trajectories, PARITY.md rows 1/6/27); past frames equal gt."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import DiffusionConfig as JDiffCfg  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.eval import smpl_short as jss  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_tpu.parallel import sample_parallel as jsp  # noqa: E402
from interdiff_torch.config import (  # noqa: E402
    CorrectionConfig,
    DiffusionConfig,
    SmplTrackConfig,
)
from interdiff_torch.eval import smpl_short as tss  # noqa: E402
from interdiff_torch.parallel import sample_parallel as tsp  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

B, FOLD, T, P = 2, 2, 35, 64
SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)


def _batch():
    """Seeded clip states and an object cloud with no point pair within
    1e-6 of a ball-query radius squared (each side computes its own
    distances)."""
    rng = np.random.default_rng(35)
    gt = (rng.standard_normal((B, T, 144)) * 0.5).astype(np.float32)
    pts = rng.uniform(-0.12, 0.12, (B, P, 6)).astype(np.float32)
    xyz = pts[..., :3].astype(np.float64)
    d2 = ((xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    for r in (0.05, 0.1, 0.2):
        assert np.abs(d2 - np.float32(r * r)).min() > 1e-6
    return rng, gt, pts


def test_tile_split_and_pad_idx_match_jax():
    np.testing.assert_array_equal(tss.pad_idx(tss.SmplEvalConfig()),
                                  jss.pad_idx(jss.SmplEvalConfig()))
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    tiled = tsp.tile_for_diverse_samples((torch.from_numpy(x),), 3)[0]
    np.testing.assert_array_equal(
        tiled.numpy(), np.asarray(jsp.tile_for_diverse_samples(x, 3)))
    np.testing.assert_array_equal(
        tsp.split_diverse_samples(tiled, 3).numpy(),
        np.asarray(jsp.split_diverse_samples(jnp.asarray(tiled.numpy()), 3)))


def test_sampler_no_correction_matches_jax():
    rng, gt, pts = _batch()
    jtrack = JTrack(**SMALL, diffusion=JDiffCfg(timestep_respacing="10"))
    jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()
    variables = jax.jit(lambda g, p: jmodel.init(
        jax.random.PRNGKey(1), g, p, jnp.zeros((B,), jnp.int32),
        method=JMDM.init_forward))(gt, pts)
    track = SmplTrackConfig(**SMALL,
                            diffusion=DiffusionConfig(timestep_respacing="10"))
    model, diffusion = track.build_model("cpu"), track.diffusion.build("cpu")
    model.load_state_dict(
        flax_to_torch_state_dict(jax.device_get(variables)), strict=True)

    rows = B * FOLD
    noise = rng.standard_normal((rows, T, 144)).astype(np.float32)
    step_noise = rng.standard_normal(
        (diffusion.num_timesteps, rows, T, 144)).astype(np.float32)
    hand = np.zeros((B, T, 90), np.float32)
    betas = np.zeros((B, T, 10), np.float32)
    cfg = tss.SmplEvalConfig()

    mem_ref = jax.jit(lambda v, g, p: jmodel.apply(
        v, g, p, method=JMDM.encode))(variables, gt, pts)
    jrun = jax.jit(jss.make_sampler(jss.SmplEvalConfig(), jmodel, jdiff,
                                    reuse_memory=True))
    jargs = jsp.tile_for_diverse_samples(
        (jnp.asarray(gt), jnp.asarray(pts), jnp.asarray(hand),
         jnp.asarray(betas), mem_ref), FOLD)
    ref = np.asarray(jrun(variables, jax.random.PRNGKey(0), *jargs,
                          noise=jnp.asarray(noise),
                          step_noise=jnp.asarray(step_noise)))

    gt_t, pts_t = torch.from_numpy(gt), torch.from_numpy(pts)
    with torch.no_grad():
        memory = model.encode(gt_t, pts_t)
    np.testing.assert_allclose(memory.numpy(), np.asarray(mem_ref),
                               atol=1e-4, rtol=1e-4)
    run = tss.make_sampler(cfg, model, diffusion, reuse_memory=True)
    targs = tsp.tile_for_diverse_samples(
        (gt_t, pts_t, torch.from_numpy(hand), torch.from_numpy(betas),
         memory), FOLD)
    got = run(*targs, noise=torch.from_numpy(noise),
              step_noise=torch.from_numpy(step_noise)).numpy()

    assert got.shape == (rows, T, 144)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got[:, :cfg.past_len],
                                  np.tile(gt, (FOLD, 1, 1))[:, :cfg.past_len])

    # the sampler that encodes for itself gives the same trajectories
    sample = tss.make_sampler(cfg, model, diffusion)
    again = sample(*targs[:4], noise=torch.from_numpy(noise),
                   step_noise=torch.from_numpy(step_noise)).numpy()
    np.testing.assert_array_equal(again, got)

    body, obj = tss.state_to_axis_angle(cfg, torch.from_numpy(got))
    jbody, jobj = jss.state_to_axis_angle(jss.SmplEvalConfig(),
                                          jnp.asarray(got))
    np.testing.assert_allclose(body.numpy(), np.asarray(jbody), atol=1e-4)
    np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), atol=1e-4)


@pytest.mark.parametrize("kw", [dict(projector=True),
                                dict(sampler="plms", projector=True),
                                dict(sampler="euler")])
def test_unported_modes_raise(kw):
    track = SmplTrackConfig(**SMALL,
                            diffusion=DiffusionConfig(timestep_respacing="10"))
    # a projector without the body model, with any sampler, or a sampler
    # the package does not have (DDIM and PLMS are ported:
    # tests/test_torch_samplers.py)
    if kw.get("projector"):
        kw = dict(kw, projector=CorrectionConfig(
            num_nodes=40, dct=4).build_model("cpu"))
    with pytest.raises(ValueError,
                       match="unknown sampler|needs the body model"):
        tss.make_sampler(tss.SmplEvalConfig(), track.build_model("cpu"),
                         track.diffusion.build("cpu"), **kw)
