"""The port's short-term eval entry point
(`interdiff_torch/cli/eval_smpl_short.py`): `main([...])` on the CPU from
saved state dicts of the trained `artifacts/` weights (written by
`scripts/torch_convert_orbax.py`), its flag checks, the
synthetic batches against the JAX package's, and `evaluate` against the loop
body of `interdiff_tpu/cli/eval_smpl_short.py` at a small size (3 layers,
d=32, "5" respacing, the 128-vertex stand-in body) with the same weights
and noise: every metric of the MPJPE family within 1e-3 (PARITY.md row 27),
`penetrate` within two sign tests of 1600."""

import ast
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.cli import common as jcommon  # noqa: E402
from interdiff_tpu.config import DiffusionConfig as JDiffCfg  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.eval import smpl_short as jss  # noqa: E402
from interdiff_tpu.eval.metrics import smpl_metrics as j_smpl_metrics  # noqa: E402
from interdiff_tpu.models.correction import ObjProjectorSmpl as JProj  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_tpu.models.mdm_smpl import smpl_gt_from_raw as j_gt_from_raw  # noqa: E402
from interdiff_tpu.parallel import sample_parallel as jsp  # noqa: E402
from interdiff_torch.cli import common as tcommon  # noqa: E402
from interdiff_torch.cli import eval_smpl_short as tcli  # noqa: E402
from interdiff_torch.config import (  # noqa: E402
    CorrectionConfig,
    DiffusionConfig,
    SmplTrackConfig,
)
from interdiff_torch.data.constants import MARKERSET_SSM67_SMPLH  # noqa: E402
from interdiff_torch.eval.smpl_short import SmplEvalConfig  # noqa: E402
from interdiff_torch.utils.convert import (  # noqa: E402
    flax_to_torch_state_dict,
    load_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_convert_orbax as convert_orbax  # noqa: E402

SMPL_REAL = os.path.join(ROOT, "artifacts", "smpl_real_params")
CORRECTION_REAL = os.path.join(ROOT, "artifacts", "correction_real_params")
KEYS = {"global_mpjpe", "local_mpjpe", "body_translation", "obj_translation",
        "obj_rot_error", "penetrate"}
SMALL_RUN = ["--device", "cpu", "--synthetic", "1", "--batch_size", "2",
             "--diverse_samples", "2", "--diverse_fold", "2", "--respacing",
             "5"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The trained weights of `artifacts/`, restored as the JAX package's
    tests restore them, carried over by the bridge and written in the port's
    own format."""
    if not (os.path.isdir(SMPL_REAL) and os.path.isdir(CORRECTION_REAL)):
        pytest.skip("artifacts/ not present")
    out = tmp_path_factory.mktemp("ckpt")
    paths = {"diffusion": str(out / "mdm_smpl.pt"),
             "correction": str(out / "projector.pt")}
    convert_orbax.convert(SMPL_REAL, "mdm_smpl", paths["diffusion"])
    convert_orbax.convert(CORRECTION_REAL, "correction", paths["correction"])
    return paths


def _last_report(text: str):
    """(batches so far, running dict) of the last line the CLI printed."""
    line = [ln for ln in text.splitlines() if ln.strip()][-1]
    nb, _, rest = line.partition(" ")
    return int(nb), ast.literal_eval(rest)


@pytest.mark.parametrize("mode,sampler", [("correction", "ddpm"),
                                          ("no_correction", "ddim"),
                                          ("correction", "plms"),
                                          ("no_correction", "ddpm")])
def test_cli_runs_from_saved_state_dicts(checkpoints, capsys, mode, sampler):
    totals, nb = tcli.main(SMALL_RUN + [
        "--mode", mode, "--sampler", sampler,
        "--diffusion_ckpt", checkpoints["diffusion"],
        "--correction_ckpt", checkpoints["correction"]])
    batches, running = _last_report(capsys.readouterr().out)
    assert nb == batches == 1
    assert set(totals) == set(running) == KEYS
    for k in KEYS:
        assert np.isfinite(totals[k]) and totals[k] >= 0
        assert running[k] == round(totals[k], 5)
    assert totals["penetrate"] <= 1


def test_state_dict_files_round_trip(checkpoints):
    state = load_state_dict(checkpoints["correction"])
    model = CorrectionConfig().build_model("cpu")
    model.load_state_dict(state, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k])
    with pytest.raises(RuntimeError, match="Missing|Unexpected|size"):
        SmplTrackConfig().build_model("cpu").load_state_dict(state,
                                                             strict=True)


def test_load_state_dict_refuses_other_files(tmp_path):
    path = tmp_path / "not_a_state.pt"
    torch.save([torch.zeros(2)], path)
    with pytest.raises(ValueError, match="state dict"):
        load_state_dict(path)


def test_default_device_stops_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--synthetic", "1", "--batch_size", "2"])


@pytest.mark.parametrize("argv", [
    ["--synthetic", "1", "--diverse_fold", "0"],
    ["--synthetic", "1", "--diverse_samples", "3", "--diverse_fold", "2"],
    ["--device", "cpu"],  # no --synthetic: real data is not ported
    ["--synthetic", "1", "--motion_path", "x"],
    ["--synthetic", "1", "--batch_size", "3", "--mesh_devices", "2"],
    ["--synthetic", "1", "--render_dir", "x", "--obj_mesh", "missing.ply"],
    ["--synthetic", "1", "--sampler", "euler"],
])
def test_flag_checks(argv):
    with pytest.raises(SystemExit) as stop:
        tcli.main(argv)
    assert stop.value.code == 2


def test_synthetic_batches_and_body_match_jax():
    """One seed, one body and one first batch on both sides, drawn in the
    order of the CLIs: the body first, then the batches."""
    jrng, trng = jcommon.seed_everything(7), tcommon.seed_everything(7)
    jbody = jcommon.synthetic_smpl_body(jrng)
    tbody = tcommon.synthetic_smpl_body(trng, device="cpu")
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor",
                 "weights"):
        np.testing.assert_array_equal(getattr(tbody, name).numpy(),
                                      np.asarray(getattr(jbody, name)))
    np.testing.assert_array_equal(tbody.faces, np.asarray(jbody.faces))
    kw = dict(batch_size=2, seq_len=35, num_points=512, steps=2)
    for jb, tb in zip(jcommon.synthetic_smpl_batches(jrng, **kw),
                      tcommon.synthetic_smpl_batches(trng, **kw)):
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    assert tcommon.fit_batch_size(3, 8) == jcommon.fit_batch_size(3, 8) == 3
    assert tcommon.fit_batch_size(30, 8) == 8


SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
B, FOLD, SAMPLES, STEPS = 2, 2, 4, 5


@pytest.fixture(scope="module")
def small_eval():
    """The small model on both sides with one set of weights, the 128-vertex
    stand-in body on both, and the JAX loop body's jitted postprocess,
    metrics and encode, made once for the module's cases."""
    jtrack = JTrack(**SMALL, diffusion=JDiffCfg(timestep_respacing=str(STEPS)))
    jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((B, 35, 144)), jnp.zeros((B, 64, 6)),
        jnp.zeros((B,), jnp.int32), method=JMDM.init_forward))()
    track = SmplTrackConfig(
        **SMALL, diffusion=DiffusionConfig(timestep_respacing=str(STEPS)))
    model = track.build_model("cpu")
    model.load_state_dict(
        flax_to_torch_state_dict(jax.device_get(variables)), strict=True)
    jsmpl = jcommon.synthetic_smpl_body(np.random.default_rng(3))
    cfg = jss.SmplEvalConfig()
    faces = jnp.asarray(jsmpl.faces)
    return dict(
        jmodel=jmodel, jdiff=jdiff, variables=variables, jsmpl=jsmpl,
        track=track, model=model,
        tsmpl=tcommon.synthetic_smpl_body(np.random.default_rng(3),
                                          device="cpu"),
        post=jax.jit(lambda x, h, b: jss.postprocess_sample(cfg, jsmpl, x, h,
                                                            b)),
        metrics=jax.jit(lambda out, gt_post, pts3: j_smpl_metrics(
            out["obj_pred"][:, 10:], out["jtr"][:, 10:],
            out["body_pred"][:, 10:], gt_post["obj_pred"][:, 10:],
            gt_post["jtr"][:, 10:], gt_post["body_pred"][:, 10:],
            out["verts"][:, 10:], faces, pts3)),
        encode=jax.jit(lambda v, g, p: jmodel.apply(v, g, p,
                                                    method=JMDM.encode)))


def _jax_loop_body(batch, parts, noises, projector=None,
                   projector_vars=None):
    """`interdiff_tpu/cli/eval_smpl_short.py:263-311` for one batch, with the
    sampling noise given."""
    cfg = jss.SmplEvalConfig()
    variables, post, metrics = (parts["variables"], parts["post"],
                                parts["metrics"])
    sample = jax.jit(jss.make_sampler(
        cfg, parts["jmodel"], parts["jdiff"], smpl=parts["jsmpl"],
        projector=projector, projector_params=projector_vars,
        use_correction=projector is not None, reuse_memory=True))
    gt = j_gt_from_raw(jnp.asarray(batch["body_pose"][..., :66]),
                       jnp.asarray(batch["body_trans"]),
                       jnp.asarray(batch["obj_angles"]),
                       jnp.asarray(batch["obj_trans"]))
    pts = jnp.asarray(batch["obj_points"][..., :6])
    hand = jnp.asarray(batch["body_pose"][..., 66:])
    betas = jnp.asarray(batch["body_betas"])
    memory = parts["encode"](variables, gt, pts)
    gt_post = post(gt, hand, betas)
    gt, pts, hand, betas, memory = jsp.tile_for_diverse_samples(
        (gt, pts, hand, betas, memory), FOLD)
    gt_post = jsp.tile_for_diverse_samples(gt_post, FOLD)
    best = None
    for noise, step_noise in noises:
        x = sample(variables, jax.random.PRNGKey(0), gt, pts, hand, betas,
                   memory, noise=jnp.asarray(noise),
                   step_noise=jnp.asarray(step_noise))
        m = metrics(post(x, hand, betas), gt_post, pts[..., :3])
        m = {k: np.asarray(v) for k, v in
             jsp.best_of_n_metrics(m, FOLD).items()}
        best = m if best is None else {k: np.minimum(best[k], m[k])
                                       for k in m}
    return {k: float(v.mean()) for k, v in best.items()}


@pytest.mark.parametrize("mode", ["no_correction", "correction"])
def test_evaluate_matches_jax_loop_body(small_eval, mode):
    rng = np.random.default_rng(41)
    batch = next(tcommon.synthetic_smpl_batches(
        rng, batch_size=B, seq_len=35, num_points=64, steps=1))
    noises = [(rng.standard_normal((B * FOLD, 35, 144)).astype(np.float32),
               rng.standard_normal((STEPS, B * FOLD, 35, 144)).astype(
                   np.float32)) for _ in range(SAMPLES // FOLD)]
    model, track = small_eval["model"], small_eval["track"]
    jproj = proj_vars = projector = None
    if mode == "correction":
        jproj = JProj()
        proj_vars = jproj.init(jax.random.PRNGKey(2), jnp.zeros((B, 35, 9)),
                               jnp.zeros((B, 35, 67, 3)), jnp.zeros((B, 67)))
        projector = CorrectionConfig().build_model("cpu")
        projector.load_state_dict(
            flax_to_torch_state_dict(jax.device_get(proj_vars)), strict=True)

    want = _jax_loop_body(batch, small_eval, noises, jproj, proj_vars)
    reports = []
    totals, nb = tcli.evaluate(
        SmplEvalConfig(), model, track.diffusion.build("cpu"),
        small_eval["tsmpl"],
        [batch], projector=projector, diverse_samples=SAMPLES,
        diverse_fold=FOLD,
        # the stand-in body has 128 vertices: the JAX gather clamps the
        # marker set's indices, the port is handed them clamped
        markers_idx=np.minimum(MARKERSET_SSM67_SMPLH, 127),
        noises=iter([tuple(torch.from_numpy(a) for a in pair)
                     for pair in noises]),
        report=lambda n, running: reports.append((n, running)))
    assert nb == 1 and reports == [(1, totals)] and set(totals) == KEYS
    for k in KEYS - {"penetrate"}:
        assert abs(totals[k] - want[k]) < 1e-3, (k, totals[k], want[k])
    # a mean over 2 clips of counts out of 25 frames x 64 points
    assert abs(totals["penetrate"] - want["penetrate"]) <= 2 / 1600 + 1e-7


def test_evaluate_checks_the_fold():
    with pytest.raises(ValueError, match="diverse_fold"):
        tcli.evaluate(SmplEvalConfig(), None, None, None, [],
                      diverse_samples=3, diverse_fold=2)
