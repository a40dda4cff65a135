"""The last modules of the port against the JAX package on the CPU: the
tiny-model fixtures (`interdiff_torch/utils/fixtures.py`, the same arrays
from the same generator, exactly), the five reference helpers
(`nerf_embedder` and `NormalDistDecoder` in `models/layers.py`,
`batch_rodrigues_smpl` in `geometry/rotations.py`,
`vertex_joint_selector_ids` and `select_extra_joints` in
`data/constants.py`; each within 1e-6), and `cli/common.py::
snapshot_sources` as the trainers call it."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.data import constants as jconst  # noqa: E402
from interdiff_tpu.geometry import rotations as jrot  # noqa: E402
from interdiff_tpu.models import layers as jlayers  # noqa: E402
from interdiff_tpu.utils import fixtures as jfix  # noqa: E402
from interdiff_torch.data import constants as tconst  # noqa: E402
from interdiff_torch.geometry import rotations as trot  # noqa: E402
from interdiff_torch.models import layers as tlayers  # noqa: E402
from interdiff_torch.utils import fixtures as tfix  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

ARRAYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights")


@pytest.mark.parametrize("V,J", [(64, 52), (16, 24)])
def test_tiny_smpl_model_equals_jax(V, J):
    want = jfix.tiny_smpl_model(np.random.default_rng(3), V, J)
    got = tfix.tiny_smpl_model(np.random.default_rng(3), V, J, device="cpu")
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.parents, np.asarray(want.parents))
    np.testing.assert_array_equal(got.faces, np.asarray(want.faces))
    assert got.levels == tuple(tuple(lvl) for lvl in want.levels)


def test_tiny_correction_sampler_runs_on_the_cpu():
    """The fixture's sampler, the gate active on every step: finite
    samples of the clip's shape, the past frames' body kept."""
    from interdiff_torch.config import SmplTrackConfig
    from interdiff_torch.diffusion.gaussian import GaussianDiffusion

    torch.manual_seed(0)
    model = SmplTrackConfig(embedding_dim=32, ff_size=64, num_layers=2,
                            use_pointnet2=False).build_model("cpu")
    diffusion = GaussianDiffusion.create_named(steps=20,
                                               timestep_respacing="4",
                                               device="cpu")
    rng = np.random.default_rng(4)
    gt = torch.from_numpy(rng.standard_normal((2, 35, 144)).astype(
        np.float32))
    sampler = tfix.make_tiny_correction_sampler(model, diffusion, gt)
    x = sampler(gt, torch.from_numpy(rng.standard_normal(
        (2, 16, 6)).astype(np.float32)), torch.zeros(2, 35, 90),
        torch.zeros(2, 35, 10), generator=torch.Generator().manual_seed(1))
    assert x.shape == gt.shape and bool(torch.isfinite(x).all())
    assert torch.equal(x[:, :10, :135], gt[:, :10, :135])


@pytest.mark.parametrize("multires,include,log", [
    (4, True, True), (3, False, True), (5, True, False), (-1, True, True)])
def test_nerf_embedder_matches_jax(multires, include, log):
    x = np.random.default_rng(5).standard_normal((7, 3)).astype(np.float32)
    jfn, jdim = jlayers.nerf_embedder(multires, include_input=include,
                                      log_sampling=log)
    tfn, tdim = tlayers.nerf_embedder(multires, include_input=include,
                                      log_sampling=log)
    assert tdim == jdim
    np.testing.assert_allclose(tfn(torch.from_numpy(x)).numpy(),
                               np.asarray(jfn(jnp.asarray(x))), atol=1e-6,
                               rtol=0)


def test_normal_dist_decoder_matches_jax():
    x = np.random.default_rng(6).standard_normal((3, 4, 8)).astype(
        np.float32)
    jdec = jlayers.NormalDistDecoder(num_feat_in=8, latent_dim=5)
    variables = jdec.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jmu, jsigma = jdec.apply(variables, jnp.asarray(x))
    tdec = tlayers.NormalDistDecoder(8, 5)
    tdec.load_state_dict(flax_to_torch_state_dict(
        jax.device_get(variables)), strict=True)
    mu, sigma = tdec(torch.from_numpy(x))
    assert mu.shape == (12, 5)
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(jsigma),
                               atol=1e-6, rtol=1e-6)


def test_batch_rodrigues_smpl_matches_jax():
    aa = np.random.default_rng(7).standard_normal((6, 5, 3)).astype(
        np.float32)
    aa[0] = 0.0  # the zero pose, where the 1e-8 bias matters
    aa[1, 0] = [1e-7, 0.0, -1e-7]
    want = np.asarray(jrot.batch_rodrigues_smpl(jnp.asarray(aa)))
    got = trot.batch_rodrigues_smpl(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0], np.broadcast_to(np.eye(3), (5, 3, 3)),
                               atol=1e-6)


@pytest.mark.parametrize("hands,feet", [(True, True), (False, True),
                                        (True, False), (False, False)])
def test_extra_joints_match_jax(hands, feet):
    kw = dict(use_hands=hands, use_feet_keypoints=feet)
    ids = tconst.vertex_joint_selector_ids(**kw)
    np.testing.assert_array_equal(ids, jconst.vertex_joint_selector_ids(**kw))
    assert ids.dtype == np.int32 and len(ids) == 10 * hands + 6 * feet
    rng = np.random.default_rng(8)
    verts = rng.standard_normal((2, 6890, 3)).astype(np.float32)
    joints = rng.standard_normal((2, 52, 3)).astype(np.float32)
    want = np.asarray(jconst.select_extra_joints(
        jnp.asarray(verts), jnp.asarray(joints), **kw))
    np.testing.assert_allclose(
        tconst.select_extra_joints(torch.from_numpy(verts),
                                   torch.from_numpy(joints), **kw).numpy(),
        want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        tconst.select_extra_joints(verts, joints, **kw),
        jconst.select_extra_joints(verts, joints, **kw))


def test_snapshot_sources(tmp_path):
    """The trainers' module lists import and copy; a module that does not
    import is left out, as in the JAX package; a trainer run writes its
    snapshot."""
    from interdiff_torch.cli import (
        train_correction_skeleton,
        train_correction_smpl,
        train_diffusion_skeleton,
        train_diffusion_smpl,
    )
    from interdiff_torch.cli.common import snapshot_sources

    for cli in (train_diffusion_smpl, train_diffusion_skeleton,
                train_correction_smpl, train_correction_skeleton):
        out = tmp_path / cli.__name__.rsplit(".", 1)[1]
        snapshot_sources(str(out), list(cli.SNAPSHOT) + ["no.such.module"])
        names = sorted(os.listdir(out / "src_snapshot"))
        assert names == sorted(m.rsplit(".", 1)[1] + ".py"
                               for m in cli.SNAPSHOT)
    _, summary = train_correction_skeleton.main([
        "--device", "cpu", "--synthetic", "1", "--batch_size", "2",
        "--results_dir", str(tmp_path / "run")])
    assert summary["steps"] == 1
    assert sorted(os.listdir(tmp_path / "run" / "src_snapshot")) == [
        "correction.py", "losses_correction.py"]


def _py_modules(package: str) -> set:
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), package)
    out = set()
    for d, _, files in os.walk(root):
        if "_build" in d or "__pycache__" in d:
            continue
        out |= {os.path.relpath(os.path.join(d, f), root)
                for f in files if f.endswith(".py")}
    return out


def test_every_module_and_flag_has_its_counterpart():
    """Each module of the JAX package has a port at the same path (a Pallas
    kernel's module, `ops/pallas_<x>.py`, its wrapper `ops/<x>.py` over
    `csrc/`), and each entry point takes every flag the JAX one does."""
    import re

    jax_mods, port = _py_modules("interdiff_tpu"), _py_modules(
        "interdiff_torch")
    missing = {m for m in jax_mods
               if m.replace("ops/pallas_", "ops/") not in port}
    assert not missing, sorted(missing)
    flag = re.compile(r'add_argument\(\s*"(--\w+)"')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checked = 0
    for m in sorted(jax_mods):
        if not m.startswith("cli/") or m.endswith(("__init__.py",
                                                   "common.py")):
            continue
        want = set(flag.findall(open(os.path.join(
            root, "interdiff_tpu", m)).read()))
        got = set(flag.findall(open(os.path.join(
            root, "interdiff_torch", m)).read()))
        # the flags that the shared helpers add
        got |= set(flag.findall(open(os.path.join(
            root, "interdiff_torch", "cli", "common.py")).read()))
        assert want <= got, (m, sorted(want - got))
        checked += 1
    assert checked == 9
