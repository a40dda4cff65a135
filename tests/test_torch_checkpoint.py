"""The reference's Lightning checkpoints in the port
(`interdiff_torch/utils/checkpoint.py`, `cli/common.py::{load_mdm,
load_correction_variables}`, `cli/convert_checkpoint.py`) against
`interdiff_tpu/utils/checkpoint.py`.

No reference checkpoint is in the repository, so each test writes one: a
port module with seeded weights (`chip_smoke.seeded_state`, small widths),
its flax-layout tree (`utils/convert.py::torch_to_flax_variables`), and the
Lightning layout of that tree (`chip_smoke.lightning_state_dict`, the
inverse of the key maps, with a positional table, BatchNorm step counters
and the reference's unused ``finalLinear`` beside the weights).  What ties
that layout to the reference's is the JAX package's converter: it reads
every key and gives back the tree it was written from.  Held here: the
port's converted state dict bitwise equal to the JAX converter's through
`flax_to_torch_state_dict`, key for key; the modules built from the files
against the JAX package's within 1e-4 (forwards); window sizes and unread
keys refused; `convert_checkpoint` round trips, and its state dict gives
`load_mdm` the module the `.ckpt` gives; and the skeleton eval's
`main` from `.ckpt` files giving the totals it gives from state-dict files
of the same weights.
"""

import ast
import json
import os

import numpy as np
import jax
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from interdiff_tpu.config import CorrectionConfig as JCorrection  # noqa: E402
from interdiff_tpu.models import correction as jcorr  # noqa: E402
from interdiff_tpu.models.mdm_skeleton import MDMSkeleton as JSkel  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_tpu.utils import checkpoint as jck  # noqa: E402
from interdiff_torch.cli import common as tcommon  # noqa: E402
from interdiff_torch.cli import convert_checkpoint as tconvert  # noqa: E402
from interdiff_torch.cli import eval_skeleton as tskel_cli  # noqa: E402
from interdiff_torch.config import (  # noqa: E402
    CorrectionConfig,
    SkeletonTrackConfig,
    SmplTrackConfig,
)
from interdiff_torch.utils import checkpoint as tck  # noqa: E402
from interdiff_torch.utils.convert import (  # noqa: E402
    flax_to_torch_state_dict,
    load_state_dict,
    save_state_dict,
    torch_to_flax_variables,
)

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
HP_SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
J = 21
CASES = ("mdm_smpl", "mdm_smpl_linear", "mdm_skeleton", "correction_smpl",
         "correction_skeleton")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(case: str):
    """(port module with seeded weights, Lightning kind, hparams)."""
    if case.startswith("mdm_smpl"):
        module = SmplTrackConfig(
            **SMALL, use_pointnet2=case == "mdm_smpl").build_model("cpu")
        kind = "mdm_smpl"
        hp = dict(HP_SMALL, past_len=10, future_len=25, smpl_dim=132)
    elif case == "mdm_skeleton":
        module = SkeletonTrackConfig(**SMALL, future_len=10).build_model(
            "cpu")
        kind, hp = case, dict(HP_SMALL, past_len=10, future_len=10)
    elif case == "correction_smpl":
        module, kind, hp = CorrectionConfig().build_model("cpu"), case, {}
    else:
        module = CorrectionConfig(track="skeleton", num_nodes=J,
                                  future_len=10).build_model("cpu")
        kind, hp = case, {}
    module.load_state_dict(chip_smoke.seeded_state(
        module, CASES.index(case) + 40), strict=True)
    return module, kind, hp


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """case -> (module, kind, hparams, path of its Lightning checkpoint)."""
    root = tmp_path_factory.mktemp("lightning")
    out = {}
    for case in CASES:
        module, kind, hp = _module(case)
        path = str(root / f"{case}.ckpt")
        chip_smoke.write_lightning_ckpt(
            path, torch_to_flax_variables(module.state_dict()), kind, hp)
        out[case] = (module, kind, hp, path)
    return out


def _jax_variables(kind: str, path: str):
    loader = {"mdm_smpl": jck.load_mdm_smpl,
              "mdm_skeleton": jck.load_mdm_skeleton,
              "correction_smpl": jck.load_correction_smpl,
              "correction_skeleton": jck.load_correction_skeleton}[kind]
    return loader(path)[0]


def _port_state(kind: str, path: str):
    if kind == "mdm_smpl":
        return flax_to_torch_state_dict(tck.load_mdm_smpl(path)[0])
    if kind == "mdm_skeleton":
        return flax_to_torch_state_dict(tck.load_mdm_skeleton(path)[0])
    return tck.correction_state_dict(path, kind.split("_")[1])


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("case", CASES)
def test_converted_state_dict_is_the_jax_converters(ckpts, case):
    module, kind, _, path = ckpts[case]
    jvars = jax.device_get(_jax_variables(kind, path))
    # the JAX converter read every key and gave back the tree written
    written = dict(_flat(torch_to_flax_variables(module.state_dict())))
    read = dict(_flat(jvars))
    written = {k: v for k, v in written.items()
               if not k.startswith("batch_stats") or v.size}
    assert set(read) == set(written)
    for k in read:
        np.testing.assert_array_equal(read[k], written[k].reshape(
            read[k].shape), err_msg=k)
    want = flax_to_torch_state_dict(jvars)
    got = _port_state(kind, path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    # and it is the module's own state dict, bit for bit
    state = module.state_dict()
    assert set(got) == set(state)
    for k in state:
        assert torch.equal(got[k], state[k]), k


def _mdm_inputs(case: str, rng):
    B, T = 2, 35 if case.startswith("mdm_smpl") else 20
    ts = np.array([500, 17], np.int32)
    if case.startswith("mdm_smpl"):
        return (rng.standard_normal((B, T, 144)).astype(np.float32) * 0.5,
                rng.uniform(-0.2, 0.2, (B, 64, 6)).astype(np.float32), ts)
    quat = rng.standard_normal((B, T, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pose = np.concatenate([rng.standard_normal((B, T, 3)), quat], -1)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.standard_normal((B, T, J, 3)), rng.standard_normal((B, T, 12, 3)),
        pose, rng.standard_normal((B, 12, 3)))) + (ts,)


def _projector_inputs(case: str, rng):
    if case == "correction_smpl":
        contact = np.zeros((3, 67), np.float32)
        contact[0, [5, 20]] = [3, 7]
        return (rng.standard_normal((3, 35, 9)).astype(np.float32),
                rng.standard_normal((3, 35, 67, 3)).astype(np.float32),
                contact)
    quat = rng.standard_normal((2, 20, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return (quat.astype(np.float32),
            rng.standard_normal((2, 20, 3)).astype(np.float32),
            rng.standard_normal((2, 20, J, 3)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_modules_from_checkpoint_match_jax(ckpts, case):
    module, kind, hp, path = ckpts[case]
    rng = np.random.default_rng(CASES.index(case))
    if kind.startswith("mdm"):
        inputs = _mdm_inputs(case, rng)
        if kind == "mdm_smpl":
            jmodel, jvars, _ = jck.mdm_smpl_from_checkpoint(path)
            model, got_hp = tck.mdm_smpl_from_checkpoint(path, "cpu")
            assert model.use_pointnet2 == (case == "mdm_smpl")
            method = JMDM.init_forward
        else:
            jmodel, jvars, _ = jck.mdm_skeleton_from_checkpoint(path)
            model, got_hp = tck.mdm_skeleton_from_checkpoint(path, "cpu")
            method = JSkel.init_forward
        assert got_hp == hp
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=method))(
            jvars, *inputs)
        with torch.no_grad():
            if kind == "mdm_smpl":  # encode + denoise, as init_forward
                gt, pts, ts = map(torch.from_numpy, inputs)
                got = model.denoise(gt, ts, model.encode(gt, pts))
            else:
                got = model.init_forward(*map(torch.from_numpy, inputs))
    else:
        track = kind.split("_")[1]
        inputs = _projector_inputs(case, rng)
        jvars = _jax_variables(kind, path)
        if track == "smpl":
            jproj = JCorrection().build_model()
            sample = jcorr.ObjProjectorSmpl.sample
            proj = CorrectionConfig().build_model("cpu")
        else:
            jproj = JCorrection(track="skeleton", num_nodes=J,
                                future_len=10).build_model()
            sample = jcorr.ObjProjectorSkeleton.sample
            proj = CorrectionConfig(track="skeleton", num_nodes=J,
                                    future_len=10).build_model("cpu")
        tcommon.load_correction_variables(proj, path, track)
        want = jax.jit(lambda v, *a: jproj.apply(v, *a, method=sample))(
            jvars, *inputs)
        with torch.no_grad():
            got = proj.sample(*map(torch.from_numpy, inputs))
    for g, w in zip(*(jax.tree.leaves(x) for x in (
            [t.numpy() for t in (got if isinstance(got, tuple) else (got,))],
            want if isinstance(want, tuple) else (want,)))):
        assert g.shape == w.shape and np.isfinite(g).all()
        # module forwards: PARITY.md's 1e-4
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case,track,windows", [
    ("mdm_smpl", "smpl", (10, 20)), ("mdm_smpl", "smpl", (8, 25)),
    ("mdm_skeleton", "skeleton", (10, 25))])
def test_load_mdm_checks_the_windows(ckpts, case, track, windows):
    path = ckpts[case][3]
    module = ckpts[case][0]
    with pytest.raises(ValueError, match="embeds past_len"):
        tcommon.load_mdm(path, track, module, past_len=windows[0],
                         future_len=windows[1])
    model = tcommon.load_mdm(path, track, module, past_len=10,
                             future_len=ckpts[case][2]["future_len"])
    assert model is not module


@pytest.mark.parametrize("case,track", [
    ("mdm_smpl", "smpl"), ("mdm_smpl_linear", "smpl"),
    ("mdm_skeleton", "skeleton")])
def test_load_mdm_builds_a_converted_state_dict_as_its_ckpt(
        ckpts, tmp_path, case, track):
    """A state dict with convert_checkpoint's hparams.json beside it gives
    the eval entry point the module the .ckpt gives (exact FPS, the linear
    encoder), not the CLI-built one; windows are checked on this route too;
    a state dict without hparams.json loads into the CLI-built module."""
    module, kind, hp, path = ckpts[case]
    out = str(tmp_path / "converted")
    tconvert.convert(path, kind, out)
    state_file = os.path.join(out, tconvert.STATE_FILE)
    cli_built = (SmplTrackConfig(**SMALL) if track == "smpl" else
                 SkeletonTrackConfig(**SMALL, future_len=10)).build_model("cpu")
    windows = dict(past_len=10, future_len=hp["future_len"])
    want = tcommon.load_mdm(path, track, cli_built, **windows)
    got = tcommon.load_mdm(state_file, track, cli_built, **windows)
    assert got is not cli_built and type(got) is type(want)
    if track == "smpl":
        assert got.use_pointnet2 == want.use_pointnet2 == (case == "mdm_smpl")
        if got.use_pointnet2:
            assert got.pcEmbedding.sa0.fps_groups == 1
    state = got.state_dict()
    assert set(state) == set(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(state[k], v), k
    with pytest.raises(ValueError, match="embeds past_len"):
        tcommon.load_mdm(state_file, track, cli_built, past_len=8,
                         future_len=hp["future_len"])
    other = "skeleton" if track == "smpl" else "smpl"
    with pytest.raises(ValueError, match="converted from"):
        tcommon.load_mdm(state_file, other, cli_built, **windows)
    plain = str(tmp_path / "plain.pt")
    save_state_dict(plain, module.state_dict())
    assert tcommon.load_mdm(plain, track, module, **windows) is module


def test_unread_or_missing_keys_are_refused(ckpts, tmp_path):
    for case in ("mdm_smpl", "correction_skeleton"):
        _, kind, hp, path = ckpts[case]
        ck = torch.load(path, weights_only=False)
        extra = dict(ck["state_dict"])
        extra["model.extraHead.weight"] = torch.zeros(2, 2)
        torch.save({**ck, "state_dict": extra}, tmp_path / "extra.ckpt")
        with pytest.raises(ValueError, match="unconsumed"):
            _port_state(kind, str(tmp_path / "extra.ckpt"))
        missing = dict(ck["state_dict"])
        del missing[sorted(k for k in missing if k.endswith(".bias"))[0]]
        torch.save({**ck, "state_dict": missing}, tmp_path / "missing.ckpt")
        with pytest.raises(KeyError):
            _port_state(kind, str(tmp_path / "missing.ckpt"))


@pytest.mark.parametrize("case", ["mdm_smpl_linear", "mdm_skeleton",
                                  "correction_smpl", "correction_skeleton"])
def test_convert_checkpoint_round_trips(ckpts, tmp_path, capsys, case):
    module, kind, hp, path = ckpts[case]
    out = str(tmp_path / "converted")
    got_hp = tconvert.main(["--ckpt", path, "--kind", kind, "--out", out])
    assert got_hp == hp
    assert "state_dict.pt" in capsys.readouterr().out
    state = load_state_dict(os.path.join(out, tconvert.STATE_FILE))
    assert set(state) == set(module.state_dict())
    for k, v in module.state_dict().items():
        assert torch.equal(state[k], v), k
    extra = {"kind": kind}
    if kind == "mdm_smpl":
        extra.update(use_pointnet2=case != "mdm_smpl_linear", fps_groups=1)
    with open(os.path.join(out, "hparams.json")) as f:
        assert json.load(f) == {**hp, **extra}
    with pytest.raises(SystemExit) as stop:  # --out must not exist
        tconvert.main(["--ckpt", path, "--kind", kind, "--out", out])
    assert stop.value.code == 2
    with pytest.raises(FileExistsError):
        tconvert.convert(path, kind, out)


def test_orbax_directories_are_refused(tmp_path):
    """A directory that is not an orbax save is refused by every loader
    (orbax saves themselves are read: `tests/test_torch_orbax_read.py`)."""
    module = CorrectionConfig().build_model("cpu")
    for load in (lambda p: tcommon.load_weights(module, p),
                 lambda p: tcommon.load_correction_variables(module, p),
                 lambda p: tcommon.load_mdm(p, "smpl", module, past_len=10,
                                            future_len=25)):
        with pytest.raises(ValueError, match="is not an orbax save"):
            load(str(tmp_path))


def _last_report(text: str) -> dict:
    """The running metrics the CLI printed last."""
    return ast.literal_eval([ln for ln in text.splitlines()
                             if ln.strip()][-1])


def test_skeleton_eval_main_from_ckpt_files_equals_state_dicts(tmp_path,
                                                                capsys):
    """`cli/eval_skeleton.py::main` at full width (the CLI's own module)
    with correction: from Lightning files and from state-dict files of the
    same seeded weights, the same totals and the same report."""
    mdm = SkeletonTrackConfig(future_len=10).build_model("cpu")
    mdm.load_state_dict(chip_smoke.seeded_state(mdm, 50), strict=True)
    proj = CorrectionConfig(track="skeleton", num_nodes=J,
                            future_len=10).build_model("cpu")
    proj.load_state_dict(chip_smoke.seeded_state(proj, 51), strict=True)
    hp = dict(embedding_dim=256, num_heads=4, ff_size=256, num_layers=8,
              past_len=10, future_len=10)
    files = {}
    for name, module, kind in (("mdm", mdm, "mdm_skeleton"),
                               ("proj", proj, "correction_skeleton")):
        files[name + ".ckpt"] = str(tmp_path / f"{name}.ckpt")
        chip_smoke.write_lightning_ckpt(
            files[name + ".ckpt"],
            torch_to_flax_variables(module.state_dict()), kind, hp)
        files[name + ".pt"] = str(tmp_path / f"{name}.pt")
        save_state_dict(files[name + ".pt"], module.state_dict())
    runs = []
    for ext in (".ckpt", ".pt"):
        totals, nb = tskel_cli.main([
            "--device", "cpu", "--synthetic", "1", "--batch_size", "2",
            "--respacing", "5", "--mode", "correction",
            "--diffusion_ckpt", files["mdm" + ext],
            "--correction_ckpt", files["proj" + ext]])
        runs.append((totals, nb, _last_report(capsys.readouterr().out)))
    (t0, n0, r0), (t1, n1, r1) = runs
    assert n0 == n1 == 1 and r0 == r1
    assert t0 == t1 and all(np.isfinite(v) for v in t0.values())
