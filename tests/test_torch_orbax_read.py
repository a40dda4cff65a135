"""The port's reader of the JAX package's orbax saves
(`interdiff_torch/utils/{zstd,ocdbt,orbax_read}.py`), which needs neither
JAX, orbax nor tensorstore, against orbax and tensorstore themselves on the
CPU: every leaf of the four `artifacts/*_params` saves bitwise orbax's
restore; the OCDBT keys and values tensorstore's; saves the test writes
(several dtypes, 0-d leaves, lists, arrays in several zarr chunks, a B+tree
of several levels, the JAX trainers' `CheckpointManager` at its latest
step) read back as written; the entry points on the orbax directories
bitwise the same runs on the state-dict files `scripts/torch_convert_orbax
.py` writes through JAX; a resume from the JAX trainer's directory starts
from its weights bitwise, its first loss within 1e-5 of JAX's; and a save
of other widths, a foreign directory, a corrupt manifest, an unread value
type or compressor and a missing zstd library raise and name the cause."""

import json
import os
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts

torch = pytest.importorskip("torch")

from interdiff_tpu.cli.common import restore_params  # noqa: E402
from interdiff_tpu.config import SmplTrackConfig as JTrack  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_tpu.train import trainer as jtr  # noqa: E402
from interdiff_tpu.train.losses import (  # noqa: E402
    smpl_diffusion_losses as j_losses,
)
from interdiff_tpu.utils.train_io import CheckpointManager  # noqa: E402
from interdiff_torch.cli import common as tcommon  # noqa: E402
from interdiff_torch.cli import eval_skeleton as tskel_cli  # noqa: E402
from interdiff_torch.cli import eval_smpl_short as tcli  # noqa: E402
from interdiff_torch.cli import train_diffusion_smpl as ttrain_cli  # noqa: E402
from interdiff_torch.config import (  # noqa: E402
    CorrectionConfig,
    SmplTrackConfig,
)
from interdiff_torch.train import trainer as ttr  # noqa: E402
from interdiff_torch.utils import ocdbt, orbax_read, zstd  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_convert_orbax as convert_orbax  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "artifacts")
SAVES = ("smpl_real_params", "smpl_params", "correction_real_params",
         "skeleton_params")
SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=2)
SMALL_RUN = ["--device", "cpu", "--synthetic", "1", "--batch_size", "2",
             "--diverse_samples", "2", "--diverse_fold", "2", "--respacing",
             "5"]
B, T, P = 2, 35, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save(name: str) -> str:
    path = os.path.join(ARTIFACTS, name)
    if not os.path.isdir(path):
        pytest.skip(f"artifacts/{name} not present")
    return path


def _flat(tree) -> dict:
    """keystr -> leaf of a nested dict/list tree."""
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bitwise(got, want) -> None:
    got, want = _flat(got), _flat(want)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", SAVES)
def test_artifact_leaves_are_orbax_restore_bitwise(name):
    path = _save(name)
    got = orbax_read.restore(path)
    want = ocp.StandardCheckpointer().restore(path)
    _assert_bitwise(got, want)
    assert len(_flat(got)) == {"smpl_real_params": 290, "smpl_params": 290,
                               "correction_real_params": 172,
                               "skeleton_params": 230}[name]


def test_ocdbt_keys_and_values_are_tensorstores():
    path = _save("smpl_real_params")
    store = ocdbt.OcdbtStore(path)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    keys = [k.decode() for k in kv.list().result()]
    assert len(keys) == 580 and store.list() == sorted(keys)
    for key in keys[:40] + keys[-40:]:
        assert store.read(key) == kv.read(key).result().value, key


def test_tree_of_several_levels_is_tensorstores(tmp_path):
    """Small nodes force interior nodes (keys with shared prefixes stripped
    into the subtrees); short values sit inline, long ones in data files;
    two commits, the newer one read."""
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 300,
                       "max_inline_value_bytes": 16}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(0)
    for commit in range(2):
        txn = ts.Transaction()
        for i in range(70):
            kv.with_transaction(txn)[f"a/{i:03d}/{commit}"] = rng.bytes(
                int(rng.integers(1, 60)))
        txn.commit_async().result()
    store = ocdbt.OcdbtStore(str(tmp_path))
    keys = [k.decode() for k in kv.list().result()]
    assert len(keys) == 140 and store.list() == sorted(keys)
    for key in keys:
        assert store.read(key) == kv.read(key).result().value, key
    with pytest.raises(KeyError):
        store.read("a/none")


def test_flat_save_reads_back_as_written(tmp_path):
    tree = {"params": {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
        "f64": np.linspace(-1, 1, 5),
        "f16": np.asarray([1.5, -2.25], np.float16),
        "i32": np.arange(-3, 3, dtype=np.int32),
        "i64": np.asarray([2 ** 40, -5], np.int64),
        "u8": np.asarray([0, 255, 7], np.uint8),
        "flag": np.asarray([True, False, True]),
        "scalar": np.asarray(3.25, np.float32),
        "count": np.asarray(-11, np.int32),
        "layers": [np.ones((2, 2), np.float32), np.zeros((1,), np.float32)],
        "zeros": np.zeros((4, 3), np.float32)}}
    path = str(tmp_path / "save")
    saver = ocp.StandardCheckpointer()
    saver.save(path, tree)
    saver.wait_until_finished()
    got = orbax_read.restore(path)
    _assert_bitwise(got, tree)
    _assert_bitwise(got, ocp.StandardCheckpointer().restore(path))


def _zarr(root, name, metadata, *, order="C"):
    return ts.open({
        "driver": "zarr",
        "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                    "path": f"{name}/"},
        "metadata": {"order": order, **metadata},
        "create": True}).result()


def test_zarr_arrays_in_several_chunks(tmp_path):
    """Chunk grids that do not divide the shape, chunks never written
    (the fill value, or zero for null), Fortran order; an unknown
    compressor raises and names itself."""
    root = str(tmp_path)
    rng = np.random.default_rng(1)
    full = rng.standard_normal((5, 7)).astype(np.float32)
    a = _zarr(root, "a", {"shape": [5, 7], "chunks": [2, 3], "dtype": "<f4",
                          "compressor": {"id": "zstd", "level": 1},
                          "fill_value": None})
    a[:4, 2:].write(full[:4, 2:]).result()
    b = _zarr(root, "b", {"shape": [6, 4, 3], "chunks": [4, 3, 2],
                          "dtype": "<i4", "compressor": None,
                          "fill_value": -7}, order="F")
    part = rng.integers(-100, 100, (2, 4, 3)).astype(np.int32)
    b[4:, :, :].write(part).result()
    c = _zarr(root, "c", {"shape": [9], "chunks": [4], "dtype": "<f8",
                          "compressor": {"id": "blosc", "cname": "lz4",
                                         "clevel": 5, "shuffle": 1},
                          "fill_value": None})
    c[:].write(np.arange(9.0)).result()
    store = ocdbt.OcdbtStore(root)
    want_a = np.zeros((5, 7), np.float32)
    want_a[:4, 2:] = full[:4, 2:]
    got_a = ocdbt.read_array(store, "a")
    assert got_a.tobytes() == want_a.tobytes()
    assert got_a.tobytes() == a.read().result().tobytes()
    got_b = ocdbt.read_array(store, "b")
    assert np.array_equal(got_b, b.read().result())
    assert got_b.dtype == np.int32 and (got_b[:4] == -7).all()
    assert np.array_equal(got_b[4:], part)
    assert "a/2.0" not in store and "b/0.0.0" not in store  # never written
    with pytest.raises(ValueError, match="blosc"):
        ocdbt.read_array(store, "c")


@pytest.fixture(scope="module")
def jax_ckpt_dir(tmp_path_factory):
    """The JAX trainer's `CheckpointManager` directory of the small SMPL
    model with three steps, each step's weights its own init (one jitted
    init for all), and an initialised template."""
    model = JTrack(**SMALL).build_model()
    init = jax.jit(lambda key: model.init(
        key, jnp.zeros((B, T, 144)), jnp.zeros((B, P, 6)),
        jnp.zeros((B,), jnp.int32), method=JMDM.init_forward))
    path = str(tmp_path_factory.mktemp("jax_train") / "ckpt")
    mgr = CheckpointManager(path)
    trees = {}
    for step in (10, 20, 30):
        trees[step] = jax.device_get(init(jax.random.PRNGKey(step)))
        mgr.save(step, trees[step], val_loss=1.0 / step)
    mgr.wait()
    return path, trees, jax.device_get(init(jax.random.PRNGKey(0)))


def test_checkpoint_manager_is_read_at_its_latest_step(jax_ckpt_dir):
    path, trees, _ = jax_ckpt_dir
    assert orbax_read.latest_step(path) == 30
    got = orbax_read.restore(path)
    _assert_bitwise(got, trees[30])
    _assert_bitwise(got, restore_params(path))


def test_resume_from_the_jax_trainers_directory(jax_ckpt_dir, monkeypatch,
                                                tmp_path):
    """`train_diffusion_smpl --resume_checkpoint <the JAX trainer's ckpt>`
    starts from the latest step's weights bitwise; its first loss, on the
    test's timesteps and noise, within 1e-5 of the JAX loss on the weights
    the JAX trainer's own resume restores (`interdiff_tpu/cli/
    train_diffusion_smpl.py:139-146`)."""
    path, trees, template = jax_ckpt_dir
    captured = {}

    def capture(model, diffusion, *args, **kwargs):
        captured.update(model=model, diffusion=diffusion)
        return None, {}

    monkeypatch.setattr(ttrain_cli, "train", capture)
    ttrain_cli.main(["--device", "cpu", "--synthetic", "1", "--batch_size",
                     "2", "--embedding_dim", "32", "--ff_size", "64",
                     "--num_layers", "2", "--resume_checkpoint", path,
                     "--results_dir", str(tmp_path / "results")])
    model = captured["model"]
    want = flax_to_torch_state_dict(trees[30])
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    # JAX's resume: restore into the initialised template
    mgr = ocp.CheckpointManager(os.path.abspath(path))
    jparams = mgr.restore(mgr.latest_step(),
                          args=ocp.args.StandardRestore(template))
    rng = np.random.default_rng(3)
    batch = {"body_pose": (rng.standard_normal((B, T, 156)) * 0.3).astype(
                 np.float32),
             "body_trans": rng.standard_normal((B, T, 3)).astype(np.float32),
             "obj_angles": rng.standard_normal((B, T, 3)).astype(np.float32),
             "obj_trans": rng.standard_normal((B, T, 3)).astype(np.float32),
             "obj_points": rng.uniform(-0.12, 0.12, (B, P, 6)).astype(
                 np.float32)}
    t = np.asarray([17, 640], np.int32)
    noise = rng.standard_normal((B, T, 144)).astype(np.float32)

    jtrack = JTrack(**SMALL)
    jmodel, jdiff = jtrack.build_model(), jtrack.diffusion.build()

    @jax.jit
    def jax_loss(params, batch, t, noise):
        # the JAX step's loss (`interdiff_tpu/train/trainer.py`) on the
        # given draws, uniform sampler weights
        gt, pts = jtr.smpl_cond_inputs(batch)
        memory = jmodel.apply(params, gt, pts, method=JMDM.encode)
        pred, target = jdiff.training_losses(
            lambda x, ts: jmodel.apply(params, x, ts, memory), gt, t,
            noise=noise)
        per_sample, _ = j_losses(pred, target, past_len=jmodel.past_len,
                                 smpl_dim=jmodel.smpl_dim)
        return jnp.mean(per_sample)

    want_loss = float(jax_loss(jparams, batch, t, noise))

    step = ttr.make_smpl_train_step(model, captured["diffusion"])
    state = ttr.TrainState.create(dict(model.named_parameters()),
                                  ttr.adamw())
    _, metrics = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()},
                      t=torch.from_numpy(t).long(),
                      noise=torch.from_numpy(noise))
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The trained saves as the port's state-dict files, written through
    JAX and orbax by `scripts/torch_convert_orbax.py`."""
    out = tmp_path_factory.mktemp("converted")
    paths = {}
    for name, kind in (("smpl_real_params", "mdm_smpl"),
                       ("correction_real_params", "correction"),
                       ("skeleton_params", "mdm_skeleton")):
        paths[name] = str(out / f"{name}.pt")
        convert_orbax.convert(_save(name), kind, paths[name])
    return paths


def test_eval_on_the_orbax_saves_is_the_converted_files_run(converted,
                                                            capsys):
    """The short eval at full width on the trained pair: the orbax
    directories and the converted state-dict files give the same metrics
    bitwise, so `tests/test_torch_eval_cli.py`'s parity with JAX holds for
    this route too."""
    runs = []
    for diffusion, correction in (
            (_save("smpl_real_params"), _save("correction_real_params")),
            (converted["smpl_real_params"],
             converted["correction_real_params"])):
        runs.append(tcli.main(SMALL_RUN + ["--diffusion_ckpt", diffusion,
                                           "--correction_ckpt", correction]))
    assert runs[0] == runs[1]
    assert runs[0][1] == 1 and all(np.isfinite(v)
                                   for v in runs[0][0].values())


def test_skeleton_eval_on_the_orbax_save_is_the_converted_files_run(
        converted):
    runs = [tskel_cli.main(["--device", "cpu", "--synthetic", "1",
                            "--batch_size", "2", "--respacing", "3",
                            "--rollouts", "1", "--diffusion_ckpt", ckpt])
            for ckpt in (_save("skeleton_params"),
                         converted["skeleton_params"])]
    assert runs[0] == runs[1] and runs[0][1] == 1


def test_a_save_of_other_widths_is_refused():
    small = SmplTrackConfig(**SMALL).build_model("cpu")
    with pytest.raises(RuntimeError, match="size mismatch for [a-zA-Z]"):
        tcommon.load_weights(small, _save("smpl_real_params"))
    projector = CorrectionConfig().build_model("cpu")
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        tcommon.load_correction_variables(projector,
                                          _save("smpl_real_params"))


def test_foreign_or_corrupt_directories_are_refused(tmp_path):
    module = CorrectionConfig().build_model("cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    (tmp_path / "steps" / "7").mkdir(parents=True)  # no _CHECKPOINT_METADATA
    for path in (empty, tmp_path / "steps"):
        with pytest.raises(ValueError, match="not an orbax save"):
            tcommon.load_weights(module, str(path))
        with pytest.raises(ValueError, match="not an orbax save"):
            tcommon.load_mdm(str(path), "smpl", module, past_len=10,
                             future_len=25)
    corrupt = tmp_path / "corrupt"
    shutil.copytree(_save("correction_real_params"), corrupt)
    raw = bytearray((corrupt / "manifest.ocdbt").read_bytes())
    raw[20] ^= 1
    (corrupt / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        tcommon.load_correction_variables(module, str(corrupt))
    raw[:4] = b"\0\0\0\0"
    (corrupt / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="magic"):
        orbax_read.restore(str(corrupt))


def test_a_value_type_other_than_ndarray_is_refused(tmp_path):
    copy = tmp_path / "save"
    shutil.copytree(_save("correction_real_params"), copy)
    meta = json.loads((copy / "_METADATA").read_text())
    leaf = next(iter(meta["tree_metadata"].values()))
    leaf["value_metadata"]["value_type"] = "jax.Array"
    (copy / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="'jax.Array'"):
        orbax_read.restore(str(copy))


def test_a_missing_zstd_library_raises(monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "_candidates",
                        lambda: ["libzstd-not-installed.so.1"])
    with pytest.raises(RuntimeError, match=r"zstd library \(libzstd.so.1\)"):
        orbax_read.restore(_save("correction_real_params"))
