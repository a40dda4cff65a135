"""The port's data mesh (`interdiff_torch/parallel/mesh.py`) and its users
on the CPU: the divisor rule against `interdiff_tpu/cli/common.py::
make_mesh` for 1-8 devices, the contiguous shards against JAX's
``PartitionSpec("data")`` layout, the collectives at two gloo ranks (the
differentiable SUM, the gather in rank order, the metrics mean, the global
quartiles, the generator sync, the global draws and the ranks' own dropout
streams, the broadcast of rank 0's weights), a rank that fails,
`data_parallel_sample` with the tiny correction sampler against JAX's
`data_parallel_sample` on a 2-device mesh (built as
`tests/test_parallel.py` builds it), ``--mesh_devices`` of both short-term
evals through ``main`` (two ranks against one, the parser's errors, the
corpus-fitted batch shrunk to a multiple of the ranks), and a trainer at
two ranks writing its outputs on rank 0 only.

Tolerances: the sampled trajectories within 1e-4 of JAX's (sampled
trajectories, as in `tests/test_torch_sampler_correction.py`); two ranks
against one within 1e-5 (each row is computed alike; the gather is exact).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import _torch_dp_ranks as ranks  # noqa: E402
import chip_smoke  # noqa: E402  (the writer of the card's corpus)
from interdiff_tpu.cli import common as jcommon  # noqa: E402
from interdiff_tpu.diffusion.gaussian import GaussianDiffusion as JDiff  # noqa: E402
from interdiff_tpu.models.correction import ObjProjectorSmpl as JProj  # noqa: E402
from interdiff_tpu.models.mdm_smpl import MDMSmpl as JMDM  # noqa: E402
from interdiff_tpu.parallel import mesh as jmesh  # noqa: E402
from interdiff_tpu.parallel.sample_parallel import (  # noqa: E402
    data_parallel_sample as jdata_parallel_sample,
)
from interdiff_tpu.utils.fixtures import (  # noqa: E402
    make_tiny_correction_sampler as jtiny_sampler,
)
from interdiff_torch.cli import eval_skeleton, eval_smpl_short  # noqa: E402
from interdiff_torch.cli.common import synthetic_smpl_body  # noqa: E402
from interdiff_torch.parallel.mesh import (  # noqa: E402
    DataMesh,
    data_ranks,
    launch,
    make_mesh,
    shard_batch,
)
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_divisor_rule_matches_jax(monkeypatch, capsys):
    """The count of ranks for a batch, and the message, as the JAX CLIs'
    `make_mesh(batch_size=)` over 1-8 devices."""
    devices = jax.devices()
    assert len(devices) == 8
    for n in range(1, 9):
        monkeypatch.setattr(jax, "devices", lambda n=n: devices[:n])
        for batch in (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 30, 32):
            want = jcommon.make_mesh(batch_size=batch).devices.size
            said = capsys.readouterr().out
            assert data_ranks(batch, n) == want, (n, batch)
            assert capsys.readouterr().out == said
            assert data_ranks(None, n) == n


def test_shards_are_jax_data_layout():
    """Rank r's rows are the rows JAX's ``PartitionSpec("data")`` puts on
    the r-th device (axis 0, and axis 1 for a chained stack); a dict, a
    tuple, a tensor and an array alike; a batch that does not divide is
    refused."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    stacked = np.arange(2 * 8 * 2, dtype=np.float32).reshape(2, 8, 2)
    for W in (1, 2, 4, 8):
        mesh = jmesh.make_mesh(data=W)
        order = list(mesh.devices.flat)
        placed = jmesh.shard_batch({"x": jnp.asarray(x)}, mesh)["x"]
        chained = jax.device_put(jnp.asarray(stacked), jax.sharding.
                                 NamedSharding(mesh, jax.sharding.
                                               PartitionSpec(None, "data")))
        for shard in placed.addressable_shards:
            r = order.index(shard.device)
            ours = DataMesh(r, W, torch.device("cpu"))
            got = shard_batch({"x": torch.from_numpy(x), "t": (x, [x])},
                              ours)
            np.testing.assert_array_equal(got["x"].numpy(),
                                          np.asarray(shard.data))
            np.testing.assert_array_equal(got["t"][1][0],
                                          np.asarray(shard.data))
        for shard in chained.addressable_shards:
            ours = DataMesh(order.index(shard.device), W,
                            torch.device("cpu"))
            np.testing.assert_array_equal(
                shard_batch(stacked, ours, axis=1), np.asarray(shard.data))
    with pytest.raises(ValueError, match="do not shard"):
        shard_batch(np.zeros((3, 2)), DataMesh(0, 2, torch.device("cpu")))
    # no process group: one rank, and a larger mesh is refused
    one = make_mesh(device="cpu")
    assert (one.rank, one.size, one.group) == (0, 1, None)
    with pytest.raises(ValueError, match="processes"):
        make_mesh(data=2, device="cpu")


def _tiny_payload():
    """The tiny correction sampler's inputs and weights (JAX's), and JAX's
    trajectories through `data_parallel_sample` on a 2-device mesh."""
    rng = np.random.default_rng(7)
    jmodel = JMDM(embed_dim=32, ff_size=64, num_layers=2, use_pointnet2=False)
    jdiff = JDiff.create_named(steps=20, timestep_respacing="5")
    T = jmodel.past_len + jmodel.future_len
    gt = rng.standard_normal((B, T, 144)).astype(np.float32)
    pts = rng.standard_normal((B, P, 6)).astype(np.float32)
    hand = np.zeros((B, T, 90), np.float32)
    betas = np.zeros((B, T, 10), np.float32)
    noise = rng.standard_normal((B, T, 144)).astype(np.float32)
    step_noise = rng.standard_normal(
        (jdiff.num_timesteps, B, T, 144)).astype(np.float32)
    params = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(gt), jnp.asarray(pts),
        jnp.zeros((B,), jnp.int32), method=JMDM.init_forward))()
    sampler = jtiny_sampler(jmodel, jdiff, jnp.asarray(gt))
    # the fixture's projector, made again for its weights
    proj = JProj(num_markers=40, n_pre=4)
    proj_params = jax.jit(lambda: proj.init(
        jax.random.PRNGKey(1), jnp.asarray(gt[..., 135:]),
        jnp.zeros((B, T, 40, 3), jnp.float32),
        jnp.zeros((B, 40), jnp.float32)))()
    dp = jdata_parallel_sample(
        lambda p, k, g, pt, h, b, n, sn: sampler(p, k, g, pt, h, b, noise=n,
                                                 step_noise=sn),
        jmesh.make_mesh(data=2), n_args=8, replicated_args=(0, 1, 7))
    want = dp(params, jax.random.PRNGKey(3),
              *dp.place_batch((jnp.asarray(gt), jnp.asarray(pts),
                               jnp.asarray(hand), jnp.asarray(betas),
                               jnp.asarray(noise))), jnp.asarray(step_noise))
    payload = dict(
        track=dict(embedding_dim=32, ff_size=64, num_layers=2,
                   use_pointnet2=False),
        steps=20, respacing="5", gt=gt, pts=pts, hand=hand, betas=betas,
        noise=noise, step_noise=step_noise,
        mdm={k: v.numpy() for k, v in flax_to_torch_state_dict(
            jax.device_get(params)).items()},
        projector={k: v.numpy() for k, v in flax_to_torch_state_dict(
            jax.device_get(proj_params)).items()})
    return payload, np.asarray(want)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    payload, want = _tiny_payload()
    out = launch(ranks.collectives, 2, args=(payload,), device="cpu",
                 init_dir=str(tmp_path_factory.mktemp("rdv")), timeout=300,
                 collective_timeout=60)
    one = ranks.sample_world(payload, make_mesh(device="cpu"))
    return out, want, one


def test_collectives_at_two_ranks(two_ranks):
    (r0, r1), _, _ = two_ranks
    assert (r0["rank"], r1["rank"], r0["size"]) == (0, 1, 2)
    np.testing.assert_array_equal(r0["rows"], np.arange(4))
    np.testing.assert_array_equal(r1["rows"], np.arange(4, 8))
    for r in (r0, r1):
        # sum of [1, 2] and [2, 2]; cotangent [3, 1] + [4, 1]
        np.testing.assert_array_equal(r["sum"], [3.0, 4.0])
        np.testing.assert_array_equal(r["sum_grad"], [7.0, 2.0])
        np.testing.assert_array_equal(r["gathered"], [0, 1, 2, 10, 11, 12])
        assert r["mean"] == 0.5
        # the global batch's quartiles: t 100, 120 | 400 | - | 900
        assert r["quartiles"] == {"q0": 2.0, "q1": 5.0, "q2": 0.0,
                                  "q3": 2.0}
        np.testing.assert_array_equal(r["replicated"], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(r0["after_sync"], r1["after_sync"])
    np.testing.assert_array_equal(
        r0["after_sync"], torch.rand(2, generator=torch.Generator()
                                     .manual_seed(1)).numpy())
    # one global draw of 4 rows, cut in two
    whole = torch.randn((4, 3), generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(r0["randn_rows"], whole[:2].numpy())
    np.testing.assert_array_equal(r1["randn_rows"], whole[2:].numpy())
    # dropout: each rank its own masks
    m0, m1 = r0["dropout"] == 0, r1["dropout"] == 0
    assert m0.any() and m1.any() and (m0 != m1).any()


def test_data_parallel_sample_matches_jax(two_ranks):
    """The tiny correction sampler (FK, gate and projector in the loop) at
    two ranks, the given noise cut to each rank's rows: every rank's
    gathered trajectories within 1e-4 of JAX's on a 2-device mesh and
    within 1e-5 of one rank's; with noise drawn from a generator, two
    ranks give one rank's samples."""
    (r0, r1), want, one = two_ranks
    for r in (r0, r1):
        got = r["samples"]
        assert got["given"].shape == want.shape
        assert np.isfinite(got["given"]).all()
        np.testing.assert_allclose(got["given"], want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["given"], one["given"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["drawn"], one["drawn"], atol=1e-5,
                                   rtol=0)
    assert np.abs(one["drawn"] - one["given"]).max() > 0.1


def test_a_failing_rank_stops_the_launch(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the launch ends
    with rank 1's error at once, not at the collective's timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 stops here"):
        launch(ranks.fail_on_rank1, 2, device="cpu", init_dir=str(tmp_path),
               timeout=120, collective_timeout=60)
    assert time.monotonic() - t0 < 45


# a collective's limit in the two tests below, and how much longer rank 0
# takes: well past the limit, well inside the tests' time
LIMIT_S, LATE_S = 3.0, 8.0


def test_a_collective_past_its_limit_fails(tmp_path):
    """The collectives' limit is real: rank 1 waits in a broadcast that
    rank 0 reaches LATE_S seconds later, past the LIMIT_S limit, and the
    launch fails.  (What the next test's trainer would meet if its ranks
    waited for rank 0's validation in a collective.)"""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch(ranks.late_broadcast, 2, args=(LATE_S,), device="cpu",
               init_dir=str(tmp_path), timeout=120,
               collective_timeout=LIMIT_S)


def test_rank0_validation_outlasts_the_collective_limit(tmp_path):
    """A trainer at two ranks whose validation, which rank 0 runs alone,
    lasts LATE_S seconds longer than the collectives' LIMIT_S limit: the
    other rank waits for it outside the collectives
    (`parallel/mesh.py::wait_for_rank0`) and the run finishes."""
    argv = ["--device", "cpu", "--synthetic", "2", "--batch_size", "4",
            "--embedding_dim", "16", "--ff_size", "32", "--num_layers", "1",
            "--val_respacing", "2", "--results_dir", str(tmp_path / "run")]
    r0, r1 = launch(ranks.slow_validation_train, 2, args=(argv, LATE_S),
                    device="cpu", init_dir=str(tmp_path / "rdv"),
                    timeout=240, collective_timeout=LIMIT_S)
    assert r0["steps"] == r1["steps"] == 2
    assert len(r0["val"]) == 1 and r1["val"] == []
    assert all(np.isfinite(v) for v in r0["val"][0].values())


def test_mesh_devices_flags_refused(capsys):
    """JAX's parser checks: the batch must divide by N, and N may not
    exceed the devices there are."""
    for main, msg in ((eval_smpl_short.main,
                       "--batch_size must be divisible by --mesh_devices"),
                      (eval_skeleton.main,
                       "--batch_size must be divisible by --mesh_devices")):
        base = ["--device", "cpu", "--synthetic", "1", "--respacing", "2"]
        with pytest.raises(SystemExit):
            main(base + ["--batch_size", "3", "--mesh_devices", "2"])
        assert msg in capsys.readouterr().err
        too_many = str(2 * (os.cpu_count() or 1))
        with pytest.raises(SystemExit):
            main(base + ["--batch_size", too_many, "--mesh_devices",
                         too_many])
        assert f"--mesh_devices {too_many} > {os.cpu_count()} available " \
               "devices" in capsys.readouterr().err


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One train and one test sequence of 110 frames: three test clips."""
    root = tmp_path_factory.mktemp("corpus")
    body = synthetic_smpl_body(np.random.default_rng(40), device="cpu")
    return chip_smoke.write_behave_corpus(
        str(root), body, np.random.default_rng(41), sequences=1, frames=110,
        points=64)


def test_eval_smpl_short_two_ranks(corpus, capfd):
    """``--mesh_devices 2 --device cpu`` through ``main`` on the dataset
    route: the three clips' batch of 4 fits to 3 and shrinks to 2, and the
    metrics are those of one rank on those 2 clips."""
    data = ["--device", "cpu", "--motion_path", corpus[0], "--model_path",
            corpus[1], "--diverse_samples", "4", "--respacing", "3",
            "--nn_prune_delta", "0"]
    two, n2 = eval_smpl_short.main(data + ["--batch_size", "4",
                                           "--mesh_devices", "2"])
    out = capfd.readouterr().out
    assert "only 3 clip windows" in out
    assert "shrinking batch to 2 (divisible by --mesh_devices)" in out
    one, n1 = eval_smpl_short.main(data + ["--batch_size", "2",
                                           "--mesh_devices", "1"])
    assert n1 == n2 == 1 and set(one) == set(two)
    for k in one:
        assert abs(one[k] - two[k]) <= 1e-5, (k, one[k], two[k])


def test_eval_skeleton_two_ranks():
    """``--mesh_devices 2 --device cpu`` against one rank, with a rollout
    and the correction in the loop."""
    args = ["--device", "cpu", "--synthetic", "1", "--batch_size", "4",
            "--respacing", "3", "--rollouts", "1"]
    two, n2 = eval_skeleton.main(args + ["--mesh_devices", "2"])
    one, n1 = eval_skeleton.main(args + ["--mesh_devices", "1"])
    none, _ = eval_skeleton.main(args)
    assert n1 == n2 == 1 and set(one) == set(two) == set(none)
    for k in one:
        assert abs(one[k] - two[k]) <= 1e-5, (k, one[k], two[k])
        assert abs(one[k] - none[k]) <= 1e-5, (k, one[k], none[k])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_trainer_at_two_ranks_writes_on_rank0_only(tmp_path):
    """A trainer started as torchrun starts it (two processes, ``RANK``,
    ``WORLD_SIZE`` and the rendezvous in the environment), each with its
    own results directory: rank 0's holds the checkpoint, the metrics and
    ``src_snapshot/``; rank 1's stays empty."""
    port = str(_free_port())
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "interdiff_torch.cli.train_correction_skeleton", "--device",
             "cpu", "--synthetic", "2", "--batch_size", "4",
             "--results_dir", str(tmp_path / f"rank{rank}")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "done: 2 steps" in outs[0][0] and "done" not in outs[1][0]
    r0 = tmp_path / "rank0"
    assert sorted(os.listdir(r0 / "src_snapshot")) == [
        "correction.py", "losses_correction.py"]
    assert (r0 / "metrics.jsonl").exists() and (r0 / "ckpt").is_dir()
    assert not (tmp_path / "rank1").exists()
