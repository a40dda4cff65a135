"""The port's BEHAVE data path (`interdiff_torch/data/behave.py`,
`data/paths.py`) against `interdiff_tpu`'s: the host numpy is a copy, so
canonicalized clips, dataset windows and their start frames are bitwise
equal; the load-time forward runs on the port's own FK and normals and
agrees within 1e-5 (vertices and normals) on a corpus written by
`chip_smoke.write_behave_corpus` with the 128-vertex stand-in body, each
package computing its own normals cache; and a cache written by one
package is read by the other."""

import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the writer of the card's corpus)
from interdiff_tpu.data import behave as jbehave  # noqa: E402
from interdiff_tpu.data import paths as jpaths  # noqa: E402
from interdiff_tpu.smpl.loader import smpl_model_from_pkl as j_pkl  # noqa: E402
from interdiff_torch.cli.common import synthetic_smpl_body  # noqa: E402
from interdiff_torch.data import behave as tbehave  # noqa: E402
from interdiff_torch.data import paths as tpaths  # noqa: E402
from interdiff_torch.smpl.loader import smpl_model_from_pkl as t_pkl  # noqa: E402

LOAD_TOL = 1e-5  # the port's FK and normals against JAX's


def _clip_inputs(rng, T=6, V=6890, P=16):
    return dict(
        poses=rng.standard_normal((T, 156)).astype(np.float32) * 0.3,
        betas=rng.standard_normal((T, 10)).astype(np.float32),
        trans=rng.standard_normal((T, 3)).astype(np.float32),
        pelvis=rng.standard_normal((T, 3)).astype(np.float32),
        obj_angles=rng.standard_normal((T, 3)).astype(np.float32) * 0.5,
        obj_trans=rng.standard_normal((T, 3)).astype(np.float32),
        human_verts=rng.standard_normal((T, V, 6)).astype(np.float32),
        obj_points=rng.standard_normal((P, 6)).astype(np.float32),
        obj_contact_idx=[np.array([0, 2]), np.array([], np.int64)]
        + [np.array([i]) for i in range(T - 2)],
        human_contact_idx=[np.array([1, 6889]) for _ in range(T)],
        left_foot=rng.standard_normal((10, 3)).astype(np.float32),
        right_foot=rng.standard_normal((10, 3)).astype(np.float32),
        frame_indices=np.arange(0, T),
        ground_joint_label_first=11,
    )


def _assert_same_arrays(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("heavy", [True, False])
def test_canonicalize_clip_is_bitwise_jax(heavy):
    inp = _clip_inputs(np.random.default_rng(11))
    if not heavy:
        inp["human_verts"] = None
    _assert_same_arrays(tbehave.canonicalize_clip(**inp, heavy=heavy),
                        jbehave.canonicalize_clip(**inp, heavy=heavy))


def test_yaw_rotation_is_bitwise_jax():
    rng = np.random.default_rng(12)
    for _ in range(5):
        v = rng.standard_normal(3).astype(np.float32)
        for got, want in zip(tbehave.yaw_canonical_rotation(v),
                             jbehave.yaw_canonical_rotation(v)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def _sequences(module, rng_seed, n_frames=(76, 40)):
    rng = np.random.default_rng(rng_seed)
    out = []
    for k, N in enumerate(n_frames):
        out.append(module.BehaveSequence(
            seq_name=f"Date01_s{k}", gender=("male", "female")[k],
            obj_name="backpack",
            poses=rng.standard_normal((N, 156)).astype(np.float32) * 0.2,
            betas=rng.standard_normal((N, 10)).astype(np.float32),
            trans=rng.standard_normal((N, 3)).astype(np.float32),
            obj_angles=rng.standard_normal((N, 3)).astype(np.float32),
            obj_trans=rng.standard_normal((N, 3)).astype(np.float32),
            pelvis=rng.standard_normal((N, 3)).astype(np.float32),
            left_foot=rng.standard_normal((N, 3)).astype(np.float32),
            right_foot=rng.standard_normal((N, 3)).astype(np.float32),
            human_verts=rng.standard_normal((N, 6890, 6)).astype(np.float32),
            obj_points=rng.standard_normal((8, 6)).astype(np.float32),
            obj_contact_idx=[np.array([i % 8]) for i in range(N)],
            human_contact_idx=[np.array([i]) for i in range(N)],
            ground_joint_label=np.full((N,), 10 + k)))
    return out


@pytest.mark.parametrize("fields", ["full", "light"])
def test_dataset_windows_start_frames_and_batches_match_jax(fields):
    kw = dict(past_len=3, future_len=5, sample_rate=2, fields=fields)
    jds = jbehave.BehaveDataset(_sequences(jbehave, 13),
                                rng=np.random.default_rng(7), **kw)
    tds = tbehave.BehaveDataset(_sequences(tbehave, 13),
                                rng=np.random.default_rng(7), **kw)
    assert tds.idx2frame == jds.idx2frame and len(tds) == len(jds) == 6
    jclips = [jds[i] for i in range(len(jds))]
    tclips = [tds[i] for i in range(len(tds))]
    # the same draws of the jitter: the same start frames
    assert [int(c["start_frame"]) for c in tclips] == \
        [int(c["start_frame"]) for c in jclips]
    for got, want in zip(tclips, jclips):
        _assert_same_arrays(got, want)
    _assert_same_arrays(tbehave.collate(tclips), jbehave.collate(jclips))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A written corpus, one train and one test sequence of 90 frames, and
    the 128-vertex body as its SMPLH pkls."""
    root = tmp_path_factory.mktemp("behave")
    body = synthetic_smpl_body(np.random.default_rng(14), device="cpu")
    motion_path, model_path = chip_smoke.write_behave_corpus(
        str(root), body, np.random.default_rng(15), sequences=1, frames=90,
        points=64)
    jm = {g: j_pkl(os.path.join(model_path, f"SMPLH_{g}.pkl"))
          for g in ("male", "female")}
    tm = {g: t_pkl(os.path.join(model_path, f"SMPLH_{g}.pkl"), device="cpu")
          for g in ("male", "female")}
    return root, motion_path, jm, tm


def _copy(src: str, dst: str) -> str:
    shutil.copytree(src, dst)
    return dst


def test_corpus_layout(corpus):
    _, motion_path, _, _ = corpus
    names = sorted(os.listdir(motion_path))
    assert [n[:6] for n in names] == ["Date01", "Date03"]
    for n in names:
        assert sorted(os.listdir(os.path.join(motion_path, n))) == [
            "contact.npz", "info.json", "object_fit_all.npz",
            "smpl_fit_all.npz"]


@pytest.mark.parametrize("mode", ["train", "test"])
def test_load_matches_jax_with_separate_caches(corpus, mode, tmp_path):
    root, motion_path, jm, tm = corpus
    jdir = _copy(motion_path, str(tmp_path / "j"))
    tdir = _copy(motion_path, str(tmp_path / "t"))
    want = jbehave.load_behave_sequences(jdir, smpl_models=jm, mode=mode)
    timings = {}
    got = tbehave.load_behave_sequences(tdir, smpl_models=tm, mode=mode,
                                        timings=timings)
    assert timings["sequences"] == len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert (g.seq_name, g.gender, g.obj_name) == \
            (w.seq_name, w.gender, w.obj_name)
        assert g.human_verts.shape == (90, 128, 6)
        for key in ("human_verts", "pelvis", "left_foot", "right_foot"):
            np.testing.assert_allclose(getattr(g, key), getattr(w, key),
                                       atol=LOAD_TOL, err_msg=key)
        for key in ("poses", "betas", "trans", "obj_angles", "obj_trans",
                    "obj_points", "ground_joint_label"):
            assert np.array_equal(getattr(g, key), getattr(w, key)), key
        for key in ("obj_contact_idx", "human_contact_idx"):
            assert all(np.array_equal(a, b) for a, b in
                       zip(getattr(g, key), getattr(w, key))), key
    # each package wrote its own cache, in one format
    for d in (jdir, tdir):
        cache = os.path.join(d, got[0].seq_name, "human_normal.npz")
        with np.load(cache, allow_pickle=True) as f:
            assert f["arr_0"].item()["normals"].shape == (90, 128, 3)


def test_each_package_reads_the_others_cache(corpus, tmp_path):
    _, motion_path, jm, tm = corpus
    jdir = _copy(motion_path, str(tmp_path / "j"))
    tdir = _copy(motion_path, str(tmp_path / "t"))
    jfirst = jbehave.load_behave_sequences(jdir, smpl_models=jm)
    tfirst = tbehave.load_behave_sequences(tdir, smpl_models=tm)
    # swap the folders: each now finds the other's normals on disk
    tread = tbehave.load_behave_sequences(jdir, smpl_models=tm)
    jread = jbehave.load_behave_sequences(tdir, smpl_models=jm)
    assert np.array_equal(tread[0].human_verts[..., 3:],
                          jfirst[0].human_verts[..., 3:])
    assert np.array_equal(jread[0].human_verts[..., 3:],
                          tfirst[0].human_verts[..., 3:])
    # a cache written for another body is made anew, at this body's size
    big = {g: synthetic_smpl_body(np.random.default_rng(0), num_verts=200,
                                  device="cpu") for g in ("male", "female")}
    again = tbehave.load_behave_sequences(jdir, smpl_models=big)
    assert again[0].human_verts.shape == (90, 200, 6)


def test_clips_of_the_loaded_corpus_match_jax(corpus, tmp_path):
    """Windows over the loaded sequences: start frames identical, the
    arrays that do not go through FK bitwise, the rest within LOAD_TOL
    (the FK pelvis is the clip's centroid)."""
    _, motion_path, jm, tm = corpus
    kw = dict(past_len=10, future_len=25, fields="light")
    jds = jbehave.BehaveDataset(jbehave.load_behave_sequences(
        _copy(motion_path, str(tmp_path / "j")), smpl_models=jm),
        rng=np.random.default_rng(3), **kw)
    tds = tbehave.BehaveDataset(tbehave.load_behave_sequences(
        _copy(motion_path, str(tmp_path / "t")), smpl_models=tm),
        rng=np.random.default_rng(3), **kw)
    want = jbehave.collate([jds[i] for i in range(len(jds))])
    got = tbehave.collate([tds[i] for i in range(len(tds))])
    assert set(got) == set(want)
    for k in ("start_frame", "gender", "body_pose", "body_betas",
              "obj_angles", "obj_points", "ground_joint_label"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("body_trans", "pelvis", "obj_trans"):
        np.testing.assert_allclose(got[k], want[k], atol=LOAD_TOL,
                                   err_msg=k)


def test_load_paths_matches_jax(tmp_path):
    cfg = tmp_path / "BEHAVE.yml"
    cfg.write_text("MOTION_PATH: /data/behave/sequences\n"
                   "objects: /data/behave/objects\n"
                   "Model_Path: /data/smplh\n")
    assert tpaths.load_paths(cfg).__dict__ == jpaths.load_paths(cfg).__dict__
    assert tpaths.load_paths(cfg) == tpaths.DataPaths(
        motion_path="/data/behave/sequences",
        object_path="/data/behave/objects", model_path="/data/smplh")
    (tmp_path / "empty.yml").write_text("")
    assert tpaths.load_paths(tmp_path / "empty.yml") == tpaths.DataPaths()


def test_load_paths_names_pyyaml_when_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    with pytest.raises(ImportError, match="PyYAML"):
        tpaths.load_paths(tmp_path / "BEHAVE.yml")
