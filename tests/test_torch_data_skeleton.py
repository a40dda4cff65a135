"""The port's copies of the host-side numpy code of the skeleton track
(`interdiff_torch/data/skeleton.py`, `interdiff_torch/geometry/rotations_np.py`,
the skeleton batches and the batch iterator of `cli/common.py`) give exactly
what `interdiff_tpu`'s give, on the same arrays and on HO-GCN pickles
written to `tmp_path`."""

import os
import pickle
import shutil

import numpy as np
import pytest

from interdiff_tpu.data import skeleton as jds
from interdiff_tpu.geometry import rotations_np as jrn
from interdiff_torch.data import skeleton as tds
from interdiff_torch.geometry import rotations_np as trn


def _quat(rng, n=None):
    q = rng.standard_normal((4,) if n is None else (n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _clip_fields(clip):
    return (clip.skeleton, clip.obj_points, clip.poses, clip.zero_pose_obj,
            clip.seq_name, clip.obj_name)


def _assert_clips_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is tds.SkeletonClip
        for a, b in zip(_clip_fields(g), _clip_fields(w)):
            np.testing.assert_array_equal(a, b)


def test_rotations_np_equal_jax_package():
    rng = np.random.default_rng(40)
    vecs = list(rng.standard_normal((20, 3)))
    axis = np.array([1.0, -2.0, 0.5]) / np.linalg.norm([1.0, -2.0, 0.5])
    vecs += [np.zeros(3), axis * np.pi, axis * (np.pi - 1e-7), axis * 1e-13]
    for v in vecs:
        np.testing.assert_array_equal(trn.rotvec_to_matrix_np(v),
                                      jrn.rotvec_to_matrix_np(v))
        R = jrn.rotvec_to_matrix_np(v)
        np.testing.assert_array_equal(trn.matrix_to_rotvec_np(R),
                                      jrn.matrix_to_rotvec_np(R))
        np.testing.assert_array_equal(trn.rotvec_compose_np(R, vecs[0]),
                                      jrn.rotvec_compose_np(R, vecs[0]))


def test_pose_helpers_equal_jax_package():
    rng = np.random.default_rng(41)
    assert tds.UNSEEN_OBJECTS == jds.UNSEEN_OBJECTS
    poses = np.concatenate([rng.standard_normal((9, 3)), _quat(rng, 9)], -1)
    poses[[2, 5, 6], 3:] *= -1.0  # sign flips frame to frame
    for q in poses[:, 3:]:
        np.testing.assert_array_equal(tds.quat_xyzw_to_matrix_np(q),
                                      jds.quat_xyzw_to_matrix_np(q))
    np.testing.assert_array_equal(tds.quat_xyzw_to_matrix_np(np.zeros(4)),
                                  jds.quat_xyzw_to_matrix_np(np.zeros(4)))
    pts = rng.standard_normal((12, 3))
    np.testing.assert_array_equal(tds.recover_init_obj(pts, poses[0]),
                                  jds.recover_init_obj(pts, poses[0]))
    np.testing.assert_array_equal(tds.pose_to_keypoints(pts, poses),
                                  jds.pose_to_keypoints(pts, poses))
    fixed = tds.get_consistent_poses(poses)
    np.testing.assert_array_equal(fixed, jds.get_consistent_poses(poses))
    assert not np.array_equal(fixed, poses)


def _sequence(rng, n, *, contact=1.0, flip=True, jitter=0.0):
    """One HO-GCN sequence: a rigid object of 12 keypoints moving with its
    pose, quaternions that flip sign, and per-frame contact."""
    q = _quat(rng, n) * 0.05 + _quat(rng)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    if flip:
        q[::7] *= -1.0
    poses = np.concatenate([rng.standard_normal((n, 3)), q], -1)
    p0 = rng.standard_normal((12, 3))
    obj = tds.pose_to_keypoints(p0, poses) + jitter * rng.standard_normal(
        (n, 12, 3))
    skeleton = rng.standard_normal((n, 21, 3))
    return skeleton, obj, poses, np.full((n, 1), contact)


@pytest.mark.parametrize("kwargs", [
    {}, {"unseen": True}, {"discard_discrep": True}, {"window": 100,
                                                      "step": 5, "down": 5}])
def test_extract_clips_and_collate_equal_jax_package(kwargs):
    rng = np.random.default_rng(42)
    skeleton, obj, poses, contact = _sequence(rng, 400)
    contact[150:] = 0.0  # the unseen rule drops windows without contact
    got = tds.extract_clips(skeleton, obj, poses, contact, seq_name="s",
                            obj_name="box", **kwargs)
    want = jds.extract_clips(skeleton, obj, poses, contact, seq_name="s",
                             obj_name="box", **kwargs)
    assert got
    _assert_clips_equal(got, want)
    batch, ref = tds.collate_skeleton(got[:3]), jds.collate_skeleton(want[:3])
    assert set(batch) == set(ref)
    for k in batch:
        assert batch[k].dtype == np.float32
        np.testing.assert_array_equal(batch[k], ref[k])
    # a sequence whose keypoints stray from the rigid pose is discarded
    bad = _sequence(rng, 400, jitter=0.1)
    assert tds.extract_clips(*bad, discard_discrep=True) == [] == \
        jds.extract_clips(*bad, discard_discrep=True)


def test_load_skeleton_datasets_equal_jax_package(tmp_path):
    rng = np.random.default_rng(43)
    root = tmp_path / "jax"
    for i, (name, n) in enumerate((("box1", 500), ("chair3", 420),
                                   ("table", 380), ("chair4", 300),
                                   ("stool", 520))):
        d = root / f"seq{i}"
        d.mkdir(parents=True)
        skeleton, obj, poses, contact = _sequence(rng, n)
        with open(d / f"subj_{name}_take{i}.pkl", "wb") as f:
            pickle.dump([[skeleton.tolist(), contact.tolist(),
                          poses.tolist(), obj.tolist()]], f)
    (root / "empty").mkdir()  # a directory with no pickle is skipped
    port = tmp_path / "port"
    shutil.copytree(root, port)

    want = jds.load_skeleton_datasets(str(root))
    got = tds.load_skeleton_datasets(str(port))
    assert [len(s) for s in got] == [len(s) for s in want]
    assert len(got[0]) and len(got[3])  # train and the unseen objects
    assert {c.obj_name for c in got[3]} <= set(tds.UNSEEN_OBJECTS)
    for g, w in zip(got, want):
        _assert_clips_equal(g, w)
    # the clip cache of either package reads back into the port's clips
    assert os.path.exists(port / "ds_seen.pkl")
    for path in (port, root):
        _assert_clips_equal(tds.load_skeleton_datasets(str(path))[0],
                            want[0])


def test_synthetic_batches_and_batch_iterator_equal_jax_package():
    """One seed gives one batch on both sides, and the host-side iterator
    yields the same minibatches in the same order."""
    from interdiff_tpu.cli import common as jcommon
    from interdiff_torch.cli import common as tcommon

    got = list(tcommon.synthetic_skeleton_batches(
        np.random.default_rng(44), batch_size=3, seq_len=20, steps=2))
    want = list(jcommon.synthetic_skeleton_batches(
        np.random.default_rng(44), batch_size=3, seq_len=20, steps=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    skeleton, obj, poses, contact = _sequence(np.random.default_rng(45), 400)
    clips = tds.extract_clips(skeleton, obj, poses, contact)
    for shuffle, drop_last in ((True, True), (False, False)):
        runs = [list(mod.batch_iterator(
            clips, tds.collate_skeleton, batch_size=4,
            rng=np.random.default_rng(46), shuffle=shuffle,
            drop_last=drop_last)) for mod in (tcommon, jcommon)]
        assert len(runs[0]) == len(runs[1]) > 0
        for g, w in zip(*runs):
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
