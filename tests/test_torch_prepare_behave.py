"""The port's contact-label preprocessing (`interdiff_torch/data/
prepare_behave.py`) against the JAX package's on the CPU, on a 6-frame
sequence written by `chip_smoke.write_behave_corpus` (the 128-vertex
stand-in body as its SMPL-H pkl, a stand-in object scan from
`chip_smoke.write_object_meshes`, 256 sampled points): the object's
template points and normals bitwise, the foot labels equal, the object and
body contact labels equal except for points (vertices) within 1e-5 m of the
0.02 m threshold by JAX's own distances (float32 signed distances for the
object, float64 distances for the body); the engine fixed on both sides
(JAX's brute force with its native engine switched off, or the native
engine on both); the written file read back by the port's
`data/behave.py`; ``main`` on the CPU; no fallback, no default device."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the writers of the corpus)
from interdiff_torch.cli.common import synthetic_smpl_body  # noqa: E402
from interdiff_torch.data import prepare_behave as tprep  # noqa: E402
from interdiff_torch.data.behave import load_behave_sequences  # noqa: E402
from interdiff_torch.smpl.loader import smpl_model_from_pkl  # noqa: E402
from interdiff_tpu.data import prepare_behave as jprep  # noqa: E402
from interdiff_tpu.geometry.rotations_np import (  # noqa: E402
    rotvec_to_matrix_np,
)
from interdiff_tpu.ops.mesh_distance import (  # noqa: E402
    signed_distance_to_mesh,
)
from interdiff_tpu.smpl import loader as jloader  # noqa: E402
from interdiff_tpu.smpl.model import smpl_forward  # noqa: E402
from interdiff_tpu.utils import native as jnative  # noqa: E402

MARGIN = 1e-5
THRES = 0.02
SAMPLES = 256


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prepare"))
    body = synthetic_smpl_body(np.random.default_rng(40), device="cpu")
    motion_path, model_path = chip_smoke.write_behave_corpus(
        root, body, np.random.default_rng(41), sequences=1, frames=6,
        points=SAMPLES, contact=False)
    object_path = os.path.join(root, "objects")
    # an object whose surface passes within the threshold of a body vertex
    # in every frame, so that the body labels are compared too
    chip_smoke.write_object_meshes(object_path, np.random.default_rng(51),
                                   verts=162)
    seq_dir = os.path.join(motion_path, sorted(os.listdir(motion_path))[0])
    jmodels = {g: jloader.smpl_model_from_pkl(
        os.path.join(model_path, f"SMPLH_{g}.pkl")) for g in ("male",
                                                              "female")}
    tmodels = {g: smpl_model_from_pkl(
        os.path.join(model_path, f"SMPLH_{g}.pkl"), device="cpu")
        for g in ("male", "female")}
    return dict(root=root, motion_path=motion_path, model_path=model_path,
                object_path=object_path, seq_dir=seq_dir, jmodels=jmodels,
                tmodels=tmodels)


def _labels(path):
    with np.load(path, allow_pickle=True) as f:
        return f["arr_0"].item()


@pytest.fixture(scope="module")
def jax_reference(corpus):
    """JAX's file (its brute force: the native engine switched off) and its
    per-frame distances: the float32 signed distances of the object points
    and, for each body vertex, the float64 distance to the nearest
    contacting object point."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "native_available", lambda: False)
    try:
        out = jprep.prepare_sequence(
            corpus["seq_dir"], corpus["object_path"], corpus["jmodels"],
            num_samples=SAMPLES, overwrite=True,
            out_file=os.path.join(corpus["root"], "jax_contact.npz"))
    finally:
        mp.undo()
    ref = _labels(out)
    seq = corpus["seq_dir"]
    with np.load(os.path.join(seq, "object_fit_all.npz")) as f:
        angles, trans_o = f["angles"], f["trans"]
    with np.load(os.path.join(seq, "smpl_fit_all.npz")) as f:
        poses, betas, trans = f["poses"], f["betas"], f["trans"]
    model = corpus["jmodels"]["male"]  # the sequence's gender
    verts = np.asarray(smpl_forward(model, poses, betas, trans)[0],
                       np.float32)
    pts = ref["object_points"][:, :3]
    obj_d, body_d = [], []
    for i in range(poses.shape[0]):
        obj_v = pts @ rotvec_to_matrix_np(angles[i]).T + trans_o[i]
        obj_d.append(np.asarray(signed_distance_to_mesh(
            obj_v, verts[i], np.asarray(model.faces))[0]))
        near = obj_v[obj_d[-1] < THRES]
        body_d.append(np.linalg.norm(near[None] - verts[i][:, None],
                                     axis=2).min(axis=1)
                      if len(near) else np.full(len(verts[i]), np.inf))
    return ref, obj_d, body_d


def _assert_labels_agree(got, ref, obj_d, body_d):
    np.testing.assert_array_equal(got["object_points"], ref["object_points"])
    assert got["foot_contact_joint_label"] == ref["foot_contact_joint_label"]
    frames = len(ref["object_contact_vertex_label"])
    for i in range(frames):
        go, ro = (set(d["object_contact_vertex_label"][i].tolist())
                  for d in (got, ref))
        off = np.asarray(sorted(go ^ ro), np.int64)
        assert np.all(np.abs(obj_d[i][off] - THRES) < MARGIN), (i, off)
        if go == ro:
            gh, rh = (set(d["human_contact_vertex_label"][i].tolist())
                      for d in (got, ref))
            off = np.asarray(sorted(gh ^ rh), np.int64)
            assert np.all(np.abs(body_d[i][off] - THRES) < MARGIN), (i, off)
    for key in ("object_contact_vertex_label", "human_contact_vertex_label"):
        assert all(a.dtype == np.int64 for a in got[key])


def test_reference_has_contacts(jax_reference):
    """The sequence reaches both sides of the threshold in every frame."""
    ref, obj_d, _ = jax_reference
    counts = [len(a) for a in ref["object_contact_vertex_label"]]
    assert all(0 < c < SAMPLES for c in counts), counts
    assert all(len(a) for a in ref["human_contact_vertex_label"])


@pytest.mark.parametrize("frames_per_call", [1, 4])
def test_prepare_sequence_matches_jax(corpus, jax_reference, tmp_path,
                                      frames_per_call):
    out = tprep.prepare_sequence(
        corpus["seq_dir"], corpus["object_path"], corpus["tmodels"],
        num_samples=SAMPLES, out_file=str(tmp_path / "contact.npz"),
        engine="torch", frames_per_call=frames_per_call, face_chunk=100)
    _assert_labels_agree(_labels(out), *jax_reference)


def test_prepare_sequence_native_engine(corpus, jax_reference, tmp_path):
    """The port's native engine against JAX's native engine."""
    if not jnative.native_available():
        pytest.skip("the JAX package's native library does not build here")
    jout = jprep.prepare_sequence(
        corpus["seq_dir"], corpus["object_path"], corpus["jmodels"],
        num_samples=SAMPLES, overwrite=True,
        out_file=str(tmp_path / "jax_native.npz"))
    timings = {}
    out = tprep.prepare_sequence(
        corpus["seq_dir"], corpus["object_path"], corpus["tmodels"],
        num_samples=SAMPLES, out_file=str(tmp_path / "native.npz"),
        engine="native", frames_per_call=3, timings=timings)
    _, obj_d, body_d = jax_reference
    _assert_labels_agree(_labels(out), _labels(jout), obj_d, body_d)
    assert timings["frames"] == 6 and set(timings) == {
        "fk", "distance", "labels", "frames"}


def test_contact_labels_for_frame_matches_jax(corpus, monkeypatch):
    """One frame, the same inputs on both sides (float64 object points,
    float32 body): both engines give JAX's sets."""
    model = corpus["tmodels"]["male"]
    verts = np.asarray(model.v_template, np.float32)
    rng = np.random.default_rng(5)
    pts = verts[rng.choice(len(verts), 64)].astype(np.float64) \
        + rng.normal(0, 0.02, (64, 3))
    for engine in ("torch", "native"):
        monkeypatch.setattr(jnative, "native_available",
                            lambda e=engine: e == "native")
        want = jprep.contact_labels_for_frame(pts, verts, model.faces)
        got = tprep.contact_labels_for_frame(pts, verts, model.faces,
                                             engine=engine, device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(want[0]) and len(want[1])


def test_written_file_reads_back(corpus, tmp_path):
    """``main`` writes every sequence's contact.npz (the corpus had none),
    and `data/behave.py` reads them into its records."""
    written = tprep.main([
        "--motion_path", corpus["motion_path"], "--object_path",
        corpus["object_path"], "--model_path", corpus["model_path"], "-n",
        str(SAMPLES), "--device", "cpu"])
    assert [os.path.dirname(p) for p in written] == sorted(
        os.path.join(corpus["motion_path"], n)
        for n in os.listdir(corpus["motion_path"]))
    seqs = load_behave_sequences(corpus["motion_path"],
                                 smpl_models=corpus["tmodels"], mode="train")
    labels = _labels(written[0])
    (seq,) = seqs
    np.testing.assert_array_equal(seq.obj_points, labels["object_points"])
    for a, b in zip(seq.obj_contact_idx,
                    labels["object_contact_vertex_label"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(seq.human_contact_idx,
                    labels["human_contact_vertex_label"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seq.ground_joint_label,
                                  labels["foot_contact_joint_label"])
    # a second run keeps the files
    mtime = os.path.getmtime(written[0])
    assert tprep.main(["--motion_path", corpus["motion_path"],
                       "--object_path", corpus["object_path"],
                       "--model_path", corpus["model_path"],
                       "--device", "cpu"]) == written
    assert os.path.getmtime(written[0]) == mtime


def test_no_fallback_and_no_default_device(corpus, monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="unknown engine"):
        tprep.prepare_sequence(corpus["seq_dir"], corpus["object_path"],
                               corpus["tmodels"], engine="igl",
                               out_file=str(tmp_path / "x.npz"))
    with pytest.raises(SystemExit):
        tprep.main(["--motion_path", "x", "--object_path", "x",
                    "--model_path", "x", "--engine", "igl"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.main(["--motion_path", corpus["motion_path"], "--object_path",
                    corpus["object_path"], "--model_path",
                    corpus["model_path"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.contact_labels_for_frame(np.zeros((2, 3)), np.eye(3),
                                       np.array([[0, 1, 2]]))
    assert not os.listdir(tmp_path)
