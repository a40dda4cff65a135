"""The render flags of the port's six entry points on the CPU at a small
size: each writes its gif, showing one frame per frame of the clip or the
rollout (`chip_smoke.gif_frame_count`: the gif writers merge identical
consecutive frames); `eval_smpl_short`'s gif is the one a direct `viz/mesh_viz.py` call
writes from the same sampled outputs, with the object as point spheres or
as the mesh of ``--obj_mesh`` (or the one found beside a one-category
corpus, as the JAX package finds it); the SMPL correction trainer ignores
the flag under ``--synthetic`` with the JAX package's message."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")
PIL = pytest.importorskip("PIL.Image")

import chip_smoke  # noqa: E402  (the writers of the corpus and meshes)
from interdiff_torch.cli import common  # noqa: E402
from interdiff_torch.cli import eval_skeleton  # noqa: E402
from interdiff_torch.cli import eval_smpl_long  # noqa: E402
from interdiff_torch.cli import eval_smpl_short  # noqa: E402
from interdiff_torch.cli import train_correction_smpl  # noqa: E402
from interdiff_torch.cli import train_diffusion_skeleton  # noqa: E402
from interdiff_torch.cli import train_diffusion_smpl  # noqa: E402
from interdiff_torch.eval.metrics import smooth_seam  # noqa: E402
from interdiff_torch.geometry.rotations import (  # noqa: E402
    axis_angle_to_matrix,
)
from interdiff_torch.viz.mesh_viz import visualize_body_obj  # noqa: E402
from interdiff_tpu.cli import common as jcommon  # noqa: E402

SHORT = ["--device", "cpu", "--batch_size", "1", "--diverse_samples", "1",
         "--diverse_fold", "1", "--respacing", "2"]
TINY = ["--embedding_dim", "32", "--ff_size", "32", "--num_layers", "2",
        "--val_respacing", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(path):
    with PIL.open(path) as im:
        out = []
        for k in range(im.n_frames):
            im.seek(k)
            out.append(np.asarray(im.convert("RGB")))
    return out


def _count(path, fps=30):
    return chip_smoke.gif_frame_count(str(path), fps)


def _write_obj(path, semi_axes=(0.15, 0.1, 0.2)):
    v, f = chip_smoke.ellipsoid_mesh(semi_axes, 80)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as out:
        out.writelines(f"v {a!r} {b!r} {c!r}\n" for a, b, c in v.tolist())
        out.writelines(f"f {a + 1} {b + 1} {c + 1}\n"
                       for a, b, c in f.tolist())
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One category (two sequences of 80 frames, 128 points) and its
    simplified mesh where `find_object_mesh` looks: beside the sequences,
    ``objects/<cat>/<cat>_f1000.ply``."""
    root = tmp_path_factory.mktemp("render_corpus")
    body = common.synthetic_smpl_body(np.random.default_rng(40),
                                      device="cpu")
    motion_path, model_path = chip_smoke.write_behave_corpus(
        str(root), body, np.random.default_rng(41), sequences=1, frames=80,
        points=128)
    cat = chip_smoke.BEHAVE_CATEGORIES[0]
    v, f = chip_smoke.ellipsoid_mesh((0.2, 0.1, 0.15), 60)
    ply = root / "objects" / cat / f"{cat}_f1000.ply"
    os.makedirs(ply.parent)
    ply.write_text("\n".join(
        ["ply", "format ascii 1.0", f"element vertex {len(v)}",
         "property float x", "property float y", "property float z",
         f"element face {len(f)}", "property list uchar int vertex_indices",
         "end_header"]
        + [f"{a!r} {b!r} {c!r}" for a, b, c in v.tolist()]
        + [f"3 {a} {b} {c}" for a, b, c in f.tolist()]) + "\n")
    return motion_path, model_path, str(ply), cat


@pytest.mark.parametrize("with_mesh", [False, True])
def test_eval_short_gif_is_mesh_viz_of_the_outputs(tmp_path, monkeypatch,
                                                   with_mesh):
    outs = []
    post = eval_smpl_short.postprocess_sample

    def spy(*args, **kwargs):
        outs.append(post(*args, **kwargs))
        return outs[-1]

    monkeypatch.setattr(eval_smpl_short, "postprocess_sample", spy)
    argv = SHORT + ["--synthetic", "1", "--mode", "no_correction",
                    "--render_dir", str(tmp_path / "r")]
    mesh = None
    if with_mesh:
        path = _write_obj(str(tmp_path / "obj" / "o.obj"))
        argv += ["--obj_mesh", path]
        mesh = common.load_object_mesh(path)
    batches = []
    real = eval_smpl_short.synthetic_smpl_batches
    monkeypatch.setattr(
        eval_smpl_short, "synthetic_smpl_batches",
        lambda *a, **k: (batches.append(b) or b for b in real(*a, **k)))
    eval_smpl_short.main(argv)
    gif = tmp_path / "r" / "batch1.gif"
    got = _frames(gif)
    assert _count(gif) == 35

    # the last postprocess call is the rendered sample's
    out = outs[-1]
    verts = smooth_seam(out["verts"], 25)[0].numpy()
    obj = smooth_seam(out["obj_pred"], 25)[0]
    rot = axis_angle_to_matrix(obj[:, :3]).numpy()
    tpl, faces = mesh if with_mesh else (
        batches[0]["obj_points"][0, :, :3], None)
    obj_verts = np.einsum("tij,pj->tpi", rot, tpl) + obj[:, None,
                                                         3:].numpy()
    smpl = common.synthetic_smpl_body(np.random.default_rng(233),
                                      device="cpu")
    visualize_body_obj(verts, smpl.faces, obj_verts, faces, past_len=10,
                       save_path=str(tmp_path / "direct.gif"))
    want = _frames(tmp_path / "direct.gif")
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_object_mesh_lookup_matches_jax(corpus, tmp_path):
    motion_path, _, ply, cat = corpus
    assert common.find_object_mesh(motion_path, cat) == ply == \
        jcommon.find_object_mesh(motion_path, cat)
    assert common.find_object_mesh(motion_path, "stool") is None
    for a, b in zip(common.load_object_mesh(ply),
                    jcommon.load_object_mesh(ply)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_eval_short_dataset_route_finds_the_mesh(corpus, tmp_path,
                                                 monkeypatch):
    motion_path, model_path, ply, _ = corpus
    seen = []
    real = common.render_body_object
    monkeypatch.setattr(common, "render_body_object",
                        lambda *a, **k: seen.append(a) or real(*a, **k))
    eval_smpl_short.main(SHORT + [
        "--motion_path", motion_path, "--model_path", model_path,
        "--render_dir", str(tmp_path)])
    assert _count(tmp_path / "batch1.gif") == 35
    verts, faces = common.load_object_mesh(ply)
    assert np.array_equal(seen[0][5], verts)
    assert np.array_equal(seen[0][6], faces)


def test_eval_long_renders_the_rollout(tmp_path):
    eval_smpl_long.main([
        "--device", "cpu", "--synthetic", "1", "--batch_size", "1",
        "--rollouts", "1", "--respacing", "2", "--out_dir",
        str(tmp_path / "out"), "--render_dir", str(tmp_path / "r")])
    assert _count(tmp_path / "r" / "rollout0.gif") == 60


def test_eval_skeleton_renders(tmp_path):
    eval_skeleton.main(["--device", "cpu", "--synthetic", "1",
                        "--batch_size", "1", "--respacing", "2",
                        "--mode", "no_correction", "--render_dir",
                        str(tmp_path)])
    assert _count(tmp_path / "batch1_no_correction.gif", fps=10) == 20


def test_train_diffusion_smpl_renders_a_validation(tmp_path):
    train_diffusion_smpl.main(["--device", "cpu", "--synthetic", "1",
                               "--batch_size", "2", "--render_interval",
                               "3", "--results_dir", str(tmp_path)] + TINY)
    # under --synthetic every validation renders, as in JAX
    assert _count(tmp_path / "render" / "epoch0.gif") == 35


def test_train_diffusion_skeleton_renders_a_validation(tmp_path):
    train_diffusion_skeleton.main([
        "--device", "cpu", "--synthetic", "1", "--batch_size", "2",
        "--render_interval", "1", "--results_dir", str(tmp_path)] + TINY)
    assert _count(tmp_path / "render" / "epoch0.gif", fps=10) == 20


def test_train_correction_smpl_renders(corpus, tmp_path, capsys):
    motion_path = corpus[0]
    train_correction_smpl.main([
        "--device", "cpu", "--motion_path", motion_path, "--synthetic_body",
        "--batch_size", "4", "--epochs", "1", "--past_len", "4",
        "--future_len", "4", "--dct", "4", "--render_interval", "1",
        "--results_dir", str(tmp_path / "data")])
    for tag in ("pred", "gt"):
        assert _count(tmp_path / "data" / "render"
                      / f"epoch0_{tag}.gif") == 8
    train_correction_smpl.main([
        "--device", "cpu", "--synthetic", "1", "--batch_size", "2",
        "--past_len", "3", "--future_len", "3", "--dct", "4",
        "--synthetic_verts", "16", "--synthetic_points", "16",
        "--render_interval", "1", "--results_dir", str(tmp_path / "syn")])
    assert "ignored under --synthetic" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "syn" / "render")
