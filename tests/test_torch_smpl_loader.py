"""The port's SMPL-H pkl loader (`interdiff_torch/smpl/loader.py`) against
`interdiff_tpu/smpl/loader.py`: a pkl in the official layout (chumpy
arrays, a scipy-sparse `J_regressor`, the root's parent 2**32-1), written
by `chip_smoke.write_smplh_pkl` from the 128-vertex stand-in body, loads to
the same arrays exactly, and FK of the two models agrees within 1e-5 (the
tolerance the port's FK is held to)."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the pkl writer of the card's corpus)
from interdiff_tpu.smpl import loader as jloader  # noqa: E402
from interdiff_tpu.smpl.model import smpl_forward as j_forward  # noqa: E402
from interdiff_torch.cli.common import synthetic_smpl_body  # noqa: E402
from interdiff_torch.smpl import loader as tloader  # noqa: E402
from interdiff_torch.smpl.model import smpl_forward  # noqa: E402

ARRAYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights")


@pytest.fixture(scope="module")
def pkl(tmp_path_factory):
    path = tmp_path_factory.mktemp("smplh") / "SMPLH_male.pkl"
    body = synthetic_smpl_body(np.random.default_rng(4), device="cpu")
    chip_smoke.write_smplh_pkl(str(path), body)
    return path, body


def test_pkl_arrays_match_jax_exactly(pkl):
    path, body = pkl
    want, got = jloader.load_smpl_pkl(path), tloader.load_smpl_pkl(path)
    assert set(got) == set(want) >= {"v_template", "shapedirs", "posedirs",
                                      "J_regressor", "weights",
                                      "kintree_table", "f"}
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert got["J_regressor"].shape == (52, 128)  # densified
    assert got["kintree_table"][0, 0] == 2 ** 32 - 1
    np.testing.assert_array_equal(got["v_template"],
                                  body.v_template.numpy())


def test_models_match_jax_exactly(pkl):
    path, body = pkl
    jmodel = jloader.smpl_model_from_pkl(path, num_betas=10)
    tmodel = tloader.smpl_model_from_pkl(path, device="cpu")
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(tmodel, name).numpy(),
                                      np.asarray(getattr(jmodel, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tmodel.parents, np.asarray(jmodel.parents))
    np.testing.assert_array_equal(tmodel.faces, np.asarray(jmodel.faces))
    assert tmodel.parents[0] == 0  # the pkl's 2**32-1 root
    for name in ARRAYS:  # and the body the pkl was written from
        torch.testing.assert_close(getattr(tmodel, name),
                                   getattr(body, name), rtol=0, atol=0)


def test_fk_from_the_pkl_matches_jax(pkl):
    path, _ = pkl
    jmodel = jloader.smpl_model_from_pkl(path)
    tmodel = tloader.smpl_model_from_pkl(path, device="cpu")
    rng = np.random.default_rng(5)
    pose = (rng.standard_normal((6, 156)) * 0.3).astype(np.float32)
    betas = rng.standard_normal((6, 10)).astype(np.float32)
    trans = rng.standard_normal((6, 3)).astype(np.float32)
    want = j_forward(jmodel, jnp.asarray(pose), jnp.asarray(betas),
                     jnp.asarray(trans))
    got = smpl_forward(tmodel, torch.from_numpy(pose),
                       torch.from_numpy(betas), torch.from_numpy(trans))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_npz_conversion_and_factory(pkl, tmp_path, monkeypatch):
    path, _ = pkl
    npz = tmp_path / "SMPLH_male.npz"
    tloader.convert_pkl_to_npz(path, npz)
    from_npz = tloader.smpl_model_from_npz(npz, device="cpu")
    from_pkl = tloader.smpl_model_from_pkl(path, device="cpu")
    for name in ARRAYS:
        assert torch.equal(getattr(from_npz, name), getattr(from_pkl, name))
    # {path}/{model_type}/{MODEL_TYPE}_{GENDER}.{ext}
    (tmp_path / "smplh").mkdir()
    (tmp_path / "smplh" / "SMPLH_MALE.pkl").write_bytes(path.read_bytes())
    model = tloader.get_body_model(tmp_path, "smplh", "male", device="cpu")
    assert model.num_verts == 128 and model.num_joints == 52
    # no device named and no card: the loader stops, as every entry does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloader.smpl_model_from_pkl(path)
