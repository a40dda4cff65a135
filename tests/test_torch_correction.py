"""The correction network of the SMPL track: `dct_matrices`, the ST-GCNN
blocks and `ObjProjectorSmpl` of `interdiff_torch` against `interdiff_tpu`,
with flax weights moved over by the bridge (`utils/convert.py`).  The
full-width projector uses the trained weights of
`artifacts/correction_real_params`."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import CorrectionConfig as JCorrection  # noqa: E402
from interdiff_tpu.data import constants as jconst  # noqa: E402
from interdiff_tpu.geometry.dct import dct_matrices as j_dct  # noqa: E402
from interdiff_tpu.models import correction as jcorr  # noqa: E402
from interdiff_tpu.models import layers as jlayers  # noqa: E402
from interdiff_torch.config import CorrectionConfig  # noqa: E402
from interdiff_torch.data import constants as tconst  # noqa: E402
from interdiff_torch.geometry.dct import dct_matrices  # noqa: E402
from interdiff_torch.models import correction as tcorr  # noqa: E402
from interdiff_torch.models import layers as tlayers  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORRECTION_REAL = os.path.join(ROOT, "artifacts", "correction_real_params")


def _randomised(variables, seed):
    """A fresh-init flax tree with every leaf redrawn, so that BatchNorm
    statistics, biases and the PReLU slope all matter."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "var":
            return np.abs(x) + 0.5
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "prelu":
            return np.float32(0.25) + 0.05 * np.abs(x)
        return 0.3 * x

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))


def test_constants_and_dct_equal():
    np.testing.assert_array_equal(tconst.MARKERSET_SSM67_SMPLH,
                                  jconst.MARKERSET_SSM67_SMPLH)
    np.testing.assert_array_equal(tconst.HAND_MARKER_IDS,
                                  jconst.HAND_MARKER_IDS)
    assert tconst.MARKER2BODYPART == jconst.MARKER2BODYPART
    for m in (67, 40):
        np.testing.assert_array_equal(tconst.hand_bias_vector(m),
                                      jconst.hand_bias_vector(m))
    for n in (7, 35):
        for got, want in zip(dct_matrices(n), j_dct(n)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("version", [0, 1, 2])
def test_graph_conv_matches_flax(version):
    T, V, C = 5, 6, 4
    rng = np.random.default_rng(version)
    x = rng.standard_normal((3, T, V, C)).astype(np.float32)
    jmod = jlayers.GraphConv(T, V, version)
    variables = _randomised(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                            10 + version)
    tmod = tlayers.GraphConv(T, V, version)
    tmod.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    want = jmod.apply(variables, jnp.asarray(x))
    # sums of 5-6 products in another order
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("c_in,c_out,version", [(9, 9, 0), (9, 16, 0),
                                                (9, 16, 2), (16, 16, 1)])
def test_stgcnn_layer_matches_flax(c_in, c_out, version):
    """Both residual kinds: identity (equal channels) and 1x1 conv + BN."""
    T, V = 5, 6
    rng = np.random.default_rng(c_in + c_out + version)
    x = rng.standard_normal((3, T, V, c_in)).astype(np.float32)
    jmod = jlayers.STGCNNLayer(c_in, c_out, T, V, version=version)
    variables = _randomised(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                            20 + version)
    tmod = tlayers.STGCNNLayer(c_in, c_out, T, V, version=version)
    state = flax_to_torch_state_dict(variables)
    tmod.load_state_dict(state, strict=True)
    assert ("res_conv.weight" in state) == (c_in != c_out)
    assert state["prelu"].shape == ()
    want = jmod.apply(variables, jnp.asarray(x))
    assert (np.asarray(want) < 0).any()  # the PReLU slope is exercised
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), atol=1e-5)


def test_pad_future_with_last_past_matches_jax():
    x = np.arange(2 * 7 * 3, dtype=np.float32).reshape(2, 7, 3)
    np.testing.assert_array_equal(
        tcorr.pad_future_with_last_past(torch.from_numpy(x), 3).numpy(),
        np.asarray(jcorr.pad_future_with_last_past(jnp.asarray(x), 3)))


@pytest.fixture(scope="module")
def projectors():
    """The full-width projector (67 markers, n_pre 10, 35 frames) with the
    trained weights restored as `interdiff_tpu/cli/common.py` does."""
    if not os.path.isdir(CORRECTION_REAL):
        pytest.skip("artifacts/correction_real_params not present")
    from interdiff_tpu.cli.common import load_correction_variables

    variables = jax.device_get(load_correction_variables(CORRECTION_REAL))
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    jproj = JCorrection().build_model()
    tproj = CorrectionConfig().build_model("cpu")
    tproj.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    return jproj, variables, tproj


def _projector_inputs():
    rng = np.random.default_rng(11)
    obj9 = rng.standard_normal((3, 35, 9)).astype(np.float32)
    markers = rng.standard_normal((3, 35, 67, 3)).astype(np.float32)
    contact = np.zeros((3, 67), np.float32)
    contact[0, [5, 20, 40]] = [3, 7, 7]  # a tie: the first maximum wins
    contact[2, [10, 50]] = [4, 4]  # a tie broken by the 0.5 hand bias
    return obj9, markers, contact


@pytest.mark.parametrize("initialize", [False, True])
def test_projector_full_width_matches_jax(projectors, initialize):
    jproj, variables, tproj = projectors
    obj9, markers, contact = _projector_inputs()
    want = jproj.apply(variables, jnp.asarray(obj9), jnp.asarray(markers),
                       jnp.asarray(contact), initialize=initialize,
                       method=jcorr.ObjProjectorSmpl.sample)
    with torch.no_grad():
        got = tproj.sample(*map(torch.from_numpy, (obj9, markers, contact)),
                           initialize=initialize)
    assert got.shape == (3, 35, 9)
    # module forwards: PARITY.md's 1e-4 (12 layers of f32 sums)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_projector_marker_choice(projectors):
    """Row 0 has contact (first of two equal counts), row 1 none (the
    absolute node), row 2 a tie that the hand bias breaks."""
    _, _, tproj = projectors
    obj9, markers, contact = _projector_inputs()
    with torch.no_grad():
        nodes = tproj.core(torch.from_numpy(obj9), torch.from_numpy(markers))
        got = tproj.sample(*map(torch.from_numpy, (obj9, markers, contact)))
    assert 10 in tconst.HAND_MARKER_IDS and 50 not in tconst.HAND_MARKER_IDS
    # two forwards of the trunk: threaded BLAS may round the last bits
    # otherwise, while two nodes differ by far more than 1e-4
    for row, node in ((0, 1 + 20), (1, 0), (2, 1 + 10)):
        torch.testing.assert_close(got[row], nodes[row, :, node],
                                   atol=1e-4, rtol=0)
        assert float((got[row] - nodes[row, :, 1 + 40]).abs().max()) > 1e-2
    w = torch.tensor([[1.0, 3.5, 3.5, 0.0]])
    assert int(torch.argmax(w, dim=-1)) == 1 == int(
        jnp.argmax(jnp.asarray(w.numpy()), axis=-1)[0])
    # an explicit choice overrides the first maximum (the train-mode path
    # takes the JAX package's draw this way)
    with torch.no_grad():
        forced = tproj.sample(*map(torch.from_numpy, (obj9, markers,
                                                      contact)),
                              marker_idx=torch.tensor([40, 0, 50]))
    for row, node in ((0, 1 + 40), (1, 0), (2, 1 + 50)):
        torch.testing.assert_close(forced[row], nodes[row, :, node],
                                   atol=1e-4, rtol=0)


def test_bridge_maps_every_projector_leaf_once_and_rejects_unknown(projectors):
    _, variables, tproj = projectors
    state = flax_to_torch_state_dict(variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(state) == n_leaves == len(tproj.state_dict())
    bad = {"params": {"core": {"gcn": {"W": np.zeros((2, 2), np.float32)}}}}
    with pytest.raises(ValueError, match="unknown params leaf core.gcn.W"):
        flax_to_torch_state_dict(bad)
    bad = {"params": {}, "batch_stats": {"bn": {"count": np.zeros(2)}}}
    with pytest.raises(ValueError, match="unknown batch_stats leaf"):
        flax_to_torch_state_dict(bad)
