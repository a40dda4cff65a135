"""The skeleton track's correction network and its quaternion plumbing in
the port (`interdiff_torch/models/correction.py::ObjProjectorSkeleton`,
`interdiff_torch/geometry/rotations.py`) against `interdiff_tpu` on the
CPU.

`matrix_to_quaternion` is held to JAX in sign: near a half turn the real
part is near 0 and the candidate choice decides q against -q.  Both give the
same keypoints, but the pose block that the sampling loop feeds back
differs, so trajectories part.  The projector (21 joints, 20 DCT
coefficients, fusion channels 9-64-32-64-9) runs on a fresh flax tree with
every leaf redrawn, moved over by the weight bridge; tolerance 1e-4 (module
forwards, PARITY.md row 6)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.config import CorrectionConfig as JCorrection  # noqa: E402
from interdiff_tpu.geometry import rotations as jrot  # noqa: E402
from interdiff_tpu.models import correction as jcorr  # noqa: E402
from interdiff_torch.config import CorrectionConfig  # noqa: E402
from interdiff_torch.geometry import rotations as trot  # noqa: E402
from interdiff_torch.utils.convert import flax_to_torch_state_dict  # noqa: E402

B, T, J = 2, 20, 21


def test_quaternion_order_helpers_match_jax():
    q = np.random.default_rng(0).standard_normal((3, 5, 4)).astype(
        np.float32)
    for name in ("quat_xyzw_to_wxyz", "quat_wxyz_to_xyzw"):
        np.testing.assert_array_equal(
            getattr(trot, name)(torch.from_numpy(q)).numpy(),
            np.asarray(getattr(jrot, name)(jnp.asarray(q))))
    t = torch.from_numpy(q)
    assert torch.equal(trot.quat_wxyz_to_xyzw(trot.quat_xyzw_to_wxyz(t)), t)
    np.testing.assert_array_equal(
        trot.quat_xyzw_to_wxyz(t)[..., 0].numpy(), q[..., 3])


def _half_turns():
    """Rotation matrices at and near a half turn about axes that tie two or
    three candidates of opposite sign, plus random rotations."""
    rng = np.random.default_rng(1)
    axes = [[1, 0, 0], [1, -1, 0], [1, 1, 0], [0, 1, -1], [1, -1, 1],
            [-1, 1, 1], [1, 2, -3]] + list(rng.standard_normal((8, 3)))
    aa = []
    for axis in axes:
        axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
        for angle in (np.pi, np.pi - 1e-3, np.pi - 1e-6, np.pi + 1e-4,
                      np.pi / 2):
            aa.append(axis * angle)
    aa = np.concatenate([np.asarray(aa), rng.standard_normal((64, 3)) * 2])
    mats = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa, jnp.float32)))
    return np.array(mats)


def test_matrix_to_quaternion_matches_jax_in_sign():
    m = _half_turns()
    want = np.asarray(jrot.matrix_to_quaternion(jnp.asarray(m)))
    got = trot.matrix_to_quaternion(torch.from_numpy(m)).numpy()
    # the same candidate on both sides: every component with its sign
    np.testing.assert_allclose(got, want, atol=1e-6)
    big = np.abs(want) > 1e-3
    np.testing.assert_array_equal(np.sign(got[big]), np.sign(want[big]))
    # near a half turn the real part is about 0, so the sign is chosen by
    # an imaginary component: the cases above do reach it
    assert (np.abs(want[:, 0]) < 1e-3).sum() >= 20


@pytest.fixture(scope="module")
def projectors():
    jproj = JCorrection(track="skeleton", num_nodes=J,
                        future_len=10).build_model()
    rng = np.random.default_rng(2)
    quat = np.array(jrot.quat_wxyz_to_xyzw(jrot.matrix_to_quaternion(
        jnp.asarray(_half_turns()[:B * T].reshape(B, T, 3, 3)))))
    trans = rng.standard_normal((B, T, 3)).astype(np.float32)
    joints = rng.standard_normal((B, T, J, 3)).astype(np.float32)
    variables = jax.device_get(jax.jit(lambda *a: jproj.init(
        jax.random.PRNGKey(3), *a))(quat, trans, joints))

    def redraw(path, leaf):
        """Every leaf moved off its initial value, at the initialiser's
        scale: the outputs stay of order one."""
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "var":
            return np.abs(x) + 0.5
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "prelu":
            return np.float32(0.25) + 0.05 * np.abs(x)
        return np.asarray(leaf) + 0.05 * x

    variables = jax.tree_util.tree_map_with_path(redraw, variables)
    tproj = CorrectionConfig(track="skeleton", num_nodes=J,
                             future_len=10).build_model("cpu")
    state = flax_to_torch_state_dict(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables)) == len(
        tproj.state_dict())
    tproj.load_state_dict(state, strict=True)
    return jproj, variables, tproj, (quat, trans, joints)


def test_projector_layout(projectors):
    _, _, tproj, _ = projectors
    core = tproj.core
    assert tuple(core.dct.shape) == (20, 20)  # n_pre = min(20, seq_len)
    assert core.st_gcnns_all.gcn0.tcn_conv.out_features == 64
    assert core.st_gcnns_all.gcn1.tcn_conv.out_features == 32
    assert tuple(core.st_gcnns_relative.gcn0.gcn.T.shape) == (20, 20)
    # the running statistics are buffers, which train mode moves; a copy,
    # so that the module-scoped projector keeps its statistics
    names = {n.rsplit(".", 1)[-1] for n, _ in tproj.named_parameters()}
    assert not names & {"running_mean", "running_var"}
    trained = copy.deepcopy(tproj)
    quat = torch.zeros(B, T, 4)
    quat[..., 3] = 1.0
    with torch.no_grad():
        trained.sample(quat, *(torch.zeros(B, T, *s) for s in ((3,), (J, 3))),
                       train=True)
    key = "core.st_gcnns_all.gcn0.tcn_bn.running_mean"
    assert not torch.equal(trained.state_dict()[key], tproj.state_dict()[key])


def test_projector_sample_matches_jax(projectors):
    jproj, variables, tproj, inputs = projectors
    want_q, want_t = jax.jit(lambda v, *a: jproj.apply(
        v, *a, method=jcorr.ObjProjectorSkeleton.sample))(variables, *inputs)
    with torch.no_grad():
        got_q, got_t = tproj.sample(*map(torch.from_numpy, inputs))
    assert got_q.shape == (B, T, 4) and got_t.shape == (B, T, 3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-4)
    # the output quaternion in sign as well (xyzw; unit)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got_q.numpy(), axis=-1), 1.0,
                               atol=1e-5)
