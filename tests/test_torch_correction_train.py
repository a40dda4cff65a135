"""The correction networks in train mode: `STGCNNLayer(train=True)` and both
projectors of `interdiff_torch` against `interdiff_tpu` with
``mutable=["batch_stats"]``, small sizes, on the CPU, flax weights moved
over by the weight bridge (`utils/convert.py`), which also carries the
updated running statistics back for the comparison.

The SMPL projector's multinomial marker draw is the JAX package's own
(`jax.random.categorical` over the log-weights, from the same key), passed
to the port as ``marker_idx``.  Tolerances: a layer's output, running
statistics and gradients within 1e-5 (sums of a few products in another
order; gradients relative to the largest entry of the gradient, which
reaches 50 on these random weights and cotangents, since a bias ahead of a
BatchNorm in train mode has an exactly zero gradient that both packages
round to about 1e-5); the projectors' outputs within 1e-4 (12 layers of
float32 sums, PARITY.md's module tolerance) and their running statistics
within 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.data.constants import hand_bias_vector  # noqa: E402
from interdiff_tpu.models import correction as jcorr  # noqa: E402
from interdiff_tpu.models import layers as jlayers  # noqa: E402
from interdiff_torch.models import correction as tcorr  # noqa: E402
from interdiff_torch.models import layers as tlayers  # noqa: E402
from interdiff_torch.utils.convert import (  # noqa: E402
    flax_to_torch_state_dict,
    torch_to_flax_variables,
)


def randomised(variables, seed):
    """A flax tree with every leaf redrawn, so that statistics, biases and
    the PReLU slope all matter."""
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


def assert_tree_close(got, want, atol, relative=False):
    """Leaf by leaf within ``atol``; with ``relative``, within ``atol``
    times the tree's largest entry (when that exceeds 1)."""
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    scale = max([1.0] + [float(np.abs(np.asarray(w)).max())
                         for w in flat_want.values()]) if relative else 1.0
    for k in flat_want:
        np.testing.assert_allclose(np.asarray(flat_got[k]),
                                   np.asarray(flat_want[k]),
                                   atol=atol * scale,
                                   err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("c_in,c_out,version", [(9, 9, 0), (9, 16, 2)])
def test_stgcnn_layer_train_mode_matches_flax(c_in, c_out, version):
    """Output, updated running statistics, and the gradient with respect to
    the parameters and the input, through the batch statistics."""
    T, V = 5, 6
    rng = np.random.default_rng(c_out + version)
    x = rng.standard_normal((3, T, V, c_in)).astype(np.float32)
    g = rng.standard_normal((3, T, V, c_out)).astype(np.float32)
    jmod = jlayers.STGCNNLayer(c_in, c_out, T, V, version=version)
    variables = randomised(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                           40 + version)

    def loss(params, xj):
        y, new = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, xj,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, new["batch_stats"])

    (_, (want, want_stats)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))

    tmod = tlayers.STGCNNLayer(c_in, c_out, T, V, version=version)
    tmod.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    # the running statistics are state, not parameters
    names = {n.rsplit(".", 1)[-1] for n, _ in tmod.named_parameters()}
    assert not names & {"running_mean", "running_var"}
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmod(xt, train=True)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    back = torch_to_flax_variables(tmod.state_dict())
    assert_tree_close(back["batch_stats"], want_stats, 1e-5)
    grads = torch_to_flax_variables(
        {n: p.grad for n, p in tmod.named_parameters()})["params"]
    assert_tree_close(grads, g_params, 1e-5, relative=True)
    assert_tree_close(xt.grad.numpy(), np.asarray(g_x), 1e-5, relative=True)
    # eval mode after the update reads the moved statistics
    with torch.no_grad():
        np.testing.assert_allclose(
            tmod(torch.from_numpy(x)).numpy(),
            np.asarray(jmod.apply({"params": variables["params"],
                                   "batch_stats": want_stats},
                                  jnp.asarray(x))), atol=1e-5)


def test_stgcnn_dropout_from_generator():
    """Dropout at rate 0.5 in train mode: inverted scaling, the mask from
    the generator (the same generator state, the same mask); no dropout in
    eval mode."""
    layer = tlayers.STGCNNLayer(4, 4, 3, 2, dropout=0.5)
    x = torch.randn(2, 3, 2, 4)

    def run(seed):
        return layer(x, train=True,
                     generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    plain = tlayers.STGCNNLayer(4, 4, 3, 2)
    plain.load_state_dict(layer.state_dict())
    torch.testing.assert_close(layer(x), plain(x), rtol=0, atol=0)


def _smpl_inputs(seed, B=4, T=12, M=67):
    rng = np.random.default_rng(seed)
    obj9 = rng.standard_normal((B, T, 9)).astype(np.float32)
    markers = rng.standard_normal((B, T, M, 3)).astype(np.float32)
    contact = np.zeros((B, M), np.float32)
    contact[0, [3, 17, 40]] = [2, 5, 1]
    contact[2, [8, 60]] = [4, 4]
    contact[3, :] = rng.integers(0, 3, M)
    return obj9, markers, contact  # row 1: no contact, the absolute node


@pytest.fixture(scope="module")
def smpl_projectors():
    obj9, markers, contact = _smpl_inputs(0)
    kw = dict(num_markers=67, n_pre=6, past_len=4, future_len=8)
    jproj = jcorr.ObjProjectorSmpl(**kw)
    variables = randomised(jproj.init(
        jax.random.PRNGKey(0), jnp.asarray(obj9), jnp.asarray(markers),
        jnp.asarray(contact)), 5)
    return jproj, variables, kw


@pytest.mark.parametrize("initialize", [False, True])
def test_smpl_projector_train_mode_matches_jax(smpl_projectors, initialize):
    """``sample(train=True)`` with the JAX package's marker draw passed as
    ``marker_idx``; ``initialize=True`` (the mean over nodes) draws
    nothing."""
    jproj, variables, kw = smpl_projectors
    obj9, markers, contact = _smpl_inputs(1)
    key = jax.random.PRNGKey(7)
    want, new = jproj.apply(
        variables, jnp.asarray(obj9), jnp.asarray(markers),
        jnp.asarray(contact), initialize=initialize, train=True,
        select_key=key, mutable=["batch_stats"],
        method=jcorr.ObjProjectorSmpl.sample)
    draw = jax.random.categorical(
        key, jnp.log(jnp.asarray(contact) + hand_bias_vector(67)))
    tproj = tcorr.ObjProjectorSmpl(**kw, device="cpu")
    tproj.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    got = tproj.sample(*map(torch.from_numpy, (obj9, markers, contact)),
                       initialize=initialize, train=True,
                       marker_idx=torch.from_numpy(np.array(draw)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    assert_tree_close(torch_to_flax_variables(tproj.state_dict())
                      ["batch_stats"], new["batch_stats"], 1e-5)


def test_smpl_projector_multinomial_draw(smpl_projectors):
    """Without ``marker_idx`` the train-mode choice is a draw from the
    generator over contact + hand bias: rows with contact take one of their
    weighted markers, a row without contact takes the absolute node, and
    the same generator state gives the same draw."""
    _, variables, kw = smpl_projectors
    obj9, markers, contact = _smpl_inputs(2)
    contact[0, [3, 17]] = [1e6, 1e6]  # a draw lands on 3 or 17 here
    tproj = tcorr.ObjProjectorSmpl(**kw, device="cpu")
    tproj.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    inputs = [torch.from_numpy(v) for v in (obj9, markers, contact)]

    def run(seed, **kwargs):
        tproj.load_state_dict(flax_to_torch_state_dict(variables))
        with torch.no_grad():
            return tproj.sample(*inputs, train=True, **kwargs,
                                generator=torch.Generator().manual_seed(seed))

    drawn = run(3)
    torch.testing.assert_close(drawn, run(3), rtol=0, atol=0)
    picks = {m: run(3, marker_idx=torch.tensor([m, 0, 0, 0]))
             for m in (3, 17)}
    assert any(torch.equal(drawn[0], p[0]) for p in picks.values())
    torch.testing.assert_close(drawn[1], picks[3][1], rtol=0, atol=0)


def test_skeleton_projector_train_mode_matches_jax():
    rng = np.random.default_rng(3)
    B, T, J = 3, 12, 21
    quat = rng.standard_normal((B, T, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    trans = rng.standard_normal((B, T, 3)).astype(np.float32)
    joints = rng.standard_normal((B, T, J, 3)).astype(np.float32)
    kw = dict(num_joints=J, past_len=4, future_len=8)
    jproj = jcorr.ObjProjectorSkeleton(**kw)
    args = tuple(map(jnp.asarray, (quat, trans, joints)))
    variables = randomised(jproj.init(jax.random.PRNGKey(0), *args), 6)
    (want_q, want_t), new = jproj.apply(
        variables, *args, train=True, mutable=["batch_stats"],
        method=jcorr.ObjProjectorSkeleton.sample)
    tproj = tcorr.ObjProjectorSkeleton(**kw, device="cpu")
    tproj.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    got_q, got_t = tproj.sample(*map(torch.from_numpy, (quat, trans, joints)),
                                train=True)
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t),
                               atol=1e-4)
    np.testing.assert_allclose(got_q.detach().numpy(), np.asarray(want_q),
                               atol=1e-4)
    assert_tree_close(torch_to_flax_variables(tproj.state_dict())
                      ["batch_stats"], new["batch_stats"], 1e-5)


def test_bridge_round_trip_of_a_projector(smpl_projectors):
    """flax -> torch -> flax gives the tree back leaf for leaf."""
    _, variables, kw = smpl_projectors
    back = torch_to_flax_variables(flax_to_torch_state_dict(variables))
    assert_tree_close(back, variables, 0.0)
    with pytest.raises(ValueError, match="no flax leaf"):
        torch_to_flax_variables({"core.x.weird": torch.zeros(2)})
