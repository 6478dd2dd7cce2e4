"""The port's agent nets against the JAX package's Flax nets: random Flax
parameters carried across with ``from_flax_params`` give the same Q-values
and hidden states (float32 on the CPU; the sums run in another order, so
within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_dmfb_tpu.models import networks as jnets
from marl_dmfb_tpu_torch.models import networks as tnets
from marl_dmfb_tpu_torch.models.convert import from_flax_params

ATOL = 1e-5


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("fov,channels", [(5, 32), (9, 24), (19, 32)])
def test_crnn_matches_flax(fov, channels):
    A, H, B = 5, 128, 12
    D = 3 * fov * fov + 2 + A
    jnet = jnets.CRNNAgent(n_actions=A, obs_channels=3, fov=fov,
                           conv_channels=channels, rnn_hidden=H)
    params = jnet.init(jax.random.PRNGKey(fov), jnp.zeros((B, D)),
                       jnp.zeros((B, H)))["params"]
    tnet = tnets.CRNNAgent(n_actions=A, obs_channels=3, fov=fov,
                           conv_channels=channels, rnn_hidden=H)
    tnet.load_state_dict(from_flax_params(_np_tree(params)))
    rs = np.random.RandomState(fov)
    # int8-valued pixels and direction, a one-hot last action: the
    # rollout's inputs
    x = np.concatenate([
        rs.randint(-3, 10, (B, D - A)),
        np.eye(A)[rs.randint(0, A, B)],
    ], axis=1).astype(np.float32)
    h = rs.randn(B, H).astype(np.float32)
    q_j, h_j = jnet.apply({"params": params}, x, h)
    with torch.no_grad():
        q_t, h_t = tnet(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(q_t.numpy(), np.array(q_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), np.array(h_j), rtol=0, atol=ATOL)


def test_rnn_matches_flax():
    A, H, B, D = 5, 32, 7, 40
    jnet = jnets.RNNAgent(n_actions=A, rnn_hidden=H)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((B, D)),
                       jnp.zeros((B, H)))["params"]
    tnet = tnets.RNNAgent(input_dim=D, n_actions=A, rnn_hidden=H)
    tnet.load_state_dict(from_flax_params({"params": _np_tree(params)}))
    rs = np.random.RandomState(1)
    x = rs.randn(B, D).astype(np.float32)
    h = rs.randn(B, H).astype(np.float32)
    q_j, h_j = jnet.apply({"params": params}, x, h)
    with torch.no_grad():
        q_t, h_t = tnet(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(q_t.numpy(), np.array(q_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), np.array(h_j), rtol=0, atol=ATOL)


def test_vdn_mix_matches():
    q = np.random.RandomState(2).randn(3, 6, 4).astype(np.float32)
    np.testing.assert_allclose(tnets.vdn_mix(torch.from_numpy(q)).numpy(),
                               np.array(jnets.vdn_mix(q)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("fov", [5, 7, 9, 11, 13, 19])
def test_conv_plan_and_out_size_match(fov):
    assert tuple(tnets.conv_plan(fov)) == tuple(jnets.conv_plan(fov))
    assert tnets.conv_out_size(fov) == jnets.conv_out_size(fov)


def test_init_params_bounds_and_seed():
    net = tnets.CRNNAgent(n_actions=5, obs_channels=3, fov=9,
                          conv_channels=24)
    tnets.init_params(net, torch.Generator().manual_seed(0))
    a = {k: v.clone() for k, v in net.state_dict().items()}
    tnets.init_params(net, torch.Generator().manual_seed(0))
    for k, v in net.state_dict().items():
        assert torch.equal(a[k], v), k
    bound = {"convs.0": 1 / np.sqrt(27), "convs.1": 1 / np.sqrt(216),
             "mlp1": 1 / np.sqrt(7), "gru": 1 / np.sqrt(128),
             "fc1": 1 / np.sqrt(128)}
    for k, v in a.items():
        b = bound[k.rsplit(".", 1)[0]]
        assert v.abs().max() <= b, k
        if v.numel() >= 100:   # large tensors come close to the bound
            assert v.abs().max() > 0.9 * b, k
    # the flat GRU input: 5*5*24 conv features + 10
    assert net.gru.input_size == 610
