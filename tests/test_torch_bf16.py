"""``--compute_dtype bf16`` in the PyTorch port against the JAX package's
mixed precision, on the CPU.

JAX casts each matmul's and conv's operands to bfloat16 and the product back
to float32; XLA drops that round trip of the product, so the product is the
float32 sum of the exact products of the rounded operands, and the port
computes that (``models/networks.py``).  The two still round the operands
of a layer from float32 values that their own float32 sums made, and one
ulp there can move an operand by one bfloat16 ulp (2**-8 relative), so the
outputs agree to a few bfloat16 ulps, not bitwise:

* the CRNN's and the RNN's Q-values within ``Q_ATOL`` = 1e-2 (the bf16
  export's Q-values reach 4.5; measured: 1.4e-3 and 1.8e-7) and their
  hidden states within ``H_ATOL`` = 2e-2, five bfloat16 ulps at 1
  (measured: 6.1e-3 and 1.8e-7), with the greedy actions of at least
  ``ACTION_AGREEMENT`` = 99% of the rows equal (measured: all);
* the learner's loss within rtol ``LOSS_RTOL`` = 1e-3 before and after one
  Adam update (measured: 7.0e-8 and 6.3e-5), and its gradients within
  ``GRAD_RTOL`` = 5e-3 of their global norm (measured: 5.5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_dmfb_tpu.models.networks import CRNNAgent as JCRNN
from marl_dmfb_tpu.models.networks import RNNAgent as JRNN
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch.checkpoint import read_export
from marl_dmfb_tpu_torch.models.convert import from_flax_params
from marl_dmfb_tpu_torch.models.networks import (CRNNAgent, RNNAgent,
                                                 build_agent_net,
                                                 init_params)
from marl_dmfb_tpu_torch.trainer import Trainer
from marl_dmfb_tpu_torch.utils.platform import disable_tf32
from tests.torch_port_util import committed_export
from tests.torch_learn_util import (agent_np, both, global_norm,
                                    jax_learner, port_learner, random_batch)

Q_ATOL = 1e-2
H_ATOL = 2e-2
ACTION_AGREEMENT = 0.99
LOSS_RTOL = 1e-3
GRAD_RTOL = 5e-3
BF16 = (("compute_dtype", "bf16"),)

torch.set_num_threads(1)


def _inputs(rng, rows, pix, vec_ints, n_actions=5, hidden=128):
    """Rows of the flat agent input: integer pixels, an integer direction
    and a last-action one-hot, and a hidden state."""
    x = np.concatenate([
        rng.randint(0, 5, (rows, pix)),
        rng.randint(-6, 7, (rows, vec_ints)),
        np.eye(n_actions)[rng.randint(0, n_actions, rows)]], 1)
    h = rng.randn(rows, hidden) * 0.5
    return x.astype(np.float32), h.astype(np.float32)


def _agreement(jq, tq):
    return float((jq.argmax(-1) == tq.argmax(-1)).mean())


def test_bf16_crnn_forward_matches_jax():
    """The bf16 export's weights (24 conv channels, GRU 128), 512 rows."""
    params = read_export(
        committed_export("dmfb_20x20_4d_bf16"))["ema"]["agent"]
    x, h = _inputs(np.random.RandomState(0), 512, 3 * 81, 2)
    jnet = JCRNN(n_actions=5, obs_channels=3, fov=9, conv_channels=24,
                 compute_dtype=jnp.bfloat16)
    jq, jh = map(np.array, jax.jit(jnet.apply)({"params": params}, x, h))
    net = CRNNAgent(5, 3, 9, 24, compute_dtype=torch.bfloat16)
    net.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        tq, th = (t.numpy() for t in net(torch.from_numpy(x),
                                         torch.from_numpy(h)))
    assert tq.dtype == th.dtype == np.float32
    np.testing.assert_allclose(tq, jq, rtol=0, atol=Q_ATOL)
    np.testing.assert_allclose(th, jh, rtol=0, atol=H_ATOL)
    assert _agreement(jq, tq) >= ACTION_AGREEMENT
    # and bf16 is not float32: the same weights in float32 differ
    f32 = CRNNAgent(5, 3, 9, 24)
    f32.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        assert not torch.equal(f32(torch.from_numpy(x),
                                   torch.from_numpy(h))[0],
                               torch.from_numpy(tq))


def test_bf16_rnn_forward_matches_jax():
    """The RNN agent (fc -> GRU -> fc) at random weights drawn by the JAX
    package's init."""
    x, h = _inputs(np.random.RandomState(1), 256, 20, 2)
    jnet = JRNN(n_actions=5, rnn_hidden=128, compute_dtype=jnp.bfloat16)
    params = jnet.init(jax.random.PRNGKey(0), x, h)["params"]
    jq, jh = map(np.array, jax.jit(jnet.apply)({"params": params}, x, h))
    net = RNNAgent(x.shape[1], 5, 128, compute_dtype=torch.bfloat16)
    net.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        tq, th = (t.numpy() for t in net(torch.from_numpy(x),
                                         torch.from_numpy(h)))
    np.testing.assert_allclose(tq, jq, rtol=0, atol=Q_ATOL)
    np.testing.assert_allclose(th, jh, rtol=0, atol=H_ATOL)
    assert _agreement(jq, tq) >= ACTION_AGREEMENT


def test_bf16_learner_update_matches_jax():
    """One update of the small learner configuration in bf16 in both
    packages from the same state and minibatch: the loss, the gradients,
    and the loss of the updated params on the same minibatch."""
    J = jax_learner(BF16)
    assert J.ta.compute_dtype == J.ja.compute_dtype == "bf16"
    st = J.init(jax.random.PRNGKey(0))
    port = port_learner(J.ta, st)
    assert all(m.compute_dtype is torch.bfloat16
               for m in port.net.modules() if hasattr(m, "compute_dtype"))
    jb, tb = both(random_batch(np.random.RandomState(3)))
    jl, jg = J.loss_grad(st.params, st.target_params, jb)
    tl, tg = port.loss_and_grads(tb)
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    jg = agent_np(jg)
    norm = global_norm(jg)
    for name, g in jg.items():
        np.testing.assert_allclose(tg[name].numpy(), g, rtol=0,
                                   atol=GRAD_RTOL * norm, err_msg=name)
    st, _ = J.learn(st, jb)
    port.update(tb)
    jl2, _ = J.loss_grad(st.params, st.target_params, jb)
    tl2, _ = port.loss_and_grads(tb)
    np.testing.assert_allclose(float(tl2.detach()), float(jl2),
                               rtol=LOSS_RTOL)
    assert float(jl2) != float(jl)      # the update moved the params


@pytest.mark.parametrize("argv", [
    ["dmfb", "--compute_dtype=bf16"],
    ["dmfb", "--compute_dtype=bf16", "--net=rnn", "--version=0.1"],
])
def test_bf16_trainer_builds_a_bf16_net(argv):
    args = tconfig.get_train_args(argv + ["--device=cpu", "--buffer_size=8",
                                          "--evaluate_task=2"], pri=False)
    trainer = Trainer(tconfig.make_env_from_args(args), args)
    layers = [m for m in trainer.net.modules() if hasattr(m, "compute_dtype")]
    assert layers and all(m.compute_dtype is torch.bfloat16 for m in layers)
    assert all(p.dtype == torch.float32 for p in trainer.net.parameters())
    f32 = build_agent_net(tconfig.get_train_args(["dmfb"], pri=False)
                          .update_env_info(trainer.env.env_info()))
    assert all(m.compute_dtype is None for m in f32.modules()
               if hasattr(m, "compute_dtype"))


def test_disable_tf32_turns_off_bf16_reductions():
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    disable_tf32()
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_bf16_and_float32_nets_share_their_state_dict():
    """Mixed precision changes the arithmetic, not the parameters: a bf16
    net loads a float32 net's checkpoint and is initialised alike."""
    a = init_params(CRNNAgent(5, 3, 9, 8), torch.Generator().manual_seed(0))
    b = init_params(CRNNAgent(5, 3, 9, 8, compute_dtype=torch.bfloat16),
                    torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
