"""``--fused_streams`` in the PyTorch port's learner: the eval and target
streams in one unroll over the two nets' parameters stacked
(``algos/qlearn.py:TDLoss.unroll_pair``, JAX ``qlearn.py:184-215``), on the
CPU, against JAX's learner with ``fused_streams=True`` and against the
port's two separate unrolls, with ``--remat`` too, for VDN and QMIX.

Tolerances: ``tests/torch_learn_util``'s (loss rtol 1e-6, gradients atol
1e-6 times their global norm, parameters 1e-5 outside float-noise
gradients).  The fused call runs the GRU cell in its stacked form, whose
float32 sums are not bitwise those of torch's fused cell."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch.config import make_env_from_args
from marl_dmfb_tpu_torch.trainer import Trainer
from tests.torch_learn_util import (GRAD_ATOL, LOSS_RTOL, QMIX, batch_for,
                                    check_updates, jax_learner, port_learner)

FUSED = (("fused_streams", True),)


@pytest.mark.parametrize("items", [
    FUSED, FUSED + (("remat", True),), QMIX + FUSED],
    ids=["vdn", "remat", "qmix"])
def test_fused_updates_match_jax(items):
    """Three updates of the fused learner against JAX's fused learner."""
    check_updates(items, n=3)


@pytest.mark.parametrize("items", [(), QMIX], ids=["vdn", "qmix"])
def test_fused_equals_two_unrolls(items):
    J = jax_learner(items)
    state = J.init(jax.random.PRNGKey(3))
    plain = port_learner(J.ta, state)
    fused = port_learner(dataclasses.replace(J.ta, fused_streams=True),
                         state)
    for seed in range(2):
        batch = {k: torch.from_numpy(v) for k, v in
                 batch_for(J.ta, np.random.RandomState(seed)).items()}
        l0, g0 = plain.loss_and_grads(batch)
        l1, g1 = fused.loss_and_grads(batch)
        np.testing.assert_allclose(float(l1.detach()), float(l0.detach()),
                                   rtol=LOSS_RTOL)
        norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in g0.values())))
        assert g0.keys() == g1.keys()
        for k in g0:
            np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=0,
                                       atol=GRAD_ATOL * norm, err_msg=k)
        plain.update(batch)
        fused.update(batch)


def test_fused_streams_parse_as_jax_and_train(tmp_path):
    from marl_dmfb_tpu import config as jconfig

    argv = ["dmfb", "--drop_num=2", "--fov=5", "--chip_size=5",
            "--fused_streams"]
    t = tconfig.get_train_args(argv, pri=False)
    assert t.fused_streams is True
    assert jconfig.get_train_args(argv, pri=False).fused_streams is True
    t.device, t.data_dir = "cpu", str(tmp_path)
    t.buffer_size, t.batch_size, t.evaluate_task = 8, 4, 2
    trainer = Trainer(make_env_from_args(t), t)
    for _ in range(2):
        trainer.train_cycle()
    assert trainer.learner.loss_module._pair is not None
    assert all(np.isfinite(float(x)) for x in trainer.losses)
