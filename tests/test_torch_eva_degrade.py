"""The PyTorch port's degradation sweep (``marl_dmfb_tpu_torch.eva_degrade``)
against the JAX package's ``eva_degrade.py`` on the CPU.

Torch generators cannot replay JAX keys, so ``tools/degrade_replay_jax.py``
records each episode's chips and key in the JAX sweep, and the port
replays them: its reset takes the tasks of JAX's reset of the same chips
(its own wear maps stay its own), and its rollout takes JAX's draws
(``replay_noise``).  Two epochs of two tasks at 10x10 with the
``dmfb_10x10_4d_fov9_vdn`` policy (the JAX package's Orbax checkpoint
there, its committed export here), greedy and with ``--noise_eps=0.3``,
and the DegreData row ``20by20-10d0b`` cut to two epochs of one task:
every action of every episode, the health and usage snapshots, the steps
and the success are equal, the per-epoch mean rewards within
``REWARD_ATOL``."""

import os

import numpy as np
import pytest
import torch

import eva_degrade as jeva
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch import eva_degrade as teva
from tests.torch_port_util import committed_export
from tools import degrade_replay_jax
from tools.degrade_sweeps_torch import ROWS

NAME = "dmfb_10x10_4d_fov9_vdn"
ROW = {r[0]: r for r in ROWS}["20by20-10d0b"]
REWARD_ATOL = 1e-5   # means of sums of 40 float32 team rewards

torch.set_num_threads(1)


@pytest.mark.parametrize("cli, export, epochs, tasks", [
    pytest.param(["dmfb", "--drop_num=4", "--fov=9"], NAME, 2, 2, id="0.0"),
    pytest.param(["dmfb", "--drop_num=4", "--fov=9", "--noise_eps=0.3"],
                 NAME, 2, 2, id="0.3"),
    # the DegreData row 20by20-10d0b's policy and flags (the tile kernel's
    # 16-droplet instantiation on the card), cut to 2 epochs of 1 task
    pytest.param(ROW[2], ROW[1], 2, 1, id=ROW[0]),
])
def test_sweep_matches_jax(tmp_path, cli, export, epochs, tasks):
    got, want, departure = degrade_replay_jax.replay(cli, export, epochs,
                                                     tasks, str(tmp_path))
    assert departure is None, departure
    for k in ("steps", "success", "health", "usage"):
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=0,
                               atol=REWARD_ATOL)
    # the wear moved: usage grew in the second epoch's snapshot
    assert (got["usage"][:, 1] >= got["usage"][:, 0]).all()
    assert got["usage"][:, 1].sum() > 0


@pytest.mark.parametrize("argv", [
    ["dmfb"],
    ["dmfb", "--chip_size=50", "--drop_num=4", "--noise_eps=0.3"],
    ["dmfb", "-w", "30", "-l", "20", "--block_num=2", "--noise_eps=0.05",
     "--data_dir=out"],
])
def test_degre_dir_matches_jax(argv):
    assert teva.degre_dir(tconfig.get_evaluate_args(argv)) == \
        jeva.degre_dir(jeva.get_evaluate_args(argv))


def test_main_saves_the_sweep_on_cpu(tmp_path):
    """The CLI on the CPU with the committed export: five arrays of the JAX
    package's shapes and dtypes under ``degre_dir``; health never rises and
    usage never falls between the snapshots of a chip."""
    run = tmp_path / "model" / "vdn" / "fov9"
    run.mkdir(parents=True)
    os.symlink(committed_export(NAME), run / "0_final_state.npz")
    out = teva.main(["dmfb", "--drop_num=4", "--fov=9", "--chip_size=20",
                     "--evaluate_task=2", "--evaluate_epoch=3",
                     "--device=cpu", f"--data_dir={tmp_path}"])
    assert out["path"] == str(tmp_path / "DegreData" / "20by20-4d0b")
    for k, shape in (("rewards", (5, 3)), ("steps", (5, 3)),
                     ("success", (5, 3)), ("health", (5, 3, 20, 20)),
                     ("usage", (5, 3, 20, 20))):
        arr = np.load(os.path.join(out["path"], f"{k}.npy"))
        assert arr.shape == shape and arr.dtype == np.float64, k
    h = out["health"]
    assert (np.diff(h, axis=1) <= 0).all() and (h <= 1).all()


def test_eva_degrade_raises_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teva.main(["dmfb", "--evaluate_task=1", "--evaluate_epoch=1"])

