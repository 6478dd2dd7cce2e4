"""The port's train CLI (``python -m marl_dmfb_tpu_torch.train``): its
arguments parse to the JAX package's ``get_train_args`` values; it runs on
the card by default and raises where there is none; the flags it does not
port raise; and on the CPU it trains, checkpoints, resumes, and hands its
checkpoint to ``evaluate --load_model``."""

import os

import numpy as np
import pytest
import torch

from marl_dmfb_tpu import config as jconfig
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch import evaluate, train
from marl_dmfb_tpu_torch.config import make_env_from_args
from marl_dmfb_tpu_torch.trainer import Trainer

torch.set_num_threads(1)


@pytest.mark.parametrize("argv", [
    ["dmfb", "--drop_num=4", "--fov=9"],
    ["dmfb", "-d", "2", "--chip_size=20", "--exact_steps=1000",
     "--buffer_size=64", "--batch_size=16", "--lr_decay",
     "--param_ema=0.99", "--ckpt_replay", "--n_parallel_envs=64",
     "--optimizer=RMS", "--gamma=0.9", "--evaluate_cycle=500",
     "--online_eval", "--ith_run=2", "--scan_unroll=4", "--mesh=off",
     "--vmap_seeds=1"],
    ["dmfb", "-d", "10", "-w", "30", "--n_steps=3", "--data_dir=out",
     "--model_dir=./m", "--result_dir=./r", "--last_action", "--stall",
     "--reuse_network", "--load_model", "--load_model_name=0_final",
     "--seed=5", "--block_num=2", "--alg=vdn", "--net=rnn"],
], ids=["main", "options", "sizes"])
def test_train_args_match_jax(argv):
    j = jconfig.get_train_args(argv, pri=False)
    t = tconfig.get_train_args(argv, pri=False)
    for field in tconfig.Args.__dataclass_fields__:
        if field in ("device", "profile_dir"):   # the port's own
            continue
        assert getattr(t, field) == getattr(j, field), field
    assert t.total_env_steps == j.total_env_steps
    assert t.rollout_batch == j.rollout_batch


def test_train_defaults_to_cuda_and_raises_without_it(tmp_path):
    assert tconfig.get_train_args(["dmfb"], pri=False).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["dmfb", "--exact_steps=40", f"--data_dir={tmp_path}"])


@pytest.mark.parametrize("flag", [
    "--mesh=4", "--local_sampling", "--vmap_seeds=2", "--fused_streams"])
def test_unported_train_flags_raise(flag, tmp_path):
    """Every flag that was refused is ported: each parses to the JAX
    CLI's value, and ``--fused_streams`` trains
    (``tests/test_torch_mesh*.py`` train under ``--mesh`` and
    ``--local_sampling``, ``tests/test_torch_fused_streams.py`` holds the
    fused learner to JAX's).  The seed farm on a device mesh still exits,
    as JAX train.py:39-48 does."""
    argv = ["dmfb", flag]
    t = tconfig.get_train_args(argv, pri=False)
    j = jconfig.get_train_args(argv, pri=False)
    for field in ("mesh", "local_sampling", "vmap_seeds", "fused_streams"):
        assert getattr(t, field) == getattr(j, field), field
    if flag == "--vmap_seeds=2":
        assert t.vmap_seeds == 2
        with pytest.raises(SystemExit, match="--mesh=off"):
            tconfig.get_train_args(["dmfb", flag, "--mesh=4"], pri=False)
    elif flag == "--fused_streams":
        trainer = train.main([
            "dmfb", "--drop_num=2", "--fov=5", "--chip_size=5", flag,
            "--exact_steps=40", "--n_parallel_envs=2", "--buffer_size=8",
            "--batch_size=4", "--evaluate_task=2", "--device=cpu",
            f"--data_dir={tmp_path}"])
        assert trainer.args.fused_streams and trainer.learner.train_step
        assert all(np.isfinite(float(x)) for x in trainer.losses)


@pytest.mark.parametrize("name", ["dmfb", "meda"])
def test_remat_parses_as_jax_and_reaches_the_learner(name):
    """``--remat`` is ported (``tests/test_torch_meda_train.py`` holds its
    loss and gradients to the run without it)."""
    argv = [name, "--remat"]
    t = tconfig.get_train_args(argv, pri=False)
    assert t.remat is True is jconfig.get_train_args(argv, pri=False).remat
    t.device, t.buffer_size, t.evaluate_task = "cpu", 4, 2
    trainer = Trainer(make_env_from_args(t), t)
    assert trainer.learner.args.remat


def test_compute_dtype_bf16_is_ported():
    """``--compute_dtype=bf16`` parses as JAX's does and builds a trainer
    whose net multiplies in bf16 (``tests/test_torch_bf16.py`` holds its
    numbers to JAX's)."""
    argv = ["dmfb", "--compute_dtype=bf16"]
    t = tconfig.get_train_args(argv, pri=False)
    assert t.compute_dtype == jconfig.get_train_args(
        argv, pri=False).compute_dtype == "bf16"
    t.device, t.buffer_size, t.evaluate_task = "cpu", 4, 2
    trainer = Trainer(make_env_from_args(t), t)
    assert trainer.net.gru.compute_dtype is torch.bfloat16


def test_train_cli_runs_resumes_and_evaluates_on_cpu(tmp_path):
    """The main configuration at full width (24 conv channels, GRU 128),
    with a small replay and minibatch so that the CPU is quick."""
    common = ["dmfb", "--drop_num=4", "--fov=9", "--device", "cpu",
              "--evaluate_task=4", f"--data_dir={tmp_path}"]
    t1 = train.main(common + ["--exact_steps=80", "--buffer_size=16",
                              "--batch_size=8"])
    assert t1.args.hyper_hidden_dim == 24 and t1.args.rnn_hidden_dim == 128
    model = tmp_path / "model" / "vdn" / "fov9"
    assert (model / "0_final_state.pt").is_file()
    assert (model / "0_0_state.pt").is_file()
    curves = tmp_path / "TrainResult" / "vdn" / "fov9" / "10by10-4d0b"
    assert len(os.listdir(curves)) == 5
    steps = t1.learner.train_step
    assert steps == t1.n_cycles >= 1      # 2 chips a rollout, 1 update

    # resume from the final checkpoint: the update count carries on
    t2 = train.main(common + ["--exact_steps=40", "--buffer_size=16",
                              "--batch_size=8", "--load_model"])
    assert t2.learner.train_step == steps + t2.n_cycles

    # evaluate reads the final checkpoint (now the resumed run's) with the
    # net hyperparameters it holds, bitwise
    m = evaluate.main(common + ["--load_model", "--load_model_name=0_final"])
    assert 0 < m["steps"] <= 40
    args = tconfig.get_evaluate_args(common + ["--load_model"])
    ref = Trainer(make_env_from_args(args), args, eval_only=True)
    ref.load_model("final", params_only=True)
    for k, p in ref.net.named_parameters():
        assert torch.equal(p, dict(t2.net.named_parameters())[k]), k
    assert ref.evaluate() == m
