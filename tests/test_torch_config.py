"""The port's configuration against the JAX package's: the hyperparameter
dict equals the YAML files it replaces, and the evaluation CLI parses to the
same values (a checkpoint loaded by default, ``--evaluate_epoch``,
``--noise_eps``), builds the v0.1 and bf16 configurations, and raises
without a checkpoint; plus the options the port does not have yet."""

import os

import pytest
import yaml

from marl_dmfb_tpu import config as jconfig
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch.envs import make_env
from marl_dmfb_tpu_torch.trainer import Trainer

YAML_DIR = os.path.join(os.path.dirname(jconfig.__file__), "data", "dmfb")


@pytest.mark.parametrize("drops", [2, 3, 4, 5, 10])
def test_hparams_equal_yaml(drops):
    with open(os.path.join(YAML_DIR, f"{drops}d.yaml")) as f:
        netdata, traindata = yaml.safe_load_all(f.read())
    want_net, want_train = tconfig.DMFB_HPARAMS[drops]
    assert want_net == netdata
    assert want_train == traindata


def test_every_yaml_is_carried():
    files = {int(n[:-6]) for n in os.listdir(YAML_DIR) if n.endswith("d.yaml")}
    assert files == set(tconfig.DMFB_HPARAMS)


@pytest.mark.parametrize("argv", [
    ["dmfb", "--drop_num=4", "--fov=9", "--evaluate_task=100"],
    ["dmfb", "--drop_num=2", "--chip_size=20", "--block_num=2"],
    ["dmfb", "-d", "10", "-w", "30", "-l", "20", "--fov", "7", "--stall"],
    ["dmfb", "--drop_num=2", "--version=0.1", "--compute_dtype=bf16",
     "--evaluate_epoch=3", "--noise_eps=0.3", "--load_model",
     "--load_model_name=0_final"],
])
def test_evaluate_args_match_jax(argv):
    j = jconfig.get_evaluate_args(argv)
    t = tconfig.get_evaluate_args(argv)
    for field in tconfig.Args.__dataclass_fields__:
        if field in ("device", "profile_dir"):   # the port's own
            continue
        assert getattr(t, field) == getattr(j, field), field
    assert {"evaluate_epoch", "noise_eps"} <= set(
        tconfig.Args.__dataclass_fields__)
    assert t.hyper_hidden_dim == 24   # evaluation loads the 4d parameters
    assert t.load_model               # as JAX's: always on for evaluation
    je, te = jconfig.make_env_from_args(j), tconfig.make_env_from_args(t)
    assert je.env_info() == te.env_info()


def test_evaluate_without_a_checkpoint_raises(tmp_path):
    """JAX's evaluation loads a checkpoint, and no flag turns that off: the
    port raises where there is none instead of evaluating random weights."""
    from marl_dmfb_tpu_torch import evaluate

    with pytest.raises(FileNotFoundError, match="0_final_state"):
        evaluate.main(["dmfb", "--evaluate_task=2", "--device=cpu",
                       f"--data_dir={tmp_path}"])


def test_unported_envs_and_modes_raise():
    """MEDA and QMIX are ported (``test_torch_meda_*.py``,
    ``test_torch_qmix.py``); what neither package has still raises: an
    unknown env, a DMFB v0.2 observation, an unknown ``--alg``."""
    with pytest.raises(ValueError, match="unknown env"):
        make_env("pcr")
    with pytest.raises(ValueError):
        make_env("dmfb", version="0.2")
    args = tconfig.get_evaluate_args(["dmfb", "--device=cpu", "--alg=coma"])
    with pytest.raises(ValueError, match="--alg"):
        Trainer(tconfig.make_env_from_args(args), args, eval_only=False)
