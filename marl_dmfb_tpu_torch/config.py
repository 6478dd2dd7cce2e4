"""Configuration for the PyTorch port: CLI args + per-droplet-count
hyperparameters.

Ported from ``marl_dmfb_tpu/config.py`` (the evaluation half).  The DMFB
hyperparameter YAMLs (``marl_dmfb_tpu/data/dmfb/{2,3,4,5,10}d.yaml``) are
carried as the dict literal :data:`DMFB_HPARAMS`, so nothing parses YAML at
run time; a CPU test holds the dict equal to the YAML files.

Deviations from the JAX CLI, all of them for this slice's scope:

* ``--device`` (default ``cuda``) picks the torch device; the entry point
  raises when CUDA is asked for and absent.
* ``--load_model`` defaults to False and, like ``--show``/``--show_save``,
  raises ``NotImplementedError``: the port has no checkpoint format yet.
* The TPU-only flags (``--mesh``, ``--n_parallel_envs``,
  ``--compute_dtype``) and the degradation-sweep flags
  (``--evaluate_epoch``, ``--noise_eps``) are not parsed.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

# One entry per TrainParas YAML: (network section, training section), in the
# files' order (``netdata, traindata = yaml.safe_load_all(...)``).
DMFB_HPARAMS = {
    2: (
        dict(rnn_hidden_dim=128, qmix_hidden_dim=32, two_hyper_layers=True,
             hyper_hidden_dim=32, lr=5.0e-4),
        dict(n_episodes=5, epsilon=1, min_epsilon=0.05, anneal_steps=50000,
             epsilon_anneal_scale="step", train_time=1, batch_size=128,
             buffer_size=5000, target_update_cycle=200, grad_norm_clip=10),
    ),
    3: (
        dict(rnn_hidden_dim=128, qmix_hidden_dim=32, two_hyper_layers=True,
             hyper_hidden_dim=32, lr=5.0e-4),
        dict(n_episodes=2, epsilon=1, min_epsilon=0.05, anneal_steps=100000,
             epsilon_anneal_scale="step", train_time=1, batch_size=128,
             buffer_size=5000, target_update_cycle=200, grad_norm_clip=9),
    ),
    4: (
        dict(rnn_hidden_dim=128, qmix_hidden_dim=32, two_hyper_layers=True,
             hyper_hidden_dim=24, lr=5.0e-4),
        dict(n_episodes=2, epsilon=1, min_epsilon=0.05, anneal_steps=150000,
             epsilon_anneal_scale="step", train_time=1, batch_size=128,
             buffer_size=5000, target_update_cycle=200, grad_norm_clip=9),
    ),
    5: (
        dict(rnn_hidden_dim=128, qmix_hidden_dim=32, two_hyper_layers=True,
             hyper_hidden_dim=32, lr=5.0e-4),
        dict(n_episodes=2, epsilon=1, min_epsilon=0.05, anneal_steps=150000,
             epsilon_anneal_scale="step", train_time=1, batch_size=128,
             buffer_size=5000, target_update_cycle=200, grad_norm_clip=9),
    ),
    10: (
        dict(rnn_hidden_dim=128, qmix_hidden_dim=32, two_hyper_layers=True,
             hyper_hidden_dim=32, lr=5.0e-4),
        dict(n_episodes=2, epsilon=1, min_epsilon=0.05, anneal_steps=50000,
             epsilon_anneal_scale="step", train_time=1, batch_size=256,
             buffer_size=10000, target_update_cycle=200, grad_norm_clip=9),
    ),
}


@dataclasses.dataclass
class Args:
    # --- environment selection (JAX config.py:28-48) ---
    name: str = "dmfb"
    seed: int = 12
    alg: str = "vdn"
    last_action: bool = True
    evaluate_task: int = 100
    load_model: bool = False
    load_model_name: str = ""
    stall: bool = True
    drop_num: int = 4
    block_num: int = 0
    net: str = "crnn"
    fov: Optional[int] = None
    width: Optional[int] = None
    length: Optional[int] = None
    version: Optional[str] = None

    # --- evaluation flags ---
    show: bool = False
    show_save: bool = False
    b_degrade: bool = False
    per_degrade: float = 0.1

    # --- hyperparameters (DMFB_HPARAMS network section) ---
    rnn_hidden_dim: int = 128
    qmix_hidden_dim: int = 32
    two_hyper_layers: bool = True
    hyper_hidden_dim: int = 32
    lr: float = 5e-4

    # --- hyperparameters (DMFB_HPARAMS training section) ---
    n_episodes: int = 2
    epsilon: float = 1.0
    min_epsilon: float = 0.05
    anneal_steps: int = 150000
    epsilon_anneal_scale: str = "step"
    train_time: int = 1
    batch_size: int = 128
    buffer_size: int = 5000
    target_update_cycle: int = 200
    grad_norm_clip: float = 9.0

    # --- env-derived (filled from env.env_info()) ---
    n_actions: int = 0
    n_agents: int = 0
    obs_shape: Tuple[int, ...] = ()
    state_shape: int = 0
    episode_limit: int = 0

    # --- port additions ---
    device: str = "cuda"

    def apply_env_defaults(self):
        """set_default (JAX config.py:111-137, DMFB part)."""
        if self.name != "dmfb":
            raise NotImplementedError(
                f"env {self.name!r} is not ported yet; see ROADMAP.md")
        if self.fov is None:
            self.fov = 9
        if self.width is None:
            self.width = 10
            self.length = 10
        elif self.length is None:
            self.length = self.width
        return self

    def load_hparams(self, drop_num: Optional[int] = None):
        """Merge the TrainParas hyperparameters (JAX ``load_yaml``)."""
        d = self.drop_num if drop_num is None else drop_num
        if d not in DMFB_HPARAMS:
            raise FileNotFoundError(
                f"no DMFB hyperparameters for {d} droplets "
                f"(have {sorted(DMFB_HPARAMS)})")
        netdata, traindata = DMFB_HPARAMS[d]
        for k, v in {**netdata, **traindata}.items():
            setattr(self, k, v)
        return self

    def update_env_info(self, info: dict):
        for k, v in info.items():
            setattr(self, k, v)
        return self


def _evaluate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("name", default="dmfb", choices=["dmfb", "meda"])
    p.add_argument("--seed", type=int, default=12)
    p.add_argument("--alg", type=str, default="vdn")
    p.add_argument("--last_action", default=True, action="store_false")
    p.add_argument("--evaluate_task", type=int, default=100)
    p.add_argument("--load_model", default=False, action="store_true")
    p.add_argument("--load_model_name", type=str, default="")
    p.add_argument("--stall", default=True, action="store_false")
    p.add_argument("--drop_num", "-d", type=int, default=4)
    p.add_argument("--block_num", type=int, default=0)
    p.add_argument("--net", type=str, default="crnn")
    p.add_argument("--fov", type=int, default=None)
    p.add_argument("--width", "-w", "--chip_size", type=int, default=None)
    p.add_argument("--length", "-l", type=int, default=None)
    p.add_argument("--version", "-v", type=str, default=None)
    p.add_argument("--show", default=False, action="store_true")
    p.add_argument("--show_save", default=False, action="store_true")
    p.add_argument("--b-degrade", dest="b_degrade", default=True)
    p.add_argument("--per-degrade", dest="per_degrade", type=float, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p


def get_evaluate_args(argv=None) -> Args:
    ns = _evaluate_parser().parse_args(argv)
    args = Args(**vars(ns))
    args.apply_env_defaults()
    # quirk parity: evaluation always loads the 4-droplet hyperparameters
    # (JAX config.py:294-296), so the CRNN has 24 conv channels.
    args.load_hparams(drop_num=4)
    return args


def make_env_from_args(args: Args):
    """Construct the env from parsed args (JAX config.py:300-317)."""
    from marl_dmfb_tpu_torch.envs import make_env

    return make_env(
        args.name,
        version=args.version,
        width=args.width,
        length=args.length,
        n_droplets=args.drop_num,
        n_blocks=args.block_num,
        fov=args.fov,
        stall=args.stall,
        b_degrade=bool(args.b_degrade),
        per_degrade=args.per_degrade,
    )
