"""Configuration for the PyTorch port: CLI args + per-droplet-count
hyperparameters.

Ported from ``marl_dmfb_tpu/config.py``.  The hyperparameter YAMLs
(``marl_dmfb_tpu/data/dmfb/{2,3,4,5,10}d.yaml`` and
``marl_dmfb_tpu/data/meda/{2,3,4,10}d.yaml``) are carried as the dict
literals :data:`DMFB_HPARAMS` and :data:`MEDA_HPARAMS`, so nothing parses
YAML at run time; a CPU test holds the dicts equal to the YAML files.

Deviations from the JAX CLI:

* ``--device`` (default ``cuda``) picks the torch device; the entry points
  raise when CUDA is asked for and absent.
* evaluation loads a checkpoint, as the JAX CLI does (``--load_model`` is
  on by default and no flag turns it off): the port's own ``.pt``, or a
  JAX checkpoint exported to ``.npz`` by ``tools/export_flax_npz.py``
  (``checkpoint.py``).
* ``--mesh <n>`` runs n processes, one per device, in a
  ``torch.distributed`` group (``train.py`` starts them, or a launcher
  such as ``torchrun`` did), and ``--mesh auto`` (the default) one a card
  where several cards are visible, as JAX's shards over every device;
  the seed farm on a mesh exits as JAX's does
  (:func:`refuse_unported`); ``--scan_unroll`` is accepted and ignored.
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

MEDA_HPARAMS = {
    2: (
        dict(rnn_hidden_dim=128, qmix_hidden_dim=32, two_hyper_layers=True,
             hyper_hidden_dim=32, lr=5.0e-4),
        dict(n_episodes=2, epsilon=1, min_epsilon=0.05, anneal_steps=100000,
             epsilon_anneal_scale="step", train_time=1, batch_size=64,
             buffer_size=10000, target_update_cycle=200, grad_norm_clip=10),
    ),
    3: (
        dict(rnn_hidden_dim=128, qmix_hidden_dim=32, two_hyper_layers=True,
             hyper_hidden_dim=32, lr=5.0e-4),
        dict(n_episodes=2, epsilon=1, min_epsilon=0.05, anneal_steps=300000,
             epsilon_anneal_scale="step", train_time=2, batch_size=64,
             buffer_size=10000, target_update_cycle=200, grad_norm_clip=10),
    ),
    4: (
        dict(rnn_hidden_dim=128, qmix_hidden_dim=32, two_hyper_layers=True,
             hyper_hidden_dim=32, lr=5.0e-4),
        dict(n_episodes=10, epsilon=1, min_epsilon=0.05, anneal_steps=300000,
             epsilon_anneal_scale="step", train_time=2, batch_size=64,
             buffer_size=10000, target_update_cycle=200, grad_norm_clip=10),
    ),
    10: (
        dict(rnn_hidden_dim=128, qmix_hidden_dim=32, two_hyper_layers=True,
             hyper_hidden_dim=32, lr=5.0e-4),
        dict(n_episodes=2, epsilon=1, min_epsilon=0.01, anneal_steps=300000,
             epsilon_anneal_scale="step", train_time=2, batch_size=128,
             buffer_size=10000, target_update_cycle=200, grad_norm_clip=8),
    ),
}
HPARAMS = {"dmfb": DMFB_HPARAMS, "meda": MEDA_HPARAMS}


@dataclasses.dataclass
class Args:
    # --- environment selection (JAX config.py:28-48) ---
    name: str = "dmfb"
    seed: int = 12
    alg: str = "vdn"
    last_action: bool = True
    reuse_network: bool = True
    gamma: float = 0.99
    optimizer: str = "ADAM"
    evaluate_task: int = 100
    model_dir: str = "./model"
    result_dir: str = "./TrainResult"
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

    # --- training flags (JAX config.py:50-55) ---
    n_steps: int = 20             # x100000 total env steps
    ith_run: int = 0
    replay_dir: str = ""
    evaluate_cycle: int = 100000
    online_eval: bool = True

    # --- evaluation flags ---
    show: bool = False
    show_save: bool = False
    b_degrade: bool = False
    per_degrade: float = 0.1
    evaluate_epoch: int = 20
    noise_eps: float = 0.0        # evaluation-time epsilon (eva_degrade)

    # --- hyperparameters (HPARAMS network section) ---
    rnn_hidden_dim: int = 128
    qmix_hidden_dim: int = 32
    two_hyper_layers: bool = True
    hyper_hidden_dim: int = 32
    lr: float = 5e-4

    # --- hyperparameters (HPARAMS training section) ---
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

    # --- the JAX package's additions (JAX config.py:85-103) ---
    n_parallel_envs: int = 0      # 0 -> n_episodes
    data_dir: str = ""            # output root; default data-<env>
    mesh: str = "auto"
    compute_dtype: str = "float32"
    lr_decay: bool = False
    local_sampling: bool = False
    remat: bool = False
    fused_streams: bool = False
    scan_unroll: int = 0          # no meaning in eager torch; ignored
    vmap_seeds: int = 0
    ckpt_replay: bool = False
    param_ema: float = 0.0

    # --- port additions ---
    device: str = "cuda"
    profile_dir: str = ""         # train: profile a cycle into this dir

    def apply_env_defaults(self):
        """set_default (JAX config.py:111-137): DMFB 10x10, fov 9; MEDA
        v0.2, fov 19, 30x60 (80x80 at 10 droplets)."""
        if self.name == "dmfb":
            if self.fov is None:
                self.fov = 9
            if self.width is None:
                self.width = self.length = 10
            elif self.length is None:
                self.length = self.width
        elif self.name == "meda":
            if self.version is None:
                self.version = "0.2"
            if self.fov is None:
                self.fov = 19
            if self.width is None:
                self.width, self.length = ((80, 80) if self.drop_num == 10
                                           else (30, 60))
            elif self.length is None:
                self.length = self.width
        else:
            raise ValueError(f"unknown env name: {self.name!r}")
        if not self.data_dir:
            self.data_dir = f"data-{self.name}"
        return self

    def load_hparams(self, drop_num: Optional[int] = None):
        """Merge the TrainParas hyperparameters (JAX ``load_yaml``)."""
        d = self.drop_num if drop_num is None else drop_num
        table = HPARAMS[self.name]
        if d not in table:
            raise FileNotFoundError(
                f"no {self.name.upper()} hyperparameters for {d} droplets "
                f"(have {sorted(table)})")
        netdata, traindata = table[d]
        for k, v in {**netdata, **traindata}.items():
            setattr(self, k, v)
        return self

    def update_env_info(self, info: dict):
        for k, v in info.items():
            setattr(self, k, v)
        return self

    @property
    def total_env_steps(self) -> int:
        return self.n_steps  # already scaled by get_train_args

    @property
    def rollout_batch(self) -> int:
        return (self.n_parallel_envs if self.n_parallel_envs > 0
                else self.n_episodes)


def _common_parser() -> argparse.ArgumentParser:
    """JAX ``_common_parser`` (config.py:163-197), plus ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("name", default="dmfb", choices=["dmfb", "meda"])
    p.add_argument("--seed", type=int, default=12)
    p.add_argument("--alg", type=str, default="vdn")
    p.add_argument("--last_action", default=True, action="store_false")
    p.add_argument("--reuse_network", default=True, action="store_false")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--optimizer", type=str, default="ADAM")
    p.add_argument("--evaluate_task", type=int, default=100)
    p.add_argument("--model_dir", type=str, default="./model")
    p.add_argument("--result_dir", type=str, default="./TrainResult")
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
    p.add_argument("--n_parallel_envs", type=int, default=0,
                   help="chips simulated in lockstep per rollout "
                        "(0 = n_episodes)")
    p.add_argument("--data_dir", type=str, default="",
                   help="output root (default data-<env>/)")
    p.add_argument("--mesh", type=str, default="auto",
                   help="data-parallel devices: a count n (one process "
                        "per device, the env batch and the replay ring "
                        "split by rows, parameters replicated), 'auto' "
                        "(the launcher's process group, if any; else one "
                        "rank a card where several cards are visible, as "
                        "JAX shards over every device) or 'off' (one "
                        "device)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bf16"],
                   help="net matmul/conv precision: bf16 rounds their "
                        "operands to bfloat16 (float32 params and sums)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p


def refuse_unported(args: Args) -> Args:
    """Exit for the flags that do not go together, as the JAX CLI does: the
    seed farm runs on one device (JAX train.py:39-48)."""
    if (args.vmap_seeds > 1 and args.mesh not in ("auto", "off")
            and int(args.mesh) > 1):
        raise SystemExit("--vmap_seeds runs on one device; use --mesh=off")
    return args


def get_train_args(argv=None, pri: bool = True) -> Args:
    """JAX ``get_train_args`` (config.py:200-274)."""
    p = _common_parser()
    p.add_argument("--n_steps", type=int, default=20,
                   help="total env steps for training x100000")
    p.add_argument("--exact_steps", type=int, default=0,
                   help="exact env-step budget (bypasses x100000)")
    p.add_argument("--ith_run", "-i", type=int, default=0)
    p.add_argument("--replay_dir", type=str, default="")
    p.add_argument("--evaluate_cycle", type=int, default=100000)
    p.add_argument("--online_eval", default=True, action="store_false")
    p.add_argument("--lr_decay", default=False, action="store_true",
                   help="cosine lr decay to 5%% over training")
    p.add_argument("--local_sampling", default=False, action="store_true",
                   help="under --mesh, each device keeps its own episodes "
                        "in a ring of its own and samples its share of the "
                        "minibatch from it: no episode crosses devices")
    p.add_argument("--vmap_seeds", type=int, default=0,
                   help="train K independent seeds (seed, seed + 1, ...) "
                        "in lockstep as one program (the seed farm)")
    p.add_argument("--ckpt_replay", default=False, action="store_true",
                   help="checkpoints also hold the replay ring and the "
                        "training chips, for a resume identical to an "
                        "uninterrupted run")
    p.add_argument("--remat", default=False, action="store_true",
                   help="recompute each BPTT step's activations in the "
                        "backward pass (torch.utils.checkpoint): less "
                        "memory, the same loss and gradients")
    p.add_argument("--fused_streams", default=False, action="store_true",
                   help="one unroll for the eval and target streams, over "
                        "the two nets' parameters stacked")
    # eager torch has no scan to unroll: parsed for the JAX CLI's sake and
    # ignored
    p.add_argument("--scan_unroll", type=int, default=0)
    p.add_argument("--param_ema", type=float, default=0.0,
                   help="per-update EMA decay of the evaluated and saved "
                        "params (0 = off)")
    p.add_argument("--buffer_size", type=int, default=None,
                   help="override the replay capacity (episodes)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="override the learner minibatch (episodes)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="run the first cycle after step 0 under "
                        "torch.profiler and write its Chrome trace "
                        "(trace.json) and the port's spans (spans.json) "
                        "into this directory")
    d = vars(p.parse_args(argv))
    exact_steps = d.pop("exact_steps")
    overrides = {k: v for k in ("buffer_size", "batch_size")
                 if (v := d.pop(k)) is not None}
    args = Args(**d)
    args.apply_env_defaults()
    args.load_hparams()
    for k, v in overrides.items():   # the CLI beats the YAML
        setattr(args, k, v)
    args.n_steps = exact_steps or args.n_steps * 100000
    refuse_unported(args)
    if pri:
        print("drop number:", args.drop_num)
        print("chip size:", args.width, "*", args.length)
        print("FOV size:", args.fov)
    return args


def get_evaluate_args(argv=None) -> Args:
    p = _common_parser()
    p.add_argument("--show", default=False, action="store_true")
    p.add_argument("--show_save", default=False, action="store_true")
    p.add_argument("--b-degrade", dest="b_degrade", default=True)
    p.add_argument("--per-degrade", dest="per_degrade", type=float, default=0)
    p.add_argument("--evaluate_epoch", type=int, default=20)
    p.add_argument("--noise_eps", type=float, default=0.0,
                   help="epsilon-greedy noise during evaluation (0 = "
                        "greedy); the degradation sweep's control runs")
    p.set_defaults(load_model=True)
    args = Args(**vars(p.parse_args(argv)))
    args.apply_env_defaults()
    # quirk parity: evaluation always loads the 4-droplet hyperparameters
    # (JAX config.py:294-296), for MEDA too, so the DMFB CRNN has 24 conv
    # channels and the MEDA one 32; a loaded checkpoint's net_config
    # overrides them
    args.load_hparams(drop_num=4)
    return refuse_unported(args)


def make_env_from_args(args: Args):
    """Construct the env from parsed args (JAX config.py:300-317)."""
    from marl_dmfb_tpu_torch.envs import make_env

    common = dict(width=args.width, length=args.length,
                  n_droplets=args.drop_num, fov=args.fov, stall=args.stall,
                  b_degrade=bool(args.b_degrade),
                  per_degrade=args.per_degrade)
    if args.name == "dmfb":
        return make_env("dmfb", version=args.version,
                        n_blocks=args.block_num, **common)
    return make_env("meda", version=args.version, **common)
