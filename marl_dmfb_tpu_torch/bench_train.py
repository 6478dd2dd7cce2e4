"""Training-loop throughput (JAX ``bench_train.py``): rollout, replay store
and the learner's updates, end to end, on DMFB 10x10, 4 droplets, fov 9 at
the CLI's widths.  Prints one JSON line per metric:

* ``learn_step_ms``: one ``QLearner`` update (batch 128, T = 40), over 100
  updates chained on one sampled minibatch;
* ``learn_step_tflops``: :func:`estimate_learn_flops` over that time, with
  ``vs_baseline`` its share of :data:`PEAK_F32_FLOPS`;
* ``train_loop_env_steps_per_sec``: B * T over the seconds of a cycle
  (rollout of B chips, store, ``max(1, round(train_time * B /
  n_episodes))`` updates: the reference's updates per collected episode),
  over 3 cycles;
* ``train_e2e``: the same rate, with the replay ratio and the update's ms
  in its unit;
* ``time_to_quality_recorded`` (last, measured by no part of this run):
  the wall seconds to the first checkpoint of at least 0.96 success on the
  50x50 zero-shot board, of the port's own training of the flagship recipe
  from scratch on the card, read from
  ``marl_dmfb_tpu_torch/artifacts/time_to_quality.json`` (written by
  ``tools/time_to_quality_torch.py``); nothing where that file is missing
  or records no crossing.

Usage::

    python -m marl_dmfb_tpu_torch.bench_train [B] [dtype] [--device cuda|cpu]

B defaults to 1024 and dtype to ``float32`` (or ``bf16``).  JAX's
``vs_baseline`` of the rates divides by a north star set for a TPU host,
and its TFLOP/s by a TPU's peak; here the rates' is null.
"""

from __future__ import annotations

import argparse
import json
import os

from marl_dmfb_tpu_torch import replay as replay_lib
from marl_dmfb_tpu_torch.algos.qlearn import QLearner
from marl_dmfb_tpu_torch.bench import EXPLORE, actor
from marl_dmfb_tpu_torch.config import Args
from marl_dmfb_tpu_torch.models.networks import conv_out_size, conv_plan
from marl_dmfb_tpu_torch.trainer import updates_per_rollout
from marl_dmfb_tpu_torch.utils.benchmarking import hostread, timeit_chained
from marl_dmfb_tpu_torch.utils.platform import select_device

LEARN_ITERS = 100
CYCLES = 3
# An H100 SXM's dense float32 rate outside the tensor cores, in FLOP/s
# (chip_smoke.py's PEAK_SCALAR_OPS_PER_S).  TF32 is off in the learner
# (utils/platform.disable_tf32), and bf16 rounds the operands and multiplies
# in float32 (networks._round), so this peak holds for both dtypes.
PEAK_F32_FLOPS = 67e12
TIME_TO_QUALITY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "artifacts", "time_to_quality.json")


def estimate_learn_flops(args) -> float:
    """Analytic FLOPs of one TD update (JAX ``bench_train.py:25-54``):
    multiply-adds of the convs and matmuls only, 2 FLOPs each, of one
    forward of a sample-step, times 4 (the eval stream's forward and
    backward, ~3x, and the target stream's forward), times batch x agents
    x T samples."""
    fov, C = args.fov, args.obs_shape[0]
    ch = args.hyper_hidden_dim
    H = args.rnn_hidden_dim
    A = args.n_actions
    in_dim = args.obs_shape[-1] + (A if args.last_action else 0)

    f = 0.0
    size, cin = fov, C
    for s in conv_plan(fov):
        size = (size - 3) // s + 1
        f += size * size * ch * cin * 9 * 2
        cin = ch
    flat = conv_out_size(fov) ** 2 * ch
    f += (in_dim - C * fov * fov) * 10 * 2          # the vector MLP
    gru_in = flat + 10
    f += (gru_in * 3 * H + H * 3 * H) * 2           # the GRU's matmuls
    f += H * A * 2                                  # the Q head
    samples = args.batch_size * args.n_agents * args.episode_limit
    return 4.0 * f * samples


def time_to_quality_line(path: str = TIME_TO_QUALITY):
    """JAX's ``time_to_quality_recorded`` line from the port's artifact at
    ``path``: the default seed's first crossing, in wall seconds of its
    training; None where there is no artifact or no crossing."""
    try:
        with open(path) as f:
            ttq = json.load(f)
        first, card = ttq["first_crossing"], ttq["card"]
        return {
            "metric": "time_to_quality_recorded",
            "value": first["wall_s"],
            "unit": (f"s wall-clock to >=0.96 on 50x50 zero-shot "
                     f"({first['env_steps']} env steps, flagship 20x20 "
                     f"recipe, {card})"),
            "source": os.path.relpath(path, os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            "vs_baseline": None,
        }
    except (OSError, KeyError, TypeError, ValueError):
        return None


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", type=int, nargs="?", default=1024)
    p.add_argument("dtype", nargs="?", default="float32",
                   choices=["float32", "bf16"])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def make_args(B: int, dtype: str, device: str) -> Args:
    """JAX ``bench_train.py``'s configuration."""
    args = Args(name="dmfb", drop_num=4, fov=9, width=10, length=10,
                n_parallel_envs=B, compute_dtype=dtype, device=device)
    args.apply_env_defaults()
    return args.load_hparams()


def main(argv=None, learn_iters: int = LEARN_ITERS, cycles: int = CYCLES,
         cycle_warmup: int = 1) -> list:
    """Run the benchmark; print and return its lines.  After one cycle
    that fills the ring, ``learn_iters`` updates and then ``cycles`` cycles
    are timed, after ``cycle_warmup`` untimed ones."""
    a = parse(argv)
    select_device(a.device)
    args = make_args(a.B, a.dtype, a.device)
    env, net, rollout, states, g = actor(args)
    learner = QLearner(args, net)
    ring = replay_lib.init_replay(
        args.buffer_size, args.episode_limit, args.n_agents,
        args.obs_shape[-1], obs_dtype=env.params.obs_dtype,
        device=args.device)
    T = env.episode_limit
    updates = updates_per_rollout(args, a.B)

    def cycle(i, carry):
        states, ring, _ = carry
        res = rollout(states, g, *EXPLORE)
        ring = replay_lib.store(ring, res.episodes)
        return res.env_states, ring, learner.learn_many(ring, updates, g)

    carry = cycle(0, (states, ring, None))
    hostread(carry[2])

    batch = replay_lib.sample(carry[1], args.batch_size, g)
    dt_learn, _ = timeit_chained(lambda i, loss: learner.update(batch),
                                 carry[2], iters=learn_iters)
    tflops = estimate_learn_flops(args) / dt_learn / 1e12
    dt, _ = timeit_chained(cycle, carry, iters=cycles, warmup=cycle_warmup)
    sps = a.B * T / dt
    lines = [
        {"metric": "learn_step_ms", "value": dt_learn * 1e3,
         "unit": "ms", "vs_baseline": None},
        {"metric": "learn_step_tflops", "value": tflops,
         "unit": (f"TFLOP/s analytic ({a.dtype}); vs_baseline: share of an "
                  f"H100 SXM's {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s float32 "
                  "peak outside the tensor cores (TF32 off; bf16 rounds "
                  "the operands and multiplies in float32)"),
         "vs_baseline": tflops * 1e12 / PEAK_F32_FLOPS},
        {"metric": "train_loop_env_steps_per_sec", "value": sps,
         "unit": "env-steps/s", "vs_baseline": None},
        {"metric": "train_e2e", "value": sps,
         "unit": (f"env-steps/s at the reference replay ratio ({updates} "
                  f"updates per {a.B}-episode rollout); learn "
                  f"{dt_learn * 1e3:.2f} ms/update"),
         "vs_baseline": None},
    ]
    ttq = time_to_quality_line()
    if ttq is not None:
        lines.append(ttq)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
