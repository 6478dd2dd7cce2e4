"""Traffic mode ``collect``: chained epsilon-greedy rollouts of ``chips``
chips through the trainer's rollout, at the recipe's epsilon floor, with
no learner: each rollout starts from the last one's env states and
returns its episodes as the trainer stores them.

Set-up builds the trainer's nets and rollout, gives the net the
benchmark's weights, and runs two rollouts.  The window runs rollouts
until ``seconds`` have passed and ends after a synchronise.  The reference
then judges ``judged_chips`` chips of the window's last rollout, drawn
from the seed.  A traced run also times the env's step alone at this
batch (``env.step_core`` chained over ``step_calls`` calls between CUDA
events) and profiles two rollouts.
"""

from __future__ import annotations

import time

import torch

from benchmark import checks, flops, trace as tracing
from benchmark.harness import check_args, load_weights, note, program_args
from benchmark.instrument import Spans
from benchmark.reference import net as ref_net

WARMUP_ROLLOUTS = 2
TRACED_ROLLOUTS = 2
STEP_WARMUP = 10
HOLD_CYCLES = 200_000_000   # about 0.1 s of the SM clock


def time_step(env, state, chips: int, n_agents: int, n_actions: int,
              seed: int, calls: int) -> float:
    """Device seconds a call of the env's step at this batch, chained
    through its states, between CUDA events.  The stream is held by a
    sleeping kernel while the host queues the calls, so that the events
    time the device's work of the calls back to back and not the host's
    pace in queueing them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    actions = torch.randint(0, n_actions, (chips, n_agents), generator=g,
                            device="cuda", dtype=torch.int32)
    uniforms = torch.rand((chips, n_agents), generator=g, device="cuda")
    for _ in range(STEP_WARMUP):
        state = env.step_core(state, actions, uniforms)[0]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(calls):
        state = env.step_core(state, actions, uniforms)[0]
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def run(cell, cfg, seed, seconds, trace, device, t_start, overrides=None,
        calibrate=False, plant=None) -> dict:
    from marl_dmfb_tpu_torch.config import make_env_from_args
    from marl_dmfb_tpu_torch.trainer import Trainer

    if plant is not None:
        plant()
    traffic = cell.traffic
    chips = cfg.get("collect_chips", traffic["chips"])
    args = program_args(cell.config, seed, device,
                        extra=[f"--n_parallel_envs={chips}"],
                        overrides=overrides)
    env = make_env_from_args(args)
    observe, last = env.observe, {}

    def recorded(state):
        last["start"], last["gen"] = state, generator.get_state()
        return observe(state)

    env = env._replace(observe=recorded)
    trainer = Trainer(env, args, eval_only=True)
    generator = trainer.generator
    check_args(args, {k: v for k, v in cfg.items() if k != "rollout_batch"})
    w0 = ref_net.make_weights(cfg, seed + 1, device)
    load_weights(w0, [trainer.net])
    spans = Spans(device)
    eps = args.min_epsilon
    states = env.init(chips, generator, trainer.device)

    def rollout():
        nonlocal states
        res = trainer.rollout(states, generator, eps, 0.0, eps)
        states = res.env_states
        return res

    for _ in range(WARMUP_ROLLOUTS):
        rollout()
    spans.sync()
    setup_s = time.time() - t_start

    n = 0
    t0 = time.perf_counter()
    while True:
        res = rollout()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    spans.sync()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    judged = (last["start"], last["gen"], res.episodes)

    T = args.episode_limit
    note(f"set-up {setup_s:.2f} s, window {wall:.2f} s")
    ctx = {"window_s": wall,
           "window_flops": n * flops.rollout_flops(cfg, chips, T),
           "peak_flops": flops.PEAK_F32_FLOPS, "trace": None}
    if trace and torch.device(device).type == "cuda":
        if cfg["kind"] == "dmfb":
            ctx["step"] = {
                "seconds": time_step(env, states, chips, args.n_agents,
                                     args.n_actions, seed + 2,
                                     traffic["step_calls"]),
                "bytes": flops.dmfb_step_bytes(cfg, chips),
                "peak_bytes": flops.PEAK_HBM_BYTES}
        ctx["trace"] = tracing.summarize(
            tracing.record(rollout, TRACED_ROLLOUTS, spans))
        note(f"traced by {time.time() - t_start:.2f} s")

    pick = torch.randperm(chips, generator=torch.Generator().manual_seed(
        seed + 3))[:traffic["judged_chips"]].to(trainer.device)
    numbers = checks.judge_rollout(cfg, w0, *judged, eps, chips, rows=pick,
                                   control=calibrate)
    readings = {k: numbers.pop(k) for k in list(numbers) if "." in k}
    note(f"judged by {time.time() - t_start:.2f} s")
    return {"e2e": {"actor_env_steps_per_s": n * chips * T / wall,
                    "setup_s": setup_s},
            "ctx": ctx, "numbers": numbers, "readings": readings,
            "attempted": n, "failed": 0, "peak": peak}
