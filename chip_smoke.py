#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``marl_dmfb_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build the env-step kernel (``csrc/dmfb_step.cu``) with nvcc for sm_90a
   and print each instantiation's registers, spills and shared memory from
   the ptxas log; the 4-droplet one (the main path's) must not spill;
2. hold the kernel against its plain PyTorch version on the card (integer,
   bool and usage outputs bitwise equal, rewards within 1e-5) at three
   shapes, three chained steps each;
3. drive the evaluate entry point (DMFB 10x10, 4 droplets, fov 9, CRNN at
   the evaluation width, seeded random weights) and check that the env step
   went through the kernel once per step (T = 40 launches); then run a small
   greedy rollout on the card and on the CPU from the same chips and draws,
   which must give the same episodes;
4. time one epsilon-greedy actor rollout at B = 16384 chips, checking that
   it too launched the kernel once per step, and the kernel against its
   plain version (CUDA events around a CUDA graph of 50 calls) at the actor
   batch, B = 16384, and at the evaluation batch, B = 100, each beside its
   bound and its share of the bound;
5. train through the train entry point at full width (24 conv channels, GRU
   hidden 128, learner batch 128, replay 5000, B = 64 chips a rollout, 32
   updates a cycle) for at least 7 cycles, so that update 200 syncs the
   target, with an evaluation at the start, one mid-run and one at the end;
   check that the env step went through the kernel once per step of every
   training and evaluation rollout, that every loss is finite, that the
   update count is 32 a cycle, that the target moved and differs from the
   params, and that the final checkpoint reloads bitwise through the
   evaluate entry point; hold 3 learner updates on the card against the same
   updates on the CPU; and time an update, a cycle and the env steps.

The kernel JSON line (the kernel's numbers) and a training JSON line come
before the last, ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the exit code is non-zero and no result line is printed.  Exits
non-zero at once where CUDA is unavailable.  Writes nothing but the kernel
build and the training run's checkpoints and curves under ``build/``.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# NVIDIA H100 SXM data sheet: the HBM3 rate, and float32 outside the tensor
# cores as the rate of the kernel's scalar integer work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
KERNEL_B = 16384           # actor batch of the timing phase
EVAL_B = 100               # evaluation batch (evaluate_task=100)
TIMED_LAUNCHES = 50
REWARD_ATOL = 1e-5         # float32 sums of up to 16 rewards, other order
TRAIN_B = 64               # chips a training rollout (32 updates a cycle)
TRAIN_STEPS = 7 * TRAIN_B * 40   # >= 7 cycles: >= 224 updates, one sync
TRAIN_EVAL_CYCLE = 10000   # evaluations at 0 steps, once mid-run, at the end
# the learner on the card against the CPU, TF32 off: the loss within rtol
# LOSS_RTOL at each update (float32 sums over 128 x 4 rows x 40 steps in
# another order); the params after LEARN_UPDATES updates within PARAM_ATOL,
# except elements whose CPU gradient is within NOISE of the gradient's norm
# of zero at some update, which Adam moves by up to a learning rate either
# way (held to 2 * lr * updates)
LEARN_UPDATES = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
NOISE = 1e-6
TIMED_UPDATES = 10
TIMED_CYCLES = 3


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log_text):
    """{kernel entry: {"registers", "spill_stores", "spill_loads", "smem"}}
    from nvcc's ``-Xptxas -v`` output."""
    out, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry]["spill_stores"] = int(m.group(1))
            out[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[entry]["smem"] = int(m.group(1)) if m else 0
    return out


def bound(dmfb_step, params, batch):
    """(bound_ms, bound_by, bytes, ops) of one step of ``batch`` chips: the
    least bytes (``dmfb_step.min_bytes``) over the HBM rate against the
    integer operations over the scalar rate: 4 per distance test (2 kinds
    per droplet pair), one per observation byte and per usage cell."""
    n = params.n_droplets
    n_bytes = dmfb_step.min_bytes(params, batch)
    n_ops = batch * (8 * n * (n - 1) + n * params.obs_dim
                     + params.width * params.length)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops)


def device_ms(calls, iters=TIMED_LAUNCHES) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    timed with CUDA events around its replay, so that host overhead and the
    launch queue's depth play no part.  ``calls`` rotate, each on its own
    inputs, so that a call does not find its inputs in the 50 MB L2 cache
    from the calls before it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the default stream
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def random_states(tdmfb, params, batch, generator):
    """Chips from ``init`` with degraded electrodes in [0.5, 1), a quarter
    of the droplets on their goals and step counts spread over the episode,
    so that failed moves, stalls and the step limit all occur."""
    s = tdmfb.init(params, batch, generator, "cuda")
    n = params.n_droplets
    at_goal = torch.rand((batch, n, 1), generator=generator,
                         device="cuda") < 0.25
    goal = torch.where(at_goal, s.pos, s.goal)
    return s._replace(
        goal=goal,
        dist=(s.pos - goal).abs().sum(-1, dtype=torch.int32),
        health=torch.rand(s.health.shape, generator=generator,
                          device="cuda") * 0.5 + 0.5,
        step_count=torch.randint(0, params.max_step, (batch,),
                                 generator=generator, device="cuda",
                                 dtype=torch.int32),
    )


def step_inputs(params, batch, generator):
    n = params.n_droplets
    a = torch.randint(0, 5, (batch, n), generator=generator, device="cuda",
                      dtype=torch.int32)
    u = torch.rand((batch, n), generator=generator, device="cuda")
    return a, u


def compare_kernel(tdmfb, dmfb_step, params, batch, generator):
    """Three chained steps, kernel vs plain; returns the largest absolute
    difference over all outputs."""
    s = random_states(tdmfb, params, batch, generator)
    worst = 0.0
    for _ in range(3):
        a, u = step_inputs(params, batch, generator)
        sk, ok = dmfb_step.step_batch(params, s, a, u)
        sp, op = tdmfb.step_core(params, s, a, u)
        torch.cuda.synchronize()
        for name, x, y in (
                [(f, getattr(sk, f), getattr(sp, f)) for f in
                 ("pos", "dist", "usage", "step_count", "cum_constraints")]
                + [(f, getattr(ok, f), getattr(op, f)) for f in
                   ("obs", "dones", "terminated", "constraints", "success",
                    "rewards", "team_reward")]):
            diff = (x.double() - y.double()).abs().max().item()
            worst = max(worst, diff)
            if name in ("rewards", "team_reward"):
                if not diff <= REWARD_ATOL:
                    raise AssertionError(f"{name} differs by {diff}")
            elif not torch.equal(x, y):
                raise AssertionError(
                    f"{name} differs (max |diff| {diff}, "
                    f"{int((x != y).sum())} elements)")
        s = sk
    return worst


def compare_learner(VDNLearner, build_agent_net, args, state, batch):
    """``LEARN_UPDATES`` updates of one learner state on one minibatch, on
    the card and on the CPU; returns the largest loss difference relative
    to the CPU's, the largest param difference outside noise gradients and
    in all, and the card's learner."""
    cpu = VDNLearner(args, build_agent_net(args))
    card = VDNLearner(args, build_agent_net(args).cuda())
    cpu.load_state(state)
    card.load_state(state)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    noisy = {k: torch.zeros(v.shape, dtype=torch.bool)
             for k, v in cpu.params.items()}
    loss_rel = 0.0
    for _ in range(LEARN_UPDATES):
        _, grads = cpu.loss_and_grads(cpu_batch)
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values()))
        for k, g in grads.items():
            noisy[k] |= g.abs() <= NOISE * norm
        want = float(cpu.update(cpu_batch))
        got = float(card.update(batch))
        if not math.isfinite(got):
            raise AssertionError(f"the card's loss is {got}")
        loss_rel = max(loss_rel, abs(got - want) / abs(want))
    clean = worst = 0.0
    for k, p in cpu.params.items():
        diff = (card.params[k].detach().cpu() - p.detach()).abs()
        kept = diff[~noisy[k]]
        clean = max(clean, float(kept.max()) if kept.numel() else 0.0)
        worst = max(worst, float(diff.max()))
    return loss_rel, clean, worst, card


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from marl_dmfb_tpu_torch import checkpoint, evaluate, train
    from marl_dmfb_tpu_torch.algos.qlearn import VDNLearner
    from marl_dmfb_tpu_torch.config import get_evaluate_args
    from marl_dmfb_tpu_torch.config import make_env_from_args
    from marl_dmfb_tpu_torch.replay import sample
    from marl_dmfb_tpu_torch.trainer import Trainer
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.models.networks import (build_agent_net,
                                                     init_params)
    from marl_dmfb_tpu_torch.ops import _build, dmfb_step
    from marl_dmfb_tpu_torch.rollout import RolloutNoise, make_rollout

    t_all = time.perf_counter()

    # --- 0: the card ---
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {kind} x{torch.cuda.device_count()} "
        f"({time.perf_counter() - t0:.2f} s)")
    torch.cuda.set_device(0)

    # --- 1: build ---
    t0 = time.perf_counter()
    dmfb_step.kernel_library()
    built = _build.build("dmfb_step")
    log(f"phase 1: built {os.path.relpath(built.path, ROOT)} in "
        f"{built.seconds:.2f} s of nvcc")
    ptxas = ptxas_summary(built.log)
    for entry, info in ptxas.items():
        log(f"  ptxas: {entry}: {info}")
    main4 = [info for entry, info in ptxas.items() if "ILi4E" in entry]
    if len(main4) != 1 or main4[0].get("spill_stores") != 0 \
            or main4[0].get("spill_loads") != 0:
        raise AssertionError(f"the 4-droplet instantiation spills or was "
                             f"not found in the ptxas log: {main4}")
    log(f"phase 1: {time.perf_counter() - t0:.2f} s")

    # --- 2: kernel vs plain version ---
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(2024)
    max_err = 0.0
    for width, n, blocks, batch in ((10, 4, 0, KERNEL_B), (20, 4, 2, 1024),
                                    (20, 10, 0, 1024)):
        p = tdmfb.DMFBParams(width=width, length=width, n_droplets=n,
                             n_blocks=blocks, fov=9)
        err = compare_kernel(tdmfb, dmfb_step, p, batch, g)
        max_err = max(max_err, err)
        log(f"phase 2: {width}x{width}, {n} droplets, {blocks} blocks, "
            f"B={batch}: kernel == plain over 3 steps (max |diff| {err:.3g})")
    log(f"phase 2: {time.perf_counter() - t0:.2f} s")

    # --- 3: the evaluate entry point, through the kernel ---
    t0 = time.perf_counter()
    argv = ["dmfb", "--drop_num=4", "--fov=9", "--evaluate_task=100"]
    dmfb_step.launches = 0
    m = evaluate.main(argv)
    launches = dmfb_step.launches
    args = get_evaluate_args(argv)
    env = make_env_from_args(args)
    T = env.episode_limit
    if launches != T:
        raise AssertionError(f"evaluate launched the kernel {launches} "
                             f"times, expected {T} (one per step)")
    if not (all(math.isfinite(v) for v in m.values())
            and 0 < m["steps"] <= T and 0.0 <= m["success_rate"] <= 1.0):
        raise AssertionError(f"evaluate returned {m}")
    log(f"phase 3: evaluate: success {m['success_rate']}, steps "
        f"{m['steps']}, reward {m['reward']:.4f}, kernel launches "
        f"{launches} (T = {T}); conv width {args.hyper_hidden_dim}")

    # the same greedy rollout on the card (kernel) and the CPU (plain)
    args.update_env_info(env.env_info())
    net = init_params(build_agent_net(args),
                      torch.Generator().manual_seed(args.seed)).eval()
    gc = torch.Generator(device="cuda").manual_seed(7)
    small = env.init(64, gc, "cuda")
    reset = env.reset(small, gc)
    noise = RolloutNoise(None, None,
                         torch.rand((T, 64, env.n_agents), generator=gc,
                                    device="cuda"))
    res = {}
    for dev in ("cuda", "cpu"):
        to = lambda x: x.to(dev)
        chips = type(reset)(*map(to, reset))
        denv = env._replace(reset=lambda s, gen: chips)
        roll = make_rollout(denv, net.to(dev), args.rnn_hidden_dim)
        res[dev] = roll(chips, None, 0.0, 0.0, 0.0, greedy=True,
                        noise=RolloutNoise(None, None,
                                           noise.env_uniforms.to(dev)))
    same = (res["cuda"].episodes["o_ext"].cpu()
            == res["cpu"].episodes["o_ext"]).flatten(1).all(1)
    same &= res["cuda"].success.cpu() == res["cpu"].success
    log(f"phase 3: greedy rollout of 64 chips, card vs CPU: "
        f"{int(same.sum())}/64 episodes identical")
    if not bool(same.all()):
        raise AssertionError("the card's rollout departs from the CPU's")
    log(f"phase 3: {time.perf_counter() - t0:.2f} s")

    # --- 4: epsilon-greedy actor rollout at B = 16384 + kernel timing ---
    t0 = time.perf_counter()
    net = net.to("cuda")
    ga = torch.Generator(device="cuda").manual_seed(4)
    chips = env.init(KERNEL_B, ga, "cuda")
    rollout = make_rollout(env, net, args.rnn_hidden_dim)
    anneal = (args.epsilon - args.min_epsilon) / args.anneal_steps * KERNEL_B
    warm = rollout(chips, ga, 1.0, anneal, args.min_epsilon)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dmfb_step.launches = 0
    t1 = time.perf_counter()
    res = rollout(warm.env_states, ga, 1.0, anneal, args.min_epsilon)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches_actor = dmfb_step.launches
    if launches_actor != T:
        raise AssertionError(f"the actor rollout launched the kernel "
                             f"{launches_actor} times, expected {T}")
    peak = torch.cuda.max_memory_allocated()
    executed = int((~res.episodes["padded"]).sum())
    log(f"phase 4: [{smi}] epsilon-greedy rollout, B={KERNEL_B}, T={T}: "
        f"{dt * 1e3:.1f} ms, {KERNEL_B * T / dt:.0f} lockstep env-steps/s, "
        f"{executed / dt:.0f} executed env-steps/s, final epsilon "
        f"{float(res.epsilon):.4f}, peak memory {peak / 2 ** 20:.1f} MiB, "
        f"kernel launches {launches_actor} (T = {T})")

    p = env.params
    timed = {}
    for batch in (KERNEL_B, EVAL_B):
        sets = [(random_states(tdmfb, p, batch, ga),
                 *step_inputs(p, batch, ga)) for _ in range(4)]
        kernel_ms = device_ms([
            lambda x=x: dmfb_step.step_batch(p, *x) for x in sets])
        plain_ms = device_ms([
            lambda x=x: tdmfb.step_core(p, *x) for x in sets])
        bound_ms, bound_by, n_bytes, n_ops = bound(dmfb_step, p, batch)
        timed[batch] = dict(ms=kernel_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            share=bound_ms / kernel_ms,
                            tile=dmfb_step.tile_chips(p, batch))
        log(f"phase 4: [{smi}] dmfb_step at B={batch} "
            f"({timed[batch]['tile']} chips a tile, "
            f"{dmfb_step.tile_bytes(p, timed[batch]['tile'])} bytes of shared "
            f"memory a block): kernel "
            f"{kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}: {n_bytes} bytes, "
            f"{n_ops} ops), {100 * bound_ms / kernel_ms:.1f}% of the bound")
    log(f"phase 4: {time.perf_counter() - t0:.2f} s")

    # --- 5: train on the card, through the train entry point ---
    t0 = time.perf_counter()
    data_dir = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(data_dir, ignore_errors=True)
    targv = ["dmfb", "--drop_num=4", "--fov=9",
             f"--n_parallel_envs={TRAIN_B}", f"--exact_steps={TRAIN_STEPS}",
             f"--evaluate_cycle={TRAIN_EVAL_CYCLE}", "--evaluate_task=100",
             f"--data_dir={data_dir}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dmfb_step.launches = 0
    t1 = time.perf_counter()
    trainer = train.main(targv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches_train = dmfb_step.launches
    peak_train = torch.cuda.max_memory_allocated()
    targs = trainer.args
    width = (targs.hyper_hidden_dim, targs.rnn_hidden_dim, targs.batch_size,
             targs.buffer_size, trainer.B, trainer.updates_per_rollout)
    if width != (24, 128, 128, 5000, TRAIN_B, 32):
        raise AssertionError(f"phase 5 trained at (conv, hidden, batch, "
                             f"replay, B, updates a cycle) = {width}")
    cycles = trainer.n_cycles
    evals = len(trainer.success_rate)
    if launches_train != T * (cycles + evals):
        raise AssertionError(
            f"training launched the kernel {launches_train} times, expected "
            f"T x ({cycles} training + {evals} evaluation rollouts)")
    if evals != 3:
        raise AssertionError(f"{evals} evaluations, expected 3")
    losses = torch.stack(trainer.losses).cpu()
    if len(losses) != cycles or not bool(losses.isfinite().all()):
        raise AssertionError(f"losses {losses.tolist()}")
    learner = trainer.learner
    updates = learner.train_step
    if updates != 32 * cycles or updates < 200:
        raise AssertionError(f"{updates} updates in {cycles} cycles")
    first = checkpoint.load(checkpoint.model_state_path(targs, 0))
    start = first["learner"]["target_params"]["agent"]
    target = dict(learner.target_net.named_parameters())
    moved = sum(not torch.equal(start[k], v.cpu()) for k, v in target.items())
    apart = sum(not torch.equal(learner.params[k], v)
                for k, v in target.items())
    if moved != len(target) or apart != len(target):
        raise AssertionError(
            f"target sync: {moved} of {len(target)} target tensors moved "
            f"from their start, {apart} differ from the params")
    log(f"phase 5: [{smi}] trained {cycles} cycles of B={TRAIN_B} "
        f"({updates} updates) in {train_s:.2f} s; kernel "
        f"launches {launches_train} = T x ({cycles} + {evals}); losses "
        f"{[round(x, 4) for x in losses.tolist()]}; success "
        f"{trainer.success_rate}; epsilon {float(trainer.epsilon):.4f}; "
        f"peak memory {peak_train / 2 ** 20:.1f} MiB")

    # the final checkpoint through the evaluate entry point, bitwise
    final = checkpoint.load(checkpoint.model_state_path(targs, "final"))
    for k, v in learner.params.items():
        if not torch.equal(final["learner"]["params"]["agent"][k], v.cpu()):
            raise AssertionError(f"the final checkpoint's {k} differs")
    eargv = ["dmfb", "--drop_num=4", "--fov=9", "--evaluate_task=100",
             f"--data_dir={data_dir}", "--load_model"]
    m_loaded = evaluate.main(eargv)
    eargs = get_evaluate_args(eargv)
    ref = Trainer(make_env_from_args(eargs), eargs, eval_only=True)
    ref.net.load_state_dict(trainer.net.state_dict())
    m_ref = ref.evaluate()
    if m_loaded != m_ref:
        raise AssertionError(f"evaluate --load_model gave {m_loaded}, the "
                             f"trained net {m_ref}")
    log(f"phase 5: evaluate --load_model of the final checkpoint: "
        f"{m_loaded}, equal to the trained net's")

    # the learner on the card against the CPU, one minibatch of 128
    idx = (torch.arange(targs.batch_size, device="cuda") * 3
           % trainer.replay.size)
    batch = sample(trainer.replay, targs.batch_size, idx=idx)
    loss_rel, clean, worst, card = compare_learner(
        VDNLearner, build_agent_net, targs, learner.state(), batch)
    adam_bound = 2 * targs.lr * LEARN_UPDATES
    log(f"phase 5: learner card vs CPU over {LEARN_UPDATES} updates at batch "
        f"{targs.batch_size}: loss rel diff {loss_rel:.3g} (<= {LOSS_RTOL}), "
        f"params max diff {clean:.3g} outside noise gradients (<= "
        f"{PARAM_ATOL}), {worst:.3g} in all (<= {adam_bound:.3g})")
    if not (loss_rel <= LOSS_RTOL and clean <= PARAM_ATOL
            and worst <= adam_bound):
        raise AssertionError("the learner on the card departs from the CPU")

    # times: an update (CUDA events), a cycle and its env steps (host clock)
    card.update(batch)
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record()
    for _ in range(TIMED_UPDATES):
        card.update(batch)
    end_ev.record()
    end_ev.synchronize()
    update_ms = start_ev.elapsed_time(end_ev) / TIMED_UPDATES
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = sum(trainer.train_cycle() for _ in range(TIMED_CYCLES))
    torch.cuda.synchronize()
    cycle_s = (time.perf_counter() - t1) / TIMED_CYCLES
    train_rate = steps / (cycle_s * TIMED_CYCLES)
    log(f"phase 5: [{smi}] learner update at batch {targs.batch_size}: "
        f"{update_ms:.2f} ms; train cycle (B={TRAIN_B}, 32 updates): "
        f"{cycle_s * 1e3:.1f} ms, {train_rate:.0f} counted env-steps/s "
        f"({TRAIN_B * T / cycle_s:.0f} lockstep); peak memory of the run "
        f"{peak_train / 2 ** 20:.1f} MiB")
    log(f"phase 5: {time.perf_counter() - t0:.2f} s")
    log(f"total: {time.perf_counter() - t_all:.2f} s")

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "dmfb_step",
        "route": "cuda",
        "source": "marl_dmfb_tpu_torch/csrc/dmfb_step.cu",
        "replaces": "marl_dmfb_tpu/ops/dmfb_step_pallas.py:44",
        "launches": launches,
        "launches_actor": launches_actor,
        "launches_train": launches_train,
        "max_abs_err": max_err,
        "ms": timed[KERNEL_B]["ms"],
        "plain_ms": timed[KERNEL_B]["plain_ms"],
        "bound_ms": timed[KERNEL_B]["bound_ms"],
        "bound_by": timed[KERNEL_B]["bound_by"],
        "library_ms": None,
        "share_of_bound": timed[KERNEL_B]["share"],
        "ms_b100": timed[EVAL_B]["ms"],
        "plain_ms_b100": timed[EVAL_B]["plain_ms"],
        "bound_ms_b100": timed[EVAL_B]["bound_ms"],
        "share_of_bound_b100": timed[EVAL_B]["share"],
    }]}))
    log(json.dumps({"train": {
        "cycles": cycles, "updates": updates,
        "evaluations": evals, "launches_train": launches_train,
        "update_ms": update_ms, "cycle_ms": cycle_s * 1e3,
        "env_steps_per_s": train_rate, "peak_mib": peak_train / 2 ** 20,
        "card_vs_cpu": {"loss_rel": loss_rel, "param_diff": clean,
                        "param_diff_all": worst},
        "device": smi}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
