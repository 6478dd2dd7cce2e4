#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``marl_dmfb_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build the env-step kernels, the tile kernel (``csrc/dmfb_step.cu``),
   the wide kernel (``csrc/dmfb_step_wide.cu``) and the MEDA kernel
   (``csrc/meda_step.cu``), with three nvcc runs at once for sm_90a and
   print each instantiation's registers, spills and shared memory from the
   ptxas logs; the tile kernel's 4-droplet ones (the main path's), all four
   of the wide kernel's (its group and chip layouts, each with and without
   observations) and all three of the MEDA kernel's (v0, v0.1, v0.2) must
   not spill;
2. hold the kernel against its plain PyTorch version on the card (integer,
   bool and usage outputs bitwise equal, rewards within 1e-5), with
   observations and without, three chained steps each, at the shapes of
   ``KERNEL_CMP``: each of its 4-, 8- and 16-droplet instantiations at
   20x20 and at 50x50 (the boards of the trained policies and of the
   degradation sweeps), with and without obstacle blocks; hold the MEDA
   kernel against ``envs/meda.step_core`` on the card at the shapes of
   ``MEDA_KERNEL_CMP`` (80x80-10d and 30x60-4d, fov 19, v0.2 and v0.1),
   three chained steps on degraded health at B = 2 and B = 4096 (every
   output bitwise, the team reward within 1e-6), and time it beside the
   plain step and its byte bound at 80x80-10d v0.2 at both batches;
3. drive the evaluate entry point (DMFB 10x10, 4 droplets, fov 9, CRNN at
   the evaluation width) on the committed export of the JAX package's
   trained 10x10-4d policy, and check that the env step went through the
   tile kernel once per step (T = 40 launches) and never through the wide
   kernel; then run a small greedy rollout
   of that policy on the card and on the CPU from the same chips and draws,
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
   updates on the CPU, and a learner under ``--remat`` and one under
   ``--fused_streams`` against the plain learner on the card (the same
   tolerances); and time an update of each (with its peak memory), a cycle
   and the env steps;
6. trained policies on the card, from the JAX package's artifacts exported
   to ``tests/fixtures/torch_weights/`` (numpy only): the 20x20 flagship's
   EMA weights evaluated greedily on 20x20 and 50x50, the bf16 policy under
   ``--compute_dtype bf16`` on 50x50, the v0.1 2-droplet policy on 10x10,
   and every other DMFB policy of the JAX package on its boards (5 and 10
   droplets, the tile kernel's 8- and 16-droplet instantiations; 2 obstacle
   blocks; 2 and 3 droplets, v0 and v0.1), each held to its success rate in
   ``artifacts/README.md`` less ``SUCCESS_SLACK``, over 100 tasks, or 500
   where that rate is below 0.95; and the flagship recipe's policy that the
   port trained from scratch on the card (``tools/time_to_quality_torch.py``,
   the CLI's seed) on 50x50, and the newest checkpoints of the bf16
   flagship (50x50, the float32 path), the 4-rank mesh (10x10, 20x20) and
   the seed farm's first seed (10x10), each held to its own recorded rate
   less ``SUCCESS_SLACK``; each rollout launching the tile kernel T times and
   the wide kernel never; greedy rollouts of the 4-, 5- and 10-droplet
   policies (``GREEDY_CMP``) on the card and on the CPU from the same chips
   and draws, half of them on worn electrodes, which must give the same
   episodes; the kernel's no-observation mode (the v0.1
   step's transition) against its plain version at B = 16384 and B = 100,
   and timed; a bf16 forward on the card against the CPU's, and timed
   beside float32; and 2-epoch x 20-task degradation sweeps on 50x50 of the
   4-droplet policy and of the 10-droplet one, the latter held to JAX's
   mean success over the same epochs of its sweep less ``SUCCESS_SLACK``;
7. MEDA and QMIX: a full 30x60-4d MEDA episode (T = 90) of the card's
   env step (the MEDA kernel) against the plain step on the CPU in v0,
   v0.1 and v0.2 at B = 2 and B = 4096 (integer, bool and observation
   outputs bitwise, rewards and team rewards within 1e-6, one launch a
   step) and the MEDA actor's env-steps/s at B = 8192 (T launches); every
   MEDA rollout below launches the MEDA kernel T times and the DMFB
   kernel never; the JAX package's MEDA VDN policies (30x60 at 2, 3 and 4
   droplets, the 4-droplet seed-12 policy zero-shot on 45x90 and 60x120,
   80x80-10d), MEDA QMIX and DMFB QMIX policies (the last also on 50x50,
   its 20x20 mixer dropped) and the MEDA 30x60-3d VDN policy that the port
   trained from scratch on the card (``tools/time_to_quality_torch.py
   --recipe meda_30x60_3d``, the CLI's seed) and the DMFB QMIX flagship
   that it trained (20x20, and 50x50 with its own mixer dropped) through
   the evaluate entry point, 100 tasks each (500 where the recorded rate
   is below 0.95), held to their recorded rates less ``SUCCESS_SLACK``,
   with the kernel launched T times a DMFB QMIX rollout;
   JAX's DMFB QMIX export also on 10x10 over 500 tasks (the recorded 0.89
   less ``SUCCESS_SLACK``);
   ``train meda --drop_num=4`` and ``train dmfb --alg=qmix
   --chip_size=20`` at the CLI's widths for a few cycles, timed; the QMIX
   learners of MEDA 30x60-3d and of the DMFB QMIX flagship (20x20-4d, fov
   9: a state of 1200 values, the CLI's mixer widths, two hyper layers) on
   the card against the CPU (``LEARN_UPDATES`` updates on a minibatch of
   ``QMIX_LEARN_BATCH`` episodes: losses within ``LOSS_RTOL``, params
   within ``PARAM_ATOL`` outside noise gradients, as phase 5); an
   epsilon-greedy DMFB QMIX rollout (20x20-4d, B = 64, T = 80, epsilon
   0.3) of the port's QMIX export through the tile kernel and through the
   plain step from the same chips and draws, its observations, actions,
   padding, terminations and global states ``s_ext`` bitwise and its
   rewards within 1e-5, T launches and none; that export on 10x10 over
   500 tasks, printed as a reading without a floor; and a 2-epoch x
   20-task MEDA degradation sweep;
8. the seed farm and the aux modules: ``train dmfb --drop_num=4 --fov=9
   --vmap_seeds=4 --n_parallel_envs=64`` at full width (4 seeds, each with
   the main config's nets, batch 128 and replay 5000) for about 3 cycles
   and its two evaluations, the kernel launched T times a farm rollout at
   batch 4 x 64; one farm rollout held against the same rollout through
   the plain step; the farm's first cycle against card ``Trainer(seed +
   i)`` for i = 0..3 (each seed's mean loss within rtol ``LOSS_RTOL``, its
   params after ``LEARN_UPDATES`` updates within ``PARAM_ATOL`` outside
   float-noise gradients, as phase 5); ms per farm cycle
   and per farm update beside one seed's, with each update's kernel
   launches and device time from ``torch.profiler`` (ops that ran once per
   seed are named); a resume under ``--ckpt_replay`` whose curves must
   equal an uninterrupted run's bitwise (cuDNN's deterministic algorithms
   on); the PettingZoo shim's episode on the card against the CPU's,
   ``Agents.choose_action`` and a ``Renderer`` frame of a card state
   against the CPU's; and the MEDA staircase router on 100 tasks;
9. data parallelism (``--mesh``) at the main config's widths (B = 64 chips
   over the ranks, batch 128, replay 5000), ``MESH_CYCLES`` cycles each,
   every rank a ``torch.multiprocessing`` child that imports no JAX: (a)
   one rank under NCCL, which puts the process group's all-reduces on the
   card; (b) two ranks on the one card under gloo with CUDA tensors (NCCL
   refuses two ranks on one device), with the global ring and with
   ``--local_sampling``; (c) two ranks under NCCL on two cards, where two
   are visible (else a line says it was not run).  Every global-ring run
   is held to the same run on one device (counted steps, epsilon and the
   ring's rows exactly, the losses of the first ``LEARN_UPDATES`` updates
   within ``LOSS_RTOL`` and the params after them within ``PARAM_ATOL``
   outside noise gradients; over a cycle's 32 Adam updates two float32
   summing orders drift further, which is printed); every run keeps its
   params bitwise alike on its ranks and
   launches the kernel T times a cycle on each rank at B / n chips; ms per
   cycle and each rank's ring bytes are printed;
10. the measuring entry points through their ``main``, at their full
   widths with their iteration counts cut (``BENCH_*``): ``bench`` (the
   actor at B = 16384: DMFB, MEDA and bf16; each rollout launches its
   env's kernel T times), ``bench_train`` at B = 1024 (the cycle that fills the
   ring, 10 learner updates, one timed cycle of 512 updates; T launches a
   cycle), ``bench_scaling`` over the visible cards and, where 4 are
   visible, ``bench_multiproc``; each prints its JSON lines, and every
   value must be finite and positive under its expected metric name;
11. the wide kernel, which steps every configuration that the tile kernel
   does not take (more than 16 droplets, or a chip beyond shared memory),
   in its group layout (several chips a block) or, on large boards, its
   chip layout (one block a chip):
   (a) against its plain version (bitwise, rewards within 1e-5) over 3
   chained steps, with observations and without, from views at offset 0
   and 1, at 20x20-20d, 10x10-13d (JAX's cap, the lattice fallback),
   50x50-64d, 40x40-130d (ids past 127), 200x200-4d, 160x160-4d,
   160x160-10d and 10x10-4d, where it must also equal the tile kernel, and
   at the group layout's edges: 17, 32, 33, 64 and 65 droplets (the cuts
   of its chips a group) at B = 1001 and 20x20-20d at B = 16387 (a last
   group that is short), and 97x97-4d and 98x98-4d (either side of the
   cut between the layouts);
   (b) its time (CUDA events around a CUDA graph) beside its byte bound at
   20x20-20d and 10x10-13d (B = 16384), 50x50-64d (B = 4096), 160x160-4d
   and 200x200-4d (B = 1024), and the plain version's, with observations
   and without; (c) the evaluate
   entry point with the flagship export at 20 droplets on 20x20 (100
   tasks) and at 4 droplets on 200x200 (T = 800), and ``train`` at 4
   droplets on 160x160 at the CLI's net widths with a small ring, 2 cycles,
   each launching the wide kernel T times a rollout and the tile kernel
   never, with finite losses; and a greedy rollout of the flagship at
   20x20-20d on the card equal to the same rollout on the CPU;
12. learning from scratch: ``train dmfb --drop_num=2 --n_parallel_envs=64
   --lr_decay --param_ema=0.999 --exact_steps=200000
   --evaluate_cycle=50000`` (DMFB 10x10-2d, fov 9, VDN, at the CLI's
   widths), its env steps through the tile kernel once per step of every
   rollout; then checkpoint 0 and the final checkpoint through the
   evaluate entry point, greedy over 100 tasks on 10x10: the untrained
   policy must score at most 0.10 and the trained one at least 0.80, and
   the phase must end within 240 s; its online curve and times are
   printed;
13. JAX's largest configuration, ``train meda --drop_num=10`` (80x80,
   T = 160, batch 128, a 10,000-episode ring, 2 chips a rollout) at the
   CLI's widths, 3 cycles without ``--remat`` and 3 with it, each with
   the MEDA kernel launched T times a rollout and the DMFB kernel never,
   every loss finite, an update's and a cycle's times and the run's peak
   memory; and the update under ``--remat`` against the one without on
   the card on one minibatch (loss within 1e-5, gradients within 1e-6 of
   their norm).  It comes after phase 12: its ring holds 16 GiB of the
   card.

The phases run in this order but for phase 8, which runs last: its
``torch.profiler`` trace leaves every later launch of the process slower,
and the phases after it are timed.

The kernel JSON line (the three kernels' numbers), a training JSON line, a
trained-policies JSON line, a MEDA/QMIX JSON line, a farm JSON line, a
mesh JSON line, a bench JSON line (the entry points' lines), a
learning JSON line and a MEDA 80x80-10d JSON line come before the last,
``{"ok": true, "device": {...}}``.  Any failed check
raises, so the exit code is non-zero and no result line is printed.  Exits
non-zero at once where CUDA is unavailable.  Writes nothing but the kernel
build, the training runs' checkpoints and curves and the sweeps' arrays
under ``build/``.
"""

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# NVIDIA H100 SXM data sheet: the HBM3 rate, and float32 outside the tensor
# cores as the rate of the kernel's scalar integer work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
KERNEL_B = 16384           # actor batch of the timing phase
EVAL_B = 100               # evaluation batch (evaluate_task=100)
# phase 2: (width, droplets, blocks, chips) held to the plain version, with
# observations and without: each tile instantiation (4, 8, 16 droplets)
# on the trained policies' and the sweeps' boards
KERNEL_CMP = ((10, 4, 0, KERNEL_B), (20, 4, 2, 1024), (20, 5, 0, 1024),
              (20, 10, 0, 1024), (50, 4, 0, 1024), (50, 4, 2, 1024),
              (50, 5, 0, 1024), (50, 10, 0, 1024))
TIMED_LAUNCHES = 50
# phase 2, MEDA: (width, length, droplets, observation) held to the plain
# step, and 80x80-10d v0.2 timed, at each MEDA_KERNEL_B (the training
# rollouts' batch and meda80.collect's); phase 7 holds whole episodes of
# the kernel to the CPU's plain step at the same batches
MEDA_KERNEL_CMP = ((80, 80, 10, "v0.2"), (80, 80, 10, "v0.1"),
                   (30, 60, 4, "v0.2"), (30, 60, 4, "v0.1"))
MEDA_KERNEL_B = (2, 4096)
MEDA_TEAM_ATOL = 1e-6      # a float32 mean of up to 10 rewards, other order
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
# every in-process train.main run means one device: under the default
# --mesh auto a machine with several cards would start a rank a card
ONE_DEVICE = "--mesh=off"
# phase 6: the committed exports of trained policies (JAX's, and one the
# port trained), and the success rates recorded for them (greedy, 100
# tasks; artifacts/README.md, the port's own artifact); a rate below the
# record less SUCCESS_SLACK (about 4 binomial sigma at 100 tasks) fails
WEIGHTS = os.path.join(ROOT, "tests", "fixtures", "torch_weights")
POLICY_4D = os.path.join(WEIGHTS, "dmfb_10x10_4d_fov9_vdn")
SUCCESS_SLACK = 0.08
TRAINED = [
    # (name, export, board, extra flags, recorded success)
    ("flagship_20x20", "dmfb_20x20_4d_fov9_vdn_b64", 20, [], 0.96),
    ("flagship_50x50", "dmfb_20x20_4d_fov9_vdn_b64", 50, [], 1.00),
    ("bf16_50x50", "dmfb_20x20_4d_bf16", 50, ["--compute_dtype=bf16"], 1.00),
    ("v01_2d_10x10", "dmfb_10x10_2d_fov9_vdn_v01", 10,
     ["--version=0.1", "--drop_num=2"], 1.00),
    # the flagship recipe trained from scratch by the port on the card (the
    # CLI's seed): its final rate in marl_dmfb_tpu_torch/artifacts/
    # time_to_quality.json
    ("port_flagship_50x50", "dmfb_20x20_4d_fov9_vdn_torch", 50, [], 1.00),
    # the bf16 flagship, the 4-rank mesh and the seed farm's first seed,
    # trained from scratch by the port on the card and stopped at a time
    # limit: each newest checkpoint's rate in that artifact (bf16 scored
    # on the float32 path, as its artifact entry was)
    ("port_bf16_50x50", "dmfb_20x20_4d_bf16_torch", 50, [], 0.88),
    ("port_mesh_10x10", "mesh8_10x10_2d_torch", 10, ["--drop_num=2"], 0.97),
    ("port_mesh_20x20", "mesh8_10x10_2d_torch", 20, ["--drop_num=2"], 1.00),
    ("port_farm_10x10", "seedfarm_10x10_2d_torch", 10, ["--drop_num=2"],
     0.97),
    # the rest of the JAX package's DMFB policies: 5 and 10 droplets (the
    # tile kernel's 8- and 16-droplet instantiations), obstacle blocks (a
    # block mask), 2 and 3 droplets, v0.1 at 3; the 20x20 10d and 4d2b and
    # the 10x10 3d rates over 500 tasks (RESULTS.md:377-378 for the 10d)
    ("10d_20x20", "dmfb_20x20_10d_fov9_vdn", 20, ["--drop_num=10"], 0.73),
    ("10d_50x50", "dmfb_20x20_10d_fov9_vdn", 50, ["--drop_num=10"], 0.96),
    ("5d_20x20", "dmfb_20x20_5d_fov9_vdn", 20, ["--drop_num=5"], 0.98),
    ("5d_50x50", "dmfb_20x20_5d_fov9_vdn", 50, ["--drop_num=5"], 0.98),
    ("4d2b_20x20", "dmfb_20x20_4d2b_8m", 20, ["--block_num=2"], 0.932),
    ("4d2b_30x30", "dmfb_30x30_4d2b_8m", 30, ["--block_num=2"], 0.982),
    ("4d2b_50x50", "dmfb_30x30_4d2b_8m", 50, ["--block_num=2"], 1.00),
    ("2d_10x10", "dmfb_10x10_2d_fov9_vdn", 10, ["--drop_num=2"], 1.00),
    ("2d_20x20", "dmfb_10x10_2d_fov9_vdn", 20, ["--drop_num=2"], 0.99),
    ("3d_10x10", "dmfb_10x10_3d_fov9_vdn", 10, ["--drop_num=3"], 0.92),
    ("3d_50x50", "dmfb_10x10_3d_fov9_vdn", 50, ["--drop_num=3"], 0.99),
    ("v01_3d_10x10", "dmfb_10x10_3d_fov9_vdn_v01", 10,
     ["--version=0.1", "--drop_num=3"], 0.99),
    ("v01_3d_20x20", "dmfb_10x10_3d_fov9_vdn_v01", 20,
     ["--version=0.1", "--drop_num=3"], 1.00),
]
# SUCCESS_SLACK is about 4 binomial sigma only near a rate of 0.95; a policy
# recorded below that is evaluated over LOW_RATE_TASKS tasks, where it is
# at least 4 sigma (0.079 at 0.73)
LOW_RATE = 0.95
LOW_RATE_TASKS = 500


def eval_tasks(recorded: float) -> int:
    return LOW_RATE_TASKS if recorded < LOW_RATE else EVAL_B
# the bf16 forward on the card against the CPU's: the tolerances of
# tests/test_torch_bf16.py (Q-values, hidden state)
BF16_Q_ATOL = 1e-2
BF16_H_ATOL = 2e-2
BF16_ROWS = 8192                  # rows compared, card against CPU
BF16_TIMED_ROWS = KERNEL_B * 4    # one actor step's rows: B chips x N agents
# greedy rollouts of GREEDY_B chips, card against CPU, half of them worn:
# the 4-, 8- and 16-droplet instantiations under a policy (TRAINED names)
GREEDY_CMP = ("flagship_50x50", "5d_20x20", "5d_50x50", "10d_50x50")
GREEDY_B = 64
SWEEP = dict(board=50, epochs=2, tasks=20)
# the 10-droplet policy's sweep on 50x50, the first SWEEP_10D epochs of the
# DegreData row 50by50-10d0b (BASELINE.json's evaDegre workload): JAX's
# mean success over those epochs (artifacts/DegreData/50by50-10d0b/
# success.npy, epochs 0-1: 0.94 and 0.93) less SUCCESS_SLACK is its floor
SWEEP_10D = dict(board=50, epochs=2, tasks=20, export="dmfb_20x20_10d_fov9_vdn")
SWEEP_10D_JAX = 0.935
# phase 7: MEDA and QMIX.  The MEDA env on the card (the kernel) against
# the CPU (the plain step) at each MEDA_KERNEL_B (rewards: float32 sums of
# the same terms, one order); the MEDA actor's rate at MEDA_ACTOR_B chips,
# one launch a step; the JAX package's MEDA and QMIX policies held
# to artifacts/README.md's rates less SUCCESS_SLACK; training at the CLI's
# widths for a few cycles; the QMIX learner on the card against the CPU at
# a minibatch of QMIX_LEARN_BATCH episodes (the CPU's share of the time);
# a MEDA sweep
MEDA_REWARD_ATOL = 1e-6
MEDA_ACTOR_B = 8192
MEDA_WALL_STEPS = 20
MEDA_VDN = "meda_30x60_4d_fov19_vdn"
MEDA_TRAINED = [
    # (name, export, CLI, recorded success)
    ("meda_vdn_30x60_4d", MEDA_VDN, ["meda", "--drop_num=4"], 0.96),
    ("meda_vdn_30x60_2d", "meda_30x60_2d_fov19_vdn",
     ["meda", "--drop_num=2"], 1.00),
    ("meda_vdn_30x60_3d", "meda_30x60_3d_fov19_vdn",
     ["meda", "--drop_num=3"], 1.00),
    # the 4-droplet seed-12 policy zero-shot on larger boards
    # (RESULTS.md:419-420)
    ("meda_vdn_45x90_4d", "meda_30x60_4d_4m_s12",
     ["meda", "--drop_num=4", "--width=45", "--length=90"], 1.00),
    ("meda_vdn_60x120_4d", "meda_30x60_4d_4m_s12",
     ["meda", "--drop_num=4", "--width=60", "--length=120"], 0.94),
    # JAX's largest configuration: 80x80 (T = 160), 10 droplets
    ("meda_vdn_80x80_10d", "meda_80x80_10d_fov19_vdn",
     ["meda", "--drop_num=10"], 0.94),
    ("meda_qmix_30x60_3d", "meda_30x60_3d_fov19_qmix",
     ["meda", "--drop_num=3", "--alg=qmix"], 0.98),
    # JAX's MEDA 3-droplet recipe trained from scratch by the port on the
    # card (the CLI's seed), its newest checkpoint: its independent_final
    # in marl_dmfb_tpu_torch/artifacts/time_to_quality.json
    ("meda_vdn_30x60_3d_port", "meda_30x60_3d_fov19_vdn_torch",
     ["meda", "--drop_num=3"], 0.95),
    ("dmfb_qmix_20x20", "dmfb_20x20_4d_fov9_qmix",
     ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=20", "--alg=qmix"],
     1.00),
    # the 20x20 mixer does not fit 50x50: dropped, the agent evaluated
    ("dmfb_qmix_50x50", "dmfb_20x20_4d_fov9_qmix",
     ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=50", "--alg=qmix"],
     0.98),
    # and on 10x10 (artifacts/README.md's 100-task rate), over 500 tasks
    ("dmfb_qmix_10x10", "dmfb_20x20_4d_fov9_qmix",
     ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=10", "--alg=qmix"],
     0.89),
    # the QMIX flagship trained from scratch by the port on the card (the
    # CLI's seed, unbroken to 1.4M env steps), its newest checkpoint: its
    # rates in marl_dmfb_tpu_torch/artifacts/time_to_quality.json (20x20
    # over 500 tasks); on 50x50 the port's own 20x20 mixer is dropped
    ("dmfb_qmix_20x20_port", "dmfb_20x20_4d_fov9_qmix_torch",
     ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=20", "--alg=qmix"],
     0.968),
    ("dmfb_qmix_50x50_port", "dmfb_20x20_4d_fov9_qmix_torch",
     ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=50", "--alg=qmix"],
     0.97),
]
MEDA_QMIX_TRAIN = [
    # (name, CLI, env steps, (conv, hidden, batch, replay, B, updates a
    # cycle, mixer state))
    ("meda_vdn_4d", ["meda", "--drop_num=4"], 4000,
     (32, 128, 64, 10000, 10, 2, None)),
    ("dmfb_qmix_20x20", ["dmfb", "--alg=qmix", "--chip_size=20",
                         "--drop_num=4", "--fov=9"], 1200,
     (24, 128, 128, 5000, 2, 1, 1200)),
]
QMIX_LEARN_BATCH = 8
# the QMIX learners held card against CPU: MEDA 30x60-3d and the DMFB QMIX
# flagship's (20x20-4d, fov 9: a state of 1200 values), each at the CLI's
# widths (qmix_hidden_dim, hyper_hidden_dim, two hyper layers)
QMIX_LEARNERS = [
    ("MEDA 30x60-3d", ["meda", "--drop_num=3", "--alg=qmix"]),
    ("DMFB 20x20-4d", ["dmfb", "--chip_size=20", "--drop_num=4", "--fov=9",
                       "--alg=qmix"]),
]
# a DMFB QMIX rollout (20x20-4d, epsilon QMIX_ROLLOUT_EPS) of the port's
# QMIX export through the tile kernel and through the plain step, from the
# same chips and draws; and that export's 10x10 rate over LOW_RATE_TASKS
# tasks, printed as a reading without a floor (10x10 is a zero-shot board
# whose rate wanders between seeds and checkpoints by more than the slack)
QMIX_ROLLOUT_B = 64
QMIX_ROLLOUT_EPS = 0.3
QMIX_PORT = "dmfb_20x20_4d_fov9_qmix_torch"
MEDA_SWEEP = dict(epochs=2, tasks=20)
# phase 8: the seed farm at the main config's widths, cut to about 3 cycles
# (a failed episode counts T = 40 steps, so a cycle counts at most 64 x 40
# per seed); the resume check at a small width (8 chips a rollout, rings of
# 64, minibatches of 16: 4 updates a cycle, evaluations every 600 steps)
FARM_S = 4
FARM_B = 64
FARM_STEPS = 3 * FARM_B * 40
FARM_ARGV = ["dmfb", "--drop_num=4", "--fov=9", f"--n_parallel_envs={FARM_B}",
             "--evaluate_task=100"]
FARM_RESUME_ARGV = ["dmfb", "--drop_num=4", "--fov=9", f"--vmap_seeds={FARM_S}",
                    "--n_parallel_envs=8", "--buffer_size=64",
                    "--batch_size=16", "--evaluate_task=20",
                    "--evaluate_cycle=600", "--ckpt_replay"]
FARM_RESUME_STEPS = (900, 1500)   # the stopped run's budget, the full one
FARM_TIMED_CYCLES = 1   # a full-width farm cycle takes seconds
ROUTER_TASKS = 100
# phase 9: data parallelism at the main config's widths (B = 64 chips a
# cycle over the ranks, batch 128, replay 5000, 32 updates a cycle), cut to
# MESH_CYCLES cycles; held to the one-device run as phase 5 holds the card
# to the CPU: the first LEARN_UPDATES updates' losses within LOSS_RTOL, the
# params after them within PARAM_ATOL outside noise gradients
MESH_B = 64
MESH_CYCLES = 3
MESH_ARGV = ["dmfb", "--drop_num=4", "--fov=9", f"--n_parallel_envs={MESH_B}",
             "--evaluate_task=100"]
# phase 10: the measuring entry points at their full widths, only their
# iteration counts cut: the actor at B = 16384 (DMFB, MEDA, bf16), the
# training loop at B = 1024 (512 updates a cycle: the cycle that fills the
# ring and one timed cycle), the scaling over the visible cards, and the
# rank-count comparison where 4 cards are visible
BENCH_ACTOR = (["16384"], ["16384", "0", "meda"],
               ["16384", "0", "dmfb", "bf16"])
BENCH_ACTOR_ITERS = 3
BENCH_TRAIN_B = 1024
BENCH_LEARN_ITERS = 10
BENCH_SCALING_ITERS = 3
BENCH_MULTIPROC_CARDS = 4

# phase 11: the wide kernel.  Shapes held to the plain version, (width,
# droplets, blocks, B); shapes timed, (width, droplets, B), at least the B
# whose byte bound is some 50 us; the plain version timed over PLAIN_ITERS
# calls (it takes milliseconds a call at these shapes)
WIDE_CMP = [(20, 20, 2, 1024), (10, 13, 0, 1024), (50, 64, 0, 256),
            (40, 130, 0, 64), (200, 4, 2, 64), (160, 4, 0, 64),
            (160, 10, 2, 64), (10, 4, 2, 4096),
            # the group layout's edges: droplet counts at the cuts of its
            # chips a group (7, 4, 3, 2, 1 at 128 pairs) with a short last
            # group; a short last group at the timed shape; either side of
            # the cut between the two layouts at 4 droplets
            (20, 17, 2, 1001), (20, 32, 2, 1001), (20, 33, 0, 1001),
            (30, 64, 2, 1001), (30, 65, 0, 1001), (20, 20, 2, 16387),
            (97, 4, 2, 64), (98, 4, 2, 64)]
WIDE_TIMED = [(20, 20, 16384), (10, 13, 16384), (50, 64, 4096),
              (160, 4, 1024), (200, 4, 1024)]
PLAIN_ITERS = 4
FLAGSHIP = os.path.join(WEIGHTS, "dmfb_20x20_4d_fov9_vdn_b64")
WIDE_EVAL = [  # (name, drop_num, board, tasks)
    ("20x20_20d", 20, 20, 100), ("200x200_4d", 4, 200, 4)]
WIDE_GREEDY_B = 16
# training at 160x160 (T = 640) at the CLI's nets: 8 chips a rollout (4
# updates a cycle), a ring of 32 episodes (20 MB of observations) and
# minibatches of 8, 2 cycles
WIDE_TRAIN_B = 8
WIDE_TRAIN_ARGV = ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=160",
                   f"--n_parallel_envs={WIDE_TRAIN_B}", "--buffer_size=32",
                   "--batch_size=8", f"--exact_steps={2 * WIDE_TRAIN_B * 640}",
                   f"--evaluate_task={WIDE_TRAIN_B}", ONE_DEVICE]
# phase 13: JAX's largest configuration at the CLI's widths: MEDA 80x80
# (T = 160), 10 droplets, a ring of 10,000 episodes (16,660 MiB of
# observations), batch 128, 2 chips a rollout; without --remat, then with
# it (JAX trained it only with --remat and a 2,500-episode ring, on 16 GB).
# 960 env steps are 3 cycles when every episode runs to T.  The update with
# --remat against the one without on the card, one minibatch: the loss
# within LOSS_RTOL, the gradients within REMAT_GRAD_ATOL times their global
# norm (the learner tests' tolerance, tests/torch_learn_util.py)
MEDA_80X80_TRAIN = [
    ("meda_vdn_80x80_10d", ["meda", "--drop_num=10"], 960,
     (32, 128, 128, 10000, 2, 2, None)),
    ("meda_vdn_80x80_10d_remat", ["meda", "--drop_num=10", "--remat"], 960,
     (32, 128, 128, 10000, 2, 2, None)),
]
REMAT_GRAD_ATOL = 1e-6
# phase 12: learning from scratch.  DMFB 10x10-2d, fov 9, VDN, the lr-decay
# + EMA recipe at the CLI's widths (the 2-droplet hyperparameters: 32 conv
# channels, GRU 128, batch 128, replay 5000; B = 64 chips a rollout, 13
# updates a cycle) for LEARN_STEPS env steps; checkpoint 0
# and the final checkpoint scored greedy over 100 tasks on 10x10 through the
# evaluate entry point: the first at most LEARN_UNTRAINED_MAX, the second at
# least LEARN_TRAINED_MIN, the phase within LEARN_MAX_S seconds
LEARN_STEPS = 200000
LEARN_ARGV = ["dmfb", "--drop_num=2", "--fov=9", "--n_parallel_envs=64",
              "--lr_decay", "--param_ema=0.999",
              f"--exact_steps={LEARN_STEPS}", "--evaluate_cycle=50000",
              ONE_DEVICE]
LEARN_UNTRAINED_MAX = 0.10
LEARN_TRAINED_MIN = 0.80
LEARN_MAX_S = 240.0


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


def bound(dmfb_step, params, batch, observe=True):
    """(bound_ms, bound_by, bytes, ops) of one step of ``batch`` chips: the
    least bytes (``dmfb_step.min_bytes``) over the HBM rate against the
    integer operations over the scalar rate: 4 per distance test (2 kinds
    per droplet pair), one per observation byte (none in the
    no-observation mode) and per usage cell."""
    n = params.n_droplets
    if observe:
        n_bytes = dmfb_step.min_bytes(params, batch)
    else:
        n_bytes = dmfb_step.min_bytes(params, batch, observe=False)
    obs_row = 3 * params.fov * params.fov + 2 if observe else 0
    n_ops = batch * (8 * n * (n - 1) + n * obs_row
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


@contextlib.contextmanager
def forced(dmfb_step, kernel):
    """Within the block ``dmfb_step``'s wrappers launch ``kernel``
    (``"tile"`` or ``"wide"``) whatever the shape; None: their own choice."""
    choose = dmfb_step.kernel_for
    if kernel is not None:
        dmfb_step.kernel_for = lambda params, observe=True: kernel
    try:
        yield
    finally:
        dmfb_step.kernel_for = choose


def compare_kernel(tdmfb, dmfb_step, params, batch, generator,
                   observe=True, kernel=None, state=None, reference=None):
    """Three chained steps from ``state`` (default: ``random_states``), the
    kernel that ``kernel`` names (default: ``kernel_for``'s choice) vs
    ``reference`` (default: the plain version; the transition alone without
    ``observe``); returns the largest absolute difference over all
    outputs."""
    s = random_states(tdmfb, params, batch, generator) if state is None \
        else state
    worst = 0.0
    step = dmfb_step.step_batch if observe else dmfb_step.transition_batch
    plain = reference or (tdmfb.step_core if observe else tdmfb.transition)
    outs = ("obs",) * observe + ("dones", "terminated", "constraints",
                                 "success", "rewards", "team_reward")
    for _ in range(3):
        a, u = step_inputs(params, batch, generator)
        with forced(dmfb_step, kernel):
            sk, ok = step(params, s, a, u)
        sp, op = plain(params, s, a, u)
        torch.cuda.synchronize()
        if not observe and ok.obs is not None:
            raise AssertionError("the no-observation mode wrote observations")
        for name, x, y in (
                [(f, getattr(sk, f), getattr(sp, f)) for f in
                 ("pos", "dist", "usage", "step_count", "cum_constraints")]
                + [(f, getattr(ok, f), getattr(op, f)) for f in outs]):
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


def degraded_meda_states(tmeda, params, batch, generator):
    """MEDA chips from ``init`` on electrodes of health uniform in
    [0.5, 1), their usage boards at integers up to 60, a quarter of the
    droplets already on their goals and step counts spread over the
    episode, so that failed moves, snaps, finished droplets and the step
    limit all occur."""
    s = tmeda.init(params, batch, generator, "cuda")
    at_goal = torch.rand((batch, params.n_droplets), generator=generator,
                         device="cuda") < 0.25
    return s._replace(
        status=at_goal,
        health=torch.rand(s.health.shape, generator=generator,
                          device="cuda") * 0.5 + 0.5,
        usage=torch.randint(0, 61, s.usage.shape, generator=generator,
                            device="cuda").float(),
        step_count=torch.randint(0, params.max_step, (batch,),
                                 generator=generator, device="cuda",
                                 dtype=torch.int32))


def meda_step_inputs(params, batch, generator):
    """Actions in [-1, 10) (those outside [0, 9) move nothing) and
    move-success draws."""
    n = params.n_droplets
    a = torch.randint(-1, 10, (batch, n), generator=generator, device="cuda",
                      dtype=torch.int32)
    u = torch.rand((batch, n), generator=generator, device="cuda")
    return a, u


def compare_meda_kernel(tmeda, meda_step, params, batch, generator) -> float:
    """Three chained steps of the MEDA kernel against the plain
    ``step_core`` on the card from ``degraded_meda_states``: every state
    field and output bitwise but the team reward, within
    ``MEDA_TEAM_ATOL``; returns its largest difference."""
    ks = ps = degraded_meda_states(tmeda, params, batch, generator)
    worst = 0.0
    for t in range(3):
        a, u = meda_step_inputs(params, batch, generator)
        before = meda_step.launches
        ks, ko = meda_step.step_batch(params, ks, a, u)
        ps, po = tmeda.step_core(params, ps, a, u)
        torch.cuda.synchronize()
        if meda_step.launches != before + 1:
            raise AssertionError("the MEDA step did not launch the kernel")
        for name, x, y in ([(f, getattr(ks, f), getattr(ps, f))
                            for f in tmeda.MEDAState._fields]
                           + [(f, getattr(ko, f), getattr(po, f)) for f in
                              ("obs", "rewards", "dones", "terminated",
                               "constraints", "success")]):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"MEDA kernel step {t}: {name} differs from the plain "
                    f"step ({int((x != y).sum())} elements)")
        diff = float((ko.team_reward - po.team_reward).abs().max())
        worst = max(worst, diff)
        if not diff <= MEDA_TEAM_ATOL:
            raise AssertionError(f"MEDA kernel step {t}: team reward differs "
                                 f"by {diff}")
    return worst


def meda_bound_bytes(params, batch) -> int:
    """Least bytes one MEDA step of ``batch`` chips moves: the usage board
    read and written, the observations written, one 32-byte sector of
    health a footprint row (5 a droplet), and the small state read
    (center, destination, distance, status, action, draw; two counters)
    and written (center, distance, status, reward, done; six per chip)."""
    n, wl = params.n_droplets, params.width * params.length
    obs = params.obs_dim * (1 if params.obs_version == "v0.2" else 4)
    small = 29 * n + 8 + 18 * n + 21
    return batch * (8 * wl + n * obs + 5 * 32 * n + small)


def time_meda_kernel(tmeda, meda_step, params, batch, generator) -> dict:
    """Device ms of the MEDA kernel and of the plain step at ``batch``
    (``device_ms``: a CUDA graph, inputs rotated), the wall ms of chained
    synchronised calls of each (the host's share at a small batch), and
    the byte bound at 3.35 TB/s."""
    sets = [(degraded_meda_states(tmeda, params, batch, generator),
             *meda_step_inputs(params, batch, generator)) for _ in range(4)]
    out = {"batch": batch}
    for name, fn in (("kernel", meda_step.step_batch),
                     ("plain", tmeda.step_core)):
        out[f"{name}_ms"] = device_ms(
            [lambda x=x: fn(params, *x) for x in sets])
        st = sets[0][0]
        for _ in range(3):
            st = fn(params, st, *sets[0][1:])[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MEDA_WALL_STEPS):
            st = fn(params, st, *sets[i % 4][1:])[0]
        torch.cuda.synchronize()
        out[f"{name}_wall_ms"] = ((time.perf_counter() - t0)
                                  / MEDA_WALL_STEPS * 1e3)
    out["bound_bytes"] = meda_bound_bytes(params, batch)
    out["bound_ms"] = out["bound_bytes"] / PEAK_BYTES_PER_S * 1e3
    return out


def greedy_card_vs_cpu(env, net, hidden, chips, seed, worn=False) -> int:
    """The same greedy rollout of ``net`` on the card (the kernels) and on
    the CPU (the plain step), from the same ``chips`` fresh tasks and move
    draws (with ``worn``, the second half of the chips on electrodes of
    health uniform in [0.5, 1), as a degradation sweep wears them); returns
    the episodes whose observations and success are identical.  Leaves
    ``net`` on the CPU."""
    from marl_dmfb_tpu_torch.rollout import RolloutNoise, make_rollout

    T = env.episode_limit
    gc = torch.Generator(device="cuda").manual_seed(seed)
    reset = env.reset(env.init(chips, gc, "cuda"), gc)
    if worn:
        health = reset.health.clone()
        health[chips // 2:] = torch.rand(health[chips // 2:].shape,
                                         generator=gc, device="cuda") \
            * 0.5 + 0.5
        reset = reset._replace(health=health)
    uniforms = torch.rand((T, chips, env.n_agents), generator=gc,
                          device="cuda")
    res = {}
    for dev in ("cuda", "cpu"):
        start = type(reset)(*(x.to(dev) for x in reset))
        denv = env._replace(reset=lambda s, gen: start)
        roll = make_rollout(denv, net.to(dev), hidden)
        res[dev] = roll(start, None, 0.0, 0.0, 0.0, greedy=True,
                        noise=RolloutNoise(None, None, uniforms.to(dev)))
    same = (res["cuda"].episodes["o_ext"].cpu()
            == res["cpu"].episodes["o_ext"]).flatten(1).all(1)
    same &= res["cuda"].success.cpu() == res["cpu"].success
    return int(same.sum())


def compare_learner(make_learner, state, batch, updates=None, make_ref=None):
    """``updates`` (default ``LEARN_UPDATES``) updates of one learner state
    on one minibatch, on the card and on a reference: ``make_learner(
    device)`` builds a learner there, the reference on the CPU, or
    ``make_ref("cuda")`` where given (another learner on the card).
    Returns the largest loss difference relative to the reference's, the
    largest param difference (the agent's and a mixer's) outside the
    reference's noise gradients and in all, and the card's learner."""
    if make_ref is None:
        ref = make_learner("cpu")
        ref_batch = {k: v.cpu() for k, v in batch.items()}
    else:
        ref, ref_batch = make_ref("cuda"), batch
    card = make_learner("cuda")
    ref.load_state(state)
    card.load_state(state)
    noisy = {k: torch.zeros(v.shape, dtype=torch.bool, device=v.device)
             for k, v in ref.all_params.items()}
    loss_rel = 0.0
    for _ in range(updates or LEARN_UPDATES):
        _, grads = ref.loss_and_grads(ref_batch)
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values()))
        for k, g in grads.items():
            noisy[k] |= g.abs() <= NOISE * norm
        want = float(ref.update(ref_batch))
        got = float(card.update(batch))
        if not math.isfinite(got):
            raise AssertionError(f"the card's loss is {got}")
        loss_rel = max(loss_rel, abs(got - want) / abs(want))
    clean = worst = 0.0
    for k, p in ref.all_params.items():
        diff = (card.all_params[k].detach().cpu() - p.detach().cpu()).abs()
        noisy[k] = noisy[k].cpu()
        kept = diff[~noisy[k]]
        clean = max(clean, float(kept.max()) if kept.numel() else 0.0)
        worst = max(worst, float(diff.max()))
    return loss_rel, clean, worst, card


def time_updates(learner, batch) -> tuple:
    """ms of an update of ``learner`` on ``batch`` (CUDA events over
    ``TIMED_UPDATES`` updates, after one), and the MiB that an update
    allocates at its peak."""
    learner.update(batch)
    torch.cuda.synchronize()
    base = run_memory_start()
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record()
    for _ in range(TIMED_UPDATES):
        learner.update(batch)
    end_ev.record()
    end_ev.synchronize()
    return start_ev.elapsed_time(end_ev) / TIMED_UPDATES, run_peak_mib(base)


def _agent_rows(rows, generator):
    """Rows of the CRNN's flat input (integer pixels, an integer direction,
    a last-action one-hot) and hidden states."""
    x = torch.cat([
        torch.randint(0, 5, (rows, 3 * 81), generator=generator),
        torch.randint(-6, 7, (rows, 2), generator=generator),
        torch.nn.functional.one_hot(
            torch.randint(0, 5, (rows,), generator=generator), 5)],
        dim=1).float()
    return x, torch.randn((rows, 128), generator=generator) * 0.5


def card_vs_cpu_bf16(net_cls, params, generator):
    """A bf16 CRNN forward of ``BF16_ROWS`` random rows on the card and on
    the CPU from the same weights (the bf16 export's) and inputs; returns
    the largest differences of the Q-values and the hidden states, the
    greedy actions' agreement, and the card's device time of a forward of
    ``BF16_TIMED_ROWS`` rows in bf16 and in float32 (CUDA graphs,
    ``device_ms``)."""
    rows = BF16_ROWS
    x, h = _agent_rows(rows, generator)
    nets = {}
    for dtype in (torch.bfloat16, None):
        for dev in ("cpu", "cuda"):
            net = net_cls(5, 3, 9, 24, compute_dtype=dtype)
            net.load_state_dict(params)
            nets[dtype, dev] = net.to(dev).eval()
    with torch.no_grad():
        q_cpu, h_cpu = nets[torch.bfloat16, "cpu"](x, h)
        q_card, h_card = nets[torch.bfloat16, "cuda"](x.cuda(), h.cuda())
    q_card, h_card = q_card.cpu(), h_card.cpu()
    xc, hc = (t.cuda() for t in _agent_rows(BF16_TIMED_ROWS, generator))
    ms = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (None, "float32")):
        net = nets[dtype, "cuda"]
        with torch.no_grad():
            ms[name] = device_ms([lambda n=net: n(xc, hc)], iters=20)
    return dict(
        q_diff=float((q_card - q_cpu).abs().max()),
        h_diff=float((h_card - h_cpu).abs().max()),
        action_agreement=float(
            (q_card.argmax(1) == q_cpu.argmax(1)).float().mean()),
        rows=rows, timed_rows=BF16_TIMED_ROWS, bf16_ms=ms["bf16"],
        float32_ms=ms["float32"])


def trained_policies(smi) -> dict:
    """Phase 6: the JAX package's trained policies on the card (module
    docstring); raises on any failed check, returns the numbers."""
    from marl_dmfb_tpu_torch import evaluate
    from marl_dmfb_tpu_torch.checkpoint import load
    from marl_dmfb_tpu_torch.config import (get_evaluate_args,
                                            make_env_from_args)
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.models.networks import CRNNAgent
    from marl_dmfb_tpu_torch.ops import dmfb_step
    from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config

    t6 = time.perf_counter()
    out = {"policies": {}, "phase_s": {}}
    launches_no_obs = 0
    for name, export, board, flags, recorded in TRAINED:
        t0 = time.perf_counter()
        tasks = eval_tasks(recorded)
        argv = (["dmfb", "--drop_num=4", "--fov=9", f"--chip_size={board}",
                 f"--evaluate_task={tasks}", "--load_model_name=0_final",
                 f"--data_dir={os.path.join(WEIGHTS, export)}"] + flags)
        dmfb_step.launches = dmfb_step.launches_no_obs = 0
        dmfb_step.launches_wide = 0
        m = evaluate.main(argv)
        launches, no_obs = dmfb_step.launches, dmfb_step.launches_no_obs
        args = get_evaluate_args(argv)
        restore_net_config(args, "final")
        env = make_env_from_args(args)
        T = env.episode_limit
        v01 = args.version == "0.1"
        if launches != T or no_obs != (T if v01 else 0) \
                or dmfb_step.launches_wide:
            raise AssertionError(
                f"{name}: {launches} kernel launches ({no_obs} without "
                f"observations), expected T = {T}"
                + (" without observations" if v01 else "")
                + f"; the wide kernel {dmfb_step.launches_wide}")
        launches_no_obs += no_obs
        # the tile kernel's instantiation (csrc/dmfb_step.cu:698-704)
        n = args.drop_num
        inst = 4 if n <= 4 else 8 if n <= 8 else 16
        floor = recorded - SUCCESS_SLACK
        seconds = time.perf_counter() - t0
        log(f"phase 6: [{smi}] {name} ({export}, {board}x{board}"
            f"{', ' + ' '.join(flags) if flags else ''}, {tasks} tasks): "
            f"success {m['success_rate']:.3f} (recorded {recorded:.3f}, "
            f"floor {floor:.3f}), steps {m['steps']:.2f}, reward "
            f"{m['reward']:.4f}, kernel launches {launches} "
            f"({no_obs} without observations), tile kernel instantiation "
            f"{inst} droplets, {env.params.n_blocks} blocks, "
            f"{seconds:.2f} s")
        if not m["success_rate"] >= floor - 1e-9:
            raise AssertionError(f"{name}: success {m['success_rate']} "
                                 f"below {floor}")
        out["policies"][name] = dict(m, recorded=recorded, floor=floor,
                                     tasks=tasks, launches=launches,
                                     instantiation=inst,
                                     blocks=env.params.n_blocks,
                                     seconds=seconds)
        if name in GREEDY_CMP:
            t0 = time.perf_counter()
            policy = Trainer(env, args, eval_only=True)
            policy.load_model("final", params_only=True)
            same = greedy_card_vs_cpu(env, policy.net.eval(),
                                      args.rnn_hidden_dim, GREEDY_B, 61,
                                      worn=True)
            log(f"phase 6: greedy rollout of {name}, {GREEDY_B} chips (half "
                f"worn), card vs CPU: {same}/{GREEDY_B} episodes identical, "
                f"{time.perf_counter() - t0:.2f} s")
            if same != GREEDY_B:
                raise AssertionError(f"the card's rollout of {name} departs "
                                     f"from the CPU's")
            out["policies"][name]["greedy_card_vs_cpu"] = same
    out["launches_no_obs"] = launches_no_obs

    # the no-observation mode (a v0.1 step's transition) against its plain
    # version, and its times, at the v0.1 policy's configuration
    t0 = time.perf_counter()
    p = tdmfb.DMFBParams(width=10, length=10, n_droplets=2, fov=9,
                         obs_version="v0.1")
    g = torch.Generator(device="cuda").manual_seed(606)
    no_obs = {"max_abs_err": 0.0}
    for batch in (KERNEL_B, EVAL_B):
        err = compare_kernel(tdmfb, dmfb_step, p, batch, g, observe=False)
        no_obs["max_abs_err"] = max(no_obs["max_abs_err"], err)
        sets = [(random_states(tdmfb, p, batch, g), *step_inputs(p, batch, g))
                for _ in range(4)]
        ms = device_ms([lambda x=x: dmfb_step.transition_batch(p, *x)
                        for x in sets])
        plain_ms = device_ms([lambda x=x: tdmfb.transition(p, *x)
                              for x in sets])
        bound_ms, bound_by, n_bytes, n_ops = bound(dmfb_step, p, batch,
                                                   observe=False)
        no_obs[batch] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, share=bound_ms / ms,
                             tile=dmfb_step.tile_chips(p, batch, False))
        log(f"phase 6: [{smi}] dmfb_step without observations, 10x10, 2 "
            f"droplets, B={batch} ({no_obs[batch]['tile']} chips a tile): "
            f"== plain transition over 3 steps (max |diff| {err:.3g}); "
            f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}: {n_bytes} bytes, "
            f"{n_ops} ops), {100 * bound_ms / ms:.1f}% of the bound")
    out["no_obs"] = no_obs
    out["phase_s"]["no_obs"] = time.perf_counter() - t0

    # bf16 on the card against the CPU, and its time beside float32
    t0 = time.perf_counter()
    tree = load(os.path.join(WEIGHTS, "dmfb_20x20_4d_bf16", "model", "vdn",
                             "fov9", "0_final_state.npz"))
    bf16 = card_vs_cpu_bf16(CRNNAgent, tree["ema"]["agent"],
                            torch.Generator().manual_seed(16))
    log(f"phase 6: [{smi}] bf16 CRNN forward of {bf16['rows']} rows, card "
        f"vs CPU: Q max |diff| {bf16['q_diff']:.3g} (<= {BF16_Q_ATOL}), h "
        f"{bf16['h_diff']:.3g} (<= {BF16_H_ATOL}), greedy actions agree on "
        f"{bf16['action_agreement']:.4f}; device time of a forward of "
        f"{bf16['timed_rows']} rows {bf16['bf16_ms']:.3f} ms in bf16, "
        f"{bf16['float32_ms']:.3f} ms in float32")
    if not (bf16["q_diff"] <= BF16_Q_ATOL and bf16["h_diff"] <= BF16_H_ATOL):
        raise AssertionError("the bf16 forward on the card departs from the "
                             "CPU's")
    out["bf16_forward"] = bf16
    out["phase_s"]["bf16"] = time.perf_counter() - t0

    # the degradation sweeps at 50x50: the 10x10-4d policy, and the
    # 10-droplet policy held to JAX's first epochs of 50by50-10d0b
    t0 = time.perf_counter()
    out["sweep"] = dmfb_sweep(smi, "dmfb_10x10_4d_fov9_vdn", 4, SWEEP,
                              "chip_smoke_sweep")
    out["phase_s"]["sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep = dmfb_sweep(smi, SWEEP_10D["export"], 10, SWEEP_10D,
                       "chip_smoke_sweep_10d")
    mean = float(np.mean(sweep["success_per_epoch"]))
    floor = SWEEP_10D_JAX - SUCCESS_SLACK
    log(f"phase 6: [{smi}] 10-droplet sweep: mean success {mean:.3f} (JAX "
        f"{SWEEP_10D_JAX:.3f} over its first {SWEEP_10D['epochs']} epochs, "
        f"floor {floor:.3f})")
    if not mean >= floor - 1e-9:
        raise AssertionError(f"the 10-droplet sweep's success {mean} is "
                             f"below {floor}")
    out["sweep_10d"] = dict(sweep, mean=mean, jax=SWEEP_10D_JAX, floor=floor)
    out["phase_s"]["sweep_10d"] = time.perf_counter() - t0
    out["phase_s"]["total"] = time.perf_counter() - t6
    log(f"phase 6: {out['phase_s']['total']:.2f} s")
    return out


def dmfb_sweep(smi, export, drop_num, sweep, run) -> dict:
    """``eva_degrade`` of the committed export ``export`` with ``drop_num``
    droplets on a ``sweep['board']`` board, ``sweep['epochs']`` epochs x
    ``sweep['tasks']`` tasks, under ``build/<run>``: the kernel launched T
    times an episode, wear that never goes back; returns the numbers."""
    from marl_dmfb_tpu_torch import eva_degrade
    from marl_dmfb_tpu_torch.ops import dmfb_step

    t0 = time.perf_counter()
    data_dir = os.path.join(ROOT, "build", run)
    shutil.rmtree(data_dir, ignore_errors=True)
    model = os.path.join(data_dir, "model", "vdn", "fov9")
    os.makedirs(model)
    shutil.copy(os.path.join(WEIGHTS, export, "model", "vdn", "fov9",
                             "0_final_state.npz"), model)
    dmfb_step.launches = dmfb_step.launches_wide = 0
    res = eva_degrade.main(
        ["dmfb", f"--drop_num={drop_num}", "--fov=9",
         f"--chip_size={sweep['board']}", f"--evaluate_task={sweep['tasks']}",
         f"--evaluate_epoch={sweep['epochs']}", f"--data_dir={data_dir}"])
    launches = dmfb_step.launches
    T = 4 * sweep["board"]
    if launches != sweep["epochs"] * sweep["tasks"] * T \
            or dmfb_step.launches_wide:
        raise AssertionError(f"the sweep launched the tile kernel {launches} "
                             f"times, the wide kernel "
                             f"{dmfb_step.launches_wide}")
    health, usage = res["health"], res["usage"]
    # health never rises; usage never falls, except on a cell that just
    # wore out (its counter restarts as its health drops)
    worn = np.diff(health, axis=1) < 0
    if (np.diff(health, axis=1) > 0).any() or \
            ((np.diff(usage, axis=1) < 0) & ~worn).any():
        raise AssertionError("the sweep's wear went backwards")
    per_epoch = res["success"].mean(axis=0).tolist()
    seconds = time.perf_counter() - t0
    log(f"phase 6: [{smi}] degradation sweep of {export}, {drop_num} "
        f"droplets, {sweep['board']}x{sweep['board']}, 5 chips, "
        f"{sweep['epochs']} epochs x {sweep['tasks']} tasks: success per "
        f"epoch {per_epoch}, steps per epoch "
        f"{res['steps'].mean(axis=0).tolist()}, cells worn "
        f"{int(worn.sum())}, usage total {float(usage[:, -1].sum())}, kernel "
        f"launches {launches} at B = 5, {seconds:.2f} s")
    return dict(success_per_epoch=per_epoch, launches=launches,
                seconds=seconds)


def remat_vs_plain(learner, batch, smi) -> dict:
    """The loss and gradients of ``learner``'s state on ``batch`` under
    ``--remat`` against those without, both on the card; raises unless the
    loss is within ``LOSS_RTOL`` and every gradient within
    ``REMAT_GRAD_ATOL`` times the global norm."""
    from marl_dmfb_tpu_torch.algos.qlearn import QLearner
    from marl_dmfb_tpu_torch.models.networks import build_agent_net

    a = dataclasses.replace(learner.args, remat=True)
    remat = QLearner(a, build_agent_net(a).cuda())
    remat.load_state(learner.state())
    loss, grads = learner.loss_and_grads(batch)
    grads = {k: g.detach().clone() for k, g in grads.items()}
    r_loss, r_grads = remat.loss_and_grads(batch)
    loss_rel = abs(r_loss.item() - loss.item()) / abs(loss.item())
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads.values())))
    grad_diff = max(float((r_grads[k] - g).abs().max())
                    for k, g in grads.items())
    log(f"phase 13: [{smi}] MEDA 80x80-10d update on one minibatch of "
        f"{len(batch['u'])} episodes, --remat vs without on the card: loss "
        f"rel diff {loss_rel:.3g} (<= {LOSS_RTOL}), gradients max diff "
        f"{grad_diff:.3g} (<= {REMAT_GRAD_ATOL} x the norm {norm:.4g})")
    if not (loss_rel <= LOSS_RTOL and grad_diff <= REMAT_GRAD_ATOL * norm):
        raise AssertionError("--remat departs from the update without it")
    return dict(loss_rel=loss_rel, grad_diff=grad_diff, grad_norm=norm)


def _toward(center, dest, rng_u, rand_a):
    """MEDA actions: the move toward the goal, or ``rand_a`` where
    ``rng_u`` < 0.4 (so that droplets reach their goals and snap)."""
    d = (dest - center).sign() + 1                   # (B, N, 2) in {0, 1, 2}
    table = torch.tensor([[7, 3, 6], [0, 8, 2], [4, 1, 5]], dtype=torch.int32)
    toward = table[d[..., 0].long(), d[..., 1].long()]
    return torch.where(rng_u < 0.4, rand_a, toward)


def run_memory_start() -> int:
    """Reset the peak-memory count; returns the bytes allocated now, which
    a run's own peak is read above (earlier phases may hold tensors)."""
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def run_peak_mib(base: int) -> float:
    """MiB that a run allocated at its peak, above ``base``."""
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def meda_card_vs_cpu(tmeda, meda_step, smi) -> float:
    """Full 30x60-4d MEDA episodes through the card's env step (the kernel,
    ``meda_step.step_batch``) and through the plain ``step_core`` on the
    CPU, from the same chips, actions and draws, in each observation
    version at each ``MEDA_KERNEL_B``; half the chips on degraded health.
    State, integer, bool and observation outputs must be bitwise equal,
    rewards within ``MEDA_REWARD_ATOL``, team rewards within
    ``MEDA_TEAM_ATOL``, and the kernel launched once a step.  Returns the
    largest reward difference."""
    worst = 0.0
    g = torch.Generator().manual_seed(707)
    for B, version in ((B, v) for B in MEDA_KERNEL_B
                       for v in ("v0", "v0.1", "v0.2")):
        p = tmeda.MEDAParams(obs_version=version, b_degrade=True,
                             per_degrade=1.0)
        cpu = tmeda.init(p, B, g, "cpu")
        health = cpu.health.clone()
        health[: B // 2] = torch.rand(health[: B // 2].shape,
                                      generator=g) * 0.5 + 0.5
        cpu = cpu._replace(health=health)
        card = type(cpu)(*(t.cuda() for t in cpu))
        before = meda_step.launches
        for t in range(p.episode_limit):
            a = _toward(cpu.center, cpu.dest, torch.rand((B, 4), generator=g),
                        torch.randint(0, 9, (B, 4), generator=g,
                                      dtype=torch.int32))
            u = torch.rand((B, 4), generator=g)
            cpu, oc = tmeda.step_core(p, cpu, a, u)
            card, og = meda_step.step_batch(p, card, a.cuda(), u.cuda())
            for name, x, y in ([(f, getattr(cpu, f), getattr(card, f))
                                for f in tmeda.MEDAState._fields]
                               + [(f, getattr(oc, f), getattr(og, f)) for f in
                                  ("obs", "dones", "terminated",
                                   "constraints", "success")]):
                if not torch.equal(x, y.cpu()):
                    raise AssertionError(
                        f"MEDA {version} B={B} step {t}: {name} differs, "
                        f"kernel vs CPU ({int((x != y.cpu()).sum())} "
                        f"elements)")
            for name, atol in (("rewards", MEDA_REWARD_ATOL),
                               ("team_reward", MEDA_TEAM_ATOL)):
                diff = float((getattr(oc, name) - getattr(og, name).cpu())
                             .abs().max())
                worst = max(worst, diff)
                if not diff <= atol:
                    raise AssertionError(f"MEDA {version} B={B} step {t}: "
                                         f"{name} differs by {diff}")
        launched = meda_step.launches - before
        if launched != p.episode_limit:
            raise AssertionError(f"MEDA {version} B={B}: {launched} kernel "
                                 f"launches in {p.episode_limit} steps")
        log(f"phase 7: [{smi}] MEDA 30x60-4d {version}, B={B}, T="
            f"{p.episode_limit}: kernel on the card == plain step on the CPU "
            f"at every step, {launched} launches (rewards max |diff| "
            f"{worst:.3g}); {int(cpu.status.sum())} droplets on their "
            f"goals, usage total {float(cpu.usage.sum())}")
    return worst


def train_runs(smi, runs, phase, check=None) -> dict:
    """Each ``(name, CLI, env steps, widths)`` of ``runs`` through the train
    entry point (evaluations at the start and the end, 100 tasks each):
    the widths it trained at, at least 3 cycles, its env's kernel (the
    DMFB tile kernel or the MEDA kernel) launched T times a rollout and the
    other never, every loss finite; then an update
    (``time_updates``, with its peak memory) and ``TIMED_CYCLES`` cycles
    timed.  ``check(name, learner, batch)``, where given, runs on each
    run's learner and a minibatch of its ring before the timing.  Returns
    the numbers by name."""
    from marl_dmfb_tpu_torch import train
    from marl_dmfb_tpu_torch.ops import dmfb_step, meda_step
    from marl_dmfb_tpu_torch.replay import sample

    out = {}
    for name, argv, steps, width in runs:
        data_dir = os.path.join(ROOT, "build", f"chip_smoke_{name}")
        shutil.rmtree(data_dir, ignore_errors=True)
        argv = argv + [f"--exact_steps={steps}", "--evaluate_task=100",
                       "--evaluate_cycle=1000000", f"--data_dir={data_dir}",
                       ONE_DEVICE]
        torch.cuda.synchronize()
        base = run_memory_start()
        dmfb_step.launches = meda_step.launches = 0
        t1 = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launches, launches_meda = dmfb_step.launches, meda_step.launches
        peak = run_peak_mib(base)
        a = trainer.args
        got = (a.hyper_hidden_dim, a.rnn_hidden_dim, a.batch_size,
               a.buffer_size, trainer.B, trainer.updates_per_rollout,
               a.state_shape if trainer.mixer is not None else None)
        if got != width:
            raise AssertionError(f"{name} trained at (conv, hidden, batch, "
                                 f"replay, B, updates a cycle, mixer state) "
                                 f"= {got}, expected {width}")
        cycles, evals = trainer.n_cycles, len(trainer.success_rate)
        T = trainer.env.episode_limit
        want = T * (cycles + evals)
        if (launches, launches_meda) != ((want, 0) if a.name == "dmfb"
                                         else (0, want)) \
                or evals != 2 or cycles < 3:
            raise AssertionError(f"{name}: {launches} DMFB and "
                                 f"{launches_meda} MEDA kernel launches in "
                                 f"{cycles} cycles and {evals} evaluations")
        losses = torch.stack(trainer.losses).cpu()
        if not bool(losses.isfinite().all()):
            raise AssertionError(f"{name}: losses {losses.tolist()}")
        learner = trainer.learner
        updates = learner.train_step
        batch = sample(trainer.replay, a.batch_size, trainer.generator)
        if check is not None:
            check(name, learner, batch)
        update_ms, update_peak = time_updates(learner, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(TIMED_CYCLES):
            trainer.train_cycle()
        torch.cuda.synchronize()
        cycle_ms = (time.perf_counter() - t1) / TIMED_CYCLES * 1e3
        replay_mib = sum(v.numel() * v.element_size()
                         for v in trainer.replay.data.values()) / 2 ** 20
        out[name] = dict(
            cycles=cycles, updates=updates, seconds=seconds,
            launches=launches, launches_meda=launches_meda,
            update_ms=update_ms, cycle_ms=cycle_ms,
            peak_mib=peak, update_peak_mib=update_peak,
            replay_mib=replay_mib, remat=bool(a.remat),
            losses=losses.tolist(), success=trainer.success_rate)
        log(f"{phase}: [{smi}] train {' '.join(argv[:4])} ({a.width}x"
            f"{a.length}, T = {T}): {cycles} cycles of B={trainer.B} "
            f"({updates} updates at batch {a.batch_size}) in {seconds:.2f} "
            f"s, kernel launches {launches} DMFB, {launches_meda} MEDA, "
            f"every loss finite; update "
            f"{update_ms:.2f} ms (peak {update_peak:.1f} MiB), cycle "
            f"{cycle_ms:.1f} ms; replay {replay_mib:.1f} MiB, peak memory "
            f"of the run {peak:.1f} MiB; success {trainer.success_rate}")
        # the ring (16,684 MiB at 80x80-10d) goes before the next run's
        del trainer, learner, batch
        torch.cuda.empty_cache()
    return out


def meda_qmix(smi) -> dict:
    """Phase 7: MEDA and QMIX on the card (module docstring); raises on any
    failed check, returns the numbers."""
    from marl_dmfb_tpu_torch import eva_degrade, evaluate
    from marl_dmfb_tpu_torch.config import (get_evaluate_args,
                                            make_env_from_args)
    from marl_dmfb_tpu_torch.envs import meda as tmeda
    from marl_dmfb_tpu_torch.ops import dmfb_step, meda_step
    from marl_dmfb_tpu_torch.rollout import make_rollout
    from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config

    t7 = time.perf_counter()
    out = {"phase_s": {}}

    # 1. the MEDA env, the kernel against the CPU, and the actor's rate
    t0 = time.perf_counter()
    out["env_reward_diff"] = meda_card_vs_cpu(tmeda, meda_step, smi)
    argv = ["meda", "--drop_num=4", "--evaluate_task=2",
            f"--data_dir={os.path.join(WEIGHTS, MEDA_VDN)}"]
    args = get_evaluate_args(argv)
    restore_net_config(args, "final")
    env = make_env_from_args(args)
    policy = Trainer(env, args, eval_only=True)
    policy.load_model("final", params_only=True)
    rollout = make_rollout(env, policy.net, args.rnn_hidden_dim)
    g = torch.Generator(device="cuda").manual_seed(8)
    B = MEDA_ACTOR_B
    chips = rollout(env.init(B, g, "cuda"), g, 1.0, 0.0, 0.05).env_states
    torch.cuda.synchronize()
    base = run_memory_start()
    dmfb_step.launches = meda_step.launches = 0
    t1 = time.perf_counter()
    res = rollout(chips, g, 0.3, 0.0, 0.05)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    T = env.episode_limit
    if dmfb_step.launches or meda_step.launches != T:
        raise AssertionError(f"the MEDA actor launched the DMFB kernel "
                             f"{dmfb_step.launches} times and the MEDA "
                             f"kernel {meda_step.launches}, expected 0 and "
                             f"{T}")
    out["actor"] = dict(B=B, T=T, launches=T, seconds=dt,
                        env_steps_per_s=B * T / dt,
                        executed_per_s=int((~res.episodes["padded"]).sum())
                        / dt, peak_mib=run_peak_mib(base),
                        success=float(res.success.float().mean()))
    log(f"phase 7: [{smi}] MEDA actor (30x60-4d VDN export, epsilon 0.3), "
        f"B={B}, T={T}: {dt * 1e3:.1f} ms, {B * T / dt:.0f} lockstep "
        f"env-steps/s, {out['actor']['executed_per_s']:.0f} executed, "
        f"peak memory {out['actor']['peak_mib']:.1f} MiB, success "
        f"{out['actor']['success']:.3f}, MEDA kernel launches {T}")
    del chips, res, rollout, policy
    out["phase_s"]["env"] = time.perf_counter() - t0

    # 2. the trained policies, greedy over 100 tasks each
    t0 = time.perf_counter()
    out["policies"] = {}
    launches_eval = launches_meda_eval = 0
    for name, export, argv, recorded in MEDA_TRAINED:
        t1 = time.perf_counter()
        tasks = eval_tasks(recorded)
        argv = argv + [f"--evaluate_task={tasks}",
                       f"--data_dir={os.path.join(WEIGHTS, export)}"]
        dmfb_step.launches = dmfb_step.launches_no_obs = 0
        meda_step.launches = 0
        m = evaluate.main(argv)
        launches, launches_meda = dmfb_step.launches, meda_step.launches
        a = get_evaluate_args(argv)
        T = make_env_from_args(a).episode_limit
        want = (T, 0) if a.name == "dmfb" else (0, T)
        if (launches, launches_meda) != want or dmfb_step.launches_no_obs:
            raise AssertionError(f"{name}: {launches} DMFB and "
                                 f"{launches_meda} MEDA kernel launches, "
                                 f"expected {want}")
        launches_eval += launches
        launches_meda_eval += launches_meda
        floor = recorded - SUCCESS_SLACK
        seconds = time.perf_counter() - t1
        log(f"phase 7: [{smi}] {name} ({export}, {a.width}x{a.length}, "
            f"{a.alg}, {tasks} tasks, T = {T}): success "
            f"{m['success_rate']:.3f} (recorded {recorded:.3f}, floor "
            f"{floor:.3f}), steps {m['steps']:.2f}, reward "
            f"{m['reward']:.4f}, kernel launches {launches} DMFB, "
            f"{launches_meda} MEDA, {seconds:.2f} s")
        if not m["success_rate"] >= floor - 1e-9:
            raise AssertionError(f"{name}: success {m['success_rate']} "
                                 f"below {floor}")
        out["policies"][name] = dict(m, recorded=recorded, floor=floor,
                                     tasks=tasks, launches=launches,
                                     launches_meda=launches_meda,
                                     seconds=seconds)
    out["launches_qmix_eval"] = launches_eval
    out["launches_meda_eval"] = launches_meda_eval
    out["phase_s"]["policies"] = time.perf_counter() - t0

    # 3. training at full width, cut in cycles
    t0 = time.perf_counter()
    out["train"] = train_runs(smi, MEDA_QMIX_TRAIN, "phase 7")
    out["launches_qmix_train"] = out["train"]["dmfb_qmix_20x20"]["launches"]
    out["launches_meda_train"] = out["train"]["meda_vdn_4d"]["launches_meda"]
    out["phase_s"]["train"] = time.perf_counter() - t0

    # 4. the QMIX learners on the card against the CPU, MEDA 30x60-3d and
    # the DMFB QMIX flagship's
    t0 = time.perf_counter()
    out["qmix_card_vs_cpu"] = {
        what: qmix_learner_card_vs_cpu(what, argv)
        for what, argv in QMIX_LEARNERS}
    out["phase_s"]["qmix_learner"] = time.perf_counter() - t0

    # 6. the DMFB QMIX rollout through the kernel and the plain step, and
    # the port's QMIX export on 10x10
    t0 = time.perf_counter()
    out["qmix_rollout"] = dmfb_qmix_rollout(smi)
    out["launches_qmix_eval"] += out["qmix_rollout"]["port_qmix_10x10"][
        "launches"]
    out["phase_s"]["qmix_rollout"] = time.perf_counter() - t0

    # 5. a MEDA degradation sweep with the 4-droplet export
    t0 = time.perf_counter()
    data_dir = os.path.join(ROOT, "build", "chip_smoke_meda_sweep")
    shutil.rmtree(data_dir, ignore_errors=True)
    model = os.path.join(data_dir, "model", "vdn", "fov19")
    os.makedirs(model)
    shutil.copy(os.path.join(WEIGHTS, MEDA_VDN, "model", "vdn", "fov19",
                             "0_final_state.npz"), model)
    dmfb_step.launches = meda_step.launches = 0
    res = eva_degrade.main(
        ["meda", "--drop_num=4", f"--evaluate_task={MEDA_SWEEP['tasks']}",
         f"--evaluate_epoch={MEDA_SWEEP['epochs']}", f"--data_dir={data_dir}"])
    launches_sweep = meda_step.launches
    want = (MEDA_SWEEP["epochs"] * MEDA_SWEEP["tasks"]
            * tmeda.MEDAParams().episode_limit)
    if dmfb_step.launches or launches_sweep != want:
        raise AssertionError(f"the MEDA sweep launched the DMFB kernel "
                             f"{dmfb_step.launches} times and the MEDA "
                             f"kernel {launches_sweep}, expected 0 and "
                             f"{want}")
    health, usage = res["health"], res["usage"]
    worn = np.diff(health, axis=1) < 0
    if (np.diff(health, axis=1) > 0).any() or \
            ((np.diff(usage, axis=1) < 0) & ~worn).any() or \
            health.shape != (5, MEDA_SWEEP["epochs"], 30, 60):
        raise AssertionError("the MEDA sweep's wear went backwards")
    per_epoch = res["success"].mean(axis=0).tolist()
    seconds = time.perf_counter() - t0
    log(f"phase 7: [{smi}] MEDA degradation sweep, 30x60-4d, 5 chips, "
        f"{MEDA_SWEEP['epochs']} epochs x {MEDA_SWEEP['tasks']} tasks: "
        f"success per epoch {per_epoch}, steps per epoch "
        f"{res['steps'].mean(axis=0).tolist()}, cells worn "
        f"{int(worn.sum())}, usage total {float(usage[:, -1].sum())}, "
        f"MEDA kernel launches {launches_sweep}, {seconds:.2f} s")
    out["sweep"] = dict(success_per_epoch=per_epoch, seconds=seconds,
                        launches=launches_sweep)
    out["phase_s"]["total"] = time.perf_counter() - t7
    log(f"phase 7: {out['phase_s']['total']:.2f} s")
    return out


def qmix_learner_card_vs_cpu(what, argv) -> dict:
    """Phase 7: ``LEARN_UPDATES`` updates of the QMIX learner that the
    train CLI builds from ``argv`` (its widths), on a minibatch of
    ``QMIX_LEARN_BATCH`` episodes of a random-policy rollout, on the card
    and on the CPU from one state; raises unless the losses agree within
    ``LOSS_RTOL`` and the params within ``PARAM_ATOL`` outside noise
    gradients, as phase 5 holds them."""
    from marl_dmfb_tpu_torch.algos.qlearn import QLearner
    from marl_dmfb_tpu_torch.config import get_train_args, make_env_from_args
    from marl_dmfb_tpu_torch.models.networks import (build_agent_net,
                                                     build_mixer)
    from marl_dmfb_tpu_torch.replay import sample, store
    from marl_dmfb_tpu_torch.trainer import Trainer

    data_dir = os.path.join(ROOT, "build", "chip_smoke_qmix_cmp")
    qargs = get_train_args(
        argv + [f"--n_parallel_envs={QMIX_LEARN_BATCH}",
                f"--buffer_size={QMIX_LEARN_BATCH}",
                f"--batch_size={QMIX_LEARN_BATCH}", "--evaluate_task=1",
                f"--data_dir={data_dir}"], pri=False)
    qt = Trainer(make_env_from_args(qargs), qargs)
    res = qt.rollout(qt.env_states, qt.generator, 1.0, 0.0, 0.05)
    replay = store(qt.replay, res.episodes)
    batch = sample(replay, QMIX_LEARN_BATCH,
                   idx=torch.arange(QMIX_LEARN_BATCH, device="cuda"))
    loss_rel, clean, worst, _ = compare_learner(
        lambda dev: QLearner(qargs, build_agent_net(qargs).to(dev),
                             build_mixer(qargs).to(dev)),
        qt.learner.state(), batch)
    adam_bound = 2 * qargs.lr * LEARN_UPDATES
    widths = dict(state=qargs.state_shape, qmix_hidden=qargs.qmix_hidden_dim,
                  hyper_hidden=qargs.hyper_hidden_dim,
                  two_hyper_layers=qargs.two_hyper_layers,
                  rnn_hidden=qargs.rnn_hidden_dim,
                  grad_norm_clip=qargs.grad_norm_clip)
    log(f"phase 7: QMIX learner ({what}, {widths}) card vs CPU over "
        f"{LEARN_UPDATES} updates at batch {QMIX_LEARN_BATCH}: loss rel "
        f"diff {loss_rel:.3g} (<= {LOSS_RTOL}), params max diff "
        f"{clean:.3g} outside noise gradients (<= {PARAM_ATOL}), "
        f"{worst:.3g} in all (<= {adam_bound:.3g})")
    if not (loss_rel <= LOSS_RTOL and clean <= PARAM_ATOL
            and worst <= adam_bound):
        raise AssertionError(f"the QMIX learner ({what}) on the card "
                             "departs from the CPU")
    return dict(widths, loss_rel=loss_rel, param_diff=clean,
                param_diff_all=worst)


def dmfb_qmix_rollout(smi) -> dict:
    """Phase 7: an epsilon-greedy DMFB QMIX rollout (20x20-4d, T = 80,
    ``QMIX_ROLLOUT_B`` chips, epsilon ``QMIX_ROLLOUT_EPS``) of the port's
    QMIX export through the tile kernel and through the plain step, from
    the same chips and pre-drawn exploration and move draws: the
    observations, actions, padding, terminations and global states
    ``s_ext`` bitwise, the rewards within ``REWARD_ATOL``, the chips after
    it bitwise, the kernel launched T times by the first and never by the
    second; then that export on 10x10 over ``LOW_RATE_TASKS`` tasks
    through the evaluate entry point (a reading, T launches)."""
    from marl_dmfb_tpu_torch import evaluate
    from marl_dmfb_tpu_torch.config import (get_evaluate_args,
                                            make_env_from_args)
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.ops import dmfb_step
    from marl_dmfb_tpu_torch.rollout import RolloutNoise, make_rollout
    from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config

    cli = ["dmfb", "--drop_num=4", "--fov=9", "--alg=qmix",
           f"--data_dir={os.path.join(WEIGHTS, QMIX_PORT)}"]
    args = get_evaluate_args(cli + ["--chip_size=20", "--evaluate_task=1"])
    restore_net_config(args, "final")
    env = make_env_from_args(args)
    policy = Trainer(env, args, eval_only=True)
    policy.load_model("final", params_only=True)
    B, T = QMIX_ROLLOUT_B, env.episode_limit
    N, A = args.n_agents, args.n_actions
    g = torch.Generator(device="cuda").manual_seed(18)
    start = env.reset(env.init(B, g, "cuda"), g)
    noise = RolloutNoise(
        torch.randint(0, A, (T, B, N), generator=g, device="cuda",
                      dtype=torch.int32),
        torch.rand((T, B, N), generator=g, device="cuda"),
        torch.rand((T, B, N), generator=g, device="cuda"))
    fixed = env._replace(reset=lambda st, gen: st)   # reset above
    plain = fixed._replace(
        step_core=lambda st, act, u: tdmfb.step_core(env.params, st, act, u))
    res, launches = {}, {}
    for name, e in (("kernel", fixed), ("plain", plain)):
        roll = make_rollout(e, policy.net, args.rnn_hidden_dim,
                            with_state=True)
        dmfb_step.launches = dmfb_step.launches_wide = 0
        res[name] = roll(start, None, QMIX_ROLLOUT_EPS, 0.0, 0.05,
                         noise=noise)
        torch.cuda.synchronize()
        launches[name] = (dmfb_step.launches, dmfb_step.launches_wide)
    if launches != {"kernel": (T, 0), "plain": (0, 0)}:
        raise AssertionError(f"the QMIX rollouts launched {launches}, "
                             f"expected the tile kernel T = {T} times "
                             "through the kernel path and never through "
                             "the plain one")
    ek, ep = res["kernel"].episodes, res["plain"].episodes
    if ek.keys() != ep.keys() or "s_ext" not in ek:
        raise AssertionError(f"the QMIX rollout stored {sorted(ek)}")
    for k in ("o_ext", "u", "padded", "terminated", "s_ext"):
        if not torch.equal(ek[k], ep[k]):
            raise AssertionError(
                f"the QMIX rollout's {k} differs, kernel against plain "
                f"({int((ek[k] != ep[k]).sum())} elements)")
    r_diff = float((ek["r"] - ep["r"]).abs().max())
    if not r_diff <= REWARD_ATOL or not all(
            torch.equal(x, y) for x, y in zip(res["kernel"].env_states,
                                              res["plain"].env_states)):
        raise AssertionError(f"the QMIX rollout departs from the plain step "
                             f"(rewards {r_diff})")
    explored = int((noise.explore_u < QMIX_ROLLOUT_EPS).sum())
    ended = int(ek["terminated"][:, :-1].any(dim=1).sum())
    success = float(res["kernel"].success.float().mean())
    out = dict(B=B, T=T, epsilon=QMIX_ROLLOUT_EPS, reward_diff=r_diff,
               explored=explored, ended_before_T=ended, success=success,
               state_dim=int(ek["s_ext"].shape[-1]),
               state_nonzero=int((ek["s_ext"] != 0).sum()))
    log(f"phase 7: [{smi}] DMFB QMIX rollout ({QMIX_PORT}, 20x20-4d, B={B}, "
        f"T={T}, epsilon {QMIX_ROLLOUT_EPS}: {explored} exploring draws, "
        f"{ended} episodes ended before T, success {success:.3f}), tile "
        f"kernel == plain step: o_ext, u, padded, terminated and s_ext "
        f"({out['state_dim']} values a step, {out['state_nonzero']} nonzero) "
        f"bitwise, the chips after it bitwise, rewards max |diff| "
        f"{r_diff:.3g} (<= {REWARD_ATOL}); launches {launches}")

    # the port's QMIX export on 10x10: a reading, no floor
    argv = cli + ["--chip_size=10", f"--evaluate_task={LOW_RATE_TASKS}"]
    dmfb_step.launches = dmfb_step.launches_wide = 0
    t1 = time.perf_counter()
    m = evaluate.main(argv)
    T10 = make_env_from_args(get_evaluate_args(argv)).episode_limit
    if (dmfb_step.launches, dmfb_step.launches_wide) != (T10, 0):
        raise AssertionError(f"the port's QMIX export on 10x10 launched "
                             f"{dmfb_step.launches} and "
                             f"{dmfb_step.launches_wide}, expected {T10}")
    out["port_qmix_10x10"] = dict(m, tasks=LOW_RATE_TASKS, launches=T10,
                                  seconds=time.perf_counter() - t1)
    log(f"phase 7: [{smi}] the port's QMIX export ({QMIX_PORT}) on 10x10, "
        f"{LOW_RATE_TASKS} tasks: success {m['success_rate']:.3f} (a "
        f"reading, no floor), steps {m['steps']:.2f}, kernel launches "
        f"{T10}, {out['port_qmix_10x10']['seconds']:.2f} s")
    return out


def mark_noise(learner):
    """Wrap ``learner.loss_and_grads`` to mark, at each update, every
    parameter element whose gradient is within ``NOISE`` of the gradient's
    global norm of zero; returns the masks (on the card)."""
    noisy = {k: torch.zeros(v.shape, dtype=torch.bool, device=v.device)
             for k, v in learner.all_params.items()}
    plain = learner.loss_and_grads

    def marking(batch):
        loss, grads = plain(batch)
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values()))
        for k, g in grads.items():
            noisy[k] |= g.abs() <= NOISE * norm
        return loss, grads

    learner.loss_and_grads = marking
    return noisy


def snapshot_after(learner, n, take) -> list:
    """Wrap ``learner.update`` so that ``take()`` runs once, right after
    its ``n``-th call; returns the list that will hold its result."""
    plain, calls, taken = learner.update, [0], []

    def update(batch):
        loss = plain(batch)
        calls[0] += 1
        if calls[0] == n:
            taken.append(take())
        return loss

    learner.update = update
    return taken


def profile_calls(fn, reps=2):
    """Kernel launches, device ms and ATen ops by count per call of ``fn``,
    from a ``torch.profiler`` trace of ``reps`` calls after one warm-up;
    also the ``torch.func`` batching-rule fallbacks warned of (an op run
    once per seed)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in kernels)
    ops = {e.key: e.count / reps for e in events
           if e.device_type.name == "CPU" and e.key.startswith("aten::")}
    fallbacks = sorted({str(w.message) for w in warned
                        if "batching rule" in str(w.message)})
    return dict(launches=sum(e.count for e in kernels) / reps,
                device_ms=device_us / 1e3 / reps, ops=ops,
                fallbacks=fallbacks)


def time_calls(fn, reps) -> float:
    """ms per call of ``fn`` on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def seed_farm(smi) -> dict:
    """Phase 8: the seed farm and the aux modules on the card (module
    docstring); raises on any failed check, returns the numbers."""
    from marl_dmfb_tpu_torch import router_baseline, train
    from marl_dmfb_tpu_torch.agent import Agents
    from marl_dmfb_tpu_torch.config import get_train_args, make_env_from_args
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.envs import make_env
    from marl_dmfb_tpu_torch.envs.pettingzoo_shim import ParallelEnvShim
    from marl_dmfb_tpu_torch.models.networks import StackedNet
    from marl_dmfb_tpu_torch.ops import dmfb_step
    from marl_dmfb_tpu_torch.parallel.seedfarm import SeedFarm
    from marl_dmfb_tpu_torch.render import Renderer
    from marl_dmfb_tpu_torch.replay import sample, sample_stacked
    from marl_dmfb_tpu_torch.rollout import make_rollout
    from marl_dmfb_tpu_torch.trainer import Trainer

    t8 = time.perf_counter()
    out = {"phase_s": {}}
    S = FARM_S

    # 1. the farm through the train entry point, at full width
    t0 = time.perf_counter()
    data_dir = os.path.join(ROOT, "build", "chip_smoke_farm")
    shutil.rmtree(data_dir, ignore_errors=True)
    argv = FARM_ARGV + [f"--vmap_seeds={S}", f"--exact_steps={FARM_STEPS}",
                        "--evaluate_cycle=1000000", f"--data_dir={data_dir}",
                        ONE_DEVICE]
    torch.cuda.synchronize()
    base = run_memory_start()
    dmfb_step.launches = 0
    farm = train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dmfb_step.launches
    peak = run_peak_mib(base)
    a = farm.args
    width = (a.hyper_hidden_dim, a.rnn_hidden_dim, a.batch_size,
             a.buffer_size, farm.B, farm.updates_per_rollout, farm.S)
    if width != (24, 128, 128, 5000, FARM_B, 32, S):
        raise AssertionError(f"the farm trained at (conv, hidden, batch, "
                             f"replay, B, updates a cycle, seeds) = {width}")
    T = farm.env.episode_limit
    cycles = farm.n_cycles
    evals = len(farm.curves["success_rate"])
    if launches != T * (cycles + evals) or evals != 2 or cycles < 3:
        raise AssertionError(f"the farm launched the kernel {launches} times "
                             f"in {cycles} cycles and {evals} evaluations")
    losses = torch.stack(farm.losses).cpu()
    if not bool(losses.isfinite().all()) or losses.shape != (cycles, S):
        raise AssertionError(f"farm losses {losses.tolist()}")
    ckpts = sorted(os.listdir(farm.model_dir))
    if ckpts != sorted([f"{i}_{t}_state.pt" for i in range(S)
                        for t in (0, "final")] + ["farm_0_resume.pt"]):
        raise AssertionError(f"the farm wrote {ckpts}")
    dmfb_step.launches = 0
    farm.train_cycle()
    launches_rollout = dmfb_step.launches
    if launches_rollout != T:
        raise AssertionError(f"a farm rollout of {S} x {FARM_B} chips "
                             f"launched the kernel {launches_rollout} times, "
                             f"expected T = {T}")
    out["train"] = dict(cycles=cycles, evaluations=evals, seconds=seconds,
                        launches=launches, launches_rollout=launches_rollout,
                        batch=S * FARM_B, peak_mib=peak,
                        losses=losses.tolist(),
                        success=[c.tolist() for c in
                                 farm.curves["success_rate"]])
    log(f"phase 8: [{smi}] farm of {S} seeds x B={FARM_B} ({a.batch_size} "
        f"batch, replay {a.buffer_size} each): {cycles} cycles in "
        f"{seconds:.2f} s, kernel launches {launches} = T x ({cycles} + "
        f"{evals}); a farm rollout launches it {launches_rollout} times at "
        f"batch {S * FARM_B}; peak memory {peak:.1f} MiB; losses "
        f"{[[round(x, 4) for x in row] for row in losses.tolist()]}")

    # 2. one farm rollout through the kernel and through the plain step
    states, noise = farm._draws(farm.env_states, farm.generators, False)
    reset = farm.env._replace(reset=lambda st, gen: st)   # done above
    plain = reset._replace(
        step_core=lambda st, act, u: tdmfb.step_core(farm.env.params, st,
                                                     act, u))
    episodes = {}
    for name, env in (("kernel", reset), ("plain", plain)):
        roll = make_rollout(env, StackedNet(farm.net,
                                            farm.learner.agent_params(), S),
                            a.rnn_hidden_dim)
        res = roll(states, None, farm.epsilon, farm.anneal_per_step,
                   a.min_epsilon, noise=noise)
        episodes[name] = (res.episodes, res.env_states)
    (ek, sk), (ep, sp) = episodes["kernel"], episodes["plain"]
    for k in ("o_ext", "u", "padded", "terminated"):
        if not torch.equal(ek[k], ep[k]):
            raise AssertionError(f"the farm rollout's {k} differs, kernel "
                                 "against plain")
    r_diff = float((ek["r"] - ep["r"]).abs().max())
    if not r_diff <= REWARD_ATOL or not all(
            torch.equal(x, y) for x, y in zip(sk, sp)):
        raise AssertionError(f"the farm rollout departs from the plain step "
                             f"(rewards {r_diff})")
    out["rollout_vs_plain"] = dict(batch=S * FARM_B, reward_diff=r_diff)
    log(f"phase 8: a farm rollout at batch {S * FARM_B}, kernel == plain "
        f"step (episodes and chips bitwise, rewards max |diff| "
        f"{r_diff:.3g})")
    del farm, episodes, states, noise
    out["phase_s"]["train"] = time.perf_counter() - t0

    # 3. the farm's first cycle against single seeds on the card: each
    # seed's mean loss over the cycle, and its params after the first
    # LEARN_UPDATES updates, as phase 5 holds the card against the CPU
    # (over a cycle's 32 updates two float32 summing orders drift apart by
    # more than float noise: 6.7e-5 in one run)
    t0 = time.perf_counter()
    cmp_dir = os.path.join(ROOT, "build", "chip_smoke_farm_cmp")
    singles = []
    for i in range(S):
        sa = get_train_args(FARM_ARGV + [f"--seed={12 + i}",
                                         f"--data_dir={cmp_dir}"], pri=False)
        t = Trainer(make_env_from_args(sa), sa)
        noisy = mark_noise(t.learner)
        early = snapshot_after(
            t.learner, LEARN_UPDATES,
            lambda t=t, noisy=noisy: (t.learner.state()["params"]["agent"],
                                      {k: v.clone()
                                       for k, v in noisy.items()}))
        t.train_cycle()
        singles.append((t, early[0]))
    fa = get_train_args(FARM_ARGV + [f"--vmap_seeds={S}",
                                     f"--data_dir={cmp_dir}"], pri=False)
    farm = SeedFarm(make_env_from_args(fa), fa, S)
    farm_early = snapshot_after(farm.learner, LEARN_UPDATES,
                                lambda: farm.learner.state()["params"])
    farm.train_cycle()
    loss_rel = clean = worst = cycle_worst = 0.0
    for i, (t, (params, noisy)) in enumerate(singles):
        want = float(t.losses[0])
        loss_rel = max(loss_rel, abs(float(farm.losses[0][i]) - want)
                       / abs(want))
        for k, v in params.items():
            diff = (farm_early[0]["agent"][k][i] - v).abs()
            kept = diff[~noisy[k]]
            clean = max(clean, float(kept.max()) if kept.numel() else 0.)
            worst = max(worst, float(diff.max()))
        mine = farm.learner.seed_state(i)["params"]["agent"]
        for k, v in t.learner.state()["params"]["agent"].items():
            cycle_worst = max(cycle_worst, float((mine[k] - v).abs().max()))
        if float(farm.epsilon[i]) != float(t.epsilon):
            raise AssertionError(f"seed {i}: epsilon {float(farm.epsilon[i])}"
                                 f" against {float(t.epsilon)}")
    updates = farm.learner.train_step
    adam_bound = 2 * fa.lr * LEARN_UPDATES
    cycle_bound = 2 * fa.lr * updates
    log(f"phase 8: [{smi}] farm vs {S} single seeds on the card, one cycle "
        f"({updates} updates): mean loss rel diff {loss_rel:.3g} (<= "
        f"{LOSS_RTOL}); params after {LEARN_UPDATES} updates max diff "
        f"{clean:.3g} outside noise gradients (<= {PARAM_ATOL}), {worst:.3g} "
        f"in all (<= {adam_bound:.3g}); after the cycle {cycle_worst:.3g} "
        f"(<= {cycle_bound:.3g}); epsilons equal")
    if not (loss_rel <= LOSS_RTOL and clean <= PARAM_ATOL
            and worst <= adam_bound and cycle_worst <= cycle_bound):
        raise AssertionError("the farm departs from its single seeds")
    out["farm_vs_singles"] = dict(loss_rel=loss_rel, param_diff=clean,
                                  param_diff_all=worst,
                                  param_diff_cycle=cycle_worst)
    out["phase_s"]["farm_vs_singles"] = time.perf_counter() - t0

    # 4. times: a farm cycle and update beside one seed's
    t0 = time.perf_counter()
    single = singles[0][0]
    del single.learner.loss_and_grads, single.learner.update   # unwrap
    del farm.learner.update
    singles = None
    g = torch.Generator(device="cuda").manual_seed(8)
    batch = sample(single.replay, fa.batch_size, g)
    idx = torch.randint(0, farm.replay.size, (S, fa.batch_size),
                        generator=g, device="cuda")
    fbatch = sample_stacked(farm.replay, idx)
    times = {}
    for name, cycle, update in (
            ("single", single.train_cycle,
             lambda: single.learner.update(batch)),
            ("farm", farm.train_cycle, lambda: farm.learner.update(fbatch))):
        update()
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        for _ in range(TIMED_UPDATES):
            update()
        end_ev.record()
        end_ev.synchronize()
        update_ms = start_ev.elapsed_time(end_ev) / TIMED_UPDATES
        prof = profile_calls(update)
        if not prof["launches"]:
            raise AssertionError("torch.profiler saw no kernel launch in a "
                                 f"{name} update")
        steps = [0]

        def counted():
            steps[0] += int(np.sum(cycle()))

        cycle_ms = time_calls(counted, FARM_TIMED_CYCLES)
        times[name] = dict(update_ms=update_ms, cycle_ms=cycle_ms,
                           env_steps_per_s=steps[0] / (cycle_ms / 1e3
                                                       * FARM_TIMED_CYCLES),
                           update_launches=prof["launches"],
                           update_device_ms=prof["device_ms"],
                           update_idle=1 - prof["device_ms"] / update_ms,
                           fallbacks=prof["fallbacks"], ops=prof["ops"])
    sops, fops = times["single"].pop("ops"), times["farm"].pop("ops")
    per_seed = sorted((k for k, n in fops.items()
                       if n >= 2 * sops.get(k, 0) and n >= S),
                      key=lambda k: -fops[k])
    times["ops_per_seed"] = [f"{k} x{fops[k]:.0f} (single {sops.get(k, 0):.0f})"
                             for k in per_seed[:8]]
    for name in ("single", "farm"):
        x = times[name]
        log(f"phase 8: [{smi}] {name}: update {x['update_ms']:.2f} ms "
            f"({x['update_launches']:.0f} kernel launches, "
            f"{x['update_device_ms']:.2f} ms device, idle share "
            f"{x['update_idle']:.3f}); cycle {x['cycle_ms']:.1f} ms, "
            f"{x['env_steps_per_s']:.0f} counted env-steps/s"
            + (f"; batching-rule fallbacks {x['fallbacks']}"
               if x["fallbacks"] else ""))
    log(f"phase 8: farm / single: update x"
        f"{times['farm']['update_ms'] / times['single']['update_ms']:.2f}, "
        f"launches x{times['farm']['update_launches'] / times['single']['update_launches']:.2f}, "
        f"env-steps/s x{times['farm']['env_steps_per_s'] / times['single']['env_steps_per_s']:.2f}; "
        f"ops run more in the farm than one seed: {times['ops_per_seed']}")
    out["times"] = times
    del farm, single, batch, fbatch
    out["phase_s"]["times"] = time.perf_counter() - t0

    # 5. resume under --ckpt_replay, bitwise against an uninterrupted run
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name, budgets in (("full", [FARM_RESUME_STEPS[1]]),
                              ("resumed", list(FARM_RESUME_STEPS))):
            rdir = os.path.join(ROOT, "build", f"chip_smoke_farm_{name}")
            shutil.rmtree(rdir, ignore_errors=True)
            for k, steps in enumerate(budgets):
                f = train.main(FARM_RESUME_ARGV + [
                    f"--exact_steps={steps}", f"--data_dir={rdir}",
                    ONE_DEVICE]
                    + (["--load_model"] if k else []))
            runs[name] = f.save_curves()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k in ("success_rate", "Rewards", "steps", "constraints"):
        if not np.array_equal(runs["full"][k], runs["resumed"][k]):
            raise AssertionError(f"the resumed farm's {k} curve differs: "
                                 f"{runs['resumed'][k].tolist()} against "
                                 f"{runs['full'][k].tolist()}")
    E = runs["full"]["success_rate"].shape[1]
    out["resume"] = dict(evaluations=E, seconds=time.perf_counter() - t0)
    log(f"phase 8: farm resume under --ckpt_replay ({S} seeds, 8 chips, "
        f"stopped at {FARM_RESUME_STEPS[0]} steps, resumed to "
        f"{FARM_RESUME_STEPS[1]}): {E} evaluations, curves bitwise equal to "
        f"the uninterrupted run's")
    out["phase_s"]["resume"] = time.perf_counter() - t0

    # 6. the aux modules on the card
    t0 = time.perf_counter()
    env = make_env("dmfb", width=10, length=10, n_droplets=4, fov=9)
    cpu = ParallelEnvShim(env, seed=7, device="cpu")
    card = ParallelEnvShim(env, seed=7, device="cuda")
    first = cpu.reset()
    card.state = type(cpu.state)(*(x.cuda() for x in cpu.state))
    rng = np.random.RandomState(0)
    dmfb_step.launches = 0
    for step in range(env.episode_limit):
        acts = rng.randint(0, 5, size=4).tolist()
        want, got = cpu.step(acts), card.step(acts)
        if not (np.array_equal(np.stack(got[0]), np.stack(want[0]))
                and got[1:] == want[1:]):
            raise AssertionError(f"shim step {step}: card != CPU")
        if all(want[2].values()):
            break
    shim_launches = dmfb_step.launches
    if shim_launches != step + 1 or not np.array_equal(
            np.stack(card.restart()), np.stack(first)):
        raise AssertionError(f"the card shim launched the kernel "
                             f"{shim_launches} times in {step + 1} steps")
    cpu.restart()
    frame = Renderer(env, u_size=20)
    same_frame = np.array_equal(frame.draw(card.state), frame.draw(cpu.state))
    picks = {}
    for device in ("cpu", "cuda"):
        aa = get_train_args(["dmfb", "--drop_num=4", "--fov=9",
                             f"--device={device}"], pri=False)
        aa.update_env_info(env.env_info())
        agents = Agents(aa)
        s = ParallelEnvShim(env, seed=1, device="cpu")
        obs, last, acts = s.reset(), np.zeros((4, 5)), []
        for _ in range(20):
            step_acts = [agents.choose_action(obs[i], last[i], i, [1] * 5,
                                              0.2) for i in range(4)]
            last = np.eye(5)[step_acts]
            obs = s.step(step_acts)[0]
            acts.append(step_acts)
        picks[device] = acts
    if not same_frame or picks["cpu"] != picks["cuda"]:
        raise AssertionError(f"card vs CPU: frame equal {same_frame}, "
                             f"actions equal {picks['cpu'] == picks['cuda']}")
    router = router_baseline.main([str(ROUTER_TASKS), "4"])
    out["aux"] = dict(shim_steps=step + 1, shim_launches=shim_launches,
                      router_success=router["value"], router=router["unit"])
    log(f"phase 8: [{smi}] shim episode on the card == CPU over {step + 1} "
        f"steps ({shim_launches} kernel launches at B = 1); Agents."
        f"choose_action card == CPU over 20 steps x 4 agents; Renderer frame "
        f"of the card state == CPU frame; MEDA staircase router "
        f"{router['value']:.2f} success over {ROUTER_TASKS} 30x60-4d tasks "
        f"({router['unit']})")
    out["phase_s"]["aux"] = time.perf_counter() - t0
    out["phase_s"]["total"] = time.perf_counter() - t8
    log(f"phase 8: {out['phase_s']['total']:.2f} s")
    return out


def mesh_run(argv, mesh=None, mark=False) -> dict:
    """``Trainer`` of ``argv`` (as a rank of ``mesh``, or alone) for
    ``MESH_CYCLES`` timed cycles; its cycles' losses, counted steps,
    epsilon, the losses of its first ``LEARN_UPDATES`` updates and the
    params after them (and with ``mark``, the noise-gradient masks of those
    updates), final params, the ring rows it wrote, its kernel launches
    and its ring's bytes."""
    from marl_dmfb_tpu_torch.config import get_train_args, make_env_from_args
    from marl_dmfb_tpu_torch.ops import dmfb_step
    from marl_dmfb_tpu_torch.trainer import Trainer
    from marl_dmfb_tpu_torch.utils.benchmarking import timeit_dispatch

    args = get_train_args(argv, pri=False)
    if mesh is not None:
        args.device = str(mesh.device)
    trainer = Trainer(make_env_from_args(args), args, mesh=mesh)
    learner = trainer.learner
    noisy = mark_noise(learner) if mark else None
    cpu = lambda tree: {k: v.detach().cpu().clone() for k, v in tree.items()}
    early = dict(losses=[])
    plain = learner.update

    def update(batch):   # the first LEARN_UPDATES updates' losses, params
        loss = plain(batch)
        if len(early["losses"]) < LEARN_UPDATES:
            early["losses"].append(float(loss))
            if len(early["losses"]) == LEARN_UPDATES:
                early["params"] = cpu(learner.all_params)
                early["noisy"] = noisy and cpu(noisy)
                if mark:
                    del learner.loss_and_grads   # these updates' only
        return loss

    learner.update = update
    steps, cycle_ms = [], []
    dmfb_step.launches = 0
    for _ in range(MESH_CYCLES):
        seconds, _ = timeit_dispatch(
            lambda: steps.append(trainer.train_cycle()), iters=1, warmup=0,
            subtract_rtt=False)
        cycle_ms.append(seconds * 1e3)
    launches = dmfb_step.launches
    r = trainer.replay
    cap_l = r.data["u"].shape[0]
    n, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if args.local_sampling:
        rows = min(cap_l, r.size // n)
    else:
        rows = min(cap_l, max(0, r.size - rank * cap_l))
    return dict(
        losses=[float(x) for x in trainer.losses], steps=steps,
        epsilon=float(trainer.epsilon), early_losses=early["losses"],
        early=early["params"], noisy=early["noisy"],
        final=cpu(learner.all_params),
        ring={k: v[:rows].cpu() for k, v in r.data.items()},
        cursor=r.cursor, size=r.size, cycle_ms=cycle_ms,
        launches=launches, T=trainer.env.episode_limit,
        B_local=trainer.env_states[0].shape[0],
        ring_bytes=sum(v.nbytes for v in r.data.values()),
        lr=args.lr)


def mesh_rank(mesh, runs, out_dir):
    """A rank of phase 9: each ``(tag, argv)`` of ``runs`` through
    :func:`mesh_run`, saved to ``<out_dir>/<tag>_rank<r>.pt``."""
    bad = sorted(m for m in ("jax", "marl_dmfb_tpu") if m in sys.modules)
    if bad:
        raise AssertionError(f"a phase 9 rank imported {bad}")
    for tag, argv in runs:
        rec = mesh_run(argv, mesh)
        torch.save(rec, os.path.join(out_dir, f"{tag}_rank{mesh.rank}.pt"))


def hold_to_one_device(ref, ranks, what, store="global") -> dict:
    """Phase 9's checks of the ranks' records of one run against the
    one-device record ``ref`` (the global store), or their own (the local
    rings); raises on a failed check, returns the differences."""
    first = ranks[0]
    for rec in ranks[1:]:
        for k, v in first["final"].items():
            if not torch.equal(rec["final"][k], v):
                raise AssertionError(f"{what}: the ranks' {k} differ")
        if rec["losses"] != first["losses"] or rec["steps"] != first["steps"]:
            raise AssertionError(f"{what}: the ranks report other losses")
    n = len(ranks)
    for rec in ranks:
        if (rec["launches"] != rec["T"] * MESH_CYCLES
                or rec["B_local"] != MESH_B // n):
            raise AssertionError(
                f"{what}: a rank launched the kernel {rec['launches']} times "
                f"in {MESH_CYCLES} cycles at B = {rec['B_local']}")
    if not all(math.isfinite(x) for x in first["losses"]):
        raise AssertionError(f"{what}: losses {first['losses']}")
    out = dict(cycle_ms=[rec["cycle_ms"] for rec in ranks],
               launches=[rec["launches"] for rec in ranks],
               ring_bytes=[rec["ring_bytes"] for rec in ranks],
               losses=first["losses"])
    if store == "local":
        size = MESH_B * MESH_CYCLES
        for rec in ranks:
            if (rec["cursor"], rec["size"]) != (size, size) or \
                    rec["ring"]["u"].shape[0] != size // n:
                raise AssertionError(f"{what}: a local ring holds "
                                     f"{rec['ring']['u'].shape[0]} rows")
        return out
    if first["steps"] != ref["steps"] or first["epsilon"] != ref["epsilon"]:
        raise AssertionError(f"{what}: steps {first['steps']} epsilon "
                             f"{first['epsilon']} against {ref['steps']} "
                             f"{ref['epsilon']}")
    for k, v in ref["ring"].items():
        got = torch.cat([rec["ring"][k] for rec in ranks])
        if not torch.equal(got, v):
            raise AssertionError(f"{what}: the ring's {k} differs from the "
                                 "one-device ring")
    rel = lambda got, want: max(abs(a - b) / abs(b) for a, b in zip(got, want))
    loss_rel = rel(first["early_losses"], ref["early_losses"])
    clean = worst = 0.0
    for k, v in ref["early"].items():
        diff = (first["early"][k] - v).abs()
        kept = diff[~ref["noisy"][k]]
        clean = max(clean, float(kept.max()) if kept.numel() else 0.0)
        worst = max(worst, float(diff.max()))
    adam_bound = 2 * ref["lr"] * LEARN_UPDATES
    if not (loss_rel <= LOSS_RTOL and clean <= PARAM_ATOL
            and worst <= adam_bound):
        raise AssertionError(
            f"{what} departs from one device over {LEARN_UPDATES} updates: "
            f"loss rel diff {loss_rel:.3g}, params {clean:.3g} outside noise "
            f"gradients, {worst:.3g} in all")
    return dict(out, loss_rel=loss_rel, param_diff=clean,
                param_diff_all=worst,
                cycle_loss_rel=rel(first["losses"], ref["losses"]))


def ms_list(ms) -> str:
    return "[" + ", ".join(f"{x:.1f}" for x in ms) + "]"


def data_parallel(smi) -> dict:
    """Phase 9: data-parallel training of the main config on the card, as
    the module docstring says; raises on any failed check, returns the
    numbers."""
    from marl_dmfb_tpu_torch.ops import dmfb_step
    from marl_dmfb_tpu_torch.parallel.distributed import spawn

    t9 = time.perf_counter()
    dmfb_step.kernel_library()   # built before the ranks start
    out_dir = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    argv = MESH_ARGV + [f"--data_dir={out_dir}"]
    local_argv = argv + ["--local_sampling"]
    load = lambda tag, n: [torch.load(os.path.join(out_dir,
                                                   f"{tag}_rank{r}.pt"))
                           for r in range(n)]
    out = {"phase_s": {}}

    t0 = time.perf_counter()
    ref = mesh_run(argv, mark=True)
    out["one_device"] = dict(cycle_ms=ref["cycle_ms"],
                             launches=ref["launches"],
                             ring_bytes=ref["ring_bytes"],
                             losses=ref["losses"])
    log(f"phase 9: [{smi}] one device: {MESH_CYCLES} cycles of B={MESH_B}, "
        f"ms a cycle {ms_list(ref['cycle_ms'])}, kernel launches "
        f"{ref['launches']}, ring {ref['ring_bytes']} bytes")
    out["phase_s"]["one_device"] = time.perf_counter() - t0

    runs = [("a", ["cuda:0"], "nccl", [("nccl1", argv)]),
            ("b", ["cuda:0", "cuda:0"], "gloo",
             [("gloo2", argv), ("gloo2_local", local_argv)])]
    if torch.cuda.device_count() >= 2:
        runs.append(("c", ["cuda:0", "cuda:1"], "nccl",
                     [("nccl2", argv), ("nccl2_local", local_argv)]))
    else:
        log(f"phase 9 (c): not run: two ranks under NCCL need two cards, "
            f"and {torch.cuda.device_count()} is visible")
    for part, devices, backend, jobs in runs:
        t0 = time.perf_counter()
        spawn(mesh_rank, devices, backend, jobs, out_dir)
        for tag, job in jobs:
            store = "local" if "--local_sampling" in job else "global"
            what = (f"phase 9 ({part}) {len(devices)} rank(s) under "
                    f"{backend} on {sorted(set(devices))}, {store} ring")
            res = hold_to_one_device(ref, load(tag, len(devices)), what,
                                     store)
            out[tag] = res
            log(f"phase 9: [{smi}] {what}: ms a cycle on the ranks "
                f"{'; '.join(ms_list(x) for x in res['cycle_ms'])} (one "
                f"device {ms_list(ref['cycle_ms'])}); "
                f"kernel launches per rank {res['launches']} (T x "
                f"{MESH_CYCLES} cycles at B = {MESH_B // len(devices)}); "
                f"ring bytes per rank {res['ring_bytes']}"
                + (f"; over the first {LEARN_UPDATES} updates loss rel diff "
                   f"{res['loss_rel']:.3g}, params {res['param_diff']:.3g} "
                   f"outside noise gradients ({res['param_diff_all']:.3g} in "
                   f"all); the cycles' mean losses drift apart by "
                   f"{res['cycle_loss_rel']:.3g} (two float32 summing "
                   "orders through 96 Adam updates); episodes, ring, steps "
                   "and epsilon equal"
                   if "loss_rel" in res else "; losses finite, ring rows "
                   "per rank as written, params alike on the ranks"))
        out["phase_s"][part] = time.perf_counter() - t0
    out["phase_s"]["total"] = time.perf_counter() - t9
    log(f"phase 9: {out['phase_s']['total']:.2f} s")
    return out


def bench_line(line, want) -> dict:
    """A checked line of an entry point: its metric ``want``, a finite
    positive value, no TPU in its unit."""
    if line["metric"] != want:
        raise AssertionError(f"phase 10: {line['metric']}, expected {want}")
    value = line["value"]
    if not (isinstance(value, (int, float)) and math.isfinite(value)
            and value > 0):
        raise AssertionError(f"phase 10: {want} = {value}")
    if re.search(r"tpu|v5e", line.get("unit", ""), re.IGNORECASE):
        raise AssertionError(f"phase 10: {want}'s unit {line['unit']!r}")
    return line


def bench_entries(smi, T) -> dict:
    """Phase 10: the port's measuring entry points on the card (``bench``,
    ``bench_train``, ``bench_scaling``, and ``bench_multiproc`` where 4
    cards are visible) through their ``main``; each prints its JSON lines,
    each line is checked, and the actor's DMFB rollouts must launch the
    tile kernel T times each (T = ``T``), its MEDA rollouts the MEDA kernel
    their env's T times.  Raises on a failed check, returns the lines and
    the launches."""
    from marl_dmfb_tpu_torch import (bench, bench_multiproc, bench_scaling,
                                     bench_train)
    from marl_dmfb_tpu_torch.config import make_env_from_args
    from marl_dmfb_tpu_torch.ops import dmfb_step, meda_step

    t10 = time.perf_counter()
    dmfb_step.kernel_library()   # built before the ranks start
    cards = torch.cuda.device_count()
    out = {"lines": [], "launches": {}, "phase_s": {}}
    for argv in BENCH_ACTOR:
        t0 = time.perf_counter()
        a = bench.parse(argv)
        want = {"dmfb": "actor_env_steps_per_sec",
                "meda": "actor_env_steps_per_sec_meda"}[a.env]
        want += "_bf16" if a.dtype == "bf16" else ""
        env_T = make_env_from_args(bench.make_args(
            a.B, a.n_blocks, a.env, a.dtype, a.device)).episode_limit
        dmfb_step.launches = meda_step.launches = 0
        line = bench_line(bench.main(argv, iters=BENCH_ACTOR_ITERS), want)
        rollouts = BENCH_ACTOR_ITERS + 1
        launches = (dmfb_step.launches if a.env == "dmfb"
                    else meda_step.launches)
        other = meda_step.launches if a.env == "dmfb" else dmfb_step.launches
        if launches != env_T * rollouts or other:
            raise AssertionError(
                f"phase 10: bench {' '.join(argv)} launched its env's kernel "
                f"{launches} times in {rollouts} rollouts of T = {env_T}, "
                f"the other {other}")
        out["lines"].append(line)
        out["launches"][want] = launches
        out["phase_s"][want] = time.perf_counter() - t0
        log(f"phase 10: [{smi}] bench {' '.join(argv)}: {line['value']:.0f} "
            f"env-steps/s; {a.env} kernel launches {launches} in {rollouts} "
            f"rollouts (T = {env_T} each)")

    t0 = time.perf_counter()
    dmfb_step.launches = 0
    lines = bench_train.main([str(BENCH_TRAIN_B)],
                             learn_iters=BENCH_LEARN_ITERS, cycles=1,
                             cycle_warmup=0)
    # the last line reads the port's committed time-to-quality artifact
    names = ["learn_step_ms", "learn_step_tflops",
             "train_loop_env_steps_per_sec", "train_e2e",
             "time_to_quality_recorded"]
    if len(lines) != len(names):
        raise AssertionError(f"phase 10: bench_train printed {lines}")
    out["lines"] += [bench_line(x, w) for x, w in zip(lines, names)]
    # the cycle that fills the ring and the timed one
    out["launches"]["bench_train"] = dmfb_step.launches
    if dmfb_step.launches != 2 * T:
        raise AssertionError(f"phase 10: bench_train launched the kernel "
                             f"{dmfb_step.launches} times in 2 cycles")
    out["phase_s"]["bench_train"] = time.perf_counter() - t0
    log(f"phase 10: [{smi}] bench_train B={BENCH_TRAIN_B}: "
        + ", ".join(f"{x['metric']} {x['value']:.6g}" for x in lines))

    t0 = time.perf_counter()
    lines = bench_scaling.main([], iters=BENCH_SCALING_ITERS)
    sizes = [n for n in bench_scaling.SIZES if n <= cards]
    names = [f"actor_env_steps_per_sec_{n}dev" for n in sizes[:1]]
    for n in sizes[1:]:
        names += [f"actor_env_steps_per_sec_{n}dev",
                  f"sharding_overhead_ratio_{n}dev"]
    if [x["metric"] for x in lines] != names:
        raise AssertionError(f"phase 10: bench_scaling printed {lines}")
    out["lines"] += [bench_line(x, w) for x, w in zip(lines, names)]
    out["phase_s"]["bench_scaling"] = time.perf_counter() - t0
    log(f"phase 10: [{smi}] bench_scaling over {sizes} card(s)")

    if cards >= BENCH_MULTIPROC_CARDS:
        t0 = time.perf_counter()
        lines = bench_multiproc.main([], cycles=1)
        names = ["train_cycle_s_1rank", "train_cycle_s_2rank",
                 "multiproc_efficiency", "train_cycle_s_2rank_local_sampling",
                 "train_cycle_s_4rank"]
        timed = [x for x in lines
                 if x["metric"] != "collective_bytes_per_update"]
        if len(timed) != len(names) or len(lines) != len(names) + 2:
            raise AssertionError(f"phase 10: bench_multiproc printed {lines}")
        out["lines"] += [bench_line(x, w) for x, w in zip(timed, names)]
        out["phase_s"]["bench_multiproc"] = time.perf_counter() - t0
    else:
        log(f"phase 10: bench_multiproc not run: it compares 1, 2 and 4 "
            f"NCCL ranks, and {cards} card(s) are visible")
    out["phase_s"]["total"] = time.perf_counter() - t10
    log(f"phase 10: {out['phase_s']['total']:.2f} s")
    return out


def wide_params(tdmfb, width, n, blocks=0):
    """A square board of ``width`` with ``n`` droplets, fov 9; the lattice
    fallback's warning of the crowded boards is expected."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tdmfb.DMFBParams(width=width, length=width, n_droplets=n,
                                n_blocks=blocks, fov=9)


def counted(dmfb_step, fn):
    """``fn()`` with both kernels' launch counts set to 0 just before;
    returns its result and the (tile, wide) counts just after."""
    dmfb_step.launches = dmfb_step.launches_wide = 0
    out = fn()
    return out, (dmfb_step.launches, dmfb_step.launches_wide)


def wide_kernel(smi) -> dict:
    """Phase 11: the wide kernel on the card (module docstring); raises on
    any failed check, returns the numbers."""
    from marl_dmfb_tpu_torch import evaluate, train
    from marl_dmfb_tpu_torch.config import (get_evaluate_args,
                                            make_env_from_args)
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.ops import dmfb_step
    from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config

    t11 = time.perf_counter()
    out = {"max_abs_err": 0.0, "timed": [], "phase_s": {}}
    g = torch.Generator(device="cuda").manual_seed(1111)

    # (a) against the plain version, both modes, views at offsets 0 and 1
    t0 = time.perf_counter()
    for width, n, blocks, batch in WIDE_CMP:
        p = wide_params(tdmfb, width, n, blocks)
        s = random_states(tdmfb, p, batch + 1, g)
        errs = []
        for observe in (True, False):
            for offset in (0, 1):
                view = tdmfb.DMFBState(*(t[offset:offset + batch] for t in s))
                errs.append(compare_kernel(tdmfb, dmfb_step, p, batch, g,
                                           observe, "wide", view))
        if dmfb_step.kernel_for(p) == "tile":   # a shape both kernels take
            errs.append(compare_kernel(tdmfb, dmfb_step, p, batch, g, True,
                                       "wide",
                                       reference=dmfb_step.step_batch))
        out["max_abs_err"] = max(out["max_abs_err"], *errs)
        group = dmfb_step.wide_group_chips(p, batch)
        layout = (f"group layout, {group} chips a group, the last "
                  f"{batch - (-(-batch // group) - 1) * group}" if group
                  else "chip layout")
        log(f"phase 11: {width}x{width}-{n}d, {blocks} blocks, B={batch} "
            f"({dmfb_step.kernel_for(p)} kernel's shape; wide kernel's "
            f"{layout}): wide == plain over "
            f"3 steps, with and without observations, offsets 0 and 1"
            + (", and == the tile kernel" if len(errs) > 4 else "")
            + f" (max |diff| {max(errs):.3g})")
    out["phase_s"]["compare"] = time.perf_counter() - t0

    # (b) times beside the byte bound, with observations and without
    t0 = time.perf_counter()
    for width, n, batch in WIDE_TIMED:
        p = wide_params(tdmfb, width, n)
        s = random_states(tdmfb, p, 4 * batch, g)
        sets = [(tdmfb.DMFBState(*(t[i * batch:(i + 1) * batch] for t in s)),
                 *step_inputs(p, batch, g)) for i in range(4)]
        row = dict(shape=f"{width}x{width}-{n}d", batch=batch,
                   group=dmfb_step.wide_group_chips(p, batch))
        how = (f"{row['group']} chips a group" if row["group"]
               else "a block a chip")
        for observe in (True, False):
            step = dmfb_step.step_batch if observe \
                else dmfb_step.transition_batch
            plain = tdmfb.step_core if observe else tdmfb.transition
            with forced(dmfb_step, "wide"):
                ms = device_ms([lambda x=x: step(p, *x) for x in sets])
            plain_ms = device_ms([lambda x=x: plain(p, *x) for x in sets],
                                 iters=PLAIN_ITERS)
            bound_ms, bound_by, n_bytes, n_ops = bound(dmfb_step, p, batch,
                                                       observe)
            mode = "" if observe else "no_obs_"
            row.update({f"{mode}ms": ms, f"{mode}plain_ms": plain_ms,
                        f"{mode}bound_ms": bound_ms,
                        f"{mode}bound_by": bound_by,
                        f"{mode}share": bound_ms / ms})
            log(f"phase 11: [{smi}] dmfb_step_wide {width}x{width}-{n}d at "
                f"B={batch} ({how}, observe={observe}): kernel "
                f"{ms * 1e3:.2f} us, plain "
                f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                f"({bound_by}: {n_bytes} bytes, {n_ops} ops), "
                f"{100 * bound_ms / ms:.1f}% of the bound")
        out["timed"].append(row)
        del s, sets
    out["phase_s"]["timed"] = time.perf_counter() - t0

    # (c) the entry points on shapes only the wide kernel takes
    t0 = time.perf_counter()
    out["launches"] = {}
    for name, drop_num, board, tasks in WIDE_EVAL:
        argv = ["dmfb", f"--drop_num={drop_num}", "--fov=9",
                f"--chip_size={board}", f"--evaluate_task={tasks}",
                "--load_model_name=0_final", f"--data_dir={FLAGSHIP}"]
        t1 = time.perf_counter()
        m, (tiles, wides) = counted(dmfb_step, lambda: evaluate.main(argv))
        args = get_evaluate_args(argv)
        restore_net_config(args, "final")
        env = make_env_from_args(args)
        T = env.episode_limit
        if dmfb_step.kernel_for(env.params) != "wide" or (tiles, wides) != (
                0, T):
            raise AssertionError(f"evaluate {name} launched the tile kernel "
                                 f"{tiles} and the wide kernel {wides} "
                                 f"times, expected 0 and T = {T}")
        if not (all(math.isfinite(v) for v in m.values())
                and 0 < m["steps"] <= T and 0.0 <= m["success_rate"] <= 1.0):
            raise AssertionError(f"evaluate {name} returned {m}")
        out["launches"][f"eval_{name}"] = wides
        out[f"eval_{name}"] = dict(m, seconds=time.perf_counter() - t1)
        log(f"phase 11: [{smi}] evaluate {name} ({tasks} tasks): success "
            f"{m['success_rate']}, steps {m['steps']}, reward "
            f"{m['reward']:.4f}, wide kernel launches {wides} (T = {T}), "
            f"tile kernel {tiles}, {time.perf_counter() - t1:.2f} s")
        if name == "20x20_20d":
            policy = Trainer(env, args, eval_only=True)
            policy.load_model("final", params_only=True)
            same = greedy_card_vs_cpu(env, policy.net.eval(),
                                      args.rnn_hidden_dim, WIDE_GREEDY_B, 11)
            log(f"phase 11: greedy rollout of {WIDE_GREEDY_B} chips at "
                f"20x20-20d, card vs CPU: {same}/{WIDE_GREEDY_B} episodes "
                f"identical")
            if same != WIDE_GREEDY_B:
                raise AssertionError("the card's rollout at 20x20-20d "
                                     "departs from the CPU's")
    out["phase_s"]["evaluate"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    data_dir = os.path.join(ROOT, "build", "chip_smoke_wide_train")
    shutil.rmtree(data_dir, ignore_errors=True)
    trainer, (tiles, wides) = counted(dmfb_step, lambda: train.main(
        WIDE_TRAIN_ARGV + [f"--data_dir={data_dir}"]))
    targs, T = trainer.args, trainer.env.episode_limit
    cycles, evals = trainer.n_cycles, len(trainer.success_rate)
    width = (targs.hyper_hidden_dim, targs.rnn_hidden_dim, trainer.B,
             trainer.updates_per_rollout)
    if width != (24, 128, WIDE_TRAIN_B, 4):
        raise AssertionError(f"phase 11 trained at (conv, hidden, B, "
                             f"updates a cycle) = {width}")
    if (tiles, wides) != (0, T * (cycles + evals)):
        raise AssertionError(
            f"training launched the tile kernel {tiles} and the wide kernel "
            f"{wides} times, expected 0 and T x ({cycles} training + "
            f"{evals} evaluation rollouts)")
    losses = torch.stack(trainer.losses).cpu()
    if len(losses) != cycles or not bool(losses.isfinite().all()):
        raise AssertionError(f"losses {losses.tolist()}")
    out["launches"]["train_160x160_4d"] = wides
    out["train_160x160_4d"] = dict(cycles=cycles, evaluations=evals,
                                   losses=losses.tolist(),
                                   seconds=time.perf_counter() - t0)
    log(f"phase 11: [{smi}] train 160x160-4d (T = {T}): {cycles} cycles of "
        f"B={WIDE_TRAIN_B}, {trainer.learner.train_step} updates, losses "
        f"{[round(x, 4) for x in losses.tolist()]}, wide kernel launches "
        f"{wides} = T x ({cycles} + {evals}), tile kernel {tiles}, "
        f"{time.perf_counter() - t0:.2f} s")
    out["phase_s"]["train"] = time.perf_counter() - t0
    out["phase_s"]["total"] = time.perf_counter() - t11
    log(f"phase 11: {out['phase_s']['total']:.2f} s")
    return out


def learning(smi, seed=None) -> dict:
    """Phase 12: a policy trained from scratch on the card (module
    docstring), at the CLI's seed or ``seed``; raises on any failed check,
    returns the numbers."""
    from marl_dmfb_tpu_torch import evaluate, train
    from marl_dmfb_tpu_torch.ops import dmfb_step

    t12 = time.perf_counter()
    data_dir = os.path.join(ROOT, "build", "chip_smoke_learning")
    shutil.rmtree(data_dir, ignore_errors=True)
    argv = LEARN_ARGV + [f"--data_dir={data_dir}"] + (
        [] if seed is None else [f"--seed={seed}"])
    trainer, (tiles, wides) = counted(dmfb_step, lambda: train.main(argv))
    train_s = time.perf_counter() - t12
    targs, T = trainer.args, trainer.env.episode_limit
    cycles, evals = trainer.n_cycles, len(trainer.success_rate)
    width = (targs.hyper_hidden_dim, targs.rnn_hidden_dim, targs.batch_size,
             targs.buffer_size, trainer.B, trainer.updates_per_rollout)
    if width != (32, 128, 128, 5000, 64, 13):
        raise AssertionError(f"phase 12 trained at (conv, hidden, batch, "
                             f"replay, B, updates a cycle) = {width}")
    if (tiles, wides) != (T * (cycles + evals), 0):
        raise AssertionError(
            f"training launched the tile kernel {tiles} and the wide kernel "
            f"{wides} times, expected T x ({cycles} training + {evals} "
            f"evaluation rollouts) and 0")
    losses = torch.stack(trainer.losses).cpu()
    if not bool(losses.isfinite().all()):
        raise AssertionError("a training loss is not finite")
    scores = {}
    for tag in ("0", "final"):
        m = evaluate.main(["dmfb", "--drop_num=2", "--fov=9",
                           "--evaluate_task=100", f"--data_dir={data_dir}",
                           f"--load_model_name={tag}"])
        scores[tag] = m["success_rate"]
    seconds = time.perf_counter() - t12
    out = dict(seed=targs.seed, cycles=cycles, updates=trainer.learner
               .train_step, curve=trainer.success_rate,
               runtime=trainer.time_cost, untrained=scores["0"],
               trained=scores["final"], launches=tiles, train_s=train_s,
               seconds=seconds)
    log(f"phase 12: [{smi}] trained 10x10-2d from scratch, seed "
        f"{targs.seed}: {cycles} cycles of B=64, {out['updates']} updates, "
        f"{targs.total_env_steps} env steps in {train_s:.2f} s; online "
        f"success every {targs.evaluate_cycle} env steps "
        f"{[round(x, 2) for x in trainer.success_rate]} at "
        f"{[round(x, 1) for x in trainer.time_cost]} s; tile kernel "
        f"launches {tiles} = T x ({cycles} + {evals})")
    log(f"phase 12: evaluate checkpoint 0: success {scores['0']:.2f} (<= "
        f"{LEARN_UNTRAINED_MAX}), final: {scores['final']:.2f} (>= "
        f"{LEARN_TRAINED_MIN}); {seconds:.2f} s (<= {LEARN_MAX_S})")
    # the rates are float32 counts of 100 tasks
    if not (scores["0"] <= LEARN_UNTRAINED_MAX + 1e-6
            and scores["final"] >= LEARN_TRAINED_MIN - 1e-6):
        raise AssertionError(f"phase 12: untrained {scores['0']}, trained "
                             f"{scores['final']}: the port did not learn")
    if seconds > LEARN_MAX_S:
        raise AssertionError(f"phase 12 took {seconds:.2f} s")
    return out


def largest_meda(smi) -> dict:
    """Phase 13: MEDA 80x80-10d trained at the CLI's widths without and
    with ``--remat``, and the two updates held on one minibatch (module
    docstring); raises on any failed check, returns the numbers."""
    t13 = time.perf_counter()
    out = {}

    def check(name, learner, batch):
        if not learner.args.remat:
            out["remat_vs_plain"] = remat_vs_plain(learner, batch, smi)

    out["train"] = train_runs(smi, MEDA_80X80_TRAIN, "phase 13", check)
    out["seconds"] = time.perf_counter() - t13
    log(f"phase 13: {out['seconds']:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from marl_dmfb_tpu_torch import checkpoint, evaluate, train
    from marl_dmfb_tpu_torch.algos.qlearn import QLearner
    from marl_dmfb_tpu_torch.config import get_evaluate_args
    from marl_dmfb_tpu_torch.config import make_env_from_args
    from marl_dmfb_tpu_torch.replay import sample
    from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.envs import meda as tmeda
    from marl_dmfb_tpu_torch.models.networks import build_agent_net
    from marl_dmfb_tpu_torch.ops import _build, dmfb_step, meda_step
    from marl_dmfb_tpu_torch.rollout import make_rollout

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

    # --- 1: build the kernels, one nvcc each, at once ---
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        built, built_wide, built_meda = pool.map(
            _build.build, ("dmfb_step", "dmfb_step_wide", "meda_step"))
    dmfb_step.kernel_library()
    dmfb_step.wide_library()
    meda_step.kernel_library()
    for b in (built, built_wide, built_meda):
        log(f"phase 1: built {os.path.relpath(b.path, ROOT)} in "
            f"{b.seconds:.2f} s of nvcc")
    ptxas = ptxas_summary(built.log)
    ptxas_wide = ptxas_summary(built_wide.log)
    ptxas_meda = ptxas_summary(built_meda.log)
    for entry, info in {**ptxas, **ptxas_wide, **ptxas_meda}.items():
        log(f"  ptxas: {entry}: {info}")
    # the tile kernel's 4-droplet instantiations: with observations (the
    # main path's) and without (the v0.1 path's); neither may spill
    main4 = {mode: [info for entry, info in ptxas.items()
                    if f"ILi4ELb{int(mode)}E" in entry]
             for mode in (True, False)}
    for mode, found in main4.items():
        if len(found) != 1 or found[0].get("spill_stores") != 0 \
                or found[0].get("spill_loads") != 0:
            raise AssertionError(
                f"the 4-droplet instantiation (observe={mode}) spills or was "
                f"not found in the ptxas log: {found}")
    # the wide kernel: its group and chip layouts, each mode; none may spill
    wide = {(layout, mode): [info for entry, info in ptxas_wide.items()
                             if f"{layout}_kernelILb{int(mode)}E" in entry]
            for layout in ("group", "chip") for mode in (True, False)}
    if any(len(found) != 1 or found[0].get("spill_stores") != 0
           or found[0].get("spill_loads") != 0 for found in wide.values()):
        raise AssertionError(f"a wide kernel instantiation spills or was not "
                             f"found in the ptxas log: {wide}")
    # the MEDA kernel: one instantiation an observation version; none may
    # spill
    meda = {v: [info for entry, info in ptxas_meda.items()
                if f"meda_step_kernelILi{v}E" in entry] for v in range(3)}
    if any(len(found) != 1 or found[0].get("spill_stores") != 0
           or found[0].get("spill_loads") != 0 for found in meda.values()):
        raise AssertionError(f"a MEDA kernel instantiation spills or was not "
                             f"found in the ptxas log: {meda}")
    log(f"phase 1: {time.perf_counter() - t0:.2f} s")

    # --- 2: kernel vs plain version ---
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(2024)
    max_err = 0.0
    for width, n, blocks, batch in KERNEL_CMP:
        p = tdmfb.DMFBParams(width=width, length=width, n_droplets=n,
                             n_blocks=blocks, fov=9)
        for observe in (True, False):
            err = compare_kernel(tdmfb, dmfb_step, p, batch, g, observe,
                                 kernel="tile")
            max_err = max(max_err, err)
            log(f"phase 2: {width}x{width}, {n} droplets, {blocks} blocks, "
                f"B={batch}, observe={observe}: kernel == plain over 3 "
                f"steps (max |diff| {err:.3g})")
    meda_err = 0.0
    for (width, length, n, version), batch in (
            (c, b) for c in MEDA_KERNEL_CMP for b in MEDA_KERNEL_B):
        p = tmeda.MEDAParams(width=width, length=length, n_droplets=n,
                             obs_version=version, b_degrade=True)
        err = compare_meda_kernel(tmeda, meda_step, p, batch, g)
        meda_err = max(meda_err, err)
        log(f"phase 2: MEDA {width}x{length}-{n}d {version}, degraded, "
            f"B={batch}: kernel == plain over 3 steps (team reward max "
            f"|diff| {err:.3g})")
    meda_timed = {}
    p = tmeda.MEDAParams(width=80, length=80, n_droplets=10,
                         obs_version="v0.2")
    for batch in MEDA_KERNEL_B:
        x = time_meda_kernel(tmeda, meda_step, p, batch, g)
        meda_timed[batch] = x
        log(f"phase 2: [{smi}] MEDA 80x80-10d v0.2 at B={batch}: kernel "
            f"{x['kernel_ms'] * 1e3:.2f} us device, {x['kernel_wall_ms']:.4f}"
            f" ms wall; plain {x['plain_ms']:.4f} ms device, "
            f"{x['plain_wall_ms']:.4f} ms wall; bound {x['bound_bytes']} B, "
            f"{x['bound_ms'] * 1e3:.2f} us "
            f"({100 * x['bound_ms'] / x['kernel_ms']:.1f}% of it)")
    log(f"phase 2: {time.perf_counter() - t0:.2f} s")

    # --- 3: the evaluate entry point, through the kernel ---
    t0 = time.perf_counter()
    argv = ["dmfb", "--drop_num=4", "--fov=9", "--evaluate_task=100",
            f"--data_dir={POLICY_4D}"]
    dmfb_step.launches = dmfb_step.launches_wide = 0
    m = evaluate.main(argv)
    launches, launches_wide = dmfb_step.launches, dmfb_step.launches_wide
    args = get_evaluate_args(argv)
    restore_net_config(args, "final")
    env = make_env_from_args(args)
    T = env.episode_limit
    if launches != T or launches_wide:
        raise AssertionError(f"evaluate launched the tile kernel {launches} "
                             f"times, expected {T} (one per step), and the "
                             f"wide kernel {launches_wide} times, expected 0")
    if not (all(math.isfinite(v) for v in m.values())
            and 0 < m["steps"] <= T and 0.0 <= m["success_rate"] <= 1.0):
        raise AssertionError(f"evaluate returned {m}")
    log(f"phase 3: evaluate: success {m['success_rate']}, steps "
        f"{m['steps']}, reward {m['reward']:.4f}, kernel launches "
        f"{launches} (T = {T}), wide kernel {launches_wide}; conv width "
        f"{args.hyper_hidden_dim}")

    # the same greedy rollout of the policy on the card (kernel) and the CPU
    # (plain)
    policy = Trainer(env, args, eval_only=True)
    policy.load_model("final", params_only=True)
    net = policy.net.eval()
    same = greedy_card_vs_cpu(env, net, args.rnn_hidden_dim, 64, 7)
    log(f"phase 3: greedy rollout of 64 chips, card vs CPU: "
        f"{same}/64 episodes identical")
    if same != 64:
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
    dmfb_step.launches = dmfb_step.launches_wide = 0
    t1 = time.perf_counter()
    res = rollout(warm.env_states, ga, 1.0, anneal, args.min_epsilon)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches_actor = dmfb_step.launches
    if launches_actor != T or dmfb_step.launches_wide:
        raise AssertionError(f"the actor rollout launched the tile kernel "
                             f"{launches_actor} times, expected {T}, and "
                             f"the wide kernel {dmfb_step.launches_wide}")
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
             f"--data_dir={data_dir}", ONE_DEVICE]
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
        lambda dev: QLearner(targs, build_agent_net(targs).to(dev)),
        learner.state(), batch)
    adam_bound = 2 * targs.lr * LEARN_UPDATES
    log(f"phase 5: learner card vs CPU over {LEARN_UPDATES} updates at batch "
        f"{targs.batch_size}: loss rel diff {loss_rel:.3g} (<= {LOSS_RTOL}), "
        f"params max diff {clean:.3g} outside noise gradients (<= "
        f"{PARAM_ATOL}), {worst:.3g} in all (<= {adam_bound:.3g})")
    if not (loss_rel <= LOSS_RTOL and clean <= PARAM_ATOL
            and worst <= adam_bound):
        raise AssertionError("the learner on the card departs from the CPU")

    # --remat and --fused_streams on the card against the plain learner on
    # the card, from the same state and minibatch
    t1 = time.perf_counter()
    variants = {}
    for flag in ("remat", "fused_streams"):
        vargs = dataclasses.replace(targs, **{flag: True})
        v_rel, v_clean, v_worst, v_card = compare_learner(
            lambda dev, a=vargs: QLearner(a, build_agent_net(a).to(dev)),
            learner.state(), batch,
            make_ref=lambda dev: QLearner(targs,
                                          build_agent_net(targs).to(dev)))
        v_ms, v_peak = time_updates(v_card, batch)
        variants[flag] = dict(loss_rel=v_rel, param_diff=v_clean,
                              param_diff_all=v_worst, update_ms=v_ms,
                              peak_mib=v_peak)
        log(f"phase 5: [{smi}] --{flag} vs the plain learner on the card over "
            f"{LEARN_UPDATES} updates at batch {targs.batch_size}: loss rel "
            f"diff {v_rel:.3g} (<= {LOSS_RTOL}), params max diff "
            f"{v_clean:.3g} outside noise gradients (<= {PARAM_ATOL}), "
            f"{v_worst:.3g} in all (<= {adam_bound:.3g}); update "
            f"{v_ms:.2f} ms, peak memory of an update {v_peak:.1f} MiB")
        if not (v_rel <= LOSS_RTOL and v_clean <= PARAM_ATOL
                and v_worst <= adam_bound):
            raise AssertionError(f"--{flag} departs from the plain learner")
        del v_card
    log(f"phase 5: --remat and --fused_streams on the card: "
        f"{time.perf_counter() - t1:.2f} s")

    # times: an update (CUDA events), a cycle and its env steps (host clock)
    update_ms, update_peak = time_updates(card, batch)
    log(f"phase 5: [{smi}] plain update {update_ms:.2f} ms, peak memory of "
        f"an update {update_peak:.1f} MiB")
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

    phase6 = trained_policies(smi)
    phase7 = meda_qmix(smi)
    # phase 8 runs last: after its torch.profiler trace every launch of the
    # process is slower (tools/time_after_profiler.py times phase 12 alone
    # and after one trace), and the phases after it are timed
    phase9 = data_parallel(smi)
    phase10 = bench_entries(smi, T)
    phase11 = wide_kernel(smi)
    phase12 = learning(smi)
    phase13 = largest_meda(smi)
    phase8 = seed_farm(smi)
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
        "registers": main4[True][0]["registers"],
        "launches_no_obs": phase6["launches_no_obs"],
        "launches_policies": sum(v["launches"] for v in
                                 phase6["policies"].values()),
        "launches_sweeps": (phase6["sweep"]["launches"]
                            + phase6["sweep_10d"]["launches"]),
        "no_obs_max_abs_err": phase6["no_obs"]["max_abs_err"],
        "no_obs_ms": phase6["no_obs"][KERNEL_B]["ms"],
        "no_obs_plain_ms": phase6["no_obs"][KERNEL_B]["plain_ms"],
        "no_obs_bound_ms": phase6["no_obs"][KERNEL_B]["bound_ms"],
        "no_obs_bound_by": phase6["no_obs"][KERNEL_B]["bound_by"],
        "no_obs_ms_b100": phase6["no_obs"][EVAL_B]["ms"],
        "no_obs_plain_ms_b100": phase6["no_obs"][EVAL_B]["plain_ms"],
        "no_obs_bound_ms_b100": phase6["no_obs"][EVAL_B]["bound_ms"],
        "no_obs_registers": main4[False][0]["registers"],
        "launches_qmix_eval": phase7["launches_qmix_eval"],
        "launches_qmix_train": phase7["launches_qmix_train"],
        "launches_farm": phase8["train"]["launches"],
        "launches_farm_rollout": phase8["train"]["launches_rollout"],
        "farm_batch": phase8["train"]["batch"],
        "launches_mesh_rank": phase9["gloo2"]["launches"],
        "mesh_rank_batch": MESH_B // 2,
        "launches_bench_actor": phase10["launches"]["actor_env_steps_per_sec"],
        "launches_bench_train": phase10["launches"]["bench_train"],
        "launches_learning": phase12["launches"],
    }, {
        "name": "dmfb_step_wide",
        "route": "cuda",
        "source": "marl_dmfb_tpu_torch/csrc/dmfb_step_wide.cu",
        "replaces": "marl_dmfb_tpu/ops/dmfb_step_pallas.py:44",
        "launches": phase11["launches"]["eval_20x20_20d"],
        "launches_eval_200x200_4d": phase11["launches"]["eval_200x200_4d"],
        "launches_train_160x160_4d": phase11["launches"]["train_160x160_4d"],
        "max_abs_err": phase11["max_abs_err"],
        "ms": phase11["timed"][0]["ms"],
        "plain_ms": phase11["timed"][0]["plain_ms"],
        "bound_ms": phase11["timed"][0]["bound_ms"],
        "bound_by": phase11["timed"][0]["bound_by"],
        "library_ms": None,
        "shape": phase11["timed"][0]["shape"],
        "batch": phase11["timed"][0]["batch"],
        "timed": phase11["timed"],
        "no_obs_ms": phase11["timed"][0]["no_obs_ms"],
        "no_obs_plain_ms": phase11["timed"][0]["no_obs_plain_ms"],
        "no_obs_bound_ms": phase11["timed"][0]["no_obs_bound_ms"],
        "group": phase11["timed"][0]["group"],
        "ptxas": {f"{layout}_{'obs' if mode else 'no_obs'}":
                  found[0] for (layout, mode), found in wide.items()},
    }, {
        "name": "meda_step",
        "route": "cuda",
        "source": "marl_dmfb_tpu_torch/csrc/meda_step.cu",
        "replaces": None,
        "launches": phase7["actor"]["launches"],
        "launches_eval": phase7["launches_meda_eval"],
        "launches_train": phase7["launches_meda_train"],
        "launches_sweep": phase7["sweep"]["launches"],
        "launches_train_80x80_10d": {
            name: run["launches_meda"]
            for name, run in phase13["train"].items()},
        "launches_bench_actor":
            phase10["launches"]["actor_env_steps_per_sec_meda"],
        "max_abs_err": max(meda_err, phase7["env_reward_diff"]),
        "batch": MEDA_KERNEL_B[-1],
        "ms": meda_timed[MEDA_KERNEL_B[-1]]["kernel_ms"],
        "plain_ms": meda_timed[MEDA_KERNEL_B[-1]]["plain_ms"],
        "bound_ms": meda_timed[MEDA_KERNEL_B[-1]]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "share_of_bound": (meda_timed[MEDA_KERNEL_B[-1]]["bound_ms"]
                           / meda_timed[MEDA_KERNEL_B[-1]]["kernel_ms"]),
        "timed": list(meda_timed.values()),
        "registers": {version: meda[v][0]["registers"]
                      for version, v in meda_step.VERSIONS.items()},
        "ptxas": {version: meda[v][0]
                  for version, v in meda_step.VERSIONS.items()},
        "nvcc_s": built_meda.seconds,
    }]}))
    log(json.dumps({"train": {
        "cycles": cycles, "updates": updates,
        "evaluations": evals, "launches_train": launches_train,
        "update_ms": update_ms, "cycle_ms": cycle_s * 1e3,
        "env_steps_per_s": train_rate, "peak_mib": peak_train / 2 ** 20,
        "card_vs_cpu": {"loss_rel": loss_rel, "param_diff": clean,
                        "param_diff_all": worst},
        "update_peak_mib": update_peak, "variants": variants,
        "device": smi}}))
    log(json.dumps({"trained": {
        k: v for k, v in phase6.items() if k != "no_obs"}, "device": smi}))
    log(json.dumps({"meda_qmix": phase7, "device": smi}))
    log(json.dumps({"farm": phase8, "device": smi}))
    log(json.dumps({"mesh": phase9, "device": smi}))
    log(json.dumps({"bench": phase10, "device": smi}))
    log(json.dumps({"wide": {k: v for k, v in phase11.items()
                             if k not in ("timed", "launches")},
                    "device": smi}))
    log(json.dumps({"learning": phase12, "device": smi}))
    log(json.dumps({"meda_80x80_10d": phase13, "device": smi}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
