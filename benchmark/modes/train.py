"""Traffic mode ``train``: the recipe's training loop, ``Trainer.train_cycle``
(rollout, replay store, the recipe's updates, the EMA step), at the
recipe's epsilon floor.

Set-up builds the trainer, gives it the benchmark's weights, fills the
replay ring with episodes from rollouts of ``fill_batch`` chips until it
holds ``fill`` episodes (``"ring"``: its capacity; ``"minibatch"``: one
minibatch), and runs its first cycles with their calls recorded, as many
as hold three updates.  That same trainer then runs whole cycles until
``seconds`` have passed; the window ends at the end of a cycle, after a
synchronise.  The reference follows the first cycle's rollout chip by chip
and its EMA step, and the first three minibatches and updates; the store
and the minibatches are held to the ring.

A configuration with ``ranks`` above 1 is the data-parallel recipe: the
run starts that many processes, rank r on card r (NCCL; gloo on the CPU),
each building its rank of the trainer; they stop together, rank 0 judges
its chips and the global minibatches, gathered from the ranks, and
reports.
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist

from benchmark import checks, flops, trace as tracing
from benchmark.harness import check_args, load_weights, note, program_args
from benchmark.instrument import Spans
from benchmark.reference import net as ref_net

JUDGED_UPDATES = 3
TRACED_CYCLES = 2


def _gather(mesh, tree: dict) -> dict:
    """The ranks' shares of each tensor of ``tree``, in rank order."""
    out = {}
    for k, v in tree.items():
        parts = [torch.empty_like(v) for _ in range(mesh.size)]
        dist.all_gather(parts, v.contiguous(), group=mesh.group)
        out[k] = torch.cat(parts)
    return out


def _total(mesh, n: int) -> int:
    """``n`` summed over the ranks."""
    if mesh is None:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return int(t)


class Recorder:
    """Records what the first cycles' calls take and give, while armed,
    and holds the store and the minibatches to the ring there (on every
    rank, the counts summed)."""

    def __init__(self, trainer, cfg, mesh=None):
        self.trainer, self.cfg, self.mesh = trainer, cfg, mesh
        self.armed = False
        self.r = {"idx": [], "batches": [], "losses": []}
        self.replay_mismatch = 0
        self.updates = 0
        self.synced = None   # the weights the target net last took

    def observe(self, real):
        def call(state):
            self.r["start"] = state
            self.r["gen"] = self.trainer.generator.get_state()
            return real(state)
        return call

    def rollout(self, real):
        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            if self.armed and "result" not in self.r:
                self.r["result"] = out
                self.r["rollout_start"] = self.r["start"]
                self.r["rollout_gen"] = self.r["gen"]
            return out
        return call

    def store(self, real):
        def call(replay, episodes, mesh):
            out = real(replay, episodes, mesh)
            if self.armed and "stored" not in self.r:
                self.r["stored"] = True
                flat = checks.stored_layout(episodes)
                if self.mesh is not None:
                    flat = _gather(self.mesh, flat)
                B = flat["u"].shape[0]
                cap = out.data["u"].shape[0]
                pos = (replay.cursor + torch.arange(
                    B, device=out.data["u"].device)) % (
                        cap * (1 if self.mesh is None else self.mesh.size))
                mine = pos // cap == (0 if self.mesh is None
                                      else self.mesh.rank)
                rows = pos[mine] % cap
                self.replay_mismatch += _total(self.mesh, checks.count_unequal(
                    {k: v[rows] for k, v in out.data.items()},
                    {k: v[mine] for k, v in flat.items()}))
            return out
        return call

    def learn_many(self, real):
        def call(replay, n_updates, generator=None, idx=None):
            if self.armed and len(self.r["idx"]) < JUDGED_UPDATES:
                # the indices the judged updates will draw, from a copy of
                # the generator (alike on every rank)
                g = torch.Generator(device=replay.data["u"].device)
                g.set_state(generator.get_state())
                for _ in range(min(n_updates,
                                   JUDGED_UPDATES - len(self.r["idx"]))):
                    self.r["idx"].append(torch.randint(
                        0, max(replay.size, 1), (self.cfg["batch_size"],),
                        generator=g, device=replay.data["u"].device))
                self.r["replay"] = replay
            return real(replay, n_updates, generator, idx)
        return call

    def _judged_batch(self, batch: dict) -> dict:
        """The minibatch the update took (under a mesh, every rank's share
        gathered), its rows held to the ring's at the drawn indices."""
        idx = self.r["idx"][self.updates - 1]
        data = self.r["replay"].data
        n_agents = self.cfg["n_droplets"]
        if self.mesh is None:
            self.replay_mismatch += checks.count_unequal(
                batch, checks.views({k: v[idx] for k, v in data.items()},
                                    n_agents))
            return batch
        glob = _gather(self.mesh, batch)
        cap = data["u"].shape[0]
        mine = idx // cap == self.mesh.rank
        self.replay_mismatch += _total(self.mesh, checks.count_unequal(
            {k: v[mine] for k, v in glob.items()},
            checks.views({k: v[idx[mine] % cap] for k, v in data.items()},
                         n_agents)))
        return glob

    def update(self, real, learner):
        def call(batch):
            loss = real(batch)
            if self.armed and self.updates < JUDGED_UPDATES:
                self.updates += 1
                self.r["batches"].append(self._judged_batch(batch))
                self.r["losses"].append(loss)
                if self.updates == 1:
                    self.r["mu1"] = {n: v.clone() for n, v in
                                     learner.opt_state["mu"].items()}
                if self.updates == JUDGED_UPDATES:
                    self.r["w3"] = {n: p.detach().clone()
                                    for n, p in learner.params.items()}
            if learner.train_step % learner.args.target_update_cycle == 0:
                self.synced = {n: p.detach().clone()
                               for n, p in learner.params.items()}
            return loss
        return call

    def ema_step(self, real):
        def call():
            if not self.armed or "ema_after" in self.r:
                return real()
            t = self.trainer
            named = lambda m: {n: p.detach().clone()
                               for n, p in m.named_parameters()}
            self.r["ema_before"] = named(t.ema_net)
            self.r["ema_live"] = named(t.net)
            out = real()
            self.r["ema_after"] = named(t.ema_net)
            return out
        return call


def fill_ring(trainer, target: int, batch: int):
    """Store episodes of rollouts of ``batch`` chips (over all ranks) until
    the ring holds ``target`` of them."""
    a, mesh = trainer.args, trainer.mesh
    batch = min(batch, a.buffer_size)
    local = batch if mesh is None else batch // mesh.size
    states = trainer.env.init(local, trainer.generator, trainer.device)
    while trainer.replay.size < target:
        res = trainer.rollout(states, trainer.generator, trainer.epsilon,
                              0.0, a.min_epsilon)
        states = res.env_states
        trainer.replay = trainer._store(trainer.replay, res.episodes, mesh)


def run(cell, cfg, seed, seconds, trace, device, t_start, overrides=None,
        calibrate=False, plant=None) -> dict:
    ranks = cfg.get("ranks", 1)
    if ranks == 1:
        if plant is not None:
            plant()
        return run_rank(cell, cfg, seed, seconds, trace, device, t_start,
                        overrides, calibrate)
    with tempfile.TemporaryDirectory(prefix="bench_ranks_") as tmp:
        path = os.path.join(tmp, "rank0.json")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        torch.multiprocessing.start_processes(
            _rank_main, args=(ranks, port, path, plant, cell, cfg, seed,
                              seconds, trace, device, t_start, overrides,
                              calibrate),
            nprocs=ranks, join=True, start_method="spawn")
        with open(path) as f:
            return json.load(f)


def _rank_main(rank, ranks, port, path, plant, cell, cfg, seed, seconds,
               trace, device, t_start, overrides, calibrate):
    from marl_dmfb_tpu_torch.parallel.mesh import Mesh

    if plant is not None:   # a test's fault, planted in every rank
        plant()
    torch.set_num_threads(max(1, torch.get_num_threads() // ranks))
    cuda = torch.device(device).type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=ranks)
    try:
        mesh = Mesh(size=ranks, rank=rank, device=dev,
                    group=dist.group.WORLD)
        out = run_rank(cell, cfg, seed, seconds, trace, str(dev), t_start,
                       overrides, calibrate, mesh)
        if rank == 0:
            with open(path, "w") as f:
                json.dump(out, f)
        dist.barrier()   # no rank leaves while rank 0 still judges
    finally:
        dist.destroy_process_group()


def run_rank(cell, cfg, seed, seconds, trace, device, t_start,
             overrides=None, calibrate=False, mesh=None) -> dict:
    """One device's run, or under ``mesh`` one rank's (rank 0's result is
    the run's)."""
    from marl_dmfb_tpu_torch.config import make_env_from_args
    from marl_dmfb_tpu_torch.trainer import Trainer, updates_per_rollout

    traffic = cell.traffic
    args = program_args(cell.config, seed, device, overrides=overrides)
    env = make_env_from_args(args)
    observe, holder = env.observe, {}
    env = env._replace(observe=lambda s: holder["observe"](s))
    trainer = Trainer(env, args, mesh=mesh)
    learner = trainer.learner
    rec = Recorder(trainer, cfg, mesh)
    holder["observe"] = rec.observe(observe)
    check_args(args, cfg, decay_steps=learner.opt.decay_steps,
               updates=updates_per_rollout(args, trainer.B))
    w0 = ref_net.make_weights(cfg, seed + 1, device)
    load_weights(w0, [trainer.net, learner.target_net, trainer.ema_net])

    spans = Spans(device)
    trainer.rollout = spans.wrap("rollout", rec.rollout(trainer.rollout))
    trainer._store = spans.wrap("store", rec.store(trainer._store))
    learner.learn_many = spans.wrap("learn_many",
                                    rec.learn_many(learner.learn_many),
                                    units=lambda a, k: a[1])
    learner.update = rec.update(learner.update, learner)
    if trainer.ema_net is not None:
        trainer.ema_step = spans.wrap("ema", rec.ema_step(trainer.ema_step))

    fill = {"ring": args.buffer_size,
            "minibatch": args.batch_size}[traffic["fill"]]
    fill_ring(trainer, fill, traffic["fill_batch"])
    rec.armed = True
    while rec.updates < JUDGED_UPDATES:
        trainer.train_cycle()
    rec.armed = False
    spans.sync()
    setup_s = time.time() - t_start

    spans.on = trace
    steps = cycles = 0
    stop = torch.zeros(1, device=device)
    t0 = time.perf_counter()
    laps = [t0]
    while True:
        steps += trainer.train_cycle()
        cycles += 1
        laps.append(time.perf_counter())
        if mesh is None:
            if time.perf_counter() - t0 >= seconds:
                break
        else:   # rank 0's clock decides for all, so that they stop together
            stop.fill_(float(time.perf_counter() - t0 >= seconds))
            dist.broadcast(stop, 0, group=mesh.group)
            if stop.item():
                break
    spans.sync()
    wall = time.perf_counter() - t0
    spans.on = False
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    if mesh is not None:   # the fullest card's
        p = torch.tensor([peak], dtype=torch.int64, device=device)
        dist.all_reduce(p, op=dist.ReduceOp.MAX, group=mesh.group)
        peak = int(p)

    T = args.episode_limit
    per_cycle = flops.cycle_flops(cfg, trainer.B, T)
    note(f"set-up {setup_s:.2f} s, window {wall:.2f} s, cycles (s) "
         f"{[round(b - a, 3) for a, b in zip(laps, laps[1:])]}")
    ctx = {"spans": {k: {"seconds": spans.times[k], "units": spans.counts[k]}
                     for k in spans.times},
           "window_s": wall, "window_flops": cycles * per_cycle,
           "peak_flops": flops.PEAK_F32_FLOPS, "trace": None}
    if trace and torch.device(device).type == "cuda":
        t = tracing.summarize(
            tracing.record(trainer.train_cycle, TRACED_CYCLES, spans))
        if mesh is not None:   # the busy and traced seconds of every card
            v = torch.tensor([t["busy_s"], t["window_s"]],
                             dtype=torch.float64, device=device)
            dist.all_reduce(v, group=mesh.group)
            t["busy_s"], t["window_s"] = (v / mesh.size).tolist()
        ctx["trace"] = t
        ctx["updates_traced"] = TRACED_CYCLES * trainer.updates_per_rollout
        note(f"traced by {time.time() - t_start:.2f} s")

    numbers, readings = {}, {}
    if mesh is None or mesh.rank == 0:
        numbers, readings = judge(rec, trainer, cfg, w0, calibrate)
    note(f"judged by {time.time() - t_start:.2f} s")
    return {"e2e": {"train_env_steps_per_s": steps / wall,
                    "setup_s": setup_s},
            "ctx": ctx, "numbers": numbers, "readings": readings,
            "attempted": cycles, "failed": 0, "peak": peak}


def judge(rec, trainer, cfg, w0, calibrate):
    r = rec.r
    learner, mesh = trainer.learner, trainer.mesh
    res = r["result"]
    B_local = res.episodes["u"].shape[0]
    draw_rows = (None if mesh is None else
                 torch.arange(B_local, device=res.episodes["u"].device)
                 + mesh.rank * B_local)
    numbers = checks.judge_rollout(
        cfg, w0, r["rollout_start"], r["rollout_gen"], res.episodes,
        trainer.args.min_epsilon, trainer.B, draw_rows=draw_rows,
        control=calibrate)
    readings = {k: numbers.pop(k) for k in list(numbers) if "." in k}
    numbers["replay_mismatch"] = rec.replay_mismatch
    lrn = checks.judge_learner(cfg, w0, r["batches"],
                               [float(x) for x in r["losses"]], r["mu1"],
                               r["w3"], calibrate=calibrate)
    readings.update({k: lrn.pop(k) for k in list(lrn) if "." in k})
    numbers.update(lrn)
    if "ema_after" in r:
        decay = cfg["param_ema"] ** cfg["updates_per_cycle"]
        numbers["ema_gap"] = checks.ema_gap(r["ema_before"], r["ema_live"],
                                            r["ema_after"], decay)
        if calibrate:
            readings["unchanged.ema_gap"] = checks.ema_gap(
                r["ema_before"], r["ema_live"], r["ema_before"], decay)
    if calibrate:
        readings["unchanged.delta_gap"] = 1.0
    if rec.synced is not None:
        target = dict(learner.target_net.named_parameters())
        numbers["target_mismatch"] = sum(
            int((target[k] != v).sum()) for k, v in rec.synced.items())
    return numbers, readings
