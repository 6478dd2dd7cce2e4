"""Traffic mode ``train_qmix``: the ``train`` mode's cycle under QMIX, on one
card.  The configuration's ``mixer`` block (``qmix_hidden``,
``hyper_hidden``, ``two_hyper_layers``, ``state_dim``) sets the mixer the
reference follows.

Set-up and the window are the ``train`` mode's (its ``Recorder`` and
``fill_ring``): the trainer, the benchmark's weights in the agent, the
mixer (:mod:`benchmark.reference.qmix`) and their target and averaged
copies, the ring filled with ``fill`` episodes from rollouts of
``fill_batch`` chips, the first cycles recorded until three updates have
run, then whole cycles until ``seconds`` have passed.  The judgement adds
the global states to the ``train`` mode's:

* the first rollout's ``s_ext``, replayed by the reference from the
  chips' start with the stored actions and the same move draws, counted
  in ``rollout_mismatch``;
* the ring's ``s_ext`` rows against the stored episodes', and the
  minibatches' against the ring's at the drawn indices, counted in
  ``replay_mismatch``;
* the first three updates against the QMIX reference's, the mixer's
  leaves among the agent's, each update taken by the reference from the
  program's weights and Adam moments before it: ``loss_gap``,
  ``grad_gap`` and ``delta_gap`` as the ``train`` mode reads them, the
  worst update's, and ``step_gap``, the widest relative gap between the
  loss of an update's minibatch at the weights the program's step left
  and at those the reference's step left, both computed by the
  reference in float32 (:func:`learner_numbers`).

Why each update from the program's state, where the ``train`` mode
follows the reference's own three updates: Adam's first step moves each
weight by the learning rate times the sign of its gradient, and an
element whose gradient sums to within float32 round-off of zero takes
that sign from the rounding.  Followed over three updates, such a step
changes the weights the next gradients are taken at, and Adam's
normalised steps carry the change into small leaves.  On MEDA 80x80-10d,
one seed in 48: 11 elements of the agent's third conv took the other
sign in the first update, and after the third the mixer's 32x32
``hyper_w2_2`` had moved by up to 30% more in single elements, a delta
gap of 3.3e-4, against the TF32 control's smallest reading of 3.2e-4 and
the other seeds' largest of 4.5e-5, with the first gradients alike to
seven digits.  Taken from the same state, every update is still held to
the reference's, and a round-off does not carry into the next.

Why ``step_gap``: from the same state the losses compare two forward
passes at the same weights, and ``delta_gap`` compares the norms of the
steps, so a step of the right size in the wrong direction would pass
both.  The loss a step leaves tells the direction: a weight whose sign
came from the rounding has a gradient near zero and moves that loss by
next to nothing, while a step against the gradient, or a permuted one,
moves it at first order.
"""

from __future__ import annotations

import time

import torch

from benchmark import checks, flops, flops_qmix, trace as tracing
from benchmark.harness import check_args, load_weights, note, program_args
from benchmark.instrument import Spans
from benchmark.modes.train import (JUDGED_UPDATES, TRACED_CYCLES, Recorder,
                                   fill_ring)
from benchmark.reference import net as ref_net
from benchmark.reference import qmix as ref_qmix
from benchmark.reference import rollout as ref_rollout


def _without_states(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if k != "s_ext"}


class QmixRecorder(Recorder):
    """The ``train`` mode's recorder (one card), its checks of the store
    and the minibatches made on the ring without its global states and
    the states held to the ring's beside them; it also keeps the weights
    and Adam moments after each judged update, and syncs of the mixer's
    target."""

    def __init__(self, trainer, cfg):
        super().__init__(trainer, cfg)
        self.r["states"] = []

    def store(self, real):
        held = {}

        def stateless(replay, episodes, mesh):
            held["ring"] = real(replay, episodes, mesh)
            return held["ring"]._replace(
                data=_without_states(held["ring"].data))

        base = super().store(stateless)

        def call(replay, episodes, mesh):
            judged = self.armed and "stored" not in self.r
            base(replay, episodes, mesh)
            out = held.pop("ring")
            if judged:
                s = out.data["s_ext"]
                rows = (replay.cursor + torch.arange(
                    episodes["s_ext"].shape[0], device=s.device)) % s.shape[0]
                self.replay_mismatch += checks.count_unequal(
                    {"s_ext": s[rows]}, {"s_ext": episodes["s_ext"]})
            return out
        return call

    def _judged_batch(self, batch: dict) -> dict:
        super()._judged_batch(_without_states(batch))
        idx = self.r["idx"][self.updates - 1]
        self.replay_mismatch += checks.count_unequal(
            {"s_ext": batch["s_ext"]},
            {"s_ext": self.r["replay"].data["s_ext"][idx]})
        return batch

    def update(self, real, learner):
        base = super().update(real, learner)

        def call(batch):
            judged = self.armed and self.updates < JUDGED_UPDATES
            loss = base(batch)
            if judged:
                # the state after this update: the weights (stepped in
                # place) copied, the moments (new tensors each step) held
                self.r["states"].append((
                    {n: p.detach().clone()
                     for n, p in learner.all_params.items()},
                    learner.opt_state["mu"], learner.opt_state["nu"]))
            if learner.train_step % learner.args.target_update_cycle == 0:
                self.synced = {n: p.detach().clone()
                               for n, p in learner.all_params.items()}
            return loss
        return call


def check_mixer(args, cfg: dict):
    """Raise unless the program's mixer is the configuration's."""
    pairs = {"qmix_hidden": args.qmix_hidden_dim,
             "hyper_hidden": args.hyper_hidden_dim,
             "two_hyper_layers": args.two_hyper_layers,
             "state_dim": args.state_shape}
    wrong = {k: (v, cfg[k]) for k, v in pairs.items() if v != cfg[k]}
    if wrong:
        raise RuntimeError("the program's mixer is not the configuration's "
                           f"(program, file): {wrong}")


def run(cell, cfg, seed, seconds, trace, device, t_start, overrides=None,
        calibrate=False, plant=None) -> dict:
    from marl_dmfb_tpu_torch.config import make_env_from_args
    from marl_dmfb_tpu_torch.trainer import Trainer, updates_per_rollout

    if cfg.get("ranks", 1) != 1:
        raise ValueError("the train_qmix mode runs on one card")
    if plant is not None:
        plant()
    cfg = {**cell.config["mixer"], **cfg}   # the overrides stay on top
    traffic = cell.traffic
    args = program_args(cell.config, seed, device, overrides=overrides)
    env = make_env_from_args(args)
    observe, holder = env.observe, {}
    env = env._replace(observe=lambda s: holder["observe"](s))
    trainer = Trainer(env, args)
    learner = trainer.learner
    rec = QmixRecorder(trainer, cfg)
    holder["observe"] = rec.observe(observe)
    check_args(args, cfg, decay_steps=learner.opt.decay_steps,
               updates=updates_per_rollout(args, trainer.B))
    check_mixer(args, cfg)
    w0 = ref_net.make_weights(cfg, seed + 1, device)
    m0 = ref_qmix.make_mixer_weights(cfg, seed + 4, device)
    load_weights(w0, [trainer.net, learner.target_net, trainer.ema_net])
    load_weights(m0, [trainer.mixer, learner.target_mixer,
                      trainer.ema_mixer])

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
    t0 = time.perf_counter()
    laps = [t0]
    while True:
        steps += trainer.train_cycle()
        cycles += 1
        laps.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    spans.sync()
    wall = time.perf_counter() - t0
    spans.on = False
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    T = args.episode_limit
    note(f"set-up {setup_s:.2f} s, window {wall:.2f} s, cycles (s) "
         f"{[round(b - a, 3) for a, b in zip(laps, laps[1:])]}")
    ctx = {"spans": {k: {"seconds": spans.times[k], "units": spans.counts[k]}
                     for k in spans.times},
           "window_s": wall,
           "window_flops": cycles * flops_qmix.cycle_flops(cfg, trainer.B, T),
           "peak_flops": flops.PEAK_F32_FLOPS,
           "mix_row_flops": flops_qmix.mix_row_flops(cfg), "trace": None}
    if trace and torch.device(device).type == "cuda":
        ctx["trace"] = tracing.summarize(
            tracing.record(trainer.train_cycle, TRACED_CYCLES, spans))
        ctx["updates_traced"] = TRACED_CYCLES * trainer.updates_per_rollout
        note(f"traced by {time.time() - t_start:.2f} s")

    numbers, readings = judge(rec, trainer, cfg, w0, m0, calibrate)
    note(f"judged by {time.time() - t_start:.2f} s")
    return {"e2e": {"train_env_steps_per_s": steps / wall,
                    "setup_s": setup_s},
            "ctx": ctx, "numbers": numbers, "readings": readings,
            "attempted": cycles, "failed": 0, "peak": peak}


def judge(rec, trainer, cfg, w0, m0, calibrate):
    r = rec.r
    res = r["result"]
    episodes = res.episodes
    numbers = checks.judge_rollout(
        cfg, w0, r["rollout_start"], r["rollout_gen"], episodes,
        trainer.args.min_epsilon, trainer.B, control=calibrate)
    readings = {k: numbers.pop(k) for k in list(numbers) if "." in k}
    _, _, uniforms = ref_rollout.draws(
        r["rollout_gen"], episodes["u"].device, episodes["u"].shape[1],
        trainer.B, cfg["n_droplets"], cfg["n_actions"])
    wrong = ref_qmix.state_mismatch(
        cfg, r["rollout_start"]._asdict(), uniforms, episodes["s_ext"],
        episodes["u"][..., 0])
    numbers["rollout_mismatch"] += wrong
    if wrong:
        readings["mismatch.s_ext"] = wrong
    numbers["replay_mismatch"] = rec.replay_mismatch

    wm0 = ref_qmix.joined(w0, m0)
    zeros = {k: torch.zeros_like(v) for k, v in wm0.items()}
    starts = [(wm0, zeros, zeros)] + r["states"][:-1]
    batches = r["batches"]
    b1 = cfg["adam_betas"][0]
    prog = ([float(x) for x in r["losses"]],
            {k: v / (1 - b1) for k, v in r["states"][0][1].items()},
            [w for w, _, _ in r["states"]])
    ref = ref_qmix.steps_from(starts, batches, wm0, cfg)
    at = lambda weights: ref_qmix.losses_at(weights, batches, wm0, cfg)
    left_r = at(ref[2])
    numbers.update(learner_numbers(starts, prog, at(prog[2]), ref, left_r))
    if calibrate:
        for kind, kw in (("control", {"control": True}),
                         ("half_batch", {"half_batch": True})):
            c = ref_qmix.steps_from(starts, batches, wm0, cfg, **kw)
            readings.update({f"{kind}.{k}": v for k, v in learner_numbers(
                starts, c, at(c[2]), ref, left_r).items()})
        flipped = [{k: 2 * s[k] - w[k] for k in w}
                   for (s, _, _), w in zip(starts, ref[2])]
        readings["sign_flipped.step_gap"] = step_gap(at(flipped), left_r)
        readings["unchanged.step_gap"] = step_gap(
            at([w for w, _, _ in starts]), left_r)
        readings["unchanged.delta_gap"] = 1.0
    if "ema_after" in r:
        decay = cfg["param_ema"] ** cfg["updates_per_cycle"]
        numbers["ema_gap"] = checks.ema_gap(r["ema_before"], r["ema_live"],
                                            r["ema_after"], decay)
        if calibrate:
            readings["unchanged.ema_gap"] = checks.ema_gap(
                r["ema_before"], r["ema_live"], r["ema_before"], decay)
    if rec.synced is not None:
        learner = trainer.learner
        target = ref_qmix.joined(
            dict(learner.target_net.named_parameters()),
            dict(learner.target_mixer.named_parameters()))
        numbers["target_mismatch"] = sum(
            int((target[k] != v).sum()) for k, v in rec.synced.items())
    return numbers, readings


def step_gap(left_p: list, left_r: list) -> float:
    """The widest relative gap between the losses that two sides' steps
    left on their minibatches."""
    return max(abs(p - r) / abs(r) for p, r in zip(left_p, left_r))


def learner_numbers(starts, prog, left_p, ref, left_r) -> dict:
    """:func:`benchmark.checks.learner_numbers` of each update, taken from
    its start ``starts[k]`` on both sides, the worst update's, and
    ``step_gap``.  ``prog`` and ``ref`` are each side's losses before the
    steps, first clipped gradients and weights after each step
    (:func:`benchmark.reference.qmix.steps_from`); ``left_p`` and
    ``left_r`` the losses those weights leave."""
    (losses_p, g1_p, after_p), (losses_r, g1_r, after_r) = prog, ref
    per = [checks.learner_numbers([lp], g1_p, wp, [lr], g1_r, wr, w0)
           for lp, lr, wp, wr, (w0, _, _) in zip(losses_p, losses_r, after_p,
                                                 after_r, starts)]
    return {**{k: max(n[k] for n in per) for k in per[0]},
            "step_gap": step_gap(left_p, left_r)}
