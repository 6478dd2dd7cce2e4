#!/usr/bin/env python3
"""Time to quality of the PyTorch port: the flagship recipe trained from
scratch, every checkpoint scored on the 50x50 zero-shot board, the results
folded into ``marl_dmfb_tpu_torch/artifacts/time_to_quality.json`` in the
layout of the JAX package's ``artifacts/time_to_quality.json``.

    python3 tools/time_to_quality_torch.py --seed 12 --run_dir build/ttq/s12
    python3 tools/time_to_quality_torch.py --seed 1 --run_dir build/ttq/s1 \\
        --key seed_1_replication

Three steps, each skipped where the run directory already holds its
result, so that running the command again carries on where it stopped:

1. **train**: the train CLI with the recipe (:data:`RECIPE`) and
   ``--evaluate_cycle=50000 --seed=<s> --data_dir=<run dir>`` (a checkpoint
   and an online 20x20 evaluation every 50k env steps, 2M in all).  Where
   the run directory holds a run that stopped before its final checkpoint,
   the training resumes from its newest checkpoint whose time is recorded,
   as a new run (``--ith_run`` one up) of the remaining env steps; its
   learning-rate schedule keeps the whole run's horizon, which the train
   CLI's ``--load_model`` would size to the remaining steps.  Without
   ``--ckpt_replay`` (not in the recipe) the replay ring starts empty there.
2. **score**: every checkpoint through the evaluate entry point,
   ``--chip_size=50 --evaluate_task=100 --load_model_name=<tag>``: the
   checkpoint's EMA params, greedy, on the same 100 tasks for every tag
   (the CLI's evaluation seed); each score is kept in ``scores.json`` as it
   comes.
3. **fold**: the checkpoints (``tag``, ``env_steps``, ``wall_s``,
   ``success_50x50``), ``first_crossing`` (the first with success at least
   :data:`QUALITY_BAR`, else null), ``quality_bar``, ``total_run``, the
   card and its power limit, and a ``description`` naming the recipe,
   under ``--key`` (``default``: the file's top level, as JAX's flagship
   entry; else a nested entry, such as ``seed_1_replication``).
   ``wall_s`` is the training's own clock at each checkpoint
   (``Trainer.time_cost``, the online evaluations and checkpoint saves
   included, as JAX's); over a resumed run it adds up the time spent
   training up to each resume point, and the entry says where it resumed.
   The final checkpoint's EMA params are also written as a deploy export,
   ``<run dir>/deploy/model/vdn/fov9/0_final_state.pt`` (``deploy`` as the
   data directory of ``evaluate``).

``--no_train`` scores and folds what the run directory holds (for a
training stopped by a time limit: score it, keep its newest checkpoint,
and resume it later).  ``--device cpu`` runs it on the CPU (default: the
card), and ``--extra``
appends flags to the training (for a run cut in size; the description
names them) and ``--score_board`` sets the scoring board.  A run of the
recipe takes tens of minutes on an H100: start it in the background, with
its output in a file.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RECIPE = ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=20",
          "--n_parallel_envs=64", "--lr_decay", "--param_ema=0.999"]
EVALUATE_CYCLE = 50000
QUALITY_BAR = 0.96
SUCCESS = "success_50x50"
ARTIFACT = os.path.join(ROOT, "marl_dmfb_tpu_torch", "artifacts",
                        "time_to_quality.json")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=12)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--key", default="default")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=ARTIFACT)
    p.add_argument("--score_board", type=int, default=50)
    p.add_argument("--no_train", action="store_true",
                   help="score what the run directory holds, and fold it "
                        "where the run has ended, without training")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="flags appended to the training's (last)")
    return p.parse_args(argv)


def card(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    the CPU's name."""
    if not device.startswith("cuda"):
        return f"CPU ({platform.machine()}, {os.cpu_count()} cores)"
    from chip_smoke import nvidia_smi_line
    return nvidia_smi_line()


def train_argv(a, run: int = 0) -> list:
    return (RECIPE + [f"--evaluate_cycle={EVALUATE_CYCLE}",
                      f"--seed={a.seed}", f"--data_dir={a.run_dir}",
                      f"--ith_run={run}", f"--device={a.device}",
                      "--mesh=off"] + a.extra)


def _args(a, run: int = 0):
    from marl_dmfb_tpu_torch.config import get_train_args
    return get_train_args(train_argv(a, run), pri=False)


def runtime(a, run: int) -> list:
    """Run ``run``'s recorded times, one a checkpoint (the curve the
    trainer writes after each evaluation), or []."""
    import numpy as np
    from marl_dmfb_tpu_torch.trainer import curve_dir, curve_prefix
    args = _args(a, run)
    path = os.path.join(curve_dir(args),
                        f"{curve_prefix(args)}runtime_{run}.npy")
    return np.load(path).tolist() if os.path.isfile(path) else []


def _ckpt(a, run: int, tag) -> str:
    from marl_dmfb_tpu_torch.checkpoint import model_dir
    return os.path.join(model_dir(_args(a, run)), f"{run}_{tag}_state.pt")


def segments(a) -> list:
    """The runs in the run directory, in order, each ``(run, times, last,
    done)``: its recorded times, its newest checkpoint whose time is
    recorded (an index) and whether it reached its final checkpoint (whose
    time comes last).  Only that newest checkpoint need still be there."""
    out = []
    while True:
        run = len(out)
        times = runtime(a, run)
        if not times:
            return out
        folder = os.path.dirname(_ckpt(a, run, 0))
        tags = [name[len(f"{run}_"):-len("_state.pt")]
                for name in (os.listdir(folder) if os.path.isdir(folder)
                             else [])
                if name.startswith(f"{run}_") and name.endswith("_state.pt")]
        saved = max((int(t) + 1 for t in tags if t.isdigit()), default=0)
        done = "final" in tags and len(times) == saved + 1
        out.append((run, times, min(len(times), saved) - 1, done))
        if done:
            return out


def train(a):
    """Step 1 (module docstring); returns the trainer, or None where the
    run had ended."""
    from marl_dmfb_tpu_torch import train as ttrain
    from marl_dmfb_tpu_torch.config import make_env_from_args
    from marl_dmfb_tpu_torch.trainer import Trainer
    from marl_dmfb_tpu_torch.utils.platform import select_device

    segs = segments(a)
    if not segs:
        return ttrain.main(train_argv(a))
    run, _, last, done = segs[-1]
    if done:
        return None
    args = _args(a, run + 1)
    base = sum(s[2] for s in segs) * args.evaluate_cycle
    remaining = args.total_env_steps - base
    print(f"time_to_quality: resuming run {run} from its checkpoint {last} "
          f"({base} env steps) as run {run + 1}, {remaining} env steps to "
          "go", flush=True)
    args.load_model, args.load_model_name = True, f"{run}_{last}"
    select_device(args.device)
    trainer = Trainer(make_env_from_args(args), args)
    trainer.load_model(args.load_model_name)
    # the optimizer's schedule was sized for the whole run; the loop runs
    # the rest
    args.n_steps = remaining
    trainer.run()
    return trainer


def checkpoint_list(a) -> tuple:
    """``(rows, resumed)``: ``(file tag, wall_s)`` of every checkpoint of
    the whole run in order, the file tag ``<run>_<tag>`` (a resumed run's
    checkpoint 0 repeats the one it resumed from and is left out), and
    where the run resumed.  The ``i``-th row is the whole run's checkpoint
    ``i``, at ``i`` evaluation cycles of env steps (nominal, as JAX's
    artifact counts them), the last its final one."""
    rows, resumed, done_steps, clock = [], [], 0, 0.0
    cycle = _args(a).evaluate_cycle
    for run, times, last, done in segments(a):
        n = len(times) - 1 if done else last + 1
        rows += [(f"{run}_{i}", clock + times[i])
                 for i in range(1 if run else 0, n)]
        if done:
            rows.append((f"{run}_final", clock + times[-1]))
        else:
            done_steps += last * cycle
            clock += times[last]
            resumed.append({"tag": str(done_steps // cycle),
                            "env_steps": done_steps, "wall_s": clock,
                            "as_run": run + 1})
    return rows, resumed


def score(a) -> dict:
    """Step 2 (module docstring): ``{"<run>_<tag>": success}``."""
    from marl_dmfb_tpu_torch import evaluate
    path = os.path.join(a.run_dir, "scores.json")
    scores = {}
    if os.path.isfile(path):
        with open(path) as f:
            scores = json.load(f)
    t = _args(a)
    for i, (name, _) in enumerate(checkpoint_list(a)[0]):
        if name in scores:
            continue
        m = evaluate.main(["dmfb", f"--drop_num={t.drop_num}",
                           f"--fov={t.fov}",
                           f"--chip_size={a.score_board}",
                           "--evaluate_task=100", f"--data_dir={a.run_dir}",
                           f"--load_model_name={name}",
                           f"--device={a.device}"])
        scores[name] = round(float(m["success_rate"]), 2)
        print(f"time_to_quality: checkpoint {i} ({name}): "
              f"{SUCCESS} {scores[name]:.2f}", flush=True)
        with open(path, "w") as f:
            json.dump(scores, f, indent=1)
    return scores


def fold(success: list, wall_s: list, first_tag: int = 0,
         cycle: int = EVALUATE_CYCLE, total_steps: int = 2_000_000,
         bar: float = QUALITY_BAR, key: str = SUCCESS) -> dict:
    """The checkpoints, ``first_crossing``, ``quality_bar`` and
    ``total_run`` of an artifact entry in JAX's layout, from one success
    rate and one wall time a checkpoint: tags ``first_tag``, ``first_tag +
    1``, ... at ``cycle`` env steps each, the last one the final checkpoint
    at ``total_steps`` (``tools/scratch_ttq_meda.py``'s fold)."""
    checkpoints = [{"tag": str(first_tag + i),
                    "env_steps": (first_tag + i) * cycle,
                    "wall_s": w, key: s}
                   for i, (s, w) in enumerate(zip(success, wall_s))]
    checkpoints[-1].update(tag="final", env_steps=total_steps)
    final = checkpoints[-1]
    return {
        "quality_bar": bar,
        "first_crossing": next((c for c in checkpoints if c[key] >= bar),
                               None),
        "total_run": {"env_steps": total_steps, "wall_s": final["wall_s"],
                      f"{key}_final": final[key]},
        "checkpoints": checkpoints,
    }


def describe(a, device: str, resumed) -> str:
    flags = RECIPE[1:] + [f"--evaluate_cycle={EVALUATE_CYCLE}",
                          f"--seed={a.seed}"] + a.extra
    args = _args(a)
    return (
        "Time-to-quality of the flagship recipe trained by the PyTorch "
        f"port: python -m marl_dmfb_tpu_torch.train dmfb {' '.join(flags)} "
        f"({args.total_env_steps} env steps, a checkpoint every "
        f"{args.evaluate_cycle} env steps); every checkpoint's EMA params "
        f"scored greedy on the {a.score_board}x{a.score_board} zero-shot "
        "board, 100 random tasks, by python -m marl_dmfb_tpu_torch.evaluate "
        f"--chip_size={a.score_board} --evaluate_task=100.  Measured "
        f"{time.strftime('%Y-%m-%d')} on {device} by "
        "tools/time_to_quality_torch.py (wall_s: the training's clock, "
        "Trainer.time_cost, including the online 20x20 evaluations and the "
        "checkpoint saves"
        + ("; over a run resumed from a checkpoint, the time spent training "
           "up to each resume point, then the resumed run's"
           if resumed else "") + ").")


def write(a, scores: dict) -> dict:
    """Step 3 (module docstring); returns the entry written."""
    from marl_dmfb_tpu_torch import checkpoint

    rows, resumed = checkpoint_list(a)
    args = _args(a)
    device = card(a.device)
    entry = {"description": describe(a, device, resumed), "card": device,
             **fold([scores[name] for name, _ in rows],
                    [wall for _, wall in rows], cycle=args.evaluate_cycle,
                    total_steps=args.total_env_steps)}
    if resumed:
        entry["resumed_at"] = resumed
    data = {}
    if os.path.isfile(a.out):
        with open(a.out) as f:
            data = json.load(f)
    if a.key == "default":
        data.update(entry)
    else:
        data[a.key] = dict(entry, note=f"same recipe, --seed={a.seed}")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    tree = checkpoint.load(_ckpt(a, rows[-1][0].split("_")[0], "final"))
    args.data_dir = os.path.join(a.run_dir, "deploy")
    checkpoint.save(checkpoint.model_state_path(args, "final", write=True),
                    {k: tree[k] for k in ("ema", "epsilon", "net_config")})
    print(f"time_to_quality: {a.key}: first crossing "
          f"{entry['first_crossing']}, final {entry['checkpoints'][-1]}",
          flush=True)
    return entry


def main(argv=None):
    """Returns the entry written, or None where the run has not ended."""
    a = parse(argv)
    if not a.no_train:
        train(a)
    scores = score(a)
    segs = segments(a)
    if not (segs and segs[-1][3]):
        print("time_to_quality: the run has not ended; run again to resume "
              "it", flush=True)
        return None
    return write(a, scores)


if __name__ == "__main__":
    main()
