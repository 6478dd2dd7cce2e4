#!/usr/bin/env python3
"""Time to quality of the PyTorch port: a recipe of the JAX package's
``artifacts/time_to_quality.json`` trained from scratch, every checkpoint
scored, the results folded into
``marl_dmfb_tpu_torch/artifacts/time_to_quality.json`` in the layout of
JAX's entry.

    python3 tools/time_to_quality_torch.py --seed 12 --run_dir build/ttq/s12
    python3 tools/time_to_quality_torch.py --seed 1 --run_dir build/ttq/s1 \\
        --key seed_1_replication
    python3 tools/time_to_quality_torch.py --recipe meda_30x60_3d \\
        --seed 12 --run_dir build/ttq/m12

The recipes (:data:`RECIPES`): ``flagship`` (the default; JAX's top-level
entry), DMFB 20x20 with 4 droplets, every checkpoint scored on the 50x50
zero-shot board; ``meda_30x60_3d`` (JAX's entry of that name), MEDA 30x60
with 3 droplets, every checkpoint's success the trainer's online
evaluation.  Three steps, each skipped where the run directory already
holds its result, so that running the command again carries on where it
stopped:

1. **train**: the trainer, its arguments parsed by the train CLI's
   parser from the recipe's flags and
   ``--evaluate_cycle=50000 --seed=<s> --data_dir=<run dir>`` (a checkpoint
   and an online evaluation of 100 fresh tasks of the training board every
   50k env steps, 2M in all).  Where the run directory holds a run that
   stopped before its final checkpoint, the training resumes from its
   newest checkpoint whose time is recorded, as a new run (``--ith_run``
   one up) of the remaining env steps; its learning-rate schedule keeps
   the whole run's horizon, which the train CLI's ``--load_model`` would
   size to the remaining steps.  Without ``--ckpt_replay`` (not in the
   recipes) the replay ring starts empty there.  A run is cut by ending
   its process (``tools/time_to_quality_seeds.py`` does so at a time
   budget); never by lowering ``n_steps``, which would write a final
   checkpoint.
2. **score**: the flagship's every checkpoint through the evaluate entry
   point, ``--chip_size=50 --evaluate_task=100 --load_model_name=<tag>``:
   the checkpoint's EMA params, greedy, on the same 100 tasks for every tag
   (the CLI's evaluation seed).  An online recipe's checkpoints keep the
   trainer's own curve (``<prefix>success_rate_<run>.npy``: the EMA params,
   greedy, on 100 fresh tasks of the training board), and its newest
   checkpoint alone goes through the evaluate entry point on the training
   board, 100 tasks, as ``total_run.independent_final``.  Each score is
   kept in ``scores.json`` as it comes.
3. **fold**: the checkpoints (``tag``, ``env_steps``, ``wall_s`` and the
   recipe's success key), ``first_crossing`` (the first with success at
   least :data:`QUALITY_BAR`, else null; marked ``after_resume_at`` where
   the run resumed before it), ``quality_bar``, ``total_run``, the card and
   its power limit, and a ``description`` naming the recipe, under the
   recipe's entry and ``--key`` (``default``: the entry itself, for the
   flagship the file's top level; else a nested entry, such as
   ``seed_1_replication``).  ``wall_s`` is the training's own clock at each
   checkpoint (``Trainer.time_cost``, the online evaluations and checkpoint
   saves included, as JAX's); over a resumed run it adds up the time spent
   training up to each resume point, and the entry says where it resumed
   (``resumed_at``).  A run that has not reached its final checkpoint is
   folded as far as it reached: no ``final`` checkpoint, and ``total_run``
   at its newest checkpoint with the ``horizon`` it trains to.  The newest
   checkpoint's EMA params are also written as a deploy export,
   ``<run dir>/deploy/model/vdn/fov<fov>/0_final_state.pt`` (``deploy`` as
   the data directory of ``evaluate``).

``--no_train`` scores and folds what the run directory holds.  ``--device
cpu`` runs it on the CPU (default: the card), and ``--extra`` appends
flags to the training (for a run cut in size; the description names them)
and ``--score_board`` sets the flagship's scoring board.  A run of a
recipe takes tens of minutes or more on an H100: start it in the
background, with its output in a file.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

class Recipe(NamedTuple):
    flags: list      # the training's flags, the JAX package's
    entry: str       # the artifact's key ("" for its top level)
    success: str     # the checkpoints' success key
    online: bool     # success from the trainer's online evaluation


RECIPES = {
    "flagship": Recipe(
        ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=20",
         "--n_parallel_envs=64", "--lr_decay", "--param_ema=0.999"],
        "", "success_50x50", False),
    "meda_30x60_3d": Recipe(
        ["meda", "--drop_num=3", "--n_parallel_envs=64", "--lr_decay",
         "--param_ema=0.999"],
        "meda_30x60_3d", "success", True),
}
EVALUATE_CYCLE = 50000
QUALITY_BAR = 0.96
N_TASKS = 100
ARTIFACT = os.path.join(ROOT, "marl_dmfb_tpu_torch", "artifacts",
                        "time_to_quality.json")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", default="flagship", choices=list(RECIPES))
    p.add_argument("--seed", type=int, default=12)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--key", default="default")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=ARTIFACT)
    p.add_argument("--score_board", type=int, default=50)
    p.add_argument("--no_train", action="store_true",
                   help="score and fold what the run directory holds, "
                        "without training")
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
    return (RECIPES[a.recipe].flags + [
                      f"--evaluate_cycle={EVALUATE_CYCLE}",
                      f"--seed={a.seed}", f"--data_dir={a.run_dir}",
                      f"--ith_run={run}", f"--device={a.device}",
                      "--mesh=off"] + a.extra)


def _args(a, run: int = 0):
    from marl_dmfb_tpu_torch.config import get_train_args
    return get_train_args(train_argv(a, run), pri=False)


def runtime(a, run: int, curve: str = "runtime") -> list:
    """Run ``run``'s recorded times, one a checkpoint (the curve the
    trainer writes after each evaluation), or [] (``curve``: another of
    its curves, such as ``success_rate``)."""
    import numpy as np
    from marl_dmfb_tpu_torch.trainer import curve_dir, curve_prefix
    args = _args(a, run)
    path = os.path.join(curve_dir(args),
                        f"{curve_prefix(args)}{curve}_{run}.npy")
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
    from marl_dmfb_tpu_torch.config import make_env_from_args
    from marl_dmfb_tpu_torch.trainer import Trainer
    from marl_dmfb_tpu_torch.utils.platform import select_device

    segs = segments(a)
    if segs and segs[-1][3]:
        return None
    args = _args(a, len(segs))
    select_device(args.device)
    trainer = Trainer(make_env_from_args(args), args)
    if segs:
        run, _, last, _ = segs[-1]
        base = sum(s[2] for s in segs) * args.evaluate_cycle
        remaining = args.total_env_steps - base
        print(f"time_to_quality: resuming run {run} from its checkpoint "
              f"{last} ({base} env steps) as run {run + 1}, {remaining} env "
              "steps to go", flush=True)
        args.load_model, args.load_model_name = True, f"{run}_{last}"
        trainer.load_model(args.load_model_name)
        # the optimizer's schedule was sized for the whole run; the loop
        # runs the rest
        args.n_steps = remaining
    trainer.run(args.online_eval)
    return trainer


def checkpoint_list(a) -> tuple:
    """``(rows, resumed)``: ``(file tag, wall_s, online success)`` of every
    checkpoint of the whole run in order, the file tag ``<run>_<tag>`` (a
    resumed run's checkpoint 0 repeats the one it resumed from and is left
    out), and where the run resumed.  The ``i``-th row is the whole run's
    checkpoint ``i``, at ``i`` evaluation cycles of env steps (nominal, as
    JAX's artifact counts them), the last its final one where the run has
    ended, else its newest."""
    rows, resumed, done_steps, wall = [], [], 0, 0.0
    cycle = _args(a).evaluate_cycle
    segs = segments(a)
    for run, times, last, done in segs:
        online = runtime(a, run, "success_rate")
        n = len(times) - 1 if done else last + 1
        rows += [(f"{run}_{i}", wall + times[i], round(online[i], 2))
                 for i in range(1 if run else 0, n)]
        if done:
            rows.append((f"{run}_final", wall + times[-1],
                         round(online[-1], 2)))
        elif run < segs[-1][0]:
            done_steps += last * cycle
            wall += times[last]
            resumed.append({"tag": str(done_steps // cycle),
                            "env_steps": done_steps, "wall_s": wall,
                            "as_run": run + 1})
    return rows, resumed


def score(a) -> dict:
    """Step 2 (module docstring): ``{"<run>_<tag>": success}`` of the
    flagship's checkpoints, or of an online recipe's ``{"<run>_<tag>":
    {"n_tasks", "steps", "success"}}`` of its newest checkpoint."""
    from marl_dmfb_tpu_torch import evaluate
    path = os.path.join(a.run_dir, "scores.json")
    scores = {}
    if os.path.isfile(path):
        with open(path) as f:
            scores = json.load(f)
    t = _args(a)
    rows = checkpoint_list(a)[0]
    online = RECIPES[a.recipe].online
    for i, (name, _, _) in enumerate(rows):
        if name in scores or online and i < len(rows) - 1:
            continue
        board = ([f"--width={t.width}", f"--length={t.length}",
                  f"--version={t.version}"] if online
                 else [f"--chip_size={a.score_board}"])
        m = evaluate.main([t.name, f"--drop_num={t.drop_num}",
                           f"--fov={t.fov}", *board,
                           f"--evaluate_task={N_TASKS}",
                           f"--data_dir={a.run_dir}",
                           f"--load_model_name={name}",
                           f"--device={a.device}"])
        success = round(float(m["success_rate"]), 2)
        scores[name] = success if not online else {
            "tag": "final" if name.endswith("_final") else str(i),
            "n_tasks": N_TASKS, "steps": round(float(m["steps"]), 1),
            "success": success}
        print(f"time_to_quality: checkpoint {i} ({name}): {scores[name]}",
              flush=True)
        with open(path, "w") as f:
            json.dump(scores, f, indent=1)
    return scores


def fold(success: list, wall_s: list, first_tag: int = 0,
         cycle: int = EVALUATE_CYCLE, total_steps: int = 2_000_000,
         bar: float = QUALITY_BAR,
         key: str = RECIPES["flagship"].success,
         ended: bool = True) -> dict:
    """The checkpoints, ``first_crossing``, ``quality_bar`` and
    ``total_run`` of an artifact entry in JAX's layout, from one success
    rate and one wall time a checkpoint: tags ``first_tag``, ``first_tag +
    1``, ... at ``cycle`` env steps each, the last one the final checkpoint
    at ``total_steps`` (``tools/scratch_ttq_meda.py``'s fold), or, where
    the run has not ``ended``, its newest, and ``total_run`` how far it
    reached."""
    checkpoints = [{"tag": str(first_tag + i),
                    "env_steps": (first_tag + i) * cycle,
                    "wall_s": w, key: s}
                   for i, (s, w) in enumerate(zip(success, wall_s))]
    last = checkpoints[-1]
    if ended:
        last.update(tag="final", env_steps=total_steps)
        total_run = {"env_steps": total_steps, "wall_s": last["wall_s"],
                     f"{key}_final": last[key]}
    else:
        total_run = {"env_steps": last["env_steps"],
                     "wall_s": last["wall_s"], "horizon": total_steps}
    return {
        "quality_bar": bar,
        "first_crossing": next((c for c in checkpoints if c[key] >= bar),
                               None),
        "total_run": total_run,
        "checkpoints": checkpoints,
    }


def describe(a, device: str, resumed) -> str:
    recipe = RECIPES[a.recipe]
    flags = recipe.flags + [f"--evaluate_cycle={EVALUATE_CYCLE}",
                            f"--seed={a.seed}"] + a.extra
    args = _args(a)
    board = f"{args.width}x{args.length}"
    if recipe.online:
        scored = (
            f"every checkpoint's success is the trainer's online evaluation:"
            f" the EMA params, greedy, on {N_TASKS} fresh tasks of the "
            f"{board} training board; the newest checkpoint is also scored "
            "by python -m marl_dmfb_tpu_torch.evaluate "
            f"{args.name} --drop_num={args.drop_num} "
            f"--evaluate_task={N_TASKS} (total_run.independent_final)")
    else:
        scored = (
            "every checkpoint's EMA params scored greedy on the "
            f"{a.score_board}x{a.score_board} zero-shot board, 100 random "
            "tasks, by python -m marl_dmfb_tpu_torch.evaluate "
            f"--chip_size={a.score_board} --evaluate_task=100")
    what = ("the flagship recipe" if a.recipe == "flagship"
            else f"the {a.recipe} recipe")
    return (
        f"Time-to-quality of {what} trained by the PyTorch port: python -m "
        f"marl_dmfb_tpu_torch.train {' '.join(flags)} "
        f"({args.total_env_steps} env steps, a checkpoint every "
        f"{args.evaluate_cycle} env steps); {scored}.  Measured "
        f"{time.strftime('%Y-%m-%d')} on {device} by "
        "tools/time_to_quality_torch.py (wall_s: the training's clock, "
        f"Trainer.time_cost, including the online {board} evaluations and "
        "the checkpoint saves"
        + ("; over a run resumed from a checkpoint, the time spent training "
           "up to each resume point, then the resumed run's"
           if resumed else "") + ").")


def write(a, scores: dict) -> dict:
    """Step 3 (module docstring); returns the entry written."""
    from marl_dmfb_tpu_torch import checkpoint

    recipe = RECIPES[a.recipe]
    rows, resumed = checkpoint_list(a)
    segs = segments(a)
    ended = segs[-1][3]
    args = _args(a)
    device = card(a.device)
    newest = rows[-1][0]
    entry = {"description": describe(a, device, resumed), "card": device,
             **fold([row[2] if recipe.online else scores[row[0]]
                     for row in rows],
                    [wall for _, wall, _ in rows], cycle=args.evaluate_cycle,
                    total_steps=args.total_env_steps, key=recipe.success,
                    ended=ended)}
    if recipe.online:
        entry["total_run"]["independent_final"] = scores[newest]
    first = entry["first_crossing"]
    behind = [r["tag"] for r in resumed
              if first is not None and r["env_steps"] < first["env_steps"]]
    if behind:
        entry["first_crossing"] = dict(first, after_resume_at=behind[-1])
    if resumed:
        entry["resumed_at"] = resumed
    data = {}
    if os.path.isfile(a.out):
        with open(a.out) as f:
            data = json.load(f)
    # a recipe's entry, its nested seeds kept
    into = data.setdefault(recipe.entry, {}) if recipe.entry else data
    if a.key == "default":
        if not resumed:
            into.pop("resumed_at", None)
        into.update(entry)
    else:
        into[a.key] = dict(entry, note=f"same recipe, --seed={a.seed}")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    run, tag = newest.split("_", 1)
    tree = checkpoint.load(_ckpt(a, run, tag))
    args.data_dir = os.path.join(a.run_dir, "deploy")
    checkpoint.save(checkpoint.model_state_path(args, "final", write=True),
                    {k: tree[k] for k in ("ema", "epsilon", "net_config")})
    print(f"time_to_quality: {recipe.entry or 'flagship'} {a.key}: first "
          f"crossing {entry['first_crossing']}, "
          f"{'final' if ended else 'newest'} {entry['checkpoints'][-1]}",
          flush=True)
    return entry


def main(argv=None):
    """Returns the entry written, or None where the run directory holds no
    checkpoint."""
    a = parse(argv)
    if not a.no_train:
        train(a)
    if not checkpoint_list(a)[0]:
        print("time_to_quality: no checkpoint to fold", flush=True)
        return None
    scores = score(a)
    if not segments(a)[-1][3]:
        print("time_to_quality: the run has not ended; folded as far as it "
              "reached, run again to resume it", flush=True)
    return write(a, scores)


if __name__ == "__main__":
    main()
