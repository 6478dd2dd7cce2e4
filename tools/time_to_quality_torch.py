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

The recipes (:data:`RECIPES`), each a JAX run that trained to quality,
its flags letter for letter (the step budget, the evaluation cycle, the
algorithm, the dtype, the farm and the mesh among them), its entry in the
artifact under JAX's name:

* ``flagship`` (the default; JAX's top-level entry), DMFB 20x20 with 4
  droplets, every checkpoint scored on the 50x50 zero-shot board (100
  tasks) and on 10x10 and 20x20 (500 tasks each, :data:`CROSS_BOARDS`);
  ``dmfb_flagship_qmix`` the same with ``--alg=qmix`` (scored by
  ``evaluate --alg=qmix``: the agent, a fresh mixer on another board),
  ``dmfb_flagship_bf16`` with
  ``--compute_dtype=bf16`` (scored on the float32 path on the float32
  master weights, as JAX scored its run);
* online recipes, every checkpoint's success the trainer's online
  evaluation: ``meda_30x60_3d``, MEDA 30x60 with 3 droplets;
  ``mesh_10x10_2d``, DMFB 10x10 with 2 droplets over ``--mesh=4`` ranks
  started by the train CLI (rank 0's curve; its newest checkpoint also on
  20x20; a mesh run does not resume); ``seedfarm_10x10_2d``, 8 seeds in
  lockstep (``--vmap_seeds=8``): the farm's (S, E) curves, a success list
  of one rate a seed at each checkpoint, each seed's newest checkpoint
  through ``evaluate``; a stopped farm resumes from its own newest
  ``farm_<E>_resume.pt`` (``--load_model``).

Three steps, each skipped where the run directory already holds its
result, so that running the command again carries on where it stopped:

1. **train**: the trainer, its arguments parsed by the train CLI's
   parser from the recipe's flags and ``--seed=<s> --data_dir=<run dir>``
   (``--mesh=off`` unless the recipe names a mesh): a checkpoint and an
   online evaluation of 100 fresh tasks of the training board every
   evaluation cycle.  Where the run directory holds a run that
   stopped before its final checkpoint, the training resumes from its
   newest checkpoint whose time is recorded, as a new run (``--ith_run``
   one up) of the remaining env steps; its learning-rate schedule keeps
   the whole run's horizon, which the train CLI's ``--load_model`` would
   size to the remaining steps.  Without ``--ckpt_replay`` (not in the
   recipes) the replay ring starts empty there.  A run is cut by ending
   its process (``tools/time_to_quality_seeds.py`` does so at a time
   budget); never by lowering ``n_steps``, which would write a final
   checkpoint.
2. **score**: a scored recipe's every checkpoint through the evaluate
   entry point, ``--chip_size=50 --evaluate_task=100
   --load_model_name=<tag> --alg=<alg>``: the checkpoint's EMA params,
   greedy, on the same 100 tasks for every tag (the CLI's evaluation
   seed), float32.  An online recipe's checkpoints keep the
   trainer's own curve (``<prefix>success_rate_<run>.npy``: the EMA params,
   greedy, on 100 fresh tasks of the training board), and its newest
   checkpoint alone goes through the evaluate entry point on the training
   board, 100 tasks, as ``total_run.independent_final``.  The newest
   checkpoint is also scored on each of the recipe's final boards
   (``success_<b>x<b>_final``, or ``_newest`` before the end;
   ``independent_final_<b>x<b>`` of an online recipe), and every
   checkpoint of a scored recipe on each of its ``boards``, over that
   board's number of tasks (``success_<b>x<b>`` beside the checkpoint's
   success, the newest's also in ``total_run``; the entry's ``n_tasks``
   names each key's tasks).  Each score is kept in ``scores.json`` as it
   comes, under its board and number of tasks, so that a reading over
   other tasks is never taken for one over the recipe's.
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
   ``<run dir>/deploy/model/<alg>/fov<fov>/0_final_state.pt`` (``deploy``
   as the data directory of ``evaluate``; of a farm, its first seed's).

``--no_train`` scores and folds what the run directory holds.  ``--device
cpu`` runs it on the CPU (default: the card), and ``--extra`` appends
flags to the training (for a run cut in size; the description names them)
and ``--score_board`` replaces the recipe's scoring board.  A run of a
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
    flags: list      # the training's flags, JAX's recipe letter for letter
    entry: str       # the artifact's key ("" for its top level)
    success: str     # the checkpoints' success key
    online: bool     # success from the trainer's online evaluation
    board: int = None         # every checkpoint scored on it (not online)
    final_boards: tuple = ()  # the newest checkpoint also scored on these
    boards: tuple = ()        # (board, tasks): every checkpoint also on it


FLAGSHIP = ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=20",
            "--n_parallel_envs=64", "--lr_decay", "--param_ema=0.999",
            "--evaluate_cycle=50000"]
# the flagships' other boards: the training board and the smaller one, 500
# tasks each (a binomial sigma of about 0.02 at 0.8)
CROSS_BOARDS = ((10, 500), (20, 500))
RECIPES = {
    "flagship": Recipe(FLAGSHIP, "", "success_50x50", False, 50, (),
                       CROSS_BOARDS),
    "meda_30x60_3d": Recipe(
        ["meda", "--drop_num=3", "--n_parallel_envs=64", "--lr_decay",
         "--param_ema=0.999", "--evaluate_cycle=50000"],
        "meda_30x60_3d", "success", True),
    "dmfb_flagship_qmix": Recipe(FLAGSHIP + ["--alg=qmix"],
                                 "dmfb_flagship_qmix", "success_50x50",
                                 False, 50, (), CROSS_BOARDS),
    "dmfb_flagship_bf16": Recipe(FLAGSHIP + ["--compute_dtype=bf16"],
                                 "dmfb_flagship_bf16", "success_50x50",
                                 False, 50),
    "seedfarm_10x10_2d": Recipe(
        ["dmfb", "--drop_num=2", "--n_parallel_envs=8", "--vmap_seeds=8",
         "--lr_decay", "--param_ema=0.999", "--exact_steps=600000"],
        "seedfarm_10x10_2d", "success", True),
    "mesh_10x10_2d": Recipe(
        ["dmfb", "--drop_num=2", "--fov=9", "--n_parallel_envs=64",
         "--exact_steps=600000", "--evaluate_cycle=50000", "--lr_decay",
         "--param_ema=0.999", "--mesh=4"],
        "mesh_10x10_2d", "success", True, None, (20,)),
}
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
    p.add_argument("--score_board", type=int, default=None,
                   help="the board every checkpoint is scored on (default: "
                        "the recipe's)")
    p.add_argument("--no_train", action="store_true",
                   help="score and fold what the run directory holds, "
                        "without training")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="flags appended to the training's (last)")
    a = p.parse_args(argv)
    if a.score_board is None:
        a.score_board = RECIPES[a.recipe].board
    return a


def card(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    the CPU's name."""
    if not device.startswith("cuda"):
        return f"CPU ({platform.machine()}, {os.cpu_count()} cores)"
    from chip_smoke import nvidia_smi_line
    return nvidia_smi_line()


def train_argv(a, run: int = 0) -> list:
    """The training's flags: the recipe's, the seed and the run directory,
    and one device (``--mesh=off``) unless the recipe names a mesh."""
    flags = RECIPES[a.recipe].flags
    one = [] if any(f.startswith("--mesh") for f in flags) else ["--mesh=off"]
    return (flags + [f"--seed={a.seed}", f"--data_dir={a.run_dir}",
                     f"--ith_run={run}", f"--device={a.device}"]
            + one + a.extra)


def _args(a, run: int = 0):
    from marl_dmfb_tpu_torch.config import get_train_args
    return get_train_args(train_argv(a, run), pri=False)


def is_farm(a) -> bool:
    return _args(a).vmap_seeds > 1


def on_mesh(a) -> bool:
    return _args(a).mesh != "off"


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


def farm_progress(a):
    """A seed farm's ``(success, runtime, ended, newest)``: its online
    success (S, E), its clock at each evaluation (E,), whether it reached
    its final evaluation, and the tag of its seeds' newest checkpoints;
    from the farm's curves where it ended, else from its newest resume
    checkpoint; None before its first."""
    import numpy as np
    from marl_dmfb_tpu_torch import checkpoint
    from marl_dmfb_tpu_torch.parallel.seedfarm import resume_tags
    from marl_dmfb_tpu_torch.trainer import curve_dir, curve_prefix
    args = _args(a)
    base = os.path.join(curve_dir(args), curve_prefix(args))
    if os.path.isfile(f"{base}success_rate_farm.npy"):
        return (np.load(f"{base}success_rate_farm.npy"),
                np.load(f"{base}runtime_farm.npy"), True, "final")
    tags = resume_tags(checkpoint.model_dir(args))
    if not tags:
        return None
    progress = checkpoint.load(os.path.join(
        checkpoint.model_dir(args), f"farm_{tags[-1]}_resume.pt"))["progress"]
    return (progress["success_rate"].numpy(), progress["runtime"].numpy(),
            False, str(tags[-1]))


def train(a):
    """Step 1 (module docstring); returns the trainer (the farm), or None
    where the run had ended or ran on a mesh."""
    from marl_dmfb_tpu_torch import train as train_cli
    from marl_dmfb_tpu_torch.config import make_env_from_args
    from marl_dmfb_tpu_torch.trainer import Trainer
    from marl_dmfb_tpu_torch.utils.platform import select_device

    if is_farm(a):
        progress = farm_progress(a)
        if progress is not None and progress[2]:
            return None
        # the farm resumes from its own newest resume checkpoint
        return train_cli.main(train_argv(a) + (
            ["--load_model"] if progress is not None else []))
    segs = segments(a)
    if segs and segs[-1][3]:
        return None
    if on_mesh(a):
        if segs:
            raise SystemExit(
                f"time_to_quality: {a.run_dir} holds a mesh run that "
                "stopped before its end; a mesh run does not resume, start "
                "it in an empty run directory")
        # the train CLI starts one rank a device and fails where one fails
        return train_cli.main(train_argv(a))
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
    ended, else its newest.  A seed farm's online success is a list, a
    seed each, and its file tag the tag of each seed's checkpoint."""
    if is_farm(a):
        progress = farm_progress(a)
        if progress is None:
            return [], []
        success, times, ended, _ = progress
        tags = [str(i) for i in range(len(times) - ended)] + (
            ["final"] if ended else [])
        return [(tag, float(w), [round(float(x), 2) for x in success[:, i]])
                for i, (tag, w) in enumerate(zip(tags, times))], []
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


def _evaluate(a, t, name: str, board=None, tasks: int = N_TASKS) -> dict:
    """The evaluate entry point on checkpoint ``name`` of the run
    directory: greedy, ``tasks`` tasks, float32 (the checkpoints hold
    float32 params under every ``--compute_dtype``), on ``board`` (square)
    or the training board, as the training's algorithm (a farm seed's
    checkpoint ``<i>_<tag>`` is its run ``i``'s)."""
    from marl_dmfb_tpu_torch import evaluate
    where = ([f"--chip_size={board}"] if board is not None else
             [f"--width={t.width}", f"--length={t.length}"])
    version = [] if t.version is None else [f"--version={t.version}"]
    return evaluate.main([t.name, f"--drop_num={t.drop_num}",
                          f"--fov={t.fov}", *where, *version,
                          f"--alg={t.alg}",
                          f"--evaluate_task={tasks}",
                          f"--data_dir={a.run_dir}",
                          f"--load_model_name={name}",
                          f"--device={a.device}"])


def _independent(m: dict, tag: str) -> dict:
    return {"tag": tag, "n_tasks": N_TASKS,
            "steps": round(float(m["steps"]), 1),
            "success": round(float(m["success_rate"]), 2)}


def board_key(name: str, board: int, tasks: int = N_TASKS) -> str:
    """The key in ``scores.json`` of checkpoint ``name`` on the square
    ``board`` over ``tasks`` tasks."""
    return f"{name} {board}x{board}@{tasks}"


def score(a) -> dict:
    """Step 2 (module docstring): ``{"<run>_<tag>": success}`` of the
    scored recipes' checkpoints, or of an online recipe's newest checkpoint
    ``{"<run>_<tag>": {"tag", "n_tasks", "steps", "success"}}`` (a seed
    farm's: one a seed, ``"<i>_<tag>"``); the newest checkpoint on each of
    the recipe's final boards, and every checkpoint on each of its
    ``boards`` (to three decimals), under :func:`board_key`."""
    path = os.path.join(a.run_dir, "scores.json")
    scores = {}
    if os.path.isfile(path):
        with open(path) as f:
            scores = json.load(f)
    t = _args(a)
    rows = checkpoint_list(a)[0]
    recipe = RECIPES[a.recipe]
    online = recipe.online

    def keep(name, value):
        scores[name] = value
        print(f"time_to_quality: {name}: {value}", flush=True)
        with open(path, "w") as f:
            json.dump(scores, f, indent=1)

    if is_farm(a):
        tag = rows[-1][0]
        for name in (f"{i}_{tag}" for i in range(t.vmap_seeds)):
            if name not in scores:
                keep(name, _independent(_evaluate(a, t, name), tag))
        return scores
    for i, (name, _, _) in enumerate(rows):
        tag = "final" if name.endswith("_final") else str(i)
        newest = i == len(rows) - 1
        if name not in scores and (newest or not online):
            m = _evaluate(a, t, name, None if online else a.score_board)
            keep(name, _independent(m, tag) if online else
                 round(float(m["success_rate"]), 2))
        for board in recipe.final_boards if newest else ():
            if board_key(name, board) not in scores:
                m = _evaluate(a, t, name, board)
                keep(board_key(name, board), _independent(m, tag)
                     if online else round(float(m["success_rate"]), 2))
        for board, tasks in recipe.boards:
            if board_key(name, board, tasks) not in scores:
                m = _evaluate(a, t, name, board, tasks)
                keep(board_key(name, board, tasks),
                     round(float(m["success_rate"]), 3))
    return scores


def fold(success: list, wall_s: list, first_tag: int = 0,
         cycle: int = 50000, total_steps: int = 2_000_000,
         bar: float = QUALITY_BAR,
         key: str = RECIPES["flagship"].success,
         ended: bool = True, others: dict = None) -> dict:
    """The checkpoints, ``first_crossing``, ``quality_bar`` and
    ``total_run`` of an artifact entry in JAX's layout, from one success
    rate and one wall time a checkpoint: tags ``first_tag``, ``first_tag +
    1``, ... at ``cycle`` env steps each, the last one the final checkpoint
    at ``total_steps`` (``tools/scratch_ttq_meda.py``'s fold), or, where
    the run has not ``ended``, its newest, and ``total_run`` how far it
    reached.  A success rate that is a list (a seed farm's, a seed each)
    gives a list of first crossings, a seed each.  ``others``: more
    readings of each checkpoint, ``{key: one a checkpoint}``, such as its
    success on other boards."""
    others = others or {}
    checkpoints = [{"tag": str(first_tag + i),
                    "env_steps": (first_tag + i) * cycle,
                    "wall_s": w, key: s,
                    **{k: v[i] for k, v in others.items()}}
                   for i, (s, w) in enumerate(zip(success, wall_s))]
    last = checkpoints[-1]
    if ended:
        last.update(tag="final", env_steps=total_steps)
        total_run = {"env_steps": total_steps, "wall_s": last["wall_s"],
                     f"{key}_final": last[key]}
    else:
        total_run = {"env_steps": last["env_steps"],
                     "wall_s": last["wall_s"], "horizon": total_steps}

    def first(seed=None):
        pick = (lambda c: c[key]) if seed is None else (
            lambda c: c[key][seed])
        return next((dict(c, **{key: pick(c)}) for c in checkpoints
                     if pick(c) >= bar), None)

    farm = isinstance(success[0], list)
    return {
        "quality_bar": bar,
        "first_crossing": ([first(i) for i in range(len(success[0]))]
                           if farm else first()),
        "total_run": total_run,
        "checkpoints": checkpoints,
    }


def describe(a, device: str, resumed) -> str:
    recipe = RECIPES[a.recipe]
    flags = recipe.flags + [f"--seed={a.seed}"] + a.extra
    args = _args(a)
    board = f"{args.width}x{args.length}"
    also = "".join(f"; the newest checkpoint also on {b}x{b}, {N_TASKS} "
                   "tasks" for b in recipe.final_boards)
    also += "".join(f"; every checkpoint also on {b}x{b}, {n} tasks "
                    f"(success_{b}x{b})" for b, n in recipe.boards)
    evaluate = (f"python -m marl_dmfb_tpu_torch.evaluate {args.name} "
                f"--drop_num={args.drop_num} --alg={args.alg}")
    if is_farm(a):
        scored = (
            f"seeds {a.seed}-{a.seed + args.vmap_seeds - 1} in lockstep; "
            f"every checkpoint's success is the farm's online evaluation, a"
            f" list of one rate a seed (the seed's EMA params, greedy, on "
            f"{args.evaluate_task} fresh tasks of the {board} training "
            f"board); each seed's newest checkpoint is also scored by "
            f"{evaluate} --load_model_name=<i>_<tag> "
            f"--evaluate_task={N_TASKS} "
            "(total_run.independent_final, a seed each)")
    elif recipe.online:
        scored = (
            f"every checkpoint's success is the trainer's online evaluation"
            f" (rank 0's on a mesh): the EMA params, greedy, on {N_TASKS} "
            f"fresh tasks of the {board} training board; the newest "
            f"checkpoint is also scored by {evaluate} "
            f"--evaluate_task={N_TASKS} (total_run.independent_final{also})")
    else:
        scored = (
            "every checkpoint's EMA params scored greedy on the "
            f"{a.score_board}x{a.score_board} zero-shot board, 100 random "
            f"tasks, by {evaluate} --chip_size={a.score_board} "
            f"--evaluate_task=100{also}")
    if args.compute_dtype != "float32":
        scored += (f" (trained in {args.compute_dtype}; scored on the "
                   "float32 evaluation path on the float32 master weights, "
                   "as JAX scored its run)")
    if args.alg == "qmix":
        scored += (" (the agent's params; evaluation on another board than "
                   "the training's keeps a fresh mixer, which greedy "
                   "evaluation does not call)")
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
    farm = is_farm(a)
    ended = farm_progress(a)[2] if farm else segments(a)[-1][3]
    args = _args(a)
    device = card(a.device)
    newest = rows[-1][0]
    others = {f"success_{b}x{b}": [scores[board_key(row[0], b, n)]
                                   for row in rows] for b, n in recipe.boards}
    entry = {"description": describe(a, device, resumed), "card": device,
             **fold([row[2] if recipe.online else scores[row[0]]
                     for row in rows],
                    [wall for _, wall, _ in rows], cycle=args.evaluate_cycle,
                    total_steps=args.total_env_steps, key=recipe.success,
                    ended=ended, others=others)}
    if recipe.boards:
        entry["n_tasks"] = {recipe.success: N_TASKS, **{
            f"success_{b}x{b}": n for b, n in recipe.boards}}
    run_ = entry["total_run"]
    if farm:
        entry["seeds"] = list(range(a.seed, a.seed + args.vmap_seeds))
        run_["independent_final"] = [scores[f"{i}_{newest}"]
                                     for i in range(args.vmap_seeds)]
    elif recipe.online:
        run_["independent_final"] = scores[newest]
    for b, n in (tuple((b, N_TASKS) for b in recipe.final_boards)
                 + recipe.boards):
        run_[f"independent_final_{b}x{b}" if recipe.online else
             f"success_{b}x{b}_{'final' if ended else 'newest'}"] = scores[
                 board_key(newest, b, n)]
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
    run, tag = ("0", newest) if farm else newest.split("_", 1)
    tree = checkpoint.load(_ckpt(a, run, tag))
    args.data_dir = os.path.join(a.run_dir, "deploy")
    args.ith_run = 0
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
    ended = farm_progress(a)[2] if is_farm(a) else segments(a)[-1][3]
    if not ended:
        print("time_to_quality: the run has not ended; folded as far as it "
              "reached" + ("" if on_mesh(a) else ", run again to resume it"),
              flush=True)
    return write(a, scores)


if __name__ == "__main__":
    main()
