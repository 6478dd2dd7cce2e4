#!/usr/bin/env python3
"""Several seeds of one or more ``tools/time_to_quality_torch.py``
recipes trained at once on one device within a time limit, folded into one
artifact, and packed to resume elsewhere.

    python3 tools/time_to_quality_seeds.py --runs meda_30x60_3d:12 \\
        meda_30x60_3d:1 --budget 3300 --out build/ttq_out
    python3 tools/time_to_quality_seeds.py --runs dmfb_flagship_qmix:12 \\
        dmfb_flagship_qmix:1 flagship:12:seed_12_control --budget 2950 \\
        --out build/ttq_out

``--runs`` names the runs (default: the flagship at seeds 12 and 1), each
``<recipe>:<seed>`` or ``<recipe>:<seed>:<key>``: the key under which the
run is folded; by default a recipe's first run is its entry and the
others nest in it as ``seed_<s>_replication``.

1. **train**: one ``time_to_quality_torch.py`` process a recipe and seed
   on the run directory ``build/ttq/<recipe>_s<seed>/`` (it resumes a run
   there), all started together, each with its output in
   ``<out>/<recipe>_s<seed>.log``; a process still running ``--budget``
   seconds after the start is ended there (its newest checkpoint whose
   time is recorded stays the resume point).  A seed whose process
   exited otherwise than 0 on its own, a signal included, or whose fold
   failed, makes the command exit 1, after the fold and the pack.  A process whose run
   ends within the budget also folds it, into
   ``<out>/<recipe>_s<seed>.json``.
2. **fold**: every run scored at once, a ``--no_train`` process each
   (its scores kept in its run directory), then each in turn, ``--no_train``
   again (nothing left to score), into ``<out>/time_to_quality.json``,
   which starts as a copy of the port's committed artifact, under its
   key.
3. **pack**: each run directory into ``<out>/<recipe>_s<seed>/``: its
   curves, ``scores.json``, the deploy export, and of each of its runs the
   checkpoint it resumes from and the final one (what
   ``time_to_quality_torch.segments`` reads), not the other checkpoints; of
   a seed farm, its newest resume checkpoint where it has not ended, and
   none of its seeds' checkpoints.

``--device`` and ``--extra`` are passed on to every process (``--extra``
last).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import time_to_quality_torch as ttq  # noqa: E402

TOOL = os.path.join(ROOT, "tools", "time_to_quality_torch.py")
ARTIFACT = os.path.join(ROOT, "marl_dmfb_tpu_torch", "artifacts",
                        "time_to_quality.json")
RUNS = os.path.join(ROOT, "build", "ttq")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", nargs="+", default=["flagship:12",
                                                 "flagship:1"],
                   metavar="RECIPE:SEED[:KEY]")
    p.add_argument("--budget", type=float, required=True,
                   help="seconds after which a training process is "
                        "ended")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def tool_argv(a, recipe: str, seed: int, *flags) -> list:
    name = f"{recipe}_s{seed}"
    return [sys.executable, TOOL, f"--recipe={recipe}", f"--seed={seed}",
            f"--run_dir={os.path.join(RUNS, name)}",
            f"--device={a.device}", *flags, "--extra", *a.extra]


def runs(a) -> list:
    """``(recipe, seed, key)`` of each run (module docstring)."""
    out = []
    for spec in a.runs:
        recipe, seed, *named = spec.split(":")
        first = all(r != recipe for r, _, _ in out)
        out.append((recipe, int(seed), named[0] if named else (
            "default" if first else f"seed_{seed}_replication")))
    return out


def pack(t, dest: str):
    """Step 3 (module docstring) of the run directory of
    ``time_to_quality_torch``'s arguments ``t``: a packed run directory is
    a run directory, to put back under ``build/ttq/`` to resume it."""
    keep = set()
    if ttq.is_farm(t):
        progress = ttq.farm_progress(t)
        if progress is not None and not progress[2]:
            keep.add(f"farm_{progress[3]}_resume.pt")
    else:
        for run, _, last, done in ttq.segments(t):
            keep |= {f"{run}_{last}_state.pt"} | (
                {f"{run}_final_state.pt"} if done else set())
    for folder, _, files in os.walk(t.run_dir):
        deploy = "deploy" in os.path.relpath(folder, t.run_dir)
        for name in files:
            if name.endswith(".tmp") or (
                    name.endswith(("_state.pt", "_resume.pt"))
                    and not deploy and name not in keep):
                continue
            target = os.path.join(dest, os.path.relpath(folder, t.run_dir))
            os.makedirs(target, exist_ok=True)
            shutil.copy2(os.path.join(folder, name), target)


def wait(procs, deadline: float) -> list:
    """The end of step 1 (module docstring): waits for each ``(name,
    process)`` until ``deadline`` (``time.monotonic``; None: no limit),
    ends those still running then, and returns the names whose process
    exited otherwise than 0 on its own."""
    failed = []
    for name, proc in procs:
        try:
            rc = proc.wait(timeout=None if deadline is None else
                           max(deadline - time.monotonic(), 0.0))
            failed += [name] if rc else []
            how = f"exit {rc}"
        except subprocess.TimeoutExpired:
            proc.terminate()
            proc.wait()
            how = "ended at the budget"
        print(f"{name}: {how}", flush=True)
    return failed


def main(argv=None) -> int:
    a = parse(argv)
    os.makedirs(a.out, exist_ok=True)
    deadline = time.monotonic() + a.budget
    todo = runs(a)

    def start(recipe, seed, *flags):
        name = f"{recipe}_s{seed}"
        log = open(os.path.join(a.out, f"{name}.log"), "a")
        proc = subprocess.Popen(
            tool_argv(a, recipe, seed,
                      f"--out={os.path.join(a.out, name + '.json')}",
                      *flags),
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
        log.close()
        return name, proc

    failed = wait([start(recipe, seed) for recipe, seed, _ in todo],
                  deadline)
    out = os.path.join(a.out, "time_to_quality.json")
    try:
        # the scores at once (each run's own artifact), then the fold
        scoring = [start(recipe, seed, "--no_train")
                   for recipe, seed, _ in todo]
        failed += [n for n in wait(scoring, None) if n not in failed]
        shutil.copy2(ARTIFACT, out)
        for recipe, seed, k in todo:
            name = f"{recipe}_s{seed}"
            if subprocess.run(tool_argv(a, recipe, seed, "--no_train",
                                        f"--out={out}", f"--key={k}"),
                              cwd=ROOT).returncode and name not in failed:
                failed.append(name)
    finally:
        # what the runs reached is packed even where the fold failed
        for recipe, seed, _ in todo:
            packed = os.path.join(a.out, f"{recipe}_s{seed}")
            shutil.rmtree(packed, ignore_errors=True)
            pack(ttq.parse(tool_argv(a, recipe, seed)[2:]), packed)
    if failed:
        print(f"runs {failed} failed: see their logs", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
