#!/usr/bin/env python3
"""The port's electrode-degradation sweeps, one for each row of the JAX
package's DegreData provenance table (``artifacts/README.md``), folded into
one artifact.

    python3 tools/degrade_sweeps_torch.py [--rows 50by50-10d0b ...] \\
        [--jobs 3] [--out marl_dmfb_tpu_torch/artifacts/degrade_sweeps.json] \\
        [--arrays build/degrade_sweeps_arrays] [--device cuda]

Each row runs ``python -m marl_dmfb_tpu_torch.eva_degrade`` with the row's
own policy (the committed deploy export of its JAX checkpoint under
``tests/fixtures/torch_weights/``) and flags, as the provenance table does:
``--evaluate_task=20 --load_model_name=0_final``, seed 12, the row's epoch
count, and ``--noise_eps=0.3`` on the two ``eps0.3`` rows.  ``--rows``
picks rows (default: all, in ``ROWS``' order); ``--jobs`` runs that many
rows at once, each in a process of its own (a sweep runs 5 chips and is
bound by the host's dispatch, so rows share one card well; each row
records how many ran beside it).

``--seeds`` runs each row at other seeds instead of the table's seed 12
and folds them into the seed-spread artifact (``--spread``) under
``torch/<row>/<seed>``, beside the JAX package's sweeps of the same rows
and seeds (``tools/degrade_seeds_jax.py``, under ``jax/``): one seed's
collapse is one draw of a random epoch, and the spread over seeds says
how far two packages' single sweeps may differ.

For each row the artifact (``--out``; rows already there and not rerun are
kept) records the per-epoch means over the 5 chips of ``success``,
``steps`` and ``rewards``, the mean health and the usage sum of each
epoch's snapshot, the first epoch whose mean success is below 0.5 (null
if none), the env-step kernel's launches (0 on the CPU, where the plain
step runs), the wall seconds, and the device: ``nvidia-smi``'s name and
power limit, the torch and CUDA versions.  The ``.npy`` arrays go to
``--arrays/<row>/``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import datetime
import glob
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WEIGHTS = os.path.join(ROOT, "tests", "fixtures", "torch_weights")
ARTIFACT = os.path.join(ROOT, "marl_dmfb_tpu_torch", "artifacts",
                        "degrade_sweeps.json")
SPREAD = os.path.join(ROOT, "marl_dmfb_tpu_torch", "artifacts",
                      "degrade_seed_spread.json")
TASKS = 20
SEED = 12
DMFB = ["dmfb", "--fov=9"]
# (row, its DegreData directory's policy export, CLI, epochs): the
# provenance table's rows, BASELINE.json's workload first, then the
# collapsing rows, then the rest
ROWS = [
    ("50by50-10d0b", "dmfb_20x20_10d_fov9_vdn",
     DMFB + ["--drop_num=10", "--chip_size=50"], 40),
    ("20by20-10d0b", "dmfb_20x20_10d_fov9_vdn",
     DMFB + ["--drop_num=10", "--chip_size=20"], 20),
    ("meda-80by80-10d0b", "meda_80x80_10d_fov19_vdn",
     ["meda", "--drop_num=10"], 20),
    ("50by50-4d0b", "dmfb_10x10_4d_fov9_vdn",
     DMFB + ["--drop_num=4", "--chip_size=50"], 50),
    ("meda-30by60-2d0b", "meda_30x60_2d_fov19_vdn",
     ["meda", "--drop_num=2"], 20),
    ("meda-30by60-3d0b", "meda_30x60_3d_fov19_vdn",
     ["meda", "--drop_num=3"], 20),
    ("meda-30by60-4d0b", "meda_30x60_4d_fov19_vdn",
     ["meda", "--drop_num=4"], 20),
    ("50by50-4d0b-eps0.3", "dmfb_10x10_4d_fov9_vdn",
     DMFB + ["--drop_num=4", "--chip_size=50", "--noise_eps=0.3"], 50),
    ("50by50-4d0b-eps0.3-b64flagship", "dmfb_20x20_4d_fov9_vdn_b64",
     DMFB + ["--drop_num=4", "--chip_size=50", "--noise_eps=0.3"], 50),
]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", nargs="+", default=[r[0] for r in ROWS])
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--seeds", type=int, nargs="+", default=None)
    p.add_argument("--spread", default=SPREAD)
    p.add_argument("--out", default=ARTIFACT)
    p.add_argument("--arrays", default=os.path.join(
        ROOT, "build", "degrade_sweeps_arrays"))
    p.add_argument("--work", default=os.path.join(ROOT, "build",
                                                  "degrade_sweeps"),
                   help="the sweeps' run directories")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def device_info(device: str) -> dict:
    """The device a row ran on: ``nvidia-smi``'s name and power limit on a
    card, and the torch and CUDA versions."""
    import torch

    smi = "cpu"
    if device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return {"smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def fold(arrays: dict) -> dict:
    """A sweep's arrays (``(5, epochs)`` and ``(5, epochs, W, L)``) as the
    artifact's per-epoch lists."""
    success = arrays["success"].mean(axis=0)
    below = np.flatnonzero(success < 0.5)
    return {
        "epochs": int(success.shape[0]),
        "success": success.tolist(),
        "steps": arrays["steps"].mean(axis=0).tolist(),
        "rewards": arrays["rewards"].mean(axis=0).tolist(),
        "health_mean": arrays["health"].mean(axis=(0, 2, 3)).tolist(),
        "usage_sum": arrays["usage"].sum(axis=(0, 2, 3)).tolist(),
        "first_below_half": int(below[0]) if below.size else None,
    }


def merge_spread(path: str, package: str, done) -> dict:
    """Fold ``done``, ``((row, seed), record)`` pairs, into the seed-spread
    artifact at ``path`` under ``package/<row>/<seed>``, keeping what is
    there; returns the artifact."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    for (row, seed), record in done:
        keep = ("success", "steps", "first_below_half", "seconds",
                "launches", "device", "date")
        out.setdefault(package, {}).setdefault(row, {})[str(seed)] = {
            k: record[k] for k in keep if k in record}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}", flush=True)
    return out


def run_row(row, device: str, work: str, arrays: str,
            concurrent_rows: int, seed: int = SEED) -> tuple:
    """One row's sweep at ``seed`` through the ``eva_degrade`` entry point;
    copies its arrays to ``arrays/<row>/`` (``<row>_s<seed>`` at another
    seed than ``SEED``) and returns ``(row, its record)``."""
    import torch

    from marl_dmfb_tpu_torch import eva_degrade
    from marl_dmfb_tpu_torch.ops import dmfb_step

    label, export, cli, epochs = row
    run = label if seed == SEED else f"{label}_s{seed}"
    data_dir = os.path.join(work, run)
    shutil.rmtree(data_dir, ignore_errors=True)
    src, = glob.glob(os.path.join(WEIGHTS, export, "model", "*", "fov*",
                                  "0_final_state.npz"))
    model = os.path.join(data_dir, os.path.relpath(os.path.dirname(src),
                                                   os.path.join(WEIGHTS,
                                                                export)))
    os.makedirs(model)
    shutil.copy(src, model)
    dmfb_step.launches = dmfb_step.launches_wide = 0
    t0 = time.perf_counter()
    res = eva_degrade.main(cli + [
        f"--evaluate_task={TASKS}", f"--evaluate_epoch={epochs}",
        "--load_model_name=0_final", f"--seed={seed}",
        f"--data_dir={data_dir}", f"--device={device}"])
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dest = os.path.join(arrays, run)
    os.makedirs(dest, exist_ok=True)
    for name in ("rewards", "steps", "success", "health", "usage"):
        shutil.copy(os.path.join(res["path"], f"{name}.npy"), dest)
    record = dict(
        fold(res), policy=export, argv=cli, tasks=TASKS, seed=seed,
        seconds=seconds, launches=dmfb_step.launches,
        launches_wide=dmfb_step.launches_wide,
        concurrent_rows=concurrent_rows, device=device_info(device),
        date=datetime.date.today().isoformat())
    print(f"{run}: {epochs} epochs x {TASKS} tasks in {seconds:.2f} s, "
          f"first epoch below 0.5: {record['first_below_half']}", flush=True)
    return label, record


def main(argv=None) -> dict:
    a = parse(argv)
    table = {r[0]: r for r in ROWS}
    unknown = [r for r in a.rows if r not in table]
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; rows: {list(table)}")
    runs = [(table[r], s) for r in a.rows for s in (a.seeds or [SEED])]
    jobs = max(1, min(a.jobs, len(runs)))
    if a.device != "cpu":
        # build the kernels once, before the rows' processes load them
        from marl_dmfb_tpu_torch.ops import dmfb_step
        from marl_dmfb_tpu_torch.utils.platform import select_device

        select_device(a.device)
        dmfb_step.kernel_library()
        dmfb_step.wide_library()
    args = (a.device, a.work, a.arrays, jobs)
    if jobs == 1:
        done = [run_row(r, *args, seed=s) for r, s in runs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(jobs,
                                                    mp_context=ctx) as pool:
            futures = [pool.submit(run_row, r, *args, seed=s)
                       for r, s in runs]
            done = [f.result() for f in futures]
    if a.seeds:
        return merge_spread(a.spread, "torch", [
            ((label, rec["seed"]), rec) for label, rec in done])
    out = {"rows": {}}
    if os.path.exists(a.out):
        with open(a.out) as f:
            out = json.load(f)
    out["rows"].update(dict(done))
    out["rows"] = {r[0]: out["rows"][r[0]] for r in ROWS
                   if r[0] in out["rows"]}
    out["protocol"] = (
        "marl_dmfb_tpu_torch.eva_degrade of each row's policy export: 5 "
        "fully degradable chips in lockstep, --evaluate_task episodes an "
        "epoch, seed 12, greedy unless --noise_eps; per-epoch means over "
        "the chips, the health and usage snapshots taken before each epoch")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {a.out} ({len(out['rows'])} rows)", flush=True)
    return out


if __name__ == "__main__":
    main()
