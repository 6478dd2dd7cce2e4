#!/usr/bin/env python3
"""The JAX package's degradation sweeps of DegreData rows at other seeds
than the committed seed 12, folded into the seed-spread artifact beside the
port's.

    JAX_PLATFORMS=cpu python3 tools/degrade_seeds_jax.py \\
        --rows 20by20-10d0b --seeds 13 14 15 [--jobs 3] \\
        [--spread marl_dmfb_tpu_torch/artifacts/degrade_seed_spread.json]

A JAX-side tool, like ``tools/export_flax_npz.py``: it needs the JAX
package and runs on the CPU.  Each (row, seed) runs the JAX package's
``eva_degrade.py`` with the row's Orbax checkpoint and flags
(``tools/degrade_sweeps_torch.py``'s ``ROWS``: 20 tasks an epoch, the
row's epochs, ``--noise_eps`` where the row has it) and ``--seed``, in a
process of its own; ``--jobs`` run at once.  Each is folded as the port's
rows are (``fold``) and written under ``jax/<row>/<seed>``; the port's
sweeps of the same rows and seeds come from ``degrade_sweeps_torch.py
--seeds`` on the card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import datetime
import multiprocessing
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.degrade_sweeps_torch import (ROWS, SPREAD, TASKS,  # noqa: E402
                                        fold, merge_spread)


def run(row, seed: int, work: str) -> tuple:
    """The JAX package's sweep of ``row`` at ``seed`` under ``work``;
    returns ``((row, seed), its record)``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import eva_degrade as jeva

    label, export, cli, epochs = row
    data_dir = os.path.join(work, f"{label}_s{seed}")
    model = os.path.join(data_dir, "model", "vdn",
                         "fov19" if cli[0] == "meda" else "fov9")
    os.makedirs(model, exist_ok=True)
    link = os.path.join(model, "0_final_state")
    if not os.path.exists(link):
        os.symlink(os.path.join(ROOT, "artifacts", export), link)
    argv = cli + [f"--evaluate_task={TASKS}", f"--evaluate_epoch={epochs}",
                  "--load_model_name=0_final", f"--seed={seed}",
                  f"--data_dir={data_dir}"]
    t0 = time.perf_counter()
    jeva.main(argv)
    seconds = time.perf_counter() - t0
    path = jeva.degre_dir(jeva.get_evaluate_args(argv))
    arrays = {k: np.load(os.path.join(path, f"{k}.npy"))
              for k in ("rewards", "steps", "success", "health", "usage")}
    record = dict(fold(arrays), seconds=seconds,
                  device={"smi": "cpu", "jax": jax.__version__},
                  date=datetime.date.today().isoformat())
    print(f"{label} seed {seed}: first epoch below 0.5 "
          f"{record['first_below_half']}, {seconds:.2f} s", flush=True)
    return (label, seed), record


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", nargs="+", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--spread", default=SPREAD)
    p.add_argument("--work", default=os.path.join(ROOT, "build",
                                                  "degrade_seeds_jax"))
    a = p.parse_args(argv)
    table = {r[0]: r for r in ROWS}
    runs = [(table[r], s) for r in a.rows for s in a.seeds]
    if a.jobs == 1:
        done = [run(r, s, a.work) for r, s in runs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(a.jobs,
                                                    mp_context=ctx) as pool:
            futures = [pool.submit(run, r, s, a.work) for r, s in runs]
            done = [f.result() for f in futures]
    return merge_spread(a.spread, "jax", done)


if __name__ == "__main__":
    main()
