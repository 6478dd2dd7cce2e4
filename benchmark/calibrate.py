"""Read the numbers that decide ``correct`` over many seeds in one process,
for the program, the control (the reference in TF32 in the program's
place) and the planted faults, and set each limit from them.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... \\
        [--seconds 1] [--out chiprun_out/calibrate.<cell>.json] [--write] \\
        [--plant no_exchange --plant_seeds 101 102 103]

A number's lower reading is the largest that the program gives over the
seeds; its upper reading the smallest of the control's readings that are
at least three times the lower, and of the faults' that are at least ten
times the lower (a state left unchanged: three times).  The limit lies
between, nearer the upper in ratio (``lower**0.35 * upper**0.65``, the
lower reading taken as no less than a thousandth of the upper), since
fresh seeds read higher than a dozen did, and at most a thousand times the
lower; an exact comparison has the limit 0.
A number with no upper reading gets none, and is listed apart.
``--write`` writes ``limits/<cell>.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

from benchmark.faults import PLANTS

EXACT = ("start_faults", "rollout_mismatch", "replay_mismatch",
         "target_mismatch")


def set_limits(per_seed: list) -> dict:
    """``{number: {"lower", "upper", "upper_from", "limit"}}`` from each
    seed's readings."""
    out = {name: {"lower": None, "upper": None, "upper_from": None,
                  "limit": 0} for name in EXACT}
    names = {k for r in per_seed for k in r if "." not in k}
    for name in sorted(names):
        lower = max(r[name] for r in per_seed if name in r)
        if name in EXACT:
            out[name] = {"lower": lower, "upper": None, "upper_from": None,
                         "limit": 0}
            continue
        # each planted kind's smallest reading over the seeds, where it is
        # above zero and three (the control, a state left unchanged) or
        # ten (another fault) times the lower reading
        kinds = {}
        for r in per_seed:
            for k, v in r.items():
                kind, _, number = k.partition(".")
                if number == name and kind != "mismatch":
                    kinds[k] = min(kinds.get(k, v), v)
        cands = [(v, k) for k, v in kinds.items()
                 if v > 0 and v >= (3.0 if k.split(".")[0] in (
                     "control", "unchanged") else 10.0) * lower]
        upper = min(cands) if cands else None
        limit = None
        if upper is not None:
            lo = max(lower, upper[0] / 1000.0)
            limit = lo ** 0.35 * upper[0] ** 0.65
            if lower > 0:
                limit = min(limit, 1000.0 * lower)
            limit = float(f"{limit:.2g}")
        out[name] = {"lower": lower,
                     "upper": None if upper is None else upper[0],
                     "upper_from": None if upper is None else upper[1],
                     "limit": limit}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    p.add_argument("--write", action="store_true")
    p.add_argument("--plant", choices=sorted(PLANTS),
                   help="a fault of benchmark/faults.py planted in the "
                        "ranks of a run over several cards")
    p.add_argument("--plant_seeds", type=int, nargs="*", default=[])
    a = p.parse_args(argv)
    import torch

    from benchmark import harness

    cell = harness.find_cell(a.workload)
    per_seed = []
    for seed in a.seeds:
        t0 = time.time()
        line = harness.run(cell, seed, a.seconds, False, a.device, t0,
                           calibrate=True)
        r = line["readings"]
        per_seed.append(r)
        print(json.dumps({"seed": seed, "seconds": time.time() - t0,
                          "readings": r}), flush=True)
        del line
        gc.collect()
        if a.device == "cuda":
            torch.cuda.empty_cache()
    for i, seed in enumerate(a.plant_seeds):
        t0 = time.time()
        line = harness.run(cell, seed, a.seconds, False, a.device, t0,
                           plant=PLANTS[a.plant])
        r = {f"{a.plant}.{k}": c["value"] for k, c in line["checks"].items()}
        per_seed[i % len(per_seed)].update(r)
        print(json.dumps({"seed": seed, "plant": a.plant, "readings": r}),
              flush=True)
    limits = set_limits(per_seed)
    result = {"cell": cell.name, "seeds": a.seeds, "per_seed": per_seed,
              "limits": limits,
              "card": (torch.cuda.get_device_name(0) if a.device == "cuda"
                       else "cpu")}
    print(json.dumps(limits, indent=1), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(result, indent=1))
    if a.write:
        path = harness.HERE / "limits" / f"{cell.name}.json"
        path.write_text(json.dumps(
            {"limits": {k: v["limit"] for k, v in limits.items()
                        if v["limit"] is not None},
             "not_compared": sorted(k for k, v in limits.items()
                                    if v["limit"] is None),
             "readings": {k: {kk: vv for kk, vv in v.items()
                              if kk != "limit"} for k, v in limits.items()},
             "seeds": a.seeds}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
