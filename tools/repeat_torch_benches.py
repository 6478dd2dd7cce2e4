#!/usr/bin/env python3
"""Run the port's measuring entry points several times, interleaved, each
run a new process as a user would start it, and summarise each metric's
range.

    python3 tools/repeat_torch_benches.py [--repeats 3]
        [--entries bench,bench_meda,bench_bf16,bench_train,bench_scaling,
         bench_multiproc] [--out build/torch_benches.jsonl]

Round r runs every chosen entry once, in the order given, before round
r + 1 starts.  Every JSON line an entry prints is written to ``--out`` with
the round, the entry and the run's wall seconds; then one JSON line a
metric gives its values, their min and max, and the cards' ``nvidia-smi``
names and power limits.  Exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = {
    "bench": ("bench", []),
    "bench_meda": ("bench", ["16384", "0", "meda"]),
    "bench_bf16": ("bench", ["16384", "0", "dmfb", "bf16"]),
    "bench_train": ("bench_train", []),
    "bench_scaling": ("bench_scaling", []),
    "bench_multiproc": ("bench_multiproc", []),
}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--entries", default=",".join(ENTRIES))
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                 "torch_benches.jsonl"))
    a = p.parse_args(argv)
    names = a.entries.split(",")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    smi = card()
    print(smi, flush=True)
    values = {}
    with open(a.out, "w") as out:
        for r in range(a.repeats):
            for name in names:
                module, args = ENTRIES[name]
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-m", f"marl_dmfb_tpu_torch.{module}",
                     *args], cwd=ROOT, capture_output=True, text=True)
                seconds = time.perf_counter() - t0
                if proc.returncode:
                    print(proc.stdout[-4000:], proc.stderr[-4000:],
                          file=sys.stderr)
                    print(f"{name} (round {r}) exited {proc.returncode}",
                          file=sys.stderr)
                    return 1
                for text in proc.stdout.splitlines():
                    if not text.startswith("{"):
                        continue
                    line = json.loads(text)
                    rec = {"round": r, "entry": name, "seconds": seconds,
                           "device": smi, **line}
                    out.write(json.dumps(rec) + "\n")
                    if isinstance(line.get("value"), (int, float)):
                        values.setdefault(line["metric"], []).append(
                            line["value"])
                print(f"round {r} {name}: {seconds:.1f} s", flush=True)
    for metric, vals in values.items():
        print(json.dumps({"metric": metric, "min": min(vals),
                          "max": max(vals), "values": vals,
                          "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
