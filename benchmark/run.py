"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It needs as many CUDA cards as the cell asks
for and exits with an error, printing no result, where there are fewer.
The last line of standard output is the result's JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import time

T_START = time.time()   # set-up is timed from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.find_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    line = harness.run(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                       T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the PyTorch "
              "port alone", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
