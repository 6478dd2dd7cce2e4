#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s phase 12 (10x10-2d trained from scratch, a
host-bound run of small launches) in a fresh process, then again in the
same process after one ``torch.profiler`` trace of a single matmul.

    python3 tools/time_after_profiler.py

Needs a card.  Prints ``nvidia-smi``'s name and power limit, then a line
for each run with its seconds.  The second run reads how much a trace
slows every later launch of the process: the reason ``chip_smoke.py``
runs its one traced phase (8) last.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def run(smi, tag) -> float:
    t0 = time.perf_counter()
    try:
        c.learning(smi)
    except AssertionError as e:    # the phase's own gates: report, go on
        c.log(f"{tag}: {e}")
    seconds = time.perf_counter() - t0
    c.log(f"{tag}: learning() {seconds:.2f} s")
    return seconds


def main() -> dict:
    from marl_dmfb_tpu_torch.ops import dmfb_step

    smi = c.nvidia_smi_line()
    c.log(smi)
    dmfb_step.kernel_library()
    dmfb_step.wide_library()
    alone = run(smi, "alone")
    x = torch.randn(1024, 1024, device="cuda")
    c.profile_calls(lambda: x @ x)
    after = run(smi, "after a torch.profiler trace")
    return {"alone_s": alone, "after_trace_s": after, "device": smi}


if __name__ == "__main__":
    main()
