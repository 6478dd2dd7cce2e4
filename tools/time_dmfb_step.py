#!/usr/bin/env python3
"""Device time of the env-step kernel (``csrc/dmfb_step.cu``) on one GPU.

    python3 tools/time_dmfb_step.py [--root DIR] [--batch 16384 100]
                                    [--tiles 4 8 16 32]

For each batch (DMFB 10x10, 4 droplets, fov 9, chips as ``chip_smoke.py``
makes them) prints the kernel's time per call (CUDA events around a CUDA
graph of 50 calls over 4 input sets, ``chip_smoke.device_ms``) beside its
byte bound and, as a yardstick of the bandwidth the card reaches at that
size, the time of one device-to-device copy that reads and writes as many
bytes as the bound counts.  ``--tiles`` times the kernel at each given
count of chips per block instead of the wrapper's own choice
(``ops/dmfb_step.tile_chips``).  ``--root`` takes the package from another
checkout, for example an unpacked parent commit, so that two versions can
be timed in one call.  Each result is also printed as a JSON line.
"""

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--batch", type=int, nargs="+", default=[16384, 100])
    ap.add_argument("--tiles", type=int, nargs="*", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_dmfb_step: needs an NVIDIA GPU")

    sys.path.insert(0, os.path.abspath(opts.root))
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.ops import dmfb_step
    cs = _load_chip_smoke()

    smi = cs.nvidia_smi_line()
    root = os.path.relpath(os.path.abspath(opts.root), HERE)
    p = tdmfb.DMFBParams()
    g = torch.Generator(device="cuda").manual_seed(4)
    choose = getattr(dmfb_step, "tile_chips", None)
    for batch in opts.batch:
        sets = [(cs.random_states(tdmfb, p, batch, g),
                 *cs.step_inputs(p, batch, g)) for _ in range(4)]
        bound_ms = copy_ms = None
        if hasattr(dmfb_step, "min_bytes"):   # a tree before it has no bound
            bound_ms, _, n_bytes, _ = cs.bound(dmfb_step, p, batch)
            src = [torch.empty(n_bytes // 2, dtype=torch.uint8,
                               device="cuda") for _ in range(4)]
            dst = [torch.empty_like(x) for x in src]
            copy_ms = cs.device_ms([lambda i=i: dst[i].copy_(src[i])
                                    for i in range(4)])
        for tile in opts.tiles or [None]:
            if tile is not None:
                dmfb_step.tile_chips = lambda params, b, *mode, c=tile: c
            try:
                ms = cs.device_ms([lambda x=x: dmfb_step.step_batch(p, *x)
                                   for x in sets])
            finally:
                if choose is not None:
                    dmfb_step.tile_chips = choose
            used = tile if tile is not None else (
                choose(p, batch) if choose else None)
            row = dict(root=root, batch=batch, tile=used, us=ms * 1e3,
                       bound_us=bound_ms and bound_ms * 1e3,
                       share=bound_ms and bound_ms / ms,
                       copy_us=copy_ms and copy_ms * 1e3, card=smi)
            print(f"[{smi}] {root}: B={batch} tile={used}: kernel "
                  f"{ms * 1e3:.2f} us, bound {row['bound_us']} us, "
                  f"share {row['share']}, copy of the bound's bytes "
                  f"{row['copy_us']} us", flush=True)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
