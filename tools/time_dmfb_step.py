#!/usr/bin/env python3
"""Device time of the env-step kernels (``csrc/dmfb_step.cu``,
``csrc/dmfb_step_wide.cu``) on one GPU.

    python3 tools/time_dmfb_step.py [--root DIR] [--batch 16384 100]
                                    [--tiles 4 8 16 32]
                                    [--board 20 50 --droplets 20]
                                    [--kernel wide] [--no-obs]

For each board and batch (DMFB 10x10, 4 droplets, fov 9 unless ``--board``
and ``--droplets`` say otherwise; chips as ``chip_smoke.py`` makes them)
prints the kernel's time per call (CUDA events around a CUDA graph of 50
calls over 4 input sets, ``chip_smoke.device_ms``) beside its byte bound
and, as a yardstick of the bandwidth the card reaches at that size, the
time of one device-to-device copy that reads and writes as many bytes as
the bound counts.  ``--kernel`` forces a kernel (default: the one
``kernel_for`` chooses), ``--no-obs`` times the transition alone.
``--tiles`` times the tile kernel at each given count of chips per block
instead of the wrapper's own choice (``ops/dmfb_step.tile_chips``).  For
the wide kernel the line names its layout: the chips a group that
``ops/dmfb_step.wide_group_chips`` chooses, 0 for one block a chip (a tree
without that function has only the latter).
``--root`` takes the package from another checkout, for example an
unpacked parent commit, so that two versions can be timed in one call.
Each result is also printed as a JSON line.
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
    ap.add_argument("--board", type=int, nargs="+", default=[10])
    ap.add_argument("--droplets", type=int, default=4)
    ap.add_argument("--kernel", choices=("tile", "wide"), default=None)
    ap.add_argument("--no-obs", dest="observe", action="store_false")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_dmfb_step: needs an NVIDIA GPU")

    sys.path.insert(0, os.path.abspath(opts.root))
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.ops import dmfb_step
    cs = _load_chip_smoke()

    smi = cs.nvidia_smi_line()
    root = os.path.relpath(os.path.abspath(opts.root), HERE)
    choose = getattr(dmfb_step, "tile_chips", None)
    if opts.kernel is not None:   # forced, whatever the shape
        dmfb_step.kernel_for = lambda params, observe=True: opts.kernel
    for board in opts.board:
        p = cs.wide_params(tdmfb, board, opts.droplets) if hasattr(
            cs, "wide_params") else tdmfb.DMFBParams()
        for batch in opts.batch:
            time_one(opts, cs, tdmfb, dmfb_step, choose, smi, root, board, p,
                     batch)


def time_one(opts, cs, tdmfb, dmfb_step, choose, smi, root, board, p, batch):
    """Time one board at one batch (each tile count of ``--tiles``) and
    print its line and its JSON row."""
    g = torch.Generator(device="cuda").manual_seed(4)
    step = dmfb_step.step_batch if opts.observe else dmfb_step.transition_batch
    sets = [(cs.random_states(tdmfb, p, batch, g),
             *cs.step_inputs(p, batch, g)) for _ in range(4)]
    bound_ms = copy_ms = None
    if hasattr(dmfb_step, "min_bytes"):   # a tree before it has no bound
        bound_ms, _, n_bytes, _ = cs.bound(dmfb_step, p, batch, opts.observe)
        src = [torch.empty(n_bytes // 2, dtype=torch.uint8, device="cuda")
               for _ in range(4)]
        dst = [torch.empty_like(x) for x in src]
        copy_ms = cs.device_ms([lambda i=i: dst[i].copy_(src[i])
                                for i in range(4)])
    for tile in opts.tiles or [None]:
        if tile is not None:
            dmfb_step.tile_chips = lambda params, b, *mode, c=tile: c
        try:
            ms = cs.device_ms([lambda x=x: step(p, *x) for x in sets])
        finally:
            if choose is not None:
                dmfb_step.tile_chips = choose
        tiled = getattr(dmfb_step, "kernel_for",
                        lambda *a: "tile")(p, opts.observe) == "tile"
        used = tile if tile is not None else (
            choose(p, batch, opts.observe) if choose and tiled else None)
        group = None if tiled else getattr(
            dmfb_step, "wide_group_chips", lambda *a: 0)(p, batch,
                                                         opts.observe)
        row = dict(root=root, board=board, droplets=opts.droplets,
                   kernel=opts.kernel or "default",
                   observe=opts.observe, batch=batch, tile=used, group=group,
                   us=ms * 1e3,
                   bound_us=bound_ms and bound_ms * 1e3,
                   share=bound_ms and bound_ms / ms,
                   copy_us=copy_ms and copy_ms * 1e3, card=smi)
        print(f"[{smi}] {root}: {board}x{board}-{opts.droplets}d "
              f"{row['kernel']} observe={opts.observe} B={batch} "
              f"tile={used} group={group}: kernel {ms * 1e3:.2f} us, bound "
              f"{row['bound_us']} us, share {row['share']}, copy of the "
              f"bound's bytes {row['copy_us']} us", flush=True)
        print(json.dumps(row), flush=True)

if __name__ == "__main__":
    main()
