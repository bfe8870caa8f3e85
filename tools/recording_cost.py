#!/usr/bin/env python3
"""What stage recording costs on the card: each benchmark cell's closed
loop with ``utils.profiling.recording()`` off and on, in turns.

    python3 tools/recording_cost.py [--seconds 15] [--seed 1] [cell ...]

For each cell (default: every cell of ``BENCHMARK.json``) the cell's
pool, entry and warm-up are made as ``portbench/run.py`` makes them,
then four windows of ``--seconds`` run in the order off, on, on, off,
each one caller in a closed loop over the pool. A window with recording
on keeps every span in memory until it ends, as an operator's recording
would. The last line is one JSON object: the card, its power limit, and
per cell each window's scans per second and the spans it kept. Needs one
CUDA card; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("cells", nargs="*")
    args = ap.parse_args()

    import torch

    from portbench import run
    from threecrate_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("recording_cost: needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json(ROOT / "BENCHMARK.json")
    cells = args.cells or [w["name"] for w in bench["workloads"]]
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "power_limit": limit, "cells": {}}
    clock = run.Clock(True)
    for name in cells:
        c = run.load_cell(name, bench)
        items = c.entry.pool(c.cfg, c.traffic, args.seed, "cuda")
        program = c.entry.Program(c.cfg, "cuda", args.seed)
        inputs = [program.prepare(p) for p in items]
        for i in range(c.traffic["warmup_calls"]):
            program.call(inputs[i % len(inputs)])
        torch.cuda.synchronize()
        windows = []
        for on in (False, True, True, False):
            with profiling.recording() if on else contextlib.nullcontext() as rec:
                stamps, _, _, wall = run.closed_loop(program, inputs, args.seconds, set(), clock)
            windows.append({"recording": on, "scans_per_s": len(stamps) / wall,
                            "spans": len(rec.spans) if on else 0})
            print(f"{name} recording {'on ' if on else 'off'}: {windows[-1]}", file=sys.stderr)
        program.close()
        del program, inputs, items
        torch.cuda.empty_cache()
        off = [w["scans_per_s"] for w in windows if not w["recording"]]
        on = [w["scans_per_s"] for w in windows if w["recording"]]
        out["cells"][name] = {"windows": windows,
                              "on_over_off": (sum(on) / len(on)) / (sum(off) / len(off))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
