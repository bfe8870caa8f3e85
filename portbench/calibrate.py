"""Readings that the check's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 101 102 ... [--control 1]

For each seed, the first item of the cell's pool at the cell's own size: the
program's call (the timed path's entry, warmed up) against the plain
reference in the configuration's precision, and with ``--control 1``
the reference computed in TF32 against the same: the control, which the
limits must fail. Each seed prints one JSON line; the last line holds
the program's largest reading of each number and the control's
smallest. The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(name: str, seeds, control: bool, device: str = "cuda", overrides=None):
    """Yields {"seed", "program": numbers, "control": numbers or None}."""
    from portbench import run
    from portbench.reference import plain

    c = run.load_cell(name, run.load_json(ROOT / "BENCHMARK.json"), overrides)
    for seed in seeds:
        item = c.entry.pool(c.cfg, c.traffic, seed, device)[0]
        program = c.entry.Program(c.cfg, device, seed)
        inputs = program.prepare(item)
        program.call(inputs)
        t0 = time.perf_counter()
        answer, kept = program.call(inputs, keep=True)
        call_s = time.perf_counter() - t0
        program.close()
        del program, inputs
        t0 = time.perf_counter()
        ref = c.entry.reference(item, c.cfg, plain.FP32, seed)
        ref_s = time.perf_counter() - t0
        out = {"seed": seed, "call_s": call_s, "reference_s": ref_s,
               "missed": bool(c.entry.missed(item, answer, c.check)),
               "program": c.entry.numbers(kept, ref), "control": None}
        del kept
        if control:
            ctl = c.entry.reference(item, c.cfg, plain.Precision("tf32"), seed)
            out["control"] = c.entry.numbers(ctl, ref)
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    largest, smallest = {}, {}
    for r in readings(args.workload, args.seeds, bool(args.control)):
        print(json.dumps(r), flush=True)
        for k, v in r["program"].items():
            largest[k] = max(largest.get(k, v), v)
        for k, v in (r["control"] or {}).items():
            smallest[k] = min(smallest.get(k, v), v)
    print(json.dumps({"program_largest": largest, "control_smallest": smallest}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
