"""The benchmark of threecrate_tpu_torch on one NVIDIA H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Everything a cell needs is found by
name: the cell in ``BENCHMARK.json``, its configuration (the file that
entry names), its traffic mix in ``portbench/traffic/<traffic>.json``, its
check in ``portbench/workloads/<cell>.json``, the entry the traffic drives
in ``portbench/entries/<entry>.py`` (which makes the calls' inputs, such
as scan pairs of a scene kind in ``portbench/scenes/<kind>.py``, and
judges each call's answer) and each metric's reader in
``portbench/metrics/<metric>.py`` (``metric_file``). A new cell, configuration, scene kind,
entry, traffic mix or metric is new files and new ``BENCHMARK.json``
entries.

A run: set-up (the entry's pool of inputs made from ``--seed``, the entry
built, every pool item's shape warmed up), then a closed loop with one
caller for ``--seconds``, each call one pool item, ending when its answer
is on the host. With ``--trace 1`` the window is traced instead, and the
per-layer metrics are read from it. Then the check: the sampled items'
outputs against the plain reference (``portbench/reference``), each
number beside its limit. The last line of standard output is one JSON
object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "threecrate_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, bench: dict, overrides=None) -> SimpleNamespace:
    """The cell's entry, configuration, traffic mix and check, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = _merge(load_json(ROOT / conf["file"]), (overrides or {}).get("config", {}))
    traffic = _merge(load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
                     (overrides or {}).get("traffic", {}))
    check = load_json(HERE / "workloads" / f"{name}.json")
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    return SimpleNamespace(name=name, cell=cell, cfg=cfg, traffic=traffic, check=check,
                           entry=entry)


def metrics_for(bench: dict, cell: dict, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def metric_file(name: str) -> Path:
    """The reader of a metric: ``portbench/metrics/<name>.py``, or, for a
    quantity split by the regime of its cells (``<base>.<regime>``, each
    with its own bound), ``<base>.py`` where the split has none of its own."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def read_metric(name: str, ctx):
    """The value that the metric's reader (``metric_file``) takes from the
    run, or None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", metric_file(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


class Clock:
    """Call stamps: CUDA events on the card (the device's clock), the
    host's clock elsewhere (CPU tests only: no device number comes from
    it)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def stamp(self):
        import torch

        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


def _sync(cuda: bool):
    import torch

    if cuda:
        torch.cuda.synchronize()


def closed_loop(program, inputs, seconds: float, sample, clock, min_calls: int = 1):
    """Calls in turn over the pool until ``seconds`` have passed (and at
    least ``min_calls``): (stamps, answers, kept outputs, wall seconds)."""
    stamps, answers, kept = [], [], {}
    t0 = time.perf_counter()
    i = 0
    while True:
        j = i % len(inputs)
        start = clock.stamp()
        answer, out = program.call(inputs[j], keep=j in sample)
        stamps.append((start, clock.stamp()))
        answers.append((j, answer))
        if out is not None:
            kept[j] = out
        i += 1
        if i >= min_calls and time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    _sync(clock.cuda)
    return stamps, answers, kept, wall


def run(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        overrides=None):
    """One run of a cell: (result dict, {number: (value, limit)})."""
    import torch

    from portbench import trace
    from portbench.reference import plain

    cuda = torch.device(device).type == "cuda"
    bench = load_json(ROOT / "BENCHMARK.json")
    c = load_cell(name, bench, overrides)
    from threecrate_tpu_torch import kernels

    marks = {"imports": time.perf_counter()}
    items = c.entry.pool(c.cfg, c.traffic, seed, device)
    _sync(cuda)
    marks["inputs"] = time.perf_counter()
    program = c.entry.Program(c.cfg, device, seed)
    inputs = [program.prepare(p) for p in items]
    pick = torch.Generator()
    pick.manual_seed(seed + 1)
    sample = set(torch.randperm(len(items), generator=pick)[:c.check["check_items"]].tolist())
    for i in range(c.traffic["warmup_calls"]):
        program.call(inputs[i % len(inputs)])
    _sync(cuda)
    clock = Clock(cuda)
    setup_s = time.perf_counter() - T_START
    last = T_START
    for k, t in (*marks.items(), ("warm-up", T_START + setup_s)):
        print(f"setup {k}: {t - last:.3f} s", file=sys.stderr)
        last = t
    ctx = SimpleNamespace(setup_s=setup_s, cfg=c.cfg, traffic=c.traffic,
                          shapes=c.entry.shapes(c.cfg, items), counters=program.counters)
    breakdown = None
    if not traced:
        stamps, answers, kept, wall = closed_loop(program, inputs, seconds, sample, clock)
    else:
        program.time_spans = True
        kernels.reset_launch_counts()
        for k in program.counters:
            program.counters[k] = 0
        got = {}

        def window():
            got["loop"] = closed_loop(program, inputs, min(seconds, c.traffic["trace_seconds"]),
                                      sample, clock, min_calls=len(inputs))

        events, _ = trace.device_events(window)
        stamps, answers, kept, wall = got["loop"]
        ctx.events, ctx.launches = events, kernels.launch_counts()
        ctx.busy_s = trace.union_s([(s, e) for _, s, e in events])
        ctx.spans = {k: [s.elapsed_time(e) for s, e in v] for k, v in program.spans.items()}
        program.time_spans = False
        ctx.counters = dict(program.counters)
        ctx.host_syncs = sum(trace.count_host_syncs(lambda j=j: program.call(inputs[j]))
                             for j in range(len(inputs)))
        ctx.sync_calls = len(inputs)
        breakdown = {"device_ops": trace.by_name(events),
                     "idle_gaps": trace.idle_gaps(lambda: program.call(inputs[0]))}
    ctx.calls, ctx.window_s = len(stamps), wall
    ctx.latencies_ms = [clock.ms(a, b) for a, b in stamps]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    program.close()
    del program, inputs
    if cuda:
        torch.cuda.empty_cache()

    failed = sum(bool(c.entry.missed(items[j], answer, c.check)) for j, answer in answers)

    limits = c.check["limits"]
    worst = {k: 0.0 for k in limits}
    for j in sorted(kept):
        ref = c.entry.reference(items[j], c.cfg, plain.FP32, seed)
        for k, v in c.entry.numbers(kept[j], ref).items():
            if k in worst:
                worst[k] = max(worst[k], v) if math.isfinite(v) else math.inf
        del ref
    checks = {k: (worst[k], limits[k]) for k in limits}
    correct = bool(kept) and all(v <= lim for v, lim in checks.values())

    kind = "per_layer" if traced else "end_to_end"
    units = {m["name"]: m["unit"] for m in metrics_for(bench, c.cell, kind)}
    values = {m: read_metric(m, ctx) for m in units}
    result = {
        "correct": correct, "attempted": len(answers), "failed": failed,
        "metrics": {m: {"value": v, "unit": units[m]} for m, v in values.items()
                    if v is not None},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": c.cell["chips"], "memory_peak_bytes": peak},
    }
    if traced:
        result["device"].update(busy_s=ctx.busy_s, window_s=wall)
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = {w["name"]: w["chips"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]}
    need = chips.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark runs without them",
              file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r}){'' if v <= lim else ' FAILED'}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
