"""One run of one cell of ``BENCHMARK.json``, driven by data.

Everything that belongs to one configuration, traffic mix, metric or
cost is a file of its own, found by the name the manifest gives:

- ``configs/<config>.json``: the configuration's sizes, its serving
  precision, the program adapter (``programs/<program>.py``) and the plain
  reference (``reference/<config>.py``);
- ``mixes/<traffic>.json``: the traffic's parameters and the window driver
  that runs them (``drivers/<driver>.py``);
- ``workloads/<cell>.json``: the cell's check limits, with the readings they
  were set from;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``costs/<name>.py``: operations and bytes of a kernel or a step.

A driver module provides ``setup(ctx) -> state`` (inputs, weights, the
program, its warm-up), ``batch(state, j) -> units`` (one whole batch or
step of the window, its results back on the host), ``counters(state)``
and ``check(state, ctx) -> [check]`` (after the window: free the program,
run the reference on the sample, one ``{"name", "value", "limit"}`` per
number compared).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "zs_aac_tpu")


def load_json(*parts) -> dict:
    with open(BENCH.joinpath(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots and
    dashes, so it is loaded by path)."""
    key = f"benchmark._{kind}.{name}".replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``zs_aac_tpu_torch`` is not ``zs_aac_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def metrics_of(man: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    e2e = [m for m in man["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


class Ctx:
    """What a driver sees of the run: the cell's files, the seed, the device,
    and a timer for the set-up's phases."""

    def __init__(self, cell: dict, seed: int, device, config: Optional[dict] = None,
                 mix: Optional[dict] = None, limits: Optional[dict] = None):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.config = config if config is not None else load_json("configs", cell["config"] + ".json")
        self.mix = mix if mix is not None else load_json("mixes", cell["traffic"] + ".json")
        self.limits = (limits if limits is not None
                       else load_json("workloads", cell["name"] + ".json")["checks"])
        self.setup_split: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.sync()
        self.setup_split[name] = self.setup_split.get(name, 0.0) + time.perf_counter() - t0

    def sync(self):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def program(self, name: str):
        return load_module("programs", name)

    def reference(self):
        return load_module("reference", self.cell["config"])


class Window:
    """The measured window: one entry per whole batch (or step), in order.
    It ends at the end of the last batch that started before the deadline."""

    def __init__(self):
        self.starts: List[float] = []
        self.ends: List[float] = []
        self.units: List[int] = []
        self.profiled: List[bool] = []

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.starts[0]

    @property
    def walls(self) -> List[float]:
        return [e - s for s, e in zip(self.starts, self.ends)]

    def unprofiled(self):
        """(units, seconds) of the batches the profiler did not slow."""
        keep = [i for i, p in enumerate(self.profiled) if not p]
        return sum(self.units[i] for i in keep), sum(self.walls[i] for i in keep)


class RunView:
    """What a metric reader sees: the cell, the window, the trace of the
    profiled stretch (``None`` without ``--trace 1``), the launch counters
    and what the driver recorded of the work (``info``)."""

    def __init__(self, cell, config, mix, window, trace, counters, info, setup_s):
        self.cell, self.config, self.mix = cell, config, mix
        self.window, self.trace, self.counters, self.info = window, trace, counters, info
        self.setup_s = setup_s
        self._costs = {}

    def cost(self, name: str):
        if name not in self._costs:
            self._costs[name] = load_module("costs", name)
        return self._costs[name]


def run_window(driver, state, seconds: float, trace_plan=None):
    """Whole batches (one at least) until ``seconds`` have passed since the
    first started;
    with ``trace_plan = (first, count)`` batches ``first .. first+count-1``
    run under the profiler inside the span ``tracing.STRETCH`` (the window
    goes on until they have run). Returns (window, profiler or None)."""
    from benchmark import tracing

    import torch

    win = Window()
    prof = None
    first, count = trace_plan or (-1, 0)
    j = 0
    t_start = time.perf_counter()
    while True:
        pending = j < first + count
        if j and time.perf_counter() - t_start >= seconds and not pending:
            break
        if j == first:
            prof = tracing.start_profiler()
            span = torch.profiler.record_function(tracing.STRETCH)
            span.__enter__()
        t0 = time.perf_counter()
        units = driver.batch(state, j)
        t1 = time.perf_counter()
        if j == first + count - 1:
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        win.starts.append(t0)
        win.ends.append(t1)
        win.units.append(units)
        win.profiled.append(first <= j < first + count)
        j += 1
    return win, prof


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None, t_process: Optional[float] = None) -> int:
    import argparse

    t0 = t_process if t_process is not None else time.perf_counter()
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    t_import = time.perf_counter()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.zeros(1, device="cuda")
    ctx = Ctx(cell, args.seed, torch.device("cuda"))
    ctx.setup_split["import"] = time.perf_counter() - t_import
    driver = load_module("drivers", ctx.mix["driver"])
    state = driver.setup(ctx)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    plan = None
    if args.trace:
        plan = (ctx.mix["trace"]["first_batch"], ctx.mix["trace"]["batches"])
    window, prof = run_window(driver, state, args.seconds, plan)
    torch.cuda.synchronize()
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(cell["chips"]))
    counters = driver.counters(state)
    info = driver.info(state)
    checks = driver.check(state, ctx)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4

    trace = None
    if prof is not None:
        from benchmark import tracing

        trace = tracing.Trace.from_events(prof.profiler.kineto_results.events())
    view = RunView(cell, ctx.config, ctx.mix, window, trace, counters, info, setup_s)
    metrics = {}
    for m in metrics_of(man, cell["name"], bool(args.trace)):
        value = load_module("metrics", m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["limit"] is not None and c["value"] <= c["limit"]
                            for c in checks),
              "attempted": sum(window.units), "failed": 0, "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}

    split = ", ".join(f"{k} {v:.3f}" for k, v in ctx.setup_split.items())
    print(f"[bench] {cell['name']} seed {args.seed}: set-up {setup_s:.3f} s ({split})")
    walls = window.walls
    print(f"[bench] window {window.seconds:.3f} s, {len(walls)} batches, {sum(window.units)} "
          f"units; batch wall median {statistics.median(walls) * 1e3:.2f} ms, "
          f"min {min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}")
    print(f"[bench] memory peak {peak} bytes; counters {json.dumps(counters)}")
    print(f"[bench] card: {power_limit()}")
    sys.stdout.flush()
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
