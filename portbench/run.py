"""Runs one cell of the port's benchmark once.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell ``portbench/workloads/<name>.json`` names its entry driver
(``portbench/drivers/<driver>.py``), its configuration
(``portbench/configs/<config>.json``) and its traffic; ``BENCHMARK.json``
at the root lists the metrics, and each per-layer metric is read by
``portbench/metrics/<metric>.py``.  A run builds the system under test
and the cell's inputs from the seed, warms up the cell's shapes (all of
it set-up), measures for ``--seconds``, reads the device memory peak,
frees the program, and then compares what the timed path produced with
the plain reference under ``portbench/plain``.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics with ``--trace 0``, the
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, each number compared with its
limit.  The numbers compared are also the last lines of standard error.

Without enough CUDA devices, or if a module named ``jax``, ``jaxlib``,
``flax`` or ``paule_tpu`` was loaded, it exits with another code than 0
and prints no result.
"""

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: top-level module names the run must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "paule_tpu")


def load_json(kind, name):
    """``portbench/<kind>/<name>.json``."""
    with open(os.path.join(BENCH, kind, f"{name}.json")) as fh:
        return json.load(fh)


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def metric_reader(name):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """One run of a cell: its files, seed and devices, and what the
    driver keeps between set-up, the window and the check."""

    def __init__(self, name, seed, devices, workload=None, config=None):
        self.name = name
        self.workload = workload or load_json("workloads", name)
        self.config = config or load_json("configs",
                                          self.workload["config"])
        self.seed = int(seed)
        self.devices = devices
        self.somato = bool(self.config["paule"].get(
            "use_somatosensory_feedback"))
        self.driver = importlib.import_module(
            f"portbench.drivers.{self.workload['driver']}")
        #: the release's ``(arrays, trees)``, read once in set-up
        self.weights = None
        #: per planned unit (a call or a batch): its work, phase timings,
        #: counts and wall seconds, and whether it was traced
        self.units = []
        self.trace = None
        self.window_s = None


class Tracer:
    """Profiles loop iterations ``0 .. n - 1`` of a window, inside one
    :data:`~portbench.yardstick.trace.WINDOW` annotation.  Stopping the
    profiler (which collects the trace) takes seconds; :attr:`stop_s`
    says how many, for the driver to leave out of its window."""

    def __init__(self, n, devices):
        self.n = n
        self.devices = devices
        self.prof = None
        self.window = None
        self.events = None
        self.stop_s = 0.0

    @contextlib.contextmanager
    def iteration(self, i):
        import torch

        if self.n and i == 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if any(torch.device(d).type == "cuda" for d in self.devices):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.window = torch.profiler.record_function(
                "portbench.window")
            self.window.__enter__()
        yield self.n and i < self.n
        if self.prof is not None and i == self.n - 1:
            t = time.perf_counter()
            sync(self.devices)
            self.window.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.events = self.prof.events()
            self.prof = None
            self.stop_s = time.perf_counter() - t
            log(f"profiler stopped in {self.stop_s:.1f} s")


def sync(devices):
    import torch

    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def log(msg):
    """A progress line on standard error."""
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def execute(cell, seconds, trace, t0):
    """Set-up, window, peak, release and check of one run.  -> (setup_s,
    the driver's window numbers, memory peak, the judge's ``outputs`` and
    ``inputs``)."""
    import torch

    cell.driver.setup(cell)
    sync(cell.devices)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")
    tracer = Tracer(cell.workload["trace_iterations"] if trace else 0,
                    cell.devices)
    window = cell.driver.window(cell, seconds, tracer)
    sync(cell.devices)
    log(f"window {cell.window_s:.3f} s, {len(cell.units)} units, "
        f"{window['end_to_end']}")
    peak = max((torch.cuda.max_memory_allocated(d) for d in cell.devices
                if torch.device(d).type == "cuda"), default=0)
    outputs, inputs = cell.driver.gather(cell)
    cell.driver.close(cell)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if tracer.events is not None:
        from .yardstick import trace as T

        t = time.perf_counter()
        cell.trace = T.summarize(T.records(tracer.events), len(cell.devices))
        log(f"trace of {len(tracer.events)} events read in "
            f"{time.perf_counter() - t:.1f} s")
        tracer.events = None
    return setup_s, window, peak, outputs, inputs


def judge(cell, outputs, inputs, control=False):
    """The numbers compared for this run (or for the control put in the
    program's place): ``{name: value}``."""
    import torch

    from . import judge as J

    arrays = cell.weights[0]
    device = cell.devices[0]
    ref = J.Reference(arrays, cell.somato, device)
    if control:
        ctrl = J.Reference(arrays, cell.somato, device, torch.float32,
                           tf32_on=True, adam_dtype=torch.bfloat16)
        outputs = J.control(outputs, inputs, ctrl)
    return J.numbers(outputs, inputs, ref)


def checks_of(cell, numbers):
    """``{name: {"value", "limit"}}`` of the numbers the cell compares."""
    limits = cell.workload["limits"]
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def is_correct(checks):
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def metrics_of(cell, bench, window, setup_s, trace):
    """The cell's end-to-end metrics (``trace`` 0) or per-layer metrics
    (``trace`` 1) as ``{name: {"value", "unit"}}``."""
    out = {}
    if not trace:
        values = dict(window["end_to_end"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if cell.name in m.get("workloads", [cell.name]):
                out[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        return out
    for m in bench["per_layer"]:
        if cell.name not in m.get("workloads", [cell.name]):
            continue
        value = metric_reader(m["name"])(cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, t0=None):
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    chips = entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell = Cell(args.workload, args.seed,
                [f"cuda:{i}" for i in range(chips)])
    setup_s, window, peak, outputs, inputs = execute(
        cell, args.seconds, args.trace, t0)
    t = time.perf_counter()
    numbers = judge(cell, outputs, inputs)
    log(f"check {time.perf_counter() - t:.1f} s")
    checks = checks_of(cell, numbers)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": is_correct(checks),
              "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics_of(cell, bench, window, setup_s,
                                    args.trace),
              "device": device}
    if args.trace:
        device["busy_s"] = sum(cell.trace.busy_s) / len(cell.trace.busy_s)
        device["window_s"] = cell.trace.window_s
        result["breakdown"] = {"device_ops": cell.trace.device_ops,
                               "idle_gaps": cell.trace.idle_gaps}
    result["checks"] = checks
    for k, v in numbers.items():
        if k not in checks:
            print(f"portbench: {k} {v!r}", file=sys.stderr)
    sys.stdout.flush()
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
