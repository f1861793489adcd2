"""The benchmark's machinery: it finds every piece by name, times the window,
reads the trace, judges the outputs and builds the result line.

Nothing here belongs to one configuration, traffic mix or metric. A cell of
``BENCHMARK.json`` names a configuration (``configs/<name>.json``) and a
traffic mix (``traffic/<name>.json``); the traffic names its loop
(``loops/<loop>.py``), which builds the program's state, runs one unit
of work (a batch, a protocol) and judges what the window produced against
the plain reference; each compared number's limit is in
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import math
import os
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "difffacto_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file at ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, path=REPO / "BENCHMARK.json"):
        self.data = load_json(path)
        self.root = Path(path).resolve().parent

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic(name: str) -> dict:
        return load_json(BENCH / "traffic" / f"{name}.json")

    @staticmethod
    def limits(cell: str) -> dict:
        return load_json(BENCH / "limits" / f"{cell}.json")

    def _applies(self, metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", [w["name"] for w in self.data["workloads"]])

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics of a cell: those that list it, and those
        without a list that move an end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        out = []
        for m in self.data["per_layer"]:
            if (cell in m["workloads"]) if "workloads" in m else (m["moves"] in reported):
                out.append(m)
        return out


def loop(name: str):
    return load_module(BENCH / "loops" / f"{name}.py", f"bench_loop_{name}")


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))


class Run:
    """What a loop is given: the cell's configuration and traffic, the
    seed, the device, and the host spans it records."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, synchronize=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans = []  # (name, start, end) on the host clock
        self._sync = synchronize or (lambda: None)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def synchronize(self):
        self._sync()


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def judge(values: dict, limits: dict) -> tuple:
    """(correct, lines): every limited number present, finite and at or
    under its limit."""
    lines, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, float("nan"))
        good = isinstance(v, (int, float)) and math.isfinite(v) and v <= limit
        ok = ok and good
        lines[name] = {"value": v, "limit": limit}
    return ok, lines


def window(run: Run, drv, state, seconds: float, trace_until: float = None, profiler=None):
    """Units of work back to back until ``seconds`` have passed; each unit
    ends with the device idle. Returns (elapsed, counts, traced) where
    ``traced`` holds the traced prefix's (elapsed, counts, number of host
    spans) when a profiler is given: it stops after the first unit that ends
    past ``trace_until``, and the seconds its stop takes to collect the
    trace are left out of ``elapsed``."""
    counts, traced = {}, None
    t0 = time.perf_counter()
    i = 0
    while True:
        add_counts(counts, drv.step(run, state, i))
        i += 1
        now = time.perf_counter() - t0
        if profiler is not None and traced is None and (now >= trace_until or now >= seconds):
            traced = (now, dict(counts), len(run.spans))
            t_stop = time.perf_counter()
            profiler.stop()
            t0 += time.perf_counter() - t_stop
        if now >= seconds:
            return now, counts, traced


def device_busy(events) -> float:
    """The length of the union of (name, start, end) device events, in the
    events' unit."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((s, e) for _, s, e in events):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def kernel_table(events) -> dict:
    """{name: [seconds, count]} from (name, start_us, end_us) events."""
    table = {}
    for name, s, e in events:
        row = table.setdefault(name, [0.0, 0])
        row[0] += (e - s) * 1e-6
        row[1] += 1
    return table


def idle_gaps(events, spans, offset_us: float, t_end_us: float) -> list:
    """The device's idle time, summed by the host span running when each gap
    began: [[label, seconds]] longest first. ``offset_us`` turns device
    times into host perf_counter microseconds."""
    merged = []
    for s, e in sorted((s, e) for _, s, e in events):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    if merged and t_end_us > merged[-1][1]:
        gaps.append((merged[-1][1], t_end_us))
    host = sorted((s * 1e6, e * 1e6, n) for n, s, e in spans)
    starts = [h[0] for h in host]
    out = {}
    for g0, g1 in gaps:
        at = g0 - offset_us
        k = bisect.bisect_right(starts, at) - 1
        label = host[k][2] if k >= 0 and at < host[k][1] else "between spans"
        out[label] = out.get(label, 0.0) + (g1 - g0) * 1e-6
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])[:10]


def read_per_layer(spec_metrics, info) -> dict:
    """Each per-layer metric from its reader; a reader that finds nothing
    to read returns None and the metric is left out."""
    out = {}
    for m in spec_metrics:
        value = metric_reader(m["name"]).read(info)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def info_for(config, traffic, elapsed, counts):
    """What the per-layer readers are given; a traced run adds the traced
    prefix's seconds, work, host spans, busy seconds and kernel table."""
    return SimpleNamespace(config=config, traffic=traffic, window_s=elapsed, counts=counts,
                           traced_s=None, traced_counts={}, traced_spans=[], busy_s=None,
                           kernels={})


def plain_json(obj):
    """``obj`` with every non-finite float written as a string, so that the
    line is strict JSON."""
    if isinstance(obj, dict):
        return {k: plain_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain_json(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    return obj


def forbidden_modules(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def trace_events(prof, t_mark: float):
    """(events, offset_us) from a stopped profiler: every device event but
    the clock marker, as (name, start_us, end_us), and the shift that turns
    device microseconds into host perf_counter microseconds, read from the
    marker kernel launched at host time ``t_mark``."""
    from torch.autograd import DeviceType

    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    marker = next((ev for ev in events if "spin_kernel" in ev[0]), None)
    if marker is None:
        return events, events[0][1] - t_mark * 1e6 if events else 0.0
    return [ev for ev in events if ev is not marker], marker[1] - t_mark * 1e6


def run_cell(spec: Spec, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple:
    """One run of one cell: set-up, the window, the per-layer readings with
    ``trace``, and the check. Returns (result, checks): the object the
    result line prints, and the compared numbers with their limits."""
    import torch

    cell = spec.cell(cell_name)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(cell_name)
    drv = loop(traffic["loop"])
    # the program's own options, set as the configuration states them
    os.environ.update(config.get("env", {}))
    cuda = device.type == "cuda"
    run = Run(config, traffic, seed, device, torch.cuda.synchronize if cuda else None)
    state = drv.setup(run)
    run.synchronize()
    setup_s = time.perf_counter() - t_start
    run.spans.clear()

    prof, t_mark = None, None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.cuda._sleep(1000)  # the clock marker: a kernel named spin_kernel
    elapsed, counts, traced = window(run, drv, state, seconds,
                                     traffic.get("trace_seconds", seconds), prof)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    rates = {name: counts[unit] / elapsed for name, unit in traffic["rates"].items()}
    metrics, dev, breakdown = {}, {}, None
    if trace:
        info = info_for(config, traffic, elapsed, counts)
        if prof is not None:
            events, offset = trace_events(prof, t_mark)
            info.traced_s, info.traced_counts, n_spans = traced
            info.traced_spans = run.spans[:n_spans]
            info.busy_s, info.kernels = device_busy(events) * 1e-6, kernel_table(events)
            dev = {"busy_s": info.busy_s, "window_s": info.traced_s}
            ops = sorted(info.kernels.items(), key=lambda kv: -kv[1][0])[:10]
            breakdown = {"device_ops": [[n[:160], v[0]] for n, v in ops],
                         "idle_gaps": idle_gaps(events, run.spans, offset,
                                                (t_mark + info.traced_s) * 1e6 + offset)}
        metrics = read_per_layer(spec.per_layer(cell_name), info)
    else:
        for m in spec.end_to_end(cell_name):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in rates:
                metrics[m["name"]] = {"value": rates[m["name"]], "unit": m["unit"]}
            else:
                raise KeyError(f"traffic {cell['traffic']!r} gives no {m['name']!r}")

    values, failed = drv.check(run, state)
    correct, checks = judge(values, limits)
    attempted = counts[traffic["attempted"]]
    result = {"correct": bool(correct and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": memory_peak, **dev}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks
