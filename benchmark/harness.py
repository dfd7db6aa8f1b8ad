"""The harness's shared parts: the cell's files found by name, the
import guard, the card's identity, the statistics and the reduction of a
profiler trace to busy time, idle gaps and kernel times.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by the name that
`BENCHMARK.json` gives it:
  configs/<config>.json        the configuration as it is run
  traffic/<traffic>.json       the mix; its "driver" names
  drivers/<driver>.py          the general generator and loop for it
  metrics/<metric>.py          a per-layer metric's reader, read(run)
  reference/nets/<variant>_r<resnet_layers>_base<base>.py
                               the reference network of a configuration's
                               family, build(net, quant=False)
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run: JAX and the
# JAX package the port was made from (the port's name starts with the
# latter's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "zebrapose_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def process_start_epoch() -> float:
    """When this process started, in seconds since the epoch (Linux: its
    start tick in /proc/self/stat after the boot time in /proc/stat)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among `names` (default: the loaded
    modules), each compared whole: `zebrapose_tpu_torch` passes,
    `zebrapose_tpu.ops` does not."""
    names = list(sys.modules) if names is None else list(names)
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def library_environment() -> Dict[str, str]:
    """The switches that keep libraries from loading JAX."""
    return {"USE_FLAX": "0", "USE_JAX": "0"}


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A harness file (driver, metric reader or reference network) as a
    module, by path: its name may hold dots."""
    if not path.is_file():
        raise BenchError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_network(config: dict, quant: bool = False,
                      bench: Path = BENCH):
    """The plain reference's network of the configuration's family
    (`network`: variant, resnet_layers, base), built by the family's
    file: NHWC input, a dict of NHWC logits. `quant`: the convs' int8
    serving arithmetic."""
    net = config["network"]
    family = f"{net['variant']}_r{net['resnet_layers']}_base{net['base']}"
    mod = load_module(bench / "reference" / "nets" / f"{family}.py",
                      f"bench_net_{family}")
    return mod.build(net, quant=quant)


class Cell:
    """One entry of `workloads` with its configuration and traffic files
    and the metrics it reports."""

    def __init__(self, spec: dict, name: str, bench: Path = BENCH):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json")
        self.bench = bench
        self.spec = spec
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in spec["configs"]}
        entry = configs[self.workload["config"]]
        self.config = load_json(bench.parent / entry["file"])
        self.traffic = load_json(
            bench / "traffic" / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics read in this cell: those that list it,
        and those without a list whose `moves` the cell reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.spec["per_layer"]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif m["moves"] in e2e:
                out.append(m)
        return out

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.bench / "drivers" / f"{name}.py",
                           f"bench_driver_{name}")

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_"))


def card_identity() -> Tuple[str, str]:
    """(name, power limit) of card 0 as nvidia-smi prints them; the
    torch name and "unknown" where nvidia-smi cannot be asked."""
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
        limit = out.split(",")[-1].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return name, limit


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile over all values (linear between order
    statistics, numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merged(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals: time in which at
    least one of them runs, overlaps counted once."""
    return sum(e - s for s, e in merged(intervals))


def reduce_trace(device_events: List[Tuple[str, float, float]],
                 host_events: List[Tuple[str, float, float]],
                 window: Tuple[float, float], top: int = 10) -> dict:
    """A profiled window (times in microseconds on the profiler's clock)
    -> busy_s (union of device operations), window_s, the device
    operations that took most time, the longest idle gaps named by what
    the host was doing then (the innermost host event that holds the
    gap's start), and the kernel time by name."""
    w0, w1 = window
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in device_events
               if e > w0 and s < w1]
    busy = merged((s, e) for _, s, e in clipped)
    by_name: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for n, s, e in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        count[n] = count.get(n, 0) + 1
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    hosts = sorted((h for h in host_events
                    if h[0] != "bench.trace_window"), key=lambda x: x[1])
    starts = [h[1] for h in hosts]
    spans = sorted((h for h in hosts if h[0].startswith("bench.")),
                   key=lambda x: x[1])
    span_starts = [h[1] for h in spans]

    def innermost(events, keys, t: float) -> str:
        # the latest-started event still running at t holds no other
        # running one: events nest on the thread that issues the work
        for i in range(bisect.bisect_right(keys, t) - 1, -1, -1):
            if events[i][2] > t:
                return events[i][0]
        return "none"

    def host_at(t: float) -> str:
        return (innermost(spans, span_starts, t) + "/"
                + innermost(hosts, starts, t))

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": union_length(busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernel_s": by_name,
        "kernel_count": count,
        "device_ops": sorted(([n, v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": [[host_at(s), (e - s) / 1e6] for s, e in gaps[:top]],
    }


class ProfiledSpan:
    """torch.profiler (host and device activity) from construction to
    `stop()`, each end on a drained device; `result` is then
    reduce_trace's record of the span, whose window is a
    "bench.trace_window" range around it."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.range = record_function("bench.trace_window")
        self.range.__enter__()
        self.running = True
        self.result: Optional[dict] = None

    def stop(self) -> dict:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.range.__exit__(None, None, None)
        self.prof.stop()
        self.running = False
        dev, host, window = [], [], None
        for e in self.prof.events():
            tr = e.time_range
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("bench."):
                # a host range, and its mirror on the device's timeline
                if e.device_type != DeviceType.CUDA:
                    host.append((e.name, float(tr.start), float(tr.end)))
                if e.name == "bench.trace_window" and \
                        e.device_type != DeviceType.CUDA:
                    window = (float(tr.start), float(tr.end))
                continue
            if e.device_type == DeviceType.CUDA:
                dev.append((e.name, float(tr.start), float(tr.end)))
            else:
                host.append((e.name, float(tr.start), float(tr.end)))
                if e.name == "bench.trace_window":
                    window = (float(tr.start), float(tr.end))
        if window is None:
            raise BenchError("the profiler recorded no trace window")
        self.result = reduce_trace(dev, host, window)
        return self.result


def kernel_seconds(trace: dict, needle: str) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name holds
    `needle` in a reduced trace."""
    s = sum(v for n, v in trace["kernel_s"].items() if needle in n)
    c = sum(v for n, v in trace["kernel_count"].items() if needle in n)
    return s, c


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """Print the compared numbers beside their limits as the last lines
    on standard error, then the result as the last line on standard
    output with them under "checks", its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    out = dict(result)
    out["checks"] = checks
    print(json.dumps(out), flush=True)
