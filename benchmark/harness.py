"""What every cell shares: the manifest and the data files it names, the
device's description, the reduction of a profiler trace, the per-layer
readers, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, whose ``kind`` names the driver
``drivers/<kind>.py`` that generates it); each per-layer metric is read by
``metrics/<name>.py``. Nothing here names a cell: a later cell or metric is
a new file and a new entry in the manifest.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the modules no run may load: the JAX package and JAX itself, compared by
# whole top-level names (the port's own name begins with the package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "aki_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, man: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest with its configuration, traffic and
    the metrics it reports."""
    man = man or manifest()
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in man["configs"] if c["name"] == w["config"]][0]

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"), chips=w["chips"],
                end_to_end=[m for m in man["end_to_end"] if reports(m)],
                per_layer=[m for m in man["per_layer"] if reports(m)])


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return load_module(HERE / "drivers" / f"{kind}.py")


def read_per_layer(metrics: list[dict], ctx: dict) -> dict:
    """Each per-layer metric's reader over the run's record; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(torch, device, chips: int) -> dict:
    """platform, kind and count as the driver reads them, and the card's
    power limit beside them."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(device.index or 0)], capture_output=True, text=True,
                             timeout=20)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


# -- the profiled slice of a window ---------------------------------------------------

class ProfiledSlice:
    """The slice of a window that a ``--trace 1`` run profiles: it opens at
    ``lo`` x ``seconds`` after the window opens and closes ``hi - lo`` x
    ``seconds`` later, each on a synchronise; a driver calls :meth:`tick`
    before each unit of work. Off (``on`` false), it never opens. The
    host-clock readers leave out the slice, with the profiler's start and
    stop, since the profiler slows the host: :meth:`outside` and
    :attr:`excluded_s`."""

    def __init__(self, on: bool, t_open: float, seconds: float, bounds, sync, cuda: bool):
        self.on, self.sync, self.cuda = on, sync, cuda
        lo, hi = bounds
        self.t_start, self.length = t_open + lo * seconds, (hi - lo) * seconds
        self.prof = self.t0 = self.t1 = self.t_pre = self.t_post = None

    @property
    def done(self) -> bool:
        """Whether a traced window may close: its slice has been profiled."""
        return not self.on or self.t1 is not None

    @property
    def open(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def tick(self, now: float) -> None:
        if self.on and self.t0 is None and now >= self.t_start:
            from torch.profiler import ProfilerActivity, profile

            self.t_pre = time.perf_counter()
            self.sync()
            self.prof = profile(activities=[ProfilerActivity.CPU]
                                + ([ProfilerActivity.CUDA] if self.cuda else []))
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif self.open and now - self.t0 >= self.length:
            self.sync()
            self.t1 = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.t_post = time.perf_counter()

    @property
    def excluded_s(self) -> float:
        return 0.0 if self.t_pre is None else self.t_post - self.t_pre

    def outside(self, t: float) -> bool:
        return self.t_pre is None or not self.t_pre <= t <= self.t_post

    def inside(self, t: float) -> bool:
        return self.t0 is not None and self.t0 <= t <= self.t1

    def summary(self) -> dict | None:
        return None if self.prof is None else trace_summary(self.prof, self.t1 - self.t0)


# -- the profiler's trace ---------------------------------------------------------

def trace_summary(prof, window_s: float, top: int = 10) -> dict:
    """Reduce a torch.profiler trace of one slice: the device's busy seconds
    (the union of its kernels', copies' and fills' intervals), the kernels by
    name (seconds and launches), the costliest device operations, and the
    device's idle time by what the host was doing: each gap between device
    activity named by the innermost operation of the busiest host thread
    running at its middle, the gaps summed by name."""
    from torch.autograd import DeviceType

    dev, host = [], {}
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue      # a named range on the device's line, not an operation
            dev.append((span[0], span[1], e.name))
        elif e.device_type == DeviceType.CPU:
            host.setdefault(e.thread, []).append((span[0], span[1], e.name))
    kernels: dict[str, list] = {}
    for s, e, n in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (e - s) / 1e6
        k[1] += 1
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_s = sum(e - s for s, e in merged) / 1e6
    main = sorted(max(host.values(), key=len, default=[]))
    idle: dict[str, float] = {}
    if merged:
        t_lo = min(merged[0][0], main[0][0] if main else merged[0][0])
        t_hi = max(merged[-1][1], max((e for _, e, _ in main), default=merged[-1][1]))
        edges = [t_lo] + [x for m in merged for x in m] + [t_hi]
        gaps = sorted(((edges[i] + edges[i + 1]) / 2, edges[i + 1] - edges[i])
                      for i in range(0, len(edges), 2) if edges[i + 1] > edges[i])
        stack, j = [], 0
        for mid, length in gaps:
            while j < len(main) and main[j][0] <= mid:
                while stack and stack[-1][1] < main[j][0]:
                    stack.pop()
                stack.append(main[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2][:160] if stack else "no host operation"
            idle[name] = idle.get(name, 0.0) + length / 1e6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy_s, window_s=window_s, kernels=kernels,
                breakdown={"device_ops": [[n[:160], v[0]] for n, v in ops],
                           "idle_gaps": [[n, v] for n, v in gaps_by]})


def idle_share(ctx: dict) -> float | None:
    """Share of the profiled slice in which no operation ran on the device,
    in %; None without a trace or device activity."""
    tr = ctx.get("trace")
    if tr is None or tr["busy_s"] <= 0:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0


def kernel_time(trace: dict, name: str) -> tuple[float, int]:
    """(device seconds, launches) of the kernels whose name holds ``name``."""
    s, n = 0.0, 0
    for k, (sec, cnt) in trace["kernels"].items():
        if name in k:
            s += sec
            n += cnt
    return s, n


def issued_time(trace: dict, name: str, issued: int) -> float | None:
    """Device seconds of ``issued`` launches of ``name``: the profiler can
    miss launches, so the mean of those it saw times those issued; None
    when it saw none."""
    sec, seen = kernel_time(trace, name)
    if not seen or not issued:
        return None
    return sec / seen * issued


# -- the result ----------------------------------------------------------------------

def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The contract's last line; the numbers compared come last, each
    beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def print_checks(checks: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
