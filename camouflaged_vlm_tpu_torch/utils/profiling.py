"""Profiling harness: torch.profiler traces, timed sections, and the card's
time split by who launched it.

Counterpart of `camouflaged_vlm_tpu/utils/profiling.py`. `trace()` wraps a
block in a torch.profiler capture (CPU and, where there is a card, CUDA
activities) and writes a Chrome/Perfetto trace, the counterpart of the
xplane capture; `Timeline` gives coarse per-section wall times with a
device barrier (`barrier` reads a scalar back, which waits for the card).

Reading a trace:

  * `device_events`: its kernels, copies and fills (the device spans the
    profiler shows for `record_function` ranges left out); `busy_ms`: the
    union of their intervals, the card's busy time; `device_kernels`:
    kernel names and counts, busy time and device ms by name;
    `trace_call`: one call under the profiler, its busy time against the
    call's unprofiled wall, the host ops that cost most and the calls that
    can wait for the card.
  * `device_breakdown`: every device event of a trace in one family, the
    port's kernels by their `ops/_cuda.KERNELS` name (each launch runs
    under a `record_function` range named `PROFILE_RANGE` + that name while
    a profiler is on), cuBLAS GEMMs, cuDNN, the remaining aten kernels by
    the aten op that launched them, the runtime's copies and fills, and
    other. An eager trace attributes each kernel through its launch (the
    runtime call with the kernel's correlation id) to the CPU ops around it
    (`attribute`). A CUDA graph's replay has no CPU ops: its kernels take
    the owners of an eager trace of the same call, paired by name in launch
    order (`align`), and are left to their names' families where unpaired.
    The families' ms sum to the total by construction.

Every function here reads a trace; none makes up a device time: a trace
without device events (the CPU) gives a breakdown that says so.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import os
import re
import time
from collections import Counter
from typing import Callable, Dict, Iterator, List, Optional

import torch

from ..ops._cuda import CSRC, PROFILE_RANGE

# runtime calls and ops that can make the host wait for the card
SYNC_EVENTS = ("cudaMemcpy", "Synchronize", "aten::_local_scalar_dense")
FAMILIES = ("port kernels", "cuBLAS", "cuDNN", "aten", "copies and fills", "other")
_CUBLAS = re.compile(r"cublas|nvjet|gemm|gemv|cutlass|splitKreduce|dot_kernel", re.I)
_CUDNN = re.compile(r"cudnn|fprop|dgrad|wgrad|convolve|conv2d|winograd", re.I)
_ATEN = re.compile(r"at::|at_cuda_detail|c10::|cub::|elementwise|reduce_kernel|vectorized")


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace") -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block (CPU, and CUDA where there is a card);
    writes `<logdir>/<name>.json` (Chrome/Perfetto) and yields the profiler,
    whose events the readers below take."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


def _first_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, (str, bytes)):
        raise TypeError("not a tensor")
    items = value.values() if isinstance(value, dict) else value
    for v in items:
        try:
            return _first_tensor(v)
        except (TypeError, ValueError):
            continue
    raise ValueError("no tensor in the value")


class Timeline:
    """Named wall-clock sections with device barriers."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.sections[name] = self.sections.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def barrier(self, value) -> float:
        """Force completion by reading a scalar reduction of the first
        tensor of `value` back to the host."""
        return float(_first_tensor(value).float().sum())

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"total {total*1e3:.1f} ms"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v*1e3:.1f} ms ({100*v/total:.0f}%)")
        return "\n".join(lines)


# ------------------------------------------------------- reading a trace


def _is_annotation(e) -> bool:
    """A record_function range's span on the device (the profiler shows one
    over its kernels): no kernel of its own."""
    return bool(getattr(e, "is_user_annotation", False)) or (
        e.name.startswith(PROFILE_RANGE) and "(" not in e.name)


def device_events(prof) -> list:
    """The kernels, copies and fills of a trace (the device spans of
    record_function ranges left out)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not _is_annotation(e)]


def _ms(e) -> float:
    return (e.time_range.end - e.time_range.start) / 1e3


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def busy_ms(events) -> float:
    """The union of the device events' intervals, ms: the card's busy time."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def device_kernels(prof):
    """Kernel names and counts of a torch.profiler trace (copies and fills
    of the runtime left out), the card's busy ms, and the kernels' device
    ms by name."""
    dev = device_events(prof)
    kernels = [e for e in dev if not _is_copy(e.name)]
    ms = Counter()
    for e in kernels:
        ms[e.name] += _ms(e)
    return Counter(e.name for e in kernels), busy_ms(dev), ms


def kernel_symbol(name: str) -> str:
    """A device kernel's function name without its return type, namespaces,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^(void |std::enable_if<[^>]*>::type )", "", name)
    head = re.split(r"[<(]", name, maxsplit=1)[0]
    return head.split("::")[-1].strip()


@functools.lru_cache(maxsize=None)
def port_symbols() -> frozenset:
    """The `__global__` function names of the port's CUDA sources."""
    found = set()
    for path in glob.glob(os.path.join(CSRC, "*.cu*")):
        with open(path) as f:
            src = f.read()
        found.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(", src))
    return frozenset(found)


def _owner(op) -> Optional[str]:
    """The owner of a launch made inside CPU op `op`: a port kernel's
    PROFILE_RANGE name, else the outermost aten op around it."""
    aten = None
    while op is not None:
        if op.name.startswith(PROFILE_RANGE):
            return op.name
        if op.name.startswith("aten::"):
            aten = op.name
        op = op.cpu_parent
    return aten


def attribute(prof) -> List[tuple]:
    """The device events of a trace in start order, each as (event, owner):
    owner the PROFILE_RANGE name or the aten op of the CPU op around the
    event's launch, or None (a replay's kernels, whose one launch is the
    graph's)."""
    from torch.autograd import DeviceType

    launches = {e.id: e for e in prof.events()
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")
                and "::" not in e.name}
    out = []
    for d in sorted(device_events(prof), key=lambda e: e.time_range.start):
        r = launches.get(d.id)
        out.append((d, _owner(r.cpu_parent) if r is not None else None))
    return out


def _family(name: str, owner: Optional[str]) -> str:
    if _is_copy(name):
        return "copies and fills"
    if (owner or "").startswith(PROFILE_RANGE) or kernel_symbol(name) in port_symbols():
        return "port kernels"
    if _CUBLAS.search(name):
        return "cuBLAS"
    if _CUDNN.search(name):
        return "cuDNN"
    if (owner or "").startswith("aten::") or _ATEN.search(name):
        return "aten"
    return "other"


def align(names: List[str], call: List[str], look: int = 32) -> Dict[int, int]:
    """{i: j}: names[i] is the kernel call[j], walking both in launch order,
    `call` over and over (a trace of replays repeats the call); where the
    names part, the nearer of the next `look` of either side resyncs them,
    and what lies between stays unpaired."""
    out, n, i, j = {}, len(call), 0, 0
    while i < len(names) and n:
        if names[i] == call[j % n]:
            out[i] = j % n
            i, j = i + 1, j + 1
            continue
        dj = next((d for d in range(1, look) if call[(j + d) % n] == names[i]), None)
        di = next((d for d in range(1, look)
                   if i + d < len(names) and names[i + d] == call[j % n]), None)
        if dj is not None and (di is None or dj <= di):
            j += dj
        elif di is not None:
            i += di
        else:
            i, j = i + 1, j + 1
    return out


def device_breakdown(prof, top: int = 15, like: Optional[List[tuple]] = None) -> dict:
    """The device time of a trace by family (`FAMILIES`) and by kernel.

    like: `attribute()` of an eager trace of one call, whose kernels' owners
        a replay's kernels (the graph of that call, replayed any number of
        times) take where `align` pairs them by name in launch order.

    Returns {"events", "total_ms" (the events' summed durations), "busy_ms",
    "families": {family: ms}, "shares": {family: share of total_ms},
    "kernels": the `top` (family, label, ms, count) rows, a port kernel
    labelled by its KERNELS name where known, an aten kernel by its op,
    "aten_ops": {aten op: ms} of the attributed aten kernels, "matched": the
    share of the kernels paired with `like`'s (None without it)}."""
    rows = attribute(prof)
    matched = None
    if like is not None:
        mine = [i for i, (d, _) in enumerate(rows) if not _is_copy(d.name)]
        theirs = [(d.name, o) for d, o in like if not _is_copy(d.name)]
        pairs = align([rows[i][0].name for i in mine], [n for n, _ in theirs])
        for k, j in pairs.items():
            rows[mine[k]] = (rows[mine[k]][0], theirs[j][1])
        matched = len(pairs) / len(mine) if mine else 0.0
    fam, by_label, counts, ops = Counter(), Counter(), Counter(), Counter()
    for d, owner in rows:
        f = _family(d.name, owner)
        ms = _ms(d)
        fam[f] += ms
        if f == "port kernels" and (owner or "").startswith(PROFILE_RANGE):
            label = owner[len(PROFILE_RANGE):]
        elif f == "aten" and owner:
            label = owner
        elif f == "copies and fills":
            label = d.name
        else:
            label = kernel_symbol(d.name)
        by_label[(f, label)] += ms
        counts[(f, label)] += 1
        if f in ("aten", "cuBLAS", "cuDNN") and (owner or "").startswith("aten::"):
            ops[owner] += ms
    total = sum(fam.values())
    return {
        "events": len(rows),
        "total_ms": total,
        "busy_ms": busy_ms([d for d, _ in rows]),
        "families": {f: fam.get(f, 0.0) for f in FAMILIES},
        "shares": {f: (fam.get(f, 0.0) / total if total else 0.0) for f in FAMILIES},
        "kernels": [(f, label, ms, counts[(f, label)])
                    for (f, label), ms in by_label.most_common(top)],
        "aten_ops": dict(ops.most_common()),
        "matched": matched,
    }


def format_breakdown(b: dict, per: int = 1) -> List[str]:
    """`device_breakdown`'s result as lines, every ms divided by `per` (the
    traced calls)."""
    if not b["events"]:
        return ["device breakdown: the trace holds no device events (nothing ran on a "
                "card); no device time to split"]
    lines = [f"device time {b['total_ms'] / per:.3f} ms a call in {b['events']} device events "
             f"(busy {b['busy_ms'] / per:.3f} ms); by family:"]
    for f in FAMILIES:
        lines.append(f"  {f:18s} {b['families'][f] / per:9.3f} ms ({100 * b['shares'][f]:.1f}%)")
    lines.append("by kernel (the port's by its ops/_cuda.KERNELS name, aten's by launching op):")
    for f, label, ms, n in b["kernels"]:
        lines.append(f"  {f:18s} {label[:60]:60s} {ms / per:9.3f} ms x {n / per:g}")
    if b["aten_ops"]:
        lines.append("library kernels (cuBLAS, cuDNN, aten) by the aten op that launched them:")
        for op, ms in list(b["aten_ops"].items())[:10]:
            lines.append(f"  {op:40s} {ms / per:9.3f} ms")
    return lines


def trace_call(fn: Callable, label: str, wall_ms: float, out_dir: str,
               log: Callable[[str], None] = print, kernels: bool = False) -> None:
    """One call of `fn` under torch.profiler (CPU and CUDA): the card's busy
    time (the union of its kernels' and copies' intervals), and against
    `wall_ms`, the call's wall without the profiler, its idle share; the
    device events' count; the runtime calls and ops that can wait for the
    card (`SYNC_EVENTS`); the host ops by self CPU time, the top ones logged
    and 25 written to `out_dir`/trace<label>.txt; with `kernels`, also the
    device time of the kernels that take the most. Lines go to `log`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000
    dev = device_events(prof)
    busy = busy_ms(dev)
    avg = prof.key_averages()
    name = "trace" + re.sub(r"\W+", "_", label) + ".txt"
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(avg.table(sort_by="self_cpu_time_total", row_limit=25))
    top = sorted((e for e in avg if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    tops = "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ms x {e.count}" for e in top)
    syncs = "; ".join(f"{e.key} x {e.count}" for e in avg
                      if any(s in e.key for s in SYNC_EVENTS)) or "none"
    dev_s = (f"device busy {busy:.2f} ms in {len(dev)} device events, idle share "
             f"{1 - busy / wall_ms:.3f} of the call's {wall_ms:.2f}-ms wall" if dev
             else "device busy not measured (the trace holds no device events)")
    log(f"[trace]{label}: {dev_s}; wall {wall:.2f} ms under the profiler; host ops' self "
        f"CPU {sum(e.self_cpu_time_total for e in avg) / 1e3:.2f} ms, the most: {tops}; "
        f"calls that can wait for the card: {syncs} ({out_dir}/{name})")
    if kernels:
        def dt(e):
            return getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)

        ks = sorted((e for e in avg if e.device_type == DeviceType.CUDA and dt(e) > 0
                     and not e.key.startswith(PROFILE_RANGE)),
                    key=lambda e: -dt(e))[:8]
        short = [re.sub(r"^void |<.*$|\(.*$", "", e.key.replace("(anonymous namespace)::", ""))
                 for e in ks]
        log(f"[trace]{label}: kernels by device time: " + "; ".join(
            f"{n} {dt(e) / 1e3:.2f} ms x {e.count}" for n, e in zip(short, ks)))
