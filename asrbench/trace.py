"""A traced stretch of a run, read from ``torch.profiler`` on the device's
clock: kernels and copies by name, the device's busy time (the union of
their intervals), the kernels a host range launched (directly or
through the backward of the autograd nodes it created), and the idle
gaps by what the host was doing meanwhile."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

TRACE_TRIES = 3      # a trace now and then holds none of its kernels


@dataclass
class TraceData:
    kernels: list            # (name, start_us, end_us, correlation id)
    memops: list             # (name, start_us, end_us)
    cpu: list                # (name, start_us, end_us, thread, seq_nr, id)
    window: tuple            # (start_us, end_us) on the device clock
    steps: int = 0           # steps or batches inside the traced range
    records: list = field(default_factory=list)   # their shapes

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        ivs = sorted((s, e) for _, s, e, *_ in self.kernels + self.memops)
        merged = []
        for s, e in ivs:
            s, e = max(s, self.window[0]), min(e, self.window[1])
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_ms(self, names) -> float:
        """Device ms of the kernels whose name holds one of ``names``."""
        return sum(e - s for n, s, e, _ in self.kernels
                   if any(k in n for k in names)) / 1e3


def capture(fn, tag: str, cuda: bool) -> TraceData:
    """Run ``fn`` once under the profiler inside a range named ``tag``
    and read the trace; traced again (``fn`` runs again) when the trace
    holds no kernel of the range."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(TRACE_TRIES):
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            with record_function(tag):
                fn()
            if cuda:
                torch.cuda.synchronize()
        data = _extract(prof.events(), tag, DeviceType)
        if data.kernels or not cuda:
            return data
    raise RuntimeError(f"torch.profiler recorded no device kernel of "
                       f"{tag!r} in {TRACE_TRIES} traces")


def _extract(evs, tag: str, DeviceType) -> TraceData:
    kernels, memops, cpu, marks = [], [], [], []
    for e in evs:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name == tag:
                marks.append((s, t))
            elif getattr(e, "is_user_annotation", False):
                continue
            elif e.name.startswith(("Memcpy", "Memset")):
                memops.append((e.name, s, t))
            else:
                kernels.append((e.name, s, t, e.id))
        else:
            cpu.append((e.name, s, t, e.thread, e.sequence_nr, e.id))
    if marks:
        window = (min(m[0] for m in marks), max(m[1] for m in marks))
    elif kernels:
        # no device-side mark: the range's own device events bound it
        window = (min(k[1] for k in kernels + memops),
                  max(k[2] for k in kernels + memops))
    else:
        host = [c for c in cpu if c[0] == tag]
        window = (host[0][1], host[0][2]) if host else (0.0, 0.0)
    inside = [k for k in kernels if window[0] <= k[1] < window[1]]
    mem_in = [m for m in memops if window[0] <= m[1] < window[1]]
    return TraceData(inside, mem_in, cpu, window)


def _union_by_thread(spans) -> dict:
    by: dict = {}
    for th, s, e in spans:
        by.setdefault(th, []).append((s, e))
    out = {}
    for th, ivs in by.items():
        ivs.sort()
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        out[th] = ([m[0] for m in merged], [m[1] for m in merged])
    return out


def _inside(index: dict, thread, t: float) -> bool:
    if thread not in index:
        return False
    starts, ends = index[thread]
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def kernels_in_range(trace: TraceData, name: str) -> list:
    """The kernels launched inside host range ``name`` or inside the
    backward of an autograd node that range created (matched by the
    node's sequence number). A kernel is tied to its launch, the runtime
    call that shares its correlation id, and the launch to the ranges
    that hold it on the launching thread's clock."""
    fronts = [(c[3], c[1], c[2]) for c in trace.cpu if c[0] == name]
    if not fronts:
        return []
    idx = _union_by_thread(fronts)
    fwd_seq = {c[4] for c in trace.cpu
               if c[4] is not None and c[4] >= 0 and _inside(idx, c[3], c[1])}
    spans = fronts + [(c[3], c[1], c[2]) for c in trace.cpu
                      if "Backward" in c[0] and c[4] in fwd_seq]
    idx = _union_by_thread(spans)
    launches = {c[5]: c for c in trace.cpu if c[0].startswith("cu")}
    out = []
    for k in trace.kernels:
        c = launches.get(k[3])
        if c is not None and _inside(idx, c[3], c[1]):
            out.append(k)
    return out


def breakdown(trace: TraceData, top: int = 10, gaps_read: int = 200) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps summed by the host activity that overlapped each: the
    innermost host event covering at least half the gap, else the one
    covering most of it."""
    by_op: dict = {}
    for n, s, e, *_ in trace.kernels + trace.memops:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    busy = trace.busy_intervals()
    edges = [trace.window[0]] + [x for iv in busy for x in iv] \
        + [trace.window[1]]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:gaps_read]
    long_us = 50e3
    host = sorted((c[1], c[2], c[0]) for c in trace.cpu
                  if c[0] and c[2] - c[1] <= long_us)
    longs = [(c[1], c[2], c[0]) for c in trace.cpu
             if c[0] and c[2] - c[1] > long_us]
    starts = [h[0] for h in host]
    by_host: dict = {}
    for length, a, b in gaps:
        best, best_key = None, None
        lo = bisect.bisect_left(starts, a - long_us)
        for s, e, n in host[lo:bisect.bisect_left(starts, b)] + longs:
            cover = min(e, b) - max(s, a)
            if cover <= 0:
                continue
            key = (cover >= length / 2, -(e - s) if cover >= length / 2
                   else cover)
            if best_key is None or key > best_key:
                best, best_key = n, key
        name = best or "(no host event)"
        by_host[name] = by_host.get(name, 0.0) + length / 1e6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n[:160], v] for n, v in idle]}
