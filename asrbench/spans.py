"""The port's own profiler ranges, read from a traced stretch
(``trace.TraceData``) for the per-layer metrics of ``metrics/``: the
device time of the kernels a range launched, forward and through the
backward of the autograd nodes it created (``trace.kernels_in_range``),
and the host time spent inside a range, each a step or batch of the
trace. A reading is taken only from a trace of the card (one that holds
kernels): a CPU run's times describe no cell."""

from __future__ import annotations

from .trace import kernels_in_range


def _trace(run, metric: str, name: str):
    tr = run.out.get("trace")
    if tr is None or not tr.kernels or not tr.steps:
        return None
    if not any(c[0] == name for c in tr.cpu):
        run.log(f"{metric}: the trace holds no {name!r} range")
        return None
    return tr


def device_ms(run, metric: str, name: str, minus=()) -> float | None:
    """Device ms a step of the kernels of range ``name``, less those of
    the ranges in ``minus``; None (logged) where the trace holds no such
    range."""
    tr = _trace(run, metric, name)
    if tr is None:
        return None
    ks = set(kernels_in_range(tr, name))
    for other in minus:
        ks -= set(kernels_in_range(tr, other))
    return sum(e - s for _, s, e, _ in ks) / 1e3 / tr.steps


def host_ms(run, metric: str, name: str) -> float | None:
    """Host ms a step inside range ``name`` (the sum of its entries'
    durations); None (logged) where the trace holds no such range."""
    tr = _trace(run, metric, name)
    if tr is None:
        return None
    return sum(c[2] - c[1] for c in tr.cpu if c[0] == name) / 1e3 / tr.steps
