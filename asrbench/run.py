"""Run one cell of the benchmark of ``ctc_asr_tpu_torch`` on one card:

    python3 asrbench/run.py --workload <cell> --seed N --seconds S --trace 0|1

from the root of a checkout. With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics of ``BENCHMARK.json``; with ``--trace 1``
its per-layer metrics, each read by ``metrics/<name>.py`` from a traced
stretch after the window. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number that decided ``correct`` beside its limit, also the last lines
of standard error).

``--tiny`` runs the same drivers on the CPU at a tiny size on the
port's plain paths, for the benchmark's own tests; it never measures.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reader(path: str):
    name = "asrbench_metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from asrbench import common, judge
    from asrbench import trace as trace_mod
    common.cache_env()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="the CPU test mode: a tiny cut on the plain paths")
    args = ap.parse_args(argv)
    ctx = common.load_ctx(args.workload, args.seed, args.seconds,
                          bool(args.trace), args.tiny, T_START)
    if args.tiny:
        import torch
        torch.set_num_threads(1)
        device = {"platform": "cpu", "kind": "cpu", "count": 1}
    else:
        device = common.device_identity(ctx.workload["chips"])
    driver = importlib.import_module(
        f"asrbench.drivers.{ctx.cell_file['driver']}")
    out = driver.run(ctx)

    metrics = {}
    if not ctx.trace:
        for m in ctx.metrics:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    else:
        run = SimpleNamespace(kind=ctx.cell_file["driver"], out=out,
                              cfg=out["cfg"], family=ctx.family,
                              sample_rate=ctx.mix["sample_rate"],
                              log=common.log)
        for m in ctx.metrics:
            value = _reader(os.path.join(ROOT, "asrbench", "metrics",
                                         m["name"] + ".py")).read(run)
            if value is None:
                common.log(f"[asrbench] {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ok, checks = judge.checks(out["readings"], ctx.cell_file["limits"])
    dev = {k: device[k] for k in ("platform", "kind", "count")}
    dev["memory_peak_bytes"] = int(out["memory_peak"])
    result = {"correct": bool(ok and out["failed"] == 0),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    tr = out.get("trace")
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = trace_mod.breakdown(tr)
    if device.get("smi"):
        common.log(f"[asrbench] power limit {device['smi'].get('power_limit')}"
                   f", SM clock {device['smi'].get('clock_sm')} of "
                   f"{device['smi'].get('clock_sm_max')}")
    bad = common.forbidden_modules()
    if bad:
        common.log(f"[asrbench] refused: the process loaded {bad}")
        return 3
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
