"""Each cell end to end at the tiny CPU cut: the result line has the
contract's keys and the checks last, every end-to-end metric of the cell
and nothing else; a traced run reads the per-layer metrics that exist
on the CPU (none of the device's)."""

import json
import os

import pytest

from benchhelp import CELLS, CONTRACT_KEYS, ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_tiny(tiny, cell):
    line = tiny("--workload", cell, "--seed", str(2**31 + 11),
                "--seconds", "0.5", "--trace", "0")
    assert list(line) == CONTRACT_KEYS + ["checks"]
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in _bench()["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["ds2_train_b64", "ds3_decode_fusion_b128"])
def test_traced_run_tiny(tiny, cell):
    line = tiny("--workload", cell, "--seed", "5", "--seconds", "0.3",
                "--trace", "1")
    assert list(line) == CONTRACT_KEYS + ["breakdown", "checks"]
    assert line["correct"] is True
    host_read = {"ds2_train_b64": {"train_mfu"},
                 "ds3_decode_fusion_b128": {"decode_mfu", "rescore_host_ms"}}
    assert set(line["metrics"]) == host_read[cell]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_same_seed_same_inputs():
    """Batch j is a function of (mix, seed, j); shapes and each pass's
    audio seconds do not depend on the seed."""
    import numpy as np
    from asrbench import traffic
    mix = traffic.load_mix("libri_train_b64")
    plan = traffic.plan(mix)
    a, b = traffic.Stream(plan, 2**31 + 3), traffic.Stream(plan, 2**31 + 3)
    c = traffic.Stream(plan, 7)
    for j in (0, 5, 17):
        x, y, z = a.batch(j), b.batch(j), c.batch(j)
        assert np.array_equal(x.samples, y.samples)
        assert np.array_equal(x.labels, y.labels)
        assert x.samples.shape == z.samples.shape
        assert x.labels.shape == z.labels.shape
        assert not np.array_equal(x.samples, z.samples)
    n = plan.cycle * mix["pool_batches_per_bucket"]
    assert sum(a.batch(j).audio_seconds for j in range(n)) == \
        pytest.approx(sum(c.batch(j).audio_seconds for j in range(n)))
    means = [np.mean(bk.durations) for bk in plan.buckets]
    assert means == sorted(means) and plan.order[:2] == [0, len(means) - 1]
