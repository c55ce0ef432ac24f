"""The host side of the persistent LSTM recurrence kernels, on the CPU:
``plan_recurrence`` (route and tiling from shapes and device attributes
alone), the shared-memory budget it computes, and the ctypes signatures
of the C entry points against the CUDA sources.

Imports no JAX and nothing of the JAX package."""

import glob
import os
import re

import pytest
import torch

from ctc_asr_tpu_torch.ops import build, lstm_cuda
from ctc_asr_tpu_torch.ops.lstm_cuda import (BLOCKS_PER_SM, SM_COUNT,
                                             SMEM_PER_BLOCK, LstmSeq,
                                             plan_recurrence,
                                             recurrence_smem_bytes)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("gate_mult", [4, 3])
@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("B", [1, 16, 37, 128])
@pytest.mark.parametrize("H", [512, 800])
def test_plan_covers_the_main_shapes(H, B, nd, gate_mult, backward):
    """Every shape a main path runs gets a persistent plan whose blocks
    are all resident at once, fit the card's shared memory, and cover
    every unit and every row exactly once."""
    plan = plan_recurrence(nd, B, H, gate_mult, backward=backward)
    assert plan.route == "persistent"
    unit_tiles, row_blocks, dirs = plan.grid
    assert dirs == nd
    assert plan.blocks == unit_tiles * row_blocks * nd
    assert plan.blocks <= SM_COUNT * BLOCKS_PER_SM == 132
    assert plan.smem_bytes <= SMEM_PER_BLOCK == 232448
    assert plan.smem_bytes == recurrence_smem_bytes(
        H, plan.jt, plan.bt, gate_mult, backward)
    assert plan.jt in (16, 32) and plan.bt % 32 == 0
    # the tiles [i*jt, (i+1)*jt) and [i*bt, (i+1)*bt) partition H and B
    assert (unit_tiles - 1) * plan.jt < H <= unit_tiles * plan.jt
    assert (row_blocks - 1) * plan.bt < B <= row_blocks * plan.bt
    units = [j for i in range(unit_tiles)
             for j in range(i * plan.jt, min((i + 1) * plan.jt, H))]
    rows = [b for i in range(row_blocks)
            for b in range(i * plan.bt, min((i + 1) * plan.bt, B))]
    assert units == list(range(H)) and rows == list(range(B))


@pytest.mark.parametrize("nd,B,H", [(2, 128, 1408), (2, 1, 1408),
                                    (1, 128, 2048), (2, 128, 1024)])
def test_plan_too_wide_for_residency_is_per_step(nd, B, H):
    """Slices that exceed the card's shared memory, or more blocks than
    SMs, give the per-step route with its fixed 32 x 32 tiling."""
    for backward in (False, True):
        plan = plan_recurrence(nd, B, H, backward=backward)
        assert plan.route == "per_step"
        assert (plan.jt, plan.bt, plan.smem_bytes) == (32, 32, 0)
        assert plan.grid == (-(-H // 32), -(-B // 32), nd)


def test_plan_follows_the_device_attributes():
    """The same shape on a smaller card: fewer SMs make a block take
    more rows, less shared memory takes the persistent route away."""
    full = plan_recurrence(2, 128, 512)
    assert (full.jt, full.bt, full.grid) == (32, 32, (16, 4, 2))
    half = plan_recurrence(2, 128, 512, sm_count=64)
    assert half.route == "persistent" and half.blocks <= 64
    assert half.bt > full.bt
    assert plan_recurrence(2, 128, 512, sm_count=8).route == "per_step"
    assert plan_recurrence(2, 128, 512,
                           smem_per_block=100 * 1024).route == "per_step"
    # the serving shapes take the narrower unit tile: more blocks, each
    # with less of the step's product
    assert plan_recurrence(2, 16, 512).jt == 16
    assert plan_recurrence(2, 128, 800).bt == 128


def test_plan_rejects_shapes_the_kernels_do_not_take():
    for nd, B, H in ((2, 4, 24), (0, 4, 32), (2, 0, 32), (2, 4, 0)):
        with pytest.raises(ValueError, match="H % 16"):
            plan_recurrence(nd, B, H)


def test_shared_memory_budget_grows_with_the_tile():
    for backward in (False, True):
        small = recurrence_smem_bytes(512, 16, 32, backward=backward)
        assert small < recurrence_smem_bytes(512, 32, 32, backward=backward)
        assert small < recurrence_smem_bytes(512, 16, 64, backward=backward)
        assert small < recurrence_smem_bytes(800, 16, 32, backward=backward)
        assert small % 128 == 0


def _c_entry_points():
    """name -> number of arguments of every ``extern "C" int`` function
    in the CUDA sources."""
    found = {}
    pattern = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
    for path in glob.glob(os.path.join(build.CSRC_DIR, "*.cu")):
        with open(path) as f:
            for name, args in pattern.findall(f.read()):
                assert name not in found, f"{name} defined twice"
                found[name] = len([a for a in args.split(",") if a.strip()])
    return found


def test_every_c_entry_point_has_its_ctypes_signature():
    """A missing or short ``argtypes`` list would pass pointers as 32-bit
    ints; the sources and ``build._SIGNATURES`` must agree."""
    entry_points = _c_entry_points()
    assert set(entry_points) == set(build._SIGNATURES)
    for name, n_args in entry_points.items():
        assert len(build._SIGNATURES[name]) == n_args, name
    assert {"lstm_fwd_persistent", "lstm_bwd_persistent", "lstm_fwd_seq",
            "lstm_bwd_seq", "recurrence_barrier_probe"} <= set(entry_points)


def test_shared_header_is_part_of_the_build_hash():
    names = [os.path.basename(p) for p in build.sources()]
    assert "recurrence.cuh" in names and "lstm_fwd.cu" in names


@pytest.mark.parametrize("route", [None, "persistent", "per_step"])
def test_cpu_tensors_take_the_plain_version_on_any_route(route):
    """The route is a matter of the card: a CPU tensor gets the plain
    version whatever is asked for, and counts no launch."""
    g = torch.Generator().manual_seed(0)
    nd, T, B, H = 2, 5, 3, 16
    xproj = torch.randn(nd, T, B, 4 * H, generator=g).to(torch.bfloat16)
    b = 0.1 * torch.randn(nd, 4 * H, generator=g)
    wh = (0.2 * torch.rand(nd, H, 4 * H, generator=g) - 0.1).to(torch.bfloat16)
    lens = torch.tensor([5, 2, 0], dtype=torch.int32)
    start = torch.stack([torch.zeros_like(lens), T - lens])
    end = torch.stack([lens, torch.full_like(lens, T)])
    counts = (lstm_cuda.lstm_fwd.launches,
              lstm_cuda.lstm_fwd.per_step_launches,
              lstm_cuda.lstm_bwd.launches,
              lstm_cuda.lstm_bwd.per_step_launches)
    want = lstm_cuda.lstm_seq_plain(xproj, b, wh, start, end)
    got = lstm_cuda.lstm_seq(xproj, b, wh, start, end, route=route)
    assert torch.equal(got, want.to(torch.bfloat16))
    x = xproj.clone().requires_grad_(True)
    w = wh.clone().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    args = (x, bb, w, start, end) + (() if route is None else (route,))
    LstmSeq.apply(*args).float().sum().backward()
    x0 = xproj.clone().requires_grad_(True)
    w0 = wh.clone().requires_grad_(True)
    b0 = b.clone().requires_grad_(True)
    LstmSeq.apply(x0, b0, w0, start, end).float().sum().backward()
    assert torch.equal(x.grad, x0.grad) and torch.equal(w.grad, w0.grad)
    assert torch.equal(bb.grad, b0.grad)
    assert counts == (lstm_cuda.lstm_fwd.launches,
                      lstm_cuda.lstm_fwd.per_step_launches,
                      lstm_cuda.lstm_bwd.launches,
                      lstm_cuda.lstm_bwd.per_step_launches)
