"""The host side of the recurrence kernels (LSTM K2 / K3, GRU K4 / K5),
on the CPU: ``plan_recurrence`` (the tiling from shapes and device
attributes alone, or none), the shared-memory budget it computes against
a field-by-field mirror of each kernel's ``Layout``, and the ctypes
signatures of the C entry points against the CUDA sources.

Imports no JAX and nothing of the JAX package."""

import glob
import os
import re

import pytest
import torch

from ctc_asr_tpu_torch.ops import build, gru_cuda, lstm_cuda
from ctc_asr_tpu_torch.ops.lstm_cuda import (BLOCKS_PER_SM, SM_COUNT,
                                             SMEM_PER_BLOCK, LstmSeq,
                                             plan_recurrence,
                                             recurrence_smem_bytes)


def _layout_total(fields):
    """The running offsets of a C ``Layout``: each field (bytes, 128 or
    1024) starts where the one before ends and rounds up to its
    alignment."""
    o = 0
    for size, align in fields:
        o += -(-size // align) * align
    return o


def _gru_layout(H, jt, bt, backward):
    """``Layout<JT>(H, BT).total`` of ``csrc/gru_fwd.cu`` /
    ``csrc/gru_bwd.cu``, field by field (bf16 2 bytes, f32 and int 4,
    mbarrier 8)."""
    pr = 32 if jt == 32 else 64
    if backward:
        kc, stages = (256, 2) if jt == 32 else (128, 3)
        span = (3 * H + 127) // 128 * 64 if jt == 32 else 3 * H
        return _layout_total([
            ((64 if jt == 32 else jt) * ((span + 63) // 64 * 64) * 2, 1024),
            (stages * kc * 64 * 2, 1024),            # ring
            (2 * pr * (jt + 4) * 4, 128),            # Cs, two partials
            (bt * jt * 4, 128),                      # dh carry
            (bt * 4 * jt * 2, 128),                  # gates tile
            (bt * jt * 2, 128), (bt * jt * 2, 128),  # h_{t-1}, g_out
            (2 * bt * 4, 128), (2 * stages * 8, 128)])
    kc, stages = (256, 3) if jt == 32 else (128, 4)
    return _layout_total([
        ((H + 63) // 64 * 64 * 4 * jt * 2, 1024),    # wh slice, 4*jt rows
        (stages * kc * pr * 2, 1024),                # ring
        (pr * (4 * jt + 4) * 4, 128),                # Cs
        (bt * 3 * jt * 2, 128),                      # xproj tile
        (bt * jt * 4, 128),                          # f32 h
        (3 * jt * 4, 128),                           # bias
        (2 * bt * 4, 128), (2 * stages * 8, 128)])


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("gate_mult", [4, 3])
@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("B", [1, 16, 37, 128])
@pytest.mark.parametrize("H", [512, 800])
def test_plan_covers_the_main_shapes(H, B, nd, gate_mult, backward):
    """Every shape a main path runs gets a plan whose blocks are all
    resident at once, fit the card's shared memory, and cover every unit
    and every row exactly once; the GRU's budget is its own kernels'
    ``Layout``, not the LSTM's."""
    plan = plan_recurrence(nd, B, H, gate_mult, backward=backward)
    assert plan is not None
    unit_tiles, row_blocks, dirs = plan.grid
    assert dirs == nd
    assert plan.blocks == unit_tiles * row_blocks * nd
    assert plan.blocks <= SM_COUNT * BLOCKS_PER_SM == 132
    assert plan.smem_bytes <= SMEM_PER_BLOCK == 232448
    assert plan.smem_bytes == recurrence_smem_bytes(
        H, plan.jt, plan.bt, gate_mult, backward)
    if gate_mult == 3:
        assert plan.smem_bytes == _gru_layout(H, plan.jt, plan.bt, backward)
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
    SMs, once took a per-step route; now they have no plan, and the
    wrappers refuse them before anything is launched (the encoder gives
    such layers their plain recurrence first)."""
    dev = torch.device("cpu")     # planned as on the H100
    for backward in (False, True):
        assert plan_recurrence(nd, B, H, backward=backward) is None
        assert lstm_cuda.plan_for(dev, nd, B, H, backward=backward) is None
        with pytest.raises(ValueError, match="no recurrence kernel fits"):
            lstm_cuda.require_plan(dev, nd, B, H, backward=backward)
    assert plan_recurrence(nd, B, H, 3) is None      # the GRU's forward


def test_plan_follows_the_device_attributes():
    """The same shape on a smaller card: fewer SMs make a block take
    more rows, too few SMs or too little shared memory leave no plan."""
    full = plan_recurrence(2, 128, 512)
    assert (full.jt, full.bt, full.grid) == (32, 32, (16, 4, 2))
    half = plan_recurrence(2, 128, 512, sm_count=64)
    assert half is not None and half.blocks <= 64
    assert half.bt > full.bt
    assert plan_recurrence(2, 128, 512, sm_count=8) is None
    assert plan_recurrence(2, 128, 512, smem_per_block=100 * 1024) is None
    # the serving shapes take the narrower unit tile: more blocks, each
    # with less of the step's product
    assert plan_recurrence(2, 16, 512).jt == 16
    assert plan_recurrence(2, 128, 800).bt == 128
    # the GRU plans as the LSTM at the main paths' shapes, on its own
    # (smaller) budget
    for gm in (3, 4):
        assert plan_recurrence(2, 128, 400, gm).jt == 32
        assert plan_recurrence(2, 16, 512, gm, backward=True).jt == 16
    assert plan_recurrence(2, 128, 512, 3).smem_bytes \
        < plan_recurrence(2, 128, 512, 4).smem_bytes


def test_plan_rejects_shapes_the_kernels_do_not_take():
    for nd, B, H in ((2, 4, 24), (0, 4, 32), (2, 0, 32), (2, 4, 0)):
        with pytest.raises(ValueError, match="H % 16"):
            plan_recurrence(nd, B, H)


def test_shared_memory_budget_grows_with_the_tile():
    for backward in (False, True):
        for gm in (4, 3):
            small = recurrence_smem_bytes(512, 16, 32, gm, backward)
            assert small < recurrence_smem_bytes(512, 32, 32, gm, backward)
            assert small < recurrence_smem_bytes(512, 16, 64, gm, backward)
            assert small < recurrence_smem_bytes(800, 16, 32, gm, backward)
            assert small % 128 == 0
    with pytest.raises(ValueError, match="gate_mult"):
        recurrence_smem_bytes(512, 32, 32, 2)


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
    assert {"lstm_fwd_persistent", "lstm_bwd_persistent",
            "gru_fwd_persistent", "gru_bwd_persistent",
            "recurrence_barrier_probe"} <= set(entry_points)
    assert not any(name.endswith("_seq") for name in entry_points)


def test_shared_header_is_part_of_the_build_hash():
    names = [os.path.basename(p) for p in build.sources()]
    assert {"recurrence.cuh", "lstm_fwd.cu", "gru_fwd.cu"} <= set(names)


def _seq_case(nd, G, H, seed):
    g = torch.Generator().manual_seed(seed)
    T, B = 5, 3
    xproj = torch.randn(nd, T, B, G * H, generator=g).to(torch.bfloat16)
    b = 0.1 * torch.randn(nd, G * H, generator=g)
    wh = (0.2 * torch.rand(nd, H, G * H, generator=g) - 0.1
          ).to(torch.bfloat16)
    lens = torch.tensor([5, 2, 0], dtype=torch.int32)
    start = torch.stack([torch.zeros_like(lens), T - lens])[:nd]
    end = torch.stack([lens, torch.full_like(lens, T)])[:nd]
    return xproj, b, wh, start, end


def _check_plain_on_cpu(seq, seq_plain, Seq, fwd, bwd, case):
    """A CPU tensor gets the plain version, also through autograd, and
    counts no launch."""
    xproj, b, wh, start, end = case
    counts = (fwd.launches, bwd.launches)
    got = seq(xproj, b, wh, start, end)
    assert torch.equal(got, seq_plain(xproj, b, wh, start, end)
                       .to(torch.bfloat16))
    x = xproj.clone().requires_grad_(True)
    w = wh.clone().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    h = Seq.apply(x, bb, w, start, end)
    assert torch.equal(h, got)
    h.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and bb.grad.dtype == torch.float32
    assert torch.isfinite(w.grad.float()).all() and w.grad.abs().max() > 0
    assert counts == (fwd.launches, bwd.launches)


def test_cpu_tensors_take_the_plain_version_on_any_route():
    """The kernels are a matter of the card: on the CPU the LSTM wrappers
    compute the plain versions and count no launch."""
    _check_plain_on_cpu(lstm_cuda.lstm_seq, lstm_cuda.lstm_seq_plain, LstmSeq,
                        lstm_cuda.lstm_fwd, lstm_cuda.lstm_bwd,
                        _seq_case(2, 4, 16, 0))


@pytest.mark.parametrize("nd", [1, 2])
def test_cpu_tensors_take_the_gru_plain_version(nd):
    """The same for the GRU wrappers (K4 / K5)."""
    _check_plain_on_cpu(gru_cuda.gru_seq, gru_cuda.gru_seq_plain,
                        gru_cuda.GruSeq, gru_cuda.gru_fwd, gru_cuda.gru_bwd,
                        _seq_case(nd, 3, 16, nd))
