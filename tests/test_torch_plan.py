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
from ctc_asr_tpu_torch.ops.lstm_cuda import (BLOCKS_PER_SM, CLUSTERS,
                                             SM_COUNT, SMEM_PER_BLOCK,
                                             LstmSeq, RecurrencePlan,
                                             lstm_bwd_chunks,
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


def _lstm_bwd_layout(H, jt, bt, cluster):
    """``Layout<JT, CL>(H, BT).total`` of ``csrc/lstm_bwd.cu``, field by
    field: unclustered with 32 units the two halves of K stacked as rows
    (passes of 32 rows); otherwise passes of 64 rows, of which a block of
    a cluster of two keeps the state of 32."""
    stacked = jt == 32 and cluster == 1
    pr = 32 if stacked else 64
    cr = pr // cluster
    kc, stages = (256, 2) if stacked else (128, 3)
    passes = -(-bt // pr)
    sr = bt if cluster == 1 else passes * cr
    xbufs = 0 if cluster == 1 else min(passes, 2)
    wr = (64 * ((2 * H + 63) // 64 * 64) if stacked
          else jt * ((4 * H // cluster + 63) // 64 * 64)) * 2
    return _layout_total([
        (wr, 1024), (stages * kc * 64 * 2, 1024),    # wh slice, ring
        (2 * pr * (jt + 4) * 4, 128),                # Cs, two partials
        (xbufs * cr * (jt + 4) * 4, 128),            # the partner's
        (sr * jt * 4, 128), (sr * jt * 4, 128),      # dh, dc
        (sr * 4 * jt * 2, 128),                      # gates tile
        (sr * jt * 2, 128), (sr * jt * 2, 128),      # c_t, c_{t-1}
        (sr * jt * 2, 128),                          # g_out
        (2 * sr * 4, 128), (2 * stages * 8, 128)])


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
    assert plan.blocks == unit_tiles * row_blocks * nd * plan.cluster
    assert plan.blocks <= SM_COUNT * BLOCKS_PER_SM == 132
    assert plan.blocks <= 2 * CLUSTERS
    assert plan.smem_bytes <= SMEM_PER_BLOCK == 232448
    assert plan.smem_bytes == recurrence_smem_bytes(
        H, plan.jt, plan.bt, gate_mult, backward, plan.cluster)
    if gate_mult == 3:
        assert plan.smem_bytes == _gru_layout(H, plan.jt, plan.bt, backward)
    if gate_mult == 4 and backward:
        assert plan.smem_bytes == _lstm_bwd_layout(H, plan.jt, plan.bt,
                                                   plan.cluster)
    assert plan.cluster == 1 or (gate_mult == 4 and backward)
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


# The plans before K3 ran in clusters, (jt, bt, grid, smem_bytes): the
# forward kernels' and the GRU's, and K3's where no cluster is allowed.
_UNCLUSTERED = {
    (4, False, 2, 64, 800): (16, 64, (50, 1, 2), 204672),
    (4, False, 2, 64, 512): (16, 32, (32, 2, 2), 156288),
    (4, False, 2, 128, 512): (32, 32, (16, 4, 2), 212352),
    (4, False, 1, 32, 256): (16, 32, (16, 1, 1), 123520),
    (3, False, 2, 64, 800): (16, 64, (50, 1, 2), 200576),
    (3, False, 2, 128, 400): (32, 32, (13, 4, 2), 191744),
    (3, True, 2, 64, 800): (16, 64, (50, 1, 2), 154240),
    (3, True, 2, 64, 512): (16, 32, (32, 2, 2), 117120),
    (3, True, 2, 128, 512): (32, 32, (16, 4, 2), 189824),
    (3, True, 1, 32, 256): (16, 32, (16, 1, 1), 92544),
    (4, True, 2, 64, 800): (16, 64, (50, 1, 2), 184960),
    (4, True, 2, 64, 512): (16, 32, (32, 2, 2), 136576),
    (4, True, 2, 128, 800): (16, 128, (50, 1, 2), 208000),
    (4, True, 2, 32, 800): (16, 32, (50, 1, 2), 173440),
}


@pytest.mark.parametrize("key", sorted(_UNCLUSTERED))
def test_forward_and_gru_plans_never_cluster(key):
    """Only the LSTM's backward runs in clusters: every forward plan and
    the GRU's keep their tiling whatever clusters the card holds, and K3
    with no cluster allowed keeps the tiling it had before."""
    gm, backward, nd, B, H = key
    clustered_k3 = gm == 4 and backward
    for clusters in ((0,) if clustered_k3 else (0, CLUSTERS)):
        plan = plan_recurrence(nd, B, H, gm, backward=backward,
                               max_clusters=clusters)
        assert plan.cluster == 1
        assert (plan.jt, plan.bt, plan.grid, plan.smem_bytes) \
            == _UNCLUSTERED[key]


@pytest.mark.parametrize("nd,B,H,want,chunks", [
    (2, 64, 800, (32, 64, (25, 1, 2)), (13, 25)),
    (2, 64, 512, (16, 64, (32, 1, 2)), (8, 16)),
    (2, 32, 800, (32, 32, (25, 1, 2)), (13, 25)),
    (2, 128, 800, (32, 128, (25, 1, 2)), (26, 50)),
])
def test_k3_plans_clusters_of_two_at_the_train_shapes(nd, B, H, want, chunks):
    """The backward LSTM at the train cells' shapes (B=64, H=800 and 512)
    and the ladder's and the B=128 batch at H=800 runs in clusters of two
    blocks that split K: every block resident, its clusters too, within
    the shared memory, and fewer chunks of dgates a step than the tiling
    without clusters."""
    plan = plan_recurrence(nd, B, H, backward=True)
    assert plan.cluster == 2
    assert (plan.jt, plan.bt, plan.grid) == want
    assert plan.blocks <= SM_COUNT == 132
    assert plan.blocks // 2 <= CLUSTERS
    assert plan.smem_bytes <= SMEM_PER_BLOCK == 232448
    assert plan.smem_bytes == _lstm_bwd_layout(H, plan.jt, plan.bt, 2)
    today = plan_recurrence(nd, B, H, backward=True, max_clusters=0)
    assert today.cluster == 1
    assert (lstm_bwd_chunks(plan, H, B), lstm_bwd_chunks(today, H, B)) \
        == chunks


@pytest.mark.parametrize("nd,B,H,chunks", [
    (2, 128, 512, (4, 8)), (2, 256, 256, (2, 4)), (2, 192, 256, (2, 4)),
    (1, 256, 512, (4, 8)),
])
def test_k3_keeps_the_stacked_tiling_where_it_streams_fewer_chunks(
        nd, B, H, chunks):
    """At B >= 128 with H <= 512 the unclustered tiling of 32 units (the
    two halves of K stacked, passes of 32 rows) streams fewer chunks a
    step than any clustered one that fits, so K3 keeps it."""
    plan = plan_recurrence(nd, B, H, backward=True)
    assert (plan.jt, plan.bt, plan.cluster) == (32, 32, 1)
    pair = RecurrencePlan(32, 64, (-(-H // 32), -(-B // 64), nd),
                          recurrence_smem_bytes(H, 32, 64, 4, True, 2), 2)
    assert pair.blocks <= SM_COUNT and pair.smem_bytes <= SMEM_PER_BLOCK
    assert (lstm_bwd_chunks(plan, H, B), lstm_bwd_chunks(pair, H, B)) \
        == chunks


@pytest.mark.parametrize("H,jt,bt,cluster", [
    (800, 32, 64, 2), (800, 32, 128, 2), (800, 32, 192, 2), (512, 16, 64, 2),
    (400, 16, 32, 2), (272, 32, 64, 2), (48, 16, 32, 2), (800, 16, 64, 1),
    (512, 32, 32, 1), (400, 32, 32, 1), (512, 16, 32, 1)])
def test_k3_budget_is_its_layout(H, jt, bt, cluster):
    """``recurrence_smem_bytes`` of the LSTM's backward against a
    field-by-field mirror of ``Layout<JT, CL>`` in ``csrc/lstm_bwd.cu``."""
    assert recurrence_smem_bytes(H, jt, bt, 4, True, cluster) \
        == _lstm_bwd_layout(H, jt, bt, cluster)


@pytest.mark.parametrize("nd,B,H,clusters,want", [
    (2, 64, 800, 50, (32, 64, (25, 1, 2), 2)),
    (2, 64, 800, 49, (16, 64, (50, 1, 2), 1)),
    (2, 64, 512, 64, (16, 64, (32, 1, 2), 2)),
    (2, 64, 512, 63, (32, 64, (16, 1, 2), 2)),
    (2, 64, 512, 31, (16, 32, (32, 2, 2), 1)),
])
def test_k3_clusters_beyond_the_card_fall_back(nd, B, H, clusters, want):
    """A clustered grid whose clusters the card cannot hold at once is
    not planned: the next clustered tiling that fits, or the tiling
    without clusters."""
    plan = plan_recurrence(nd, B, H, backward=True, max_clusters=clusters)
    assert (plan.jt, plan.bt, plan.grid, plan.cluster) == want
    assert plan.blocks <= 2 * clusters or plan.cluster == 1


def test_k3_with_no_plan_but_clusters_the_card_cannot_hold():
    """Where only a clustered tiling fits the shared memory, a card that
    holds too few clusters leaves no plan (the wrappers then refuse the
    shape before any launch)."""
    small = 110_000
    plan = plan_recurrence(2, 64, 512, backward=True, smem_per_block=small)
    assert (plan.jt, plan.cluster) == (16, 2) and plan.smem_bytes <= small
    for clusters in (63, 0):
        assert plan_recurrence(2, 64, 512, backward=True,
                               smem_per_block=small,
                               max_clusters=clusters) is None
    with pytest.raises(ValueError, match="clusters of 2"):
        recurrence_smem_bytes(512, 16, 64, 3, True, cluster=2)
    with pytest.raises(ValueError, match="clusters of 2"):
        recurrence_smem_bytes(512, 16, 64, 4, False, cluster=2)


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
