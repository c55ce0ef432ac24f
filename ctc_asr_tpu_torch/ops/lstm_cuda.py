"""Fused (bi)LSTM recurrence: the wrappers of the CUDA kernels
``csrc/lstm_fwd.cu`` (forward, K2) and ``csrc/lstm_bwd.cu`` (BPTT, K3),
their plain PyTorch versions, and the autograd function that joins them.

Replaces ``ctc_asr_tpu/ops/lstm_pallas.py``: ``_fwd_kernel`` and
``_bwd_kernel`` with the custom VJP of ``lstm_seq_pallas``.
Direction-major inputs ``[nd, T, B, *]``, bias added inside, per-row
``[start, end)`` windows, f32 h/c state, bf16 outputs and residuals.
The input projections ``x @ wx`` and the recurrent weight gradient
``dwh`` (one large matmul per direction, ``_dwh_from_seq``) stay
outside the kernels (``torch.matmul``), as the reference leaves them to
XLA.

On the card each kernel is one cooperative launch a layer: every block
keeps its slice of ``wh`` in shared memory for all T steps and the
blocks meet at a barrier between steps (``csrc/recurrence.cuh``).
``plan_recurrence`` cuts a layer over the card from the shapes and the
device's attributes alone, before anything is launched, for the LSTM
(``gate_mult=4``) and the GRU's K4 / K5 (``gate_mult=3``,
``ops/gru_cuda.py``); K3 runs in clusters of two blocks that split
K = 4H where that streams fewer chunks a step. A shape with no plan (a
slice too wide for the card's shared memory) has no kernel: the wrappers
raise on it, and the encoder gives such a layer its plain recurrence
before it calls them (``models/encoder.py``). A launch that the card
refuses raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build
from .dispatch import check_kernel_tensor, require_kernel_device

# One H100: SMs, and the dynamic shared memory a block may opt in to.
SM_COUNT = 132
SMEM_PER_BLOCK = 232448
# The persistent kernels run one block of 288 threads on an SM
# (``__launch_bounds__(288, 1)``), so the grid may not exceed the SMs.
BLOCKS_PER_SM = 1
# Clusters of two such blocks the H100 holds at once (its SMs in pairs).
CLUSTERS = SM_COUNT // 2
_ROW_TILE = 32          # a block's rows come in multiples of this
_UNIT_TILES = (32, 16)  # hidden units a block may own (template JT)


@dataclasses.dataclass(frozen=True)
class RecurrencePlan:
    """How one layer's recurrence is cut over the card. ``grid`` is
    (unit tiles, row blocks, directions); a block owns ``jt`` hidden
    units of one direction for ``bt`` batch rows (a multiple of 32 that
    it walks in passes of 32 or 64), with ``smem_bytes`` of dynamic
    shared memory. With ``cluster`` 2 (K3 only) each unit tile is a pair
    of blocks that split K = 4H, so the launch has twice the tiles'
    blocks along x."""
    jt: int
    bt: int
    grid: tuple
    smem_bytes: int
    cluster: int = 1

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2] * self.cluster


def _a128(n: int) -> int:
    return -(-n // 128) * 128


def _a1024(n: int) -> int:
    return -(-n // 1024) * 1024


def _ceil64(n: int) -> int:
    return -(-n // 64) * 64


def recurrence_smem_bytes(H: int, jt: int, bt: int, gate_mult: int = 4,
                          backward: bool = False, cluster: int = 1) -> int:
    """Dynamic shared memory of one block of the persistent kernels: the
    sum that ``Layout`` in ``csrc/lstm_fwd.cu`` / ``csrc/lstm_bwd.cu``
    (``gate_mult=4``) or ``csrc/gru_fwd.cu`` / ``csrc/gru_bwd.cu``
    (``gate_mult=3``) computes; the launch is refused if the two
    disagree. A block walks its rows in passes of 32 (jt = 32) or 64
    (jt = 16) rows.

    Forward: the resident ``wh`` columns [4*jt][H up to 64] bf16 (the
    GRU's 3*jt columns padded with a zero group to 4*jt), the ring of the
    h slab (3 stages of [32][256], or 4 of [64][128] bf16), the product
    tile [pass][4*jt + 4] f32, the xproj tile [bt][gm*jt] bf16, the state
    (LSTM: c f32 and h bf16; GRU: h f32) [bt][jt], the bias, the windows,
    the ring's mbarriers.

    Backward: the resident ``wh`` rows [jt][gm*H] bf16 (jt = 32: the two
    halves of K = gm*H stacked as 64 rows, each half in whole atoms of 64
    columns; the GRU's halves are 3H/2 rounded up to an atom), the ring
    of the exchanged slab (2 stages of [64][256], or 3 of [64][128]
    bf16), two partial tiles [pass][jt + 4] f32, the carried dh (and the
    LSTM's dc) f32 [bt][jt], the gates tile [bt][4*jt] bf16 and the other
    per-step inputs [bt][jt] bf16 (LSTM: c_t, c_{t-1}, g_out; GRU:
    h_{t-1}, g_out), the windows, the mbarriers.

    The LSTM's backward in clusters of two (``cluster=2``): the wh rows'
    half of K [jt][2H in whole atoms], the ring of 3 stages of
    [64][128], two partial tiles [64][jt + 4] f32, the partner's partial
    tiles [32][jt + 4] f32 (two where the block walks two or more passes
    of 64 rows), and the state and per-step inputs of the block's 32 rows
    of each pass."""
    if gate_mult not in (3, 4):
        raise ValueError(f"gate_mult is 4 (LSTM) or 3 (GRU), got {gate_mult}")
    if cluster not in (1, 2) or (cluster == 2
                                 and (gate_mult != 4 or not backward)):
        raise ValueError(f"only the LSTM's backward runs in clusters of 2, "
                         f"got cluster={cluster}")
    gm = gate_mult
    pr = 32 if jt == 32 else 64
    if cluster == 2:
        passes = -(-bt // 64)
        sr = passes * 32                      # rows of the block's state
        return (_a1024(jt * _ceil64(2 * H) * 2) + _a1024(3 * 128 * 64 * 2)
                + _a128(2 * 64 * (jt + 4) * 4)
                + _a128(min(passes, 2) * 32 * (jt + 4) * 4)
                + 2 * _a128(sr * jt * 4) + _a128(sr * 4 * jt * 2)
                + 3 * _a128(sr * jt * 2) + _a128(2 * sr * 4) + 128)
    if backward:
        ring = 2 * 256 * 64 * 2 if jt == 32 else 3 * 128 * 64 * 2
        K = gm * H
        if jt == 32:
            half = K // 2 if gm == 4 else -(-K // 128) * 64
            wr = 64 * _ceil64(half) * 2
        else:
            wr = jt * _ceil64(K) * 2
        n_state, n_inputs = (2, 3) if gm == 4 else (1, 2)
        return (_a1024(wr) + _a1024(ring)
                + _a128(2 * pr * (jt + 4) * 4) + n_state * _a128(bt * jt * 4)
                + _a128(bt * 4 * jt * 2) + n_inputs * _a128(bt * jt * 2)
                + _a128(2 * bt * 4) + 128)
    ring = 3 * 256 * 32 * 2 if jt == 32 else 4 * 128 * 64 * 2
    state = (_a128(bt * jt * 4) + _a128(bt * jt * 2)) if gm == 4 \
        else _a128(bt * jt * 4)
    return (_a1024(_ceil64(H) * 4 * jt * 2) + _a1024(ring)
            + _a128(pr * (4 * jt + 4) * 4) + _a128(bt * gm * jt * 2)
            + state + _a128(gm * jt * 4) + _a128(2 * bt * 4) + 128)


def lstm_bwd_chunks(plan: RecurrencePlan, H: int, B: int) -> int:
    """Ring chunks of dgates_{t+1} that a block of K3 waits for a step (a
    block of the first row block): passes x chunks a pass. Unclustered
    with 32 units, passes of 32 rows of the two stacked halves of K, 256
    columns of each a chunk; otherwise passes of 64 rows (padding
    included) of the block's 4H / cluster columns, 128 a chunk."""
    rows = min(plan.bt, B)
    if plan.jt == 32 and plan.cluster == 1:
        return -(-rows // 32) * -(-2 * H // 256)
    return -(-rows // 64) * -(-4 * H // plan.cluster // 128)


def plan_recurrence(nd: int, B: int, H: int, gate_mult: int = 4,
                    sm_count: int = SM_COUNT,
                    smem_per_block: int = SMEM_PER_BLOCK,
                    backward: bool = False,
                    max_clusters: int = CLUSTERS) -> RecurrencePlan | None:
    """The tiling of one layer's recurrence (forward, or the BPTT with
    ``backward``), from shapes and device attributes alone; ``None``
    where none fits. ``gate_mult`` is 4 for the LSTM and 3 for the GRU.

    Every block must be resident at once (grid <= sm_count *
    BLOCKS_PER_SM) with its shared memory within ``smem_per_block``.
    Among the tilings that fit, the one with the least product work per
    block (padded rows x units: the step's latency) wins, then the
    larger unit tile (the operand exchanged per step is read H / jt
    times).

    The LSTM's backward (K3) also weighs clusters of two blocks that
    split K (at most ``max_clusters`` of them resident at once), the
    fewest chunks first: its step waits for the chunks of dgates_{t+1} a
    block streams in series (``lstm_bwd_chunks``), so the clustered
    tiling is taken where it streams fewer chunks a step than the
    unclustered one above. Measured on the H100, that keeps the
    unclustered tiling where it is faster (B >= 192 at H = 256, two
    stacked chunks against four) and also at B >= 96 with H = 400 to 512,
    where the clustered one would be 5-8% faster."""
    if min(nd, B, H) <= 0 or H % 16:
        raise ValueError(f"need nd, B, H > 0 and H % 16 == 0, got nd={nd} "
                         f"B={B} H={H}")
    # the best tiling of each cluster size: the least work, and for K3 in
    # clusters the fewest chunks first
    best = {}
    for cluster in (1, 2) if backward and gate_mult == 4 else (1,):
        pad = 16 if cluster == 1 else 64       # rows of a product's tile
        for jt in _UNIT_TILES:
            unit_tiles = -(-H // jt)
            for bt in range(_ROW_TILE, B + _ROW_TILE, _ROW_TILE):
                plan = RecurrencePlan(jt, bt, (unit_tiles, -(-B // bt), nd),
                                      0, cluster)
                if plan.blocks > sm_count * BLOCKS_PER_SM or (
                        cluster > 1 and plan.blocks > cluster * max_clusters):
                    continue
                smem = recurrence_smem_bytes(H, jt, bt, gate_mult, backward,
                                             cluster)
                if smem <= smem_per_block:
                    plan = dataclasses.replace(plan, smem_bytes=smem)
                    key = (lstm_bwd_chunks(plan, H, B) if cluster > 1 else 0,
                           jt * pad * -(-min(bt, B) // pad))
                    if cluster not in best or key < best[cluster][0]:
                        best[cluster] = (key, plan)
                break       # a larger bt only adds work to a block
    plan = best[1][1] if 1 in best else None
    if 2 in best and (plan is None or lstm_bwd_chunks(best[2][1], H, B)
                      < lstm_bwd_chunks(plan, H, B)):
        plan = best[2][1]
    return plan


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> tuple:
    props = torch.cuda.get_device_properties(index)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", SMEM_PER_BLOCK))


def device_limits(device: torch.device) -> tuple:
    """(SM count, dynamic shared memory a block may opt in to) of a CUDA
    ``device``; for any other device those of the H100 the kernels are
    written for, so that a plan made on the CPU is the card's."""
    if device.type != "cuda":
        return SM_COUNT, SMEM_PER_BLOCK
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _device_limits(index)


@functools.lru_cache(maxsize=None)
def _cluster_capacity(index: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = build.load().lstm_bwd_cluster_capacity(ctypes.addressof(out))
    build.check(rc, "lstm_bwd_cluster_capacity")
    return out.value


def cluster_capacity(device: torch.device) -> int:
    """Clusters of two K3 blocks that a CUDA ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``); for any other device the
    H100's ``CLUSTERS``."""
    if device.type != "cuda":
        return CLUSTERS
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _cluster_capacity(index)


def plan_for(device: torch.device, nd: int, B: int, H: int,
             gate_mult: int = 4, backward: bool = False
             ) -> RecurrencePlan | None:
    """``plan_recurrence`` on ``device``'s SM count and shared memory
    (and, for K3, the clusters it holds at once)."""
    sm_count, smem = device_limits(device)
    clusters = cluster_capacity(device) if backward and gate_mult == 4 \
        else CLUSTERS
    return plan_recurrence(nd, B, H, gate_mult, sm_count, smem, backward,
                           clusters)


def require_plan(device: torch.device, nd: int, B: int, H: int,
                 gate_mult: int = 4, backward: bool = False
                 ) -> RecurrencePlan:
    """``plan_for``, raising before any launch where no tiling fits. The
    plan depends on B (row blocks times unit tiles must fit the SMs), so
    a smaller batch may have one where a larger does not."""
    plan = plan_for(device, nd, B, H, gate_mult, backward)
    if plan is None:
        sm_count, smem = device_limits(device)
        raise ValueError(
            f"no recurrence kernel fits nd={nd} B={B} H={H} "
            f"(gate_mult={gate_mult}, backward={backward}) on {sm_count} "
            f"SMs with {smem} bytes of shared memory a block: set "
            f"--model.use_pallas_rnn=false for the plain recurrence, or "
            f"use a smaller --data.batch_size")
    return plan


def _window(start, end, t, shape):
    return ((t >= start) & (t < end)).float().reshape(shape)


def lstm_fwd_plain(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor):
    """The forward recurrence in plain PyTorch: (h, c, gates), f32
    ``[nd, T, B, H]``, ``[nd, T, B, H]``, ``[nd, T, B, 4H]``.

    xproj [nd, T, B, 4H] (x @ wx, bias not added); b [nd, 4H];
    wh [nd, H, 4H]; start/end [nd, B] int. The product ``h @ wh`` takes
    h rounded to wh's dtype and accumulates in f32, as the reference
    does for its compute dtype: with bf16 xproj/wh this is the kernel's
    arithmetic, with f32 the reference's ``lax.scan`` path. h is the
    masked output, c the carried state, gates the activated [i, f, g, o]
    (``lstm_pallas.py:212-233``). Differentiable: autograd through it is
    the scan path's gradient."""
    nd, T, B, G = xproj.shape
    H = wh.shape[1]
    bf = b.float()[:, None, :]
    h = torch.zeros((nd, B, H), dtype=torch.float32, device=xproj.device)
    c = torch.zeros_like(h)
    hs, cs, gs = [], [], []
    for t in range(T):
        # wh is cast inside the loop so that autograd rounds each step's
        # dwh to wh's dtype and sums them in it, as the scan's transpose
        # does for its bf16 operand
        pre = (xproj[:, t].float() + bf) + torch.bmm(h.to(wh.dtype).float(),
                                                     wh.float())
        gi, gf, gg, go = pre.split(H, dim=-1)
        gi, gf, go = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        gg = torch.tanh(gg)
        c_new = gf * c + gi * gg
        h_new = go * torch.tanh(c_new)
        m = _window(start, end, t, (nd, B, 1))
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        hs.append(h * m)
        cs.append(c)
        gs.append(torch.cat([gi, gf, gg, go], dim=-1))
    if T == 0:
        return (h.new_zeros((nd, 0, B, H)), h.new_zeros((nd, 0, B, H)),
                h.new_zeros((nd, 0, B, G)))
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(gs, 1)


def lstm_seq_plain(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Masked hidden outputs f32 [nd, T, B, H] of ``lstm_fwd_plain``."""
    return lstm_fwd_plain(xproj, b, wh, start, end)[0]


def _check_fwd_args(xproj, b, wh, start, end):
    nd, T, B, G = xproj.shape
    H = G // 4
    if G != 4 * H or H % 16:
        raise ValueError(f"the kernels need 4*H gates with H % 16 == 0, "
                         f"got a last dim of {G}")
    check_kernel_tensor("xproj", xproj, torch.bfloat16, (nd, T, B, G))
    check_kernel_tensor("b", b, torch.float32, (nd, G))
    check_kernel_tensor("wh", wh, torch.bfloat16, (nd, H, G))
    check_kernel_tensor("start", start, torch.int32, (nd, B))
    check_kernel_tensor("end", end, torch.int32, (nd, B))
    if xproj.data_ptr() % 16 or wh.data_ptr() % 16:
        raise ValueError("xproj and wh must be 16-byte aligned")
    return nd, T, B, G, H


def lstm_fwd(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
             start: torch.Tensor, end: torch.Tensor,
             residuals: bool = False):
    """K2: masked h [nd, T, B, H] bf16, and with ``residuals`` also the
    carried c [nd, T, B, H] and activated gates [nd, T, B, 4H], bf16.

    xproj [nd, T, B, 4H] bf16; b [nd, 4H] f32; wh [nd, H, 4H] bf16;
    start/end [nd, B] int32. A CPU tensor gets the plain version
    (outputs rounded to bf16); a CUDA tensor launches the kernel on the
    plan ``plan_recurrence`` gives, and raises where there is none or
    the launch fails. Returns h, or (h, c, gates)."""
    if xproj.device.type == "cpu":
        outs = [o.to(torch.bfloat16)
                for o in lstm_fwd_plain(xproj, b, wh, start, end)]
        return tuple(outs) if residuals else outs[0]
    require_kernel_device(xproj)
    nd, T, B, G, H = _check_fwd_args(xproj, b, wh, start, end)
    dev = xproj.device
    h_out = torch.empty((nd, T, B, H), dtype=torch.bfloat16, device=dev)
    c_out = gates = None
    if residuals:
        c_out = torch.empty_like(h_out)
        gates = torch.empty((nd, T, B, G), dtype=torch.bfloat16, device=dev)
    if xproj.numel() == 0:     # no step or no row: nothing to launch
        return (h_out, c_out, gates) if residuals else h_out
    plan = require_plan(dev, nd, B, H)
    res_ptrs = (c_out.data_ptr(), gates.data_ptr()) if residuals \
        else (None, None)
    # the h exchange (never read before it is written) and the barrier
    # counters are the only scratch
    hb16 = torch.empty((2, nd, B, H), dtype=torch.bfloat16, device=dev)
    sync = torch.zeros(nd * plan.grid[1], dtype=torch.int32, device=dev)
    rc = build.load().lstm_fwd_persistent(
        xproj.data_ptr(), b.data_ptr(), wh.data_ptr(), start.data_ptr(),
        end.data_ptr(), hb16.data_ptr(), sync.data_ptr(), h_out.data_ptr(),
        *res_ptrs, nd, T, B, H, plan.jt, plan.bt, plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "lstm_fwd_persistent")
    lstm_fwd.launches += 1
    return (h_out, c_out, gates) if residuals else h_out


lstm_fwd.launches = 0            # one kernel a call


def lstm_seq(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
             start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Inference entry of K2: masked hidden outputs [nd, T, B, H] bf16.

    The kernel is cut off from autograd, so inputs that want a gradient
    are refused while grad mode is on: training goes through
    ``LstmSeq``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xproj, b, wh)):
        raise RuntimeError("lstm_seq is forward-only; use LstmSeq.apply "
                           "when gradients are wanted")
    return lstm_fwd(xproj, b, wh, start, end)


def lstm_bwd_plain(g_out: torch.Tensor, gates: torch.Tensor,
                   c_seq: torch.Tensor, wh: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor):
    """K3's plain version: BPTT of ``lstm_pallas.py:266-314`` in f32 on
    the bf16 residuals. Returns (dxproj [nd, T, B, 4H] f32 with values
    rounded to bf16, db [nd, 4H] f32)."""
    nd, T, B, G = gates.shape
    H = G // 4
    whb = wh.to(torch.bfloat16).float()
    dh = torch.zeros((nd, B, H), dtype=torch.float32, device=gates.device)
    dc = torch.zeros_like(dh)
    db = torch.zeros((nd, G), dtype=torch.float32, device=gates.device)
    dx = torch.empty((nd, T, B, G), dtype=torch.float32, device=gates.device)
    for t in range(T - 1, -1, -1):
        mf = _window(start, end, t, (nd, B, 1))
        gi, gf, gg, go = gates[:, t].float().split(H, dim=-1)
        c_t = c_seq[:, t].float()
        c_prev = c_seq[:, t - 1].float() if t > 0 else torch.zeros_like(c_t)
        tanh_c = torch.tanh(c_t)
        dh_total = dh + mf * g_out[:, t].float()
        dh_new = mf * dh_total
        d_o = dh_new * tanh_c
        dc_total = mf * dc + dh_new * go * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc_total * gg * gi * (1.0 - gi),
                            dc_total * c_prev * gf * (1.0 - gf),
                            dc_total * gi * (1.0 - gg * gg),
                            d_o * go * (1.0 - go)], dim=-1)
        dgb = dgates.to(torch.bfloat16).float()
        dx[:, t] = dgb
        db += dgates.sum(dim=1)
        dh = (1.0 - mf) * dh_total + torch.bmm(dgb, whb.transpose(1, 2))
        dc = (1.0 - mf) * dc + dc_total * gf
    return dx, db


def lstm_bwd(g_out: torch.Tensor, gates: torch.Tensor, c_seq: torch.Tensor,
             wh: torch.Tensor, start: torch.Tensor, end: torch.Tensor):
    """K3: (dxproj [nd, T, B, 4H] bf16, db [nd, 4H] f32) from the bf16
    cotangent of h and the forward's bf16 residuals. A CPU tensor gets
    the plain version; a CUDA tensor launches the kernel on the plan
    ``plan_recurrence`` gives (clustered or not), and raises where there
    is none or the launch fails."""
    if g_out.device.type == "cpu":
        dx, db = lstm_bwd_plain(g_out, gates, c_seq, wh, start, end)
        return dx.to(torch.bfloat16), db
    require_kernel_device(g_out)
    nd, T, B, G = gates.shape
    H = G // 4
    if G != 4 * H or H % 16:
        raise ValueError(f"the kernels need 4*H gates with H % 16 == 0, "
                         f"got a last dim of {G}")
    check_kernel_tensor("g_out", g_out, torch.bfloat16, (nd, T, B, H))
    check_kernel_tensor("gates", gates, torch.bfloat16, (nd, T, B, G))
    check_kernel_tensor("c_seq", c_seq, torch.bfloat16, (nd, T, B, H))
    check_kernel_tensor("wh", wh, torch.bfloat16, (nd, H, G))
    check_kernel_tensor("start", start, torch.int32, (nd, B))
    check_kernel_tensor("end", end, torch.int32, (nd, B))
    if wh.data_ptr() % 16:
        raise ValueError("wh must be 16-byte aligned")
    dev = g_out.device
    dxproj = torch.empty((nd, T, B, G), dtype=torch.bfloat16, device=dev)
    if gates.numel() == 0:     # no step or no row: nothing to launch
        return dxproj, torch.zeros((nd, G), dtype=torch.float32, device=dev)
    plan = require_plan(dev, nd, B, H, backward=True)
    # one partial per row block and rank of a cluster, each element
    # written once, summed in their order
    db_part = torch.empty((plan.grid[1] * plan.cluster, nd, G),
                          dtype=torch.float32, device=dev)
    sync = torch.zeros(nd * plan.grid[1], dtype=torch.int32, device=dev)
    rc = build.load().lstm_bwd_persistent(
        g_out.data_ptr(), gates.data_ptr(), c_seq.data_ptr(), wh.data_ptr(),
        start.data_ptr(), end.data_ptr(), dxproj.data_ptr(),
        db_part.data_ptr(), sync.data_ptr(), nd, T, B, H, plan.jt, plan.bt,
        plan.cluster, plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "lstm_bwd_persistent")
    lstm_bwd.launches += 1
    if plan.cluster > 1:
        lstm_bwd.clustered_launches += 1
    return dxproj, db_part.sum(dim=0)


lstm_bwd.launches = 0            # one kernel a call
lstm_bwd.clustered_launches = 0  # of them in clusters of two blocks


def barrier_probe(device: torch.device, plan: RecurrencePlan,
                  steps: int) -> None:
    """Launch ``steps`` step barriers and nothing else on ``plan``'s grid
    (``csrc/recurrence_probe.cu``; in its clusters, with a cluster
    barrier a step): the floor that the barriers set under a step of the
    recurrence kernels. For measurement only."""
    require_kernel_device(torch.empty(0, device=device))
    sync = torch.zeros(plan.grid[2] * plan.grid[1], dtype=torch.int32,
                       device=device)
    rc = build.load().recurrence_barrier_probe(
        sync.data_ptr(), plan.grid[0] * plan.cluster, plan.grid[1],
        plan.grid[2], steps, plan.cluster, plan.smem_bytes,
        torch.cuda.current_stream(device).cuda_stream)
    build.check(rc, "recurrence_barrier_probe")


def dwh_from_seq(h_seq: torch.Tensor, dxproj: torch.Tensor) -> torch.Tensor:
    """dwh[d] = sum_t h[t-1]^T @ dgates[t] as one matmul per direction
    (``lstm_pallas._dwh_from_seq``): h_seq is the masked output, shifted
    one step, zeros at t = 0. bf16 operands, f32 result [nd, H, 4H]."""
    nd, T, B, H = h_seq.shape
    G = dxproj.shape[-1]
    hp = torch.cat([torch.zeros_like(h_seq[:, :1]), h_seq[:, :-1]], dim=1)
    hp = hp.reshape(nd, T * B, H)
    dg = dxproj.reshape(nd, T * B, G)
    if hp.is_cuda:
        return torch.bmm(hp.transpose(1, 2), dg).float()
    return torch.bmm(hp.float().transpose(1, 2), dg.float())


class LstmSeq(torch.autograd.Function):
    """Fused (bi)LSTM with BPTT: forward = K2 with residuals, backward =
    K3 plus ``dwh_from_seq``. Gradient dtypes as the reference's
    (``lstm_pallas.py:459-460``): dxproj bf16, db f32, dwh in wh's."""

    @staticmethod
    def forward(ctx, xproj, b, wh, start, end):
        h, c, gates = lstm_fwd(xproj, b, wh, start, end, residuals=True)
        ctx.save_for_backward(h, c, gates, wh, start, end)
        return h

    @staticmethod
    def backward(ctx, g_out):
        h, c, gates, wh, start, end = ctx.saved_tensors
        dxproj, db = lstm_bwd(g_out.to(torch.bfloat16).contiguous(), gates,
                              c, wh, start, end)
        dwh = dwh_from_seq(h, dxproj)
        return dxproj, db, dwh.to(wh.dtype), None, None
