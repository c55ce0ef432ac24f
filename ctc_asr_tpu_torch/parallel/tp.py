"""Tensor parallelism over the 'model' axis of the process grid.

Counterpart of the hybrid DP x TP branch of
``ctc_asr_tpu/parallel/dist.py`` (``make_sharded_train_step`` and
``make_sharded_eval_step`` with ``shard_model``, ``dist.py:242-250``,
``:286-307``). There GSPMD derives the tensor parallelism from
``state_shardings``: the wide leaves (``mesh._param_spec``) shard their
last dim over 'model' and XLA inserts the collectives. PyTorch derives
nothing, so this module is the explicit form of what GSPMD derives,
one process a device as in the data-parallel regime:

- every wide matmul is column-parallel: the rank multiplies the
  replicated input by its own block of columns, and the blocks are
  gathered in rank order (``GatherFromModel``) before anything that
  needs the whole row; the input is wrapped in ``CopyToModel``, whose
  backward sums the ranks' partial input gradients;
- the dense frontend's layers of width >= 256 are column-parallel, and
  so are the recurrences of the RNN layers (``wx``, ``wh`` and ``b`` of
  ``G >= 256`` gate columns): ``x @ wx_local`` for all steps as one
  ``bmm`` and one gather a layer, then a step's ``h @ wh_local`` and one
  gather a step, both directions stacked, so that the cell sees the
  gates in the reference's order (contiguous blocks of the 4H columns:
  rank 0 holds i and f when 'model' is 2);
- the head, the conv kernels of 32 channels and every narrower leaf
  stay whole and are computed alike on every rank of a model group.

The kernel policy is the reference's (``_hybrid_cfg``,
``_batch_islands``, ``dist.py:187-228``): the STFT kernel and the CTC
kernels run on the rank's data shard, replicated over the model group;
the RNN kernels are off under TP, and every recurrence runs the plain
cell, the sharded ones through ``TensorParallel.recurrence``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import Config
from ..models.encoder import init_shapes
from ..models.rnn import RECURRENCE_RANGE, cell_step, init_carry
from ..ops.lstm_cuda import _window
from ..utils.profiling import span
from .dist import gather_columns
from .mesh import ProcessMesh, param_spec


class CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the sum of the gradient over the
    model group. It wraps each input of a column-parallel matmul: each
    rank's gradient of that input flows through its own columns only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class GatherFromModel(torch.autograd.Function):
    """Forward: the columns of every model rank, concatenated in rank
    order. Backward: the rank's own slice of the gradient, with no
    reduction: everything after the gather is computed identically on
    every rank, so each already holds the whole gradient.
    (``torch.distributed.nn.functional.all_gather`` sums in its backward,
    which would scale this gradient by the model axis.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.col, ctx.width = dist.get_rank(group), x.shape[-1]
        return gather_columns(x, group)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.col * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def hybrid_config(cfg: Config) -> Config:
    """``_hybrid_cfg``: the RNN kernels off, the STFT and CTC kernels as
    configured."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_pallas_rnn=False))


def sharded_keys(cfg: Config, mesh: ProcessMesh) -> frozenset:
    """The parameter keys whose last dim shards over 'model' on
    ``mesh`` (empty unless the mesh is tensor-parallel)."""
    if not mesh.tensor_parallel:
        return frozenset()
    shapes = init_shapes(cfg.model, cfg.features.feature_dim)
    return frozenset(k for k, s in shapes.items()
                     if param_spec(k, s, True) is not None)


class TensorParallel:
    """The column-parallel pieces of the encoder for one model group:
    ``apply_encoder(..., tp=this)`` sends every layer whose weight is in
    ``sharded`` through ``column_parallel`` or ``recurrence``."""

    def __init__(self, group, sharded: frozenset):
        self.group = group
        self.sharded = sharded

    def shards(self, key: str) -> bool:
        return key in self.sharded

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToModel.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return GatherFromModel.apply(x, self.group)

    def column_parallel(self, fn, layer: dict, x: torch.Tensor):
        """``fn(layer, x)`` with the layer's local output columns (a dense
        layer ``x @ w_local + b_local``, or a conv's local output
        channels), gathered to the whole width before the activation."""
        return self.gather(fn(layer, self.copy(x)))

    def recurrence(self, xd, wx, b, wh, start, end, compute_dtype,
                   use_kernel: bool = False, rnn_type: str = "lstm"):
        """Column-parallel ``models.rnn._recurrence``: xd [nd, T, B, F]
        replicated, wx [nd, F, G/n], wh [nd, H, G/n], b [nd, G/n] this
        rank's gate columns -> h [nd, T, B, H], the same on every rank.

        The arithmetic is the plain recurrence's: xproj from the
        compute-dtype operands accumulated in f32, plus the bias, and a
        step's ``h @ wh`` with h rounded to the compute dtype. The RNN
        kernels take whole gate rows, so ``use_kernel`` must be off (the
        reference's policy under TP)."""
        if use_kernel:
            raise ValueError("the RNN kernels take whole gate rows: tensor "
                             "parallelism runs the plain recurrence")
        nd, T, B, F = xd.shape
        H = wh.shape[1]
        x2 = self.copy(xd).reshape(nd, T * B, F).to(compute_dtype)
        xproj = torch.bmm(x2.float(), wx.to(compute_dtype).float())
        xg = self.gather(xproj.reshape(nd, T, B, -1)
                         + b.float()[:, None, None, :])      # [nd, T, B, G]
        whc = wh.to(compute_dtype)
        with span(RECURRENCE_RANGE):
            carry = init_carry(rnn_type, (nd, B, H), xd.device)
            hs = []
            for t in range(T):
                h = self.copy(carry[0])
                hp = self.gather(torch.bmm(h.to(whc.dtype).float(),
                                           whc.float()))
                carry, out = cell_step(rnn_type, xg[:, t], hp, carry,
                                       _window(start, end, t, (nd, B, 1)))
                hs.append(out)
            return torch.stack(hs, 1) if T else xd.new_zeros((nd, 0, B, H))


def make_tp_eval_step(cfg: Config, mesh: ProcessMesh, groups):
    """``(params, samples, slens) -> (logits, logit_lens)``, the
    tensor-parallel forward with ``train=False`` (``make_sharded_eval_step``
    with ``shard_model``, ``dist.py:286-307``): ``params`` hold this
    rank's columns of the sharded leaves, the batch is the model group's
    (the same on each of its ranks), and the logits come out whole on
    every rank. ``groups`` are the mesh's (``parallel.dist.grid_groups``)."""
    from ..features import extract_features
    from ..models.encoder import apply_encoder
    hcfg = hybrid_config(cfg)
    tp = TensorParallel(groups.model, sharded_keys(cfg, mesh))

    def eval_step(params, samples, sample_lengths):
        with torch.no_grad():
            feats, flens = extract_features(samples, sample_lengths,
                                            hcfg.features)
            return apply_encoder(params, feats, flens, hcfg.model, tp=tp)

    return eval_step
