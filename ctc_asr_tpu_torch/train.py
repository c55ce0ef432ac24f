"""Training: the train step and the single-process loop with
checkpoint, eval and heartbeat hooks.

Counterpart of ``ctc_asr_tpu/train.py``. One step is: features from the
raw padded samples (no gradient) -> SpecAugment -> encoder with dropout
-> CTC loss -> backward -> global norm -> clip -> Adam, with metrics
``loss``, ``grad_norm`` and ``lr`` left on the device. The loop feeds
batches from the reference's ``DataLoader`` with the next batch's
host-to-device copy already in flight, fetches a metric to the host only
every ``train.sync_every`` steps (the NaN trap on ``grad_norm``), logs
through the reference's ``MetricsWriter``, keeps the newest K and the
best checkpoints in the reference's format, and resumes exactly from
the loader cursor.

A step on the card gives the same bits from the same state and batch,
as the reference's fixed XLA program does: its convs run cuDNN's
deterministic algorithms (``models.layers.deterministic_convs``, for the
step alone) and the CTC label gather sums its gradient in a fixed order
(``ops.ctc_cuda.LabelGather``), so one seed and config give one run.

``train.precompile`` (``precompile_bucket_shapes``) runs one step per
length bucket's shape before step 0, on a zeros copy of the state:
eager PyTorch compiles nothing per shape, but the first step of a shape
still pays for the caching allocator's growth, cuDNN's per-shape
algorithm choice and the kernels' first build. ``train.profile_dir``
wraps the loop in a ``torch.profiler`` trace (``utils.profiling``).

Data parallelism across processes (the multi-process branch of
``ctc_asr_tpu/train.py:284-361``): when a ``torch.distributed`` group is
formed (``parallel.initialize_distributed``), every process runs the
same loop on its loader shard (``parallel.loader_shard``), the step
averages the gradients and the loss over the group with one
``all_reduce`` before the same clip and Adam update on every rank, the
replicas start equal (rank 0's state broadcast after init or restore),
and only process 0 writes metrics and checkpoints.

Tensor parallelism (``--mesh.model_axis=M --mesh.shard_model=true``
over ``data x M`` processes, ``parallel.tp``): the ranks of a model
group read the same batches and hold column shards of the wide leaves;
checkpoints are written with full leaves, gathered over rank 0's model
group. Sequence parallelism (``--mesh.seq_axis=N``, one process,
``parallel.seqpar``): the step shards the time axis of one batch over N
devices.

State: ``{"params": {k: tensor}, "opt_state": {...}, "model_state":
{k: tensor}, "step": int, "generators": {"dropout": Generator,
"specaugment": Generator}}`` on the device (``model_state``: what the
model keeps that no optimizer updates, the Conformer's BatchNorm running
statistics, moved by each step; empty for the RNN encoders); in one
process the generators are seeded from ``train.seed`` for a fresh run
and restored from the checkpoint on resume; with several, each rank's
are seeded anew at every step from (``train.seed``, step, rank).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from . import checkpoint as ckpt_mod
from .config import Config
from .data import DataLoader, read_manifest
from .features import extract_features, spec_augment
from .metrics import MetricsWriter, NullMetricsWriter, ThroughputMeter
from .models.encoder import apply_encoder, init_params, init_state
from .models.layers import deterministic_convs
from .ops.ctc_cuda import ctc_loss
from .ops.dispatch import resolve_device
from .optim import Adam, flat_leaves
from .parallel.dist import (all_reduce_mean, broadcast_state, current_group,
                            gather_state, grid_groups, reseed_for_row,
                            shard_state)
from .parallel import seqpar
from .parallel.mesh import ProcessMesh, build_mesh, loader_shard
from .parallel.tp import TensorParallel, hybrid_config, sharded_keys
from .utils.profiling import maybe_trace, span

_GENERATORS = ("dropout", "specaugment")
# the profiler ranges of one train step (its backward inside it) and of
# one batch's upload
STEP_RANGE = "train.step"
UPLOAD_RANGE = "train.upload"


def _seed_generators(seed: int, step: int, dev: torch.device) -> dict:
    """Generators of a run that has none saved: seeded from the train
    seed, the step and their name's index."""
    return {name: torch.Generator(device=dev).manual_seed(
        seed + 1 + i + 1_000_003 * step)
        for i, name in enumerate(_GENERATORS)}


def init_train_state(cfg: Config, device="cpu") -> dict:
    """A fresh train state (``train.init_train_state``): parameters from
    ``train.seed``, zero Adam moments, step 0."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.train.seed)
    params = init_params(cfg.model, cfg.features.feature_dim, gen)
    return state_from_parts(cfg, params, Adam(cfg.train).init(params), 0,
                            {}, dev)


def state_from_parts(cfg: Config, params: dict, opt_state: dict, step: int,
                     rng_states: dict, dev: torch.device,
                     model_state: dict | None = None) -> dict:
    """Move CPU parameters and moments to ``dev`` (parameters as leaves
    that want a gradient), each kind tiling one buffer
    (``optim.flat_leaves``, which Adam updates in one operation), and set
    the generators. ``model_state`` None is a fresh one
    (``models.init_state``).

    Saved generator states restore exactly; one saved on another kind
    of device (a CPU generator's state does not fit a CUDA one) raises,
    since reseeding would change the dropout and SpecAugment draws of
    the resumed run."""
    params = {k: v.requires_grad_(True)
              for k, v in flat_leaves(params, dev).items()}
    opt_state = {"count": opt_state["count"],
                 "mu": flat_leaves(opt_state["mu"], dev),
                 "nu": flat_leaves(opt_state["nu"], dev)}
    gens = _seed_generators(cfg.train.seed, step, dev)
    for name, st in rng_states.items():
        if name not in gens or st.numel() != gens[name].get_state().numel():
            raise ValueError(
                f"the checkpoint's generator state {name!r} does not fit a "
                f"generator on {dev}: it was saved by a run on another kind "
                f"of device, and resuming it here would not be exact")
        gens[name].set_state(st)
    if model_state is None:
        model_state = init_state(cfg.model)
    return {"params": params, "opt_state": opt_state,
            "model_state": {k: v.to(dev) for k, v in model_state.items()},
            "step": step, "generators": gens}


def state_to_flat(cfg: Config, state: dict) -> dict:
    """The state as a checkpoint's flat dict (``checkpoint.state_to_flat``)."""
    return ckpt_mod.state_to_flat(
        state["params"], state["opt_state"], state["step"],
        {k: g.get_state() for k, g in state["generators"].items()},
        cfg.train, cfg.train.seed, state["model_state"])


def make_step_fn(cfg: Config, group=None, mesh: ProcessMesh | None = None,
                 groups=None):
    """``(state, samples, sample_lens, labels, label_lens) -> metrics``:
    one train step on the state's device, updating ``state`` in place.
    Inputs are tensors on that device; metrics are 0-d device tensors
    (and ``lr`` a float) so the step needs no host round trip.

    With a ``torch.distributed`` ``group`` it is the data-parallel step
    (the ``data_axis`` branch of ``ctc_asr_tpu/train.py:114-150``): the
    local loss and gradients are averaged over the group by one
    ``all_reduce`` (``parallel.dist.all_reduce_mean``: the pmean of the
    shards' means, as the reference takes it, so a shard with an
    infeasible row weighs as much as one without) before the norm, the
    clip and Adam, which then agree on every rank. With more than one
    data row (``mesh``; without one, each rank is a row) each rank's
    generators are seeded anew at every step from its row
    (``parallel.dist.reseed_for_row``).

    On a tensor-parallel ``mesh`` it is the step of
    ``make_sharded_train_step`` with ``shard_model``
    (``ctc_asr_tpu/parallel/dist.py:231-270``, ``_make_tp_step_fn``);
    ``groups`` are the mesh's (``parallel.dist.grid_groups``), formed here
    when not given."""
    if mesh is not None and mesh.tensor_parallel:
        return _make_tp_step_fn(cfg, mesh, groups or grid_groups(mesh))
    tcfg = cfg.train
    opt = Adam(tcfg)
    if mesh is None:
        rows = 1 if group is None else dist.get_world_size(group)
        row = 0 if group is None else dist.get_rank(group)
    else:
        rows, row = mesh.data, mesh.data_row

    def step_fn(state, samples, sample_lengths, labels, label_lengths):
        with span(STEP_RANGE):
            gens = state["generators"]
            if rows > 1:
                reseed_for_row(gens, tcfg.seed, state["step"], row)
            params = state["params"]
            with deterministic_convs():
                feats, flens = _train_features(cfg, gens, samples,
                                               sample_lengths)
                logits, logit_lens = apply_encoder(
                    params, feats, flens, cfg.model, train=True,
                    generator=gens["dropout"],
                    model_state=state["model_state"])
                loss = ctc_loss(logits, logit_lens, labels, label_lengths,
                                use_kernel=tcfg.use_pallas_ctc)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
            if group is not None:
                *avg, loss = all_reduce_mean([*grads.values(), loss], group)
                grads = dict(zip(grads, avg))
            lr = opt.schedule(state["step"])
            gnorm = opt.step(params, grads, state["opt_state"])
            state["step"] += 1
            return {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}

    return step_fn


def _train_features(cfg: Config, gens: dict, samples, sample_lengths):
    """Features from the raw samples and SpecAugment, with no gradient."""
    tcfg = cfg.train
    with torch.no_grad():
        feats, flens = extract_features(samples, sample_lengths,
                                        cfg.features)
        if tcfg.specaugment:
            feats = spec_augment(feats, flens, tcfg.sa_time_masks,
                                 tcfg.sa_time_ratio, tcfg.sa_freq_masks,
                                 tcfg.sa_freq_width, gens["specaugment"])
    return feats, flens


def _make_tp_step_fn(cfg: Config, mesh: ProcessMesh, groups):
    """The tensor-parallel step. The kernel policy is ``_hybrid_cfg``'s
    (``parallel.tp.hybrid_config``): K1 and the CTC kernels on the data
    shard, the plain recurrences column-parallel (``parallel.tp``).

    - The loss is the mean over the data group (``pmean(loss, 'data')``,
      ``dist.py:222``); it is equal across a model group by
      construction.
    - A sharded leaf's gradient is averaged over the data group (the
      ranks holding the same columns).
    - A replicated leaf's gradient is averaged over the whole world: it
      is equal across a model group by construction, so that is the mean
      over the data group, and it makes the model ranks' copies agree
      bit for bit.
    - The global norm is ``sqrt(sum over the model group of the sharded
      leaves' squares + the replicated leaves' squares)``; the clip and
      Adam then update the local shards."""
    hcfg = hybrid_config(cfg)
    tcfg = cfg.train
    opt = Adam(tcfg)
    sharded = sharded_keys(cfg, mesh)
    tp = TensorParallel(groups.model, sharded)

    def step_fn(state, samples, sample_lengths, labels, label_lengths):
        with span(STEP_RANGE):
            gens = state["generators"]
            if mesh.data > 1:
                reseed_for_row(gens, tcfg.seed, state["step"], mesh.data_row)
            params = state["params"]
            with deterministic_convs():
                feats, flens = _train_features(hcfg, gens, samples,
                                               sample_lengths)
                logits, logit_lens = apply_encoder(
                    params, feats, flens, hcfg.model, train=True,
                    generator=gens["dropout"], tp=tp)
                loss = ctc_loss(logits, logit_lens, labels, label_lengths,
                                use_kernel=tcfg.use_pallas_ctc)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
            shard = [k for k in grads if k in sharded]
            rep = [k for k in grads if k not in sharded]
            if mesh.data > 1:
                grads.update(zip(shard, all_reduce_mean(
                    [grads[k] for k in shard], groups.data)))
            *avg, loss = all_reduce_mean([*(grads[k] for k in rep), loss],
                                         groups.world)
            grads.update(zip(rep, avg))
            with torch.no_grad():
                sq = sum((torch.sum(grads[k].float() ** 2) for k in shard),
                         torch.zeros((), device=loss.device))
                dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=groups.model)
                gnorm = torch.sqrt(sq + sum(torch.sum(grads[k].float() ** 2)
                                            for k in rep))
            lr = opt.schedule(state["step"])
            gnorm = opt.step(params, grads, state["opt_state"], gnorm)
            state["step"] += 1
            return {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}

    return step_fn


def precompile_bucket_shapes(step_fn, state: dict, loader: DataLoader,
                             cfg: Config) -> None:
    """One step per length bucket's shape before step 0
    (``ctc_asr_tpu/train.py:205`` ``precompile_bucket_shapes``), so that
    the first step of each shape does not pay, inside the run, for the
    caching allocator's growth, cuDNN's per-shape algorithm choice and
    the kernels' first build (``ops.build``). Nothing with one bucket.

    Each warm step works on a zeros copy of ``state`` with generators of
    its own, on zero-filled batches of the bucket's exact shapes made on
    the device (the shapes come from the loader, full sample lengths,
    one label). ``state``, its generators and the loader's cursor are
    not touched, so the run is bit-equal to one without the warm-up.
    Unlike the reference, a failure raises: nothing warms lazily."""
    buckets = loader.spec.buckets
    if len(buckets) <= 1:
        return
    dev = next(iter(state["params"].values())).device
    B = loader.spec.batch_size
    t0 = time.perf_counter()
    for bucket_id, bspec in enumerate(buckets):
        if loader.cache is not None:
            frames = loader.bucket_frames(bucket_id)
            samples = torch.zeros((B, frames, loader.cache.dim),
                                  dtype=getattr(torch, loader.cache.dtype),
                                  device=dev)
        else:
            frames = bspec.max_samples
            samples = torch.zeros(
                (B, frames), device=dev,
                dtype={"int16": torch.int16, "ulaw": torch.uint8}.get(
                    loader.cfg.wire_dtype, torch.float32))
        zeros = {
            "params": {k: torch.zeros_like(v).requires_grad_(True)
                       for k, v in state["params"].items()},
            "opt_state": {"count": 0, **{
                m: {k: torch.zeros_like(v)
                    for k, v in state["opt_state"][m].items()}
                for m in ("mu", "nu")}},
            "model_state": {k: v.clone()
                            for k, v in state["model_state"].items()},
            "step": state["step"],
            "generators": _seed_generators(cfg.train.seed, 0, dev)}
        step_fn(zeros, samples,
                torch.full((B,), frames, dtype=torch.int32, device=dev),
                torch.zeros((B, bspec.max_label_len), dtype=torch.int32,
                            device=dev),
                torch.ones((B,), dtype=torch.int32, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[train] precompiled {len(buckets)} bucket shapes in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def device_batches(src, loader: DataLoader | None, dev: torch.device,
                   with_labels: bool = True):
    """Yield (batch, (samples, sample_lens[, labels, label_lens])) on
    ``dev`` with the NEXT batch's copy already in flight (pinned host
    memory, ``non_blocking``), so step k overlaps batch k+1's transfer.
    ``with_labels=False`` uploads only the samples (or cached features)
    and their lengths, as evaluation needs. Given a ``loader``, re-pins
    ``loader.consumed`` to each yielded batch so ``state_dict()`` stays
    an exact resume point (``train.device_batches``)."""
    pending = None
    for b in src:
        host = (b.samples, b.sample_lengths) + (
            (b.labels, b.label_lengths) if with_labels else ())
        with span(UPLOAD_RANGE):
            arrs = [torch.from_numpy(np.ascontiguousarray(a)) for a in host]
            if dev.type == "cuda":
                arrs = [a.pin_memory().to(dev, non_blocking=True)
                        for a in arrs]
        if pending is not None:
            if loader is not None:
                loader.consumed = (pending[0].epoch, pending[0].position)
            yield pending
        pending = (b, arrs)
    if pending is not None:
        if loader is not None:
            loader.consumed = (pending[0].epoch, pending[0].position)
        yield pending


def check_regime(cfg: Config) -> ProcessMesh:
    """The process grid this run takes part in, from the formed
    ``torch.distributed`` group (one process without one). Raises for
    what the reference refuses (sequence parallelism with more than one
    process) and when ``mesh.num_processes > 1`` but no group of that
    size is formed. Training and evaluation call it before any work, so
    that such a config never runs as if it were something else (the
    reference branches on these settings: ``ctc_asr_tpu/train.py:297-331``,
    ``ctc_asr_tpu/evaluate.py:123-148``). The Conformer runs in one
    process or data-parallel: a model or sequence axis is refused."""
    m = cfg.mesh
    if cfg.model.frontend == "conformer" and (
            m.seq_axis > 1 or m.model_axis > 1 or m.shard_model):
        raise NotImplementedError(
            "the Conformer has no tensor- or sequence-parallel form: drop "
            "--mesh.model_axis, --mesh.shard_model and --mesh.seq_axis")
    return build_mesh(cfg.mesh)


def train(cfg: Config, device="cuda", max_steps: int | None = None,
          loader: DataLoader | None = None, eval_fn=None,
          writer: MetricsWriter | None = None) -> dict:
    """Run the training loop on ``device``; returns the final state.

    ``eval_fn(state) -> dict`` runs every ``train.eval_every`` steps;
    ``max_steps`` overrides ``train.total_steps``. Resumes from the
    newest checkpoint under ``train.train_dir/ckpt`` when one exists
    (written by either package).

    In a formed ``torch.distributed`` group every process calls it: the
    loader takes this rank's shard, every rank restores the same
    checkpoint and then takes rank 0's state, the step is the
    data-parallel one, and ranks other than 0 write no metrics (unless
    a ``writer`` is given) and no checkpoints. ``eval_fn`` runs on every
    rank. On a tensor-parallel mesh the state holds this rank's columns
    of the wide leaves (the returned state too), a checkpoint holds the
    full leaves, and ``eval_fn`` is given the full parameters. With
    ``mesh.seq_axis > 1`` (one process) the step is the
    sequence-parallel one over ``parallel.seqpar.sp_devices``."""
    mesh = check_regime(cfg)
    group = current_group()
    tcfg = cfg.train
    dev = resolve_device(device)
    total = max_steps if max_steps is not None else tcfg.total_steps
    sp_devices = (seqpar.sp_devices(cfg.mesh.seq_axis, dev)
                  if cfg.mesh.seq_axis > 1 else None)
    if loader is None:
        shard_idx, num_shards = loader_shard(mesh)
        loader = DataLoader(read_manifest(cfg.data.train_manifest), cfg.data,
                            cfg.features, shard_idx=shard_idx,
                            num_shards=num_shards)
    own_writer = writer is None
    if own_writer:
        writer = MetricsWriter(tcfg.train_dir) if mesh.rank == 0 \
            else NullMetricsWriter()
    ckpt_dir = tcfg.train_dir + "/ckpt"
    flat, meta = ckpt_mod.restore_latest(ckpt_dir)
    if flat is not None:
        state = state_from_parts(cfg, *ckpt_mod.state_from_flat(flat, cfg),
                                 dev, ckpt_mod.model_state_from_flat(flat,
                                                                     cfg))
        if "loader" in meta:
            loader.load_state_dict(meta["loader"])
        print(f"[train] resumed from step {state['step']}", flush=True)
    else:
        state = init_train_state(cfg, dev)
    if group is not None:
        broadcast_state(state, group)
    groups, sharded = None, frozenset()
    if mesh.tensor_parallel:
        groups = grid_groups(mesh)
        sharded = sharded_keys(cfg, mesh)
        shard_state(state, mesh, sharded)
        step_fn = make_step_fn(cfg, group, mesh, groups)
    elif sp_devices is not None:
        step_fn = seqpar.make_sp_train_step(cfg, sp_devices)
    else:
        step_fn = make_step_fn(cfg, group, mesh)
        if tcfg.precompile and group is None:
            precompile_bucket_shapes(step_fn, state, loader, cfg)
    meter = ThroughputMeter()
    best_wer = meta.get("best_wer", float("inf"))

    heartbeat = None
    if tcfg.heartbeat_seconds > 0:
        from .utils.heartbeat import Heartbeat
        heartbeat = Heartbeat(tcfg.heartbeat_seconds).start()

    def full_state():
        # under TP a collective of the model group: its ranks all call it
        return gather_state(state, sharded, groups.model) if sharded \
            else state

    def save(step, batch, is_best=False):
        if mesh.data_row != 0:
            # the replicas are equal and process 0 writes them: the other
            # rows skip even the copy of their state to the host; row 0's
            # other ranks take part in the gather of the shards
            return
        full = full_state()
        if mesh.rank != 0:
            return
        ckpt_mod.save_checkpoint(
            ckpt_dir, step, state_to_flat(cfg, full),
            metadata={"loader": {"epoch": batch.epoch,
                                 "position": batch.position + 1,
                                 "seed": cfg.data.seed},
                      "best_wer": best_wer},
            keep=tcfg.keep_checkpoints, is_best=is_best)

    it = iter(loader)
    dev_it = device_batches(it, loader, dev)
    sync_every = max(1, tcfg.sync_every)
    t_last = time.perf_counter()
    try:
        with maybe_trace(tcfg.profile_dir):
            for i in range(state["step"], total):
                batch, arrs = next(dev_it)
                m = step_fn(state, *arrs)
                meter.update(batch.audio_seconds)
                step = i + 1
                if step % sync_every == 0 or step == total:
                    # the host fetch waits for the step: a true barrier.
                    # grad_norm is the NaN canary (the log-space CTC maps a
                    # NaN logit to a finite loss; the backward does not)
                    gn = float(m["grad_norm"])
                    if gn != gn:
                        raise FloatingPointError(
                            f"grad_norm is NaN at step {step} "
                            f"(loss={float(m['loss'])})")
                if heartbeat is not None:
                    heartbeat.beat(step)
                if tcfg.log_every > 0 and (step % tcfg.log_every == 0
                                           or step == total):
                    now = time.perf_counter()
                    writer.write(step, loss=float(m["loss"]),
                                 grad_norm=float(m["grad_norm"]),
                                 lr=float(m["lr"]),
                                 audio_s_per_s=meter.audio_seconds_per_second,
                                 step_time_s=(now - t_last) / tcfg.log_every,
                                 epoch=batch.epoch, bucket=batch.bucket_id)
                    t_last = now
                if eval_fn is not None and tcfg.eval_every > 0 \
                        and step % tcfg.eval_every == 0:
                    eval_metrics = eval_fn(full_state())
                    writer.write(step, **{f"eval_{k}": v
                                          for k, v in eval_metrics.items()})
                    wer = eval_metrics.get("wer", float("inf"))
                    if wer < best_wer:
                        best_wer = wer
                        save(step, batch, is_best=True)
                if step == total or (tcfg.checkpoint_every > 0 and
                                     step % tcfg.checkpoint_every == 0):
                    save(step, batch)
        if group is not None:
            # no rank returns before process 0's last checkpoint is written
            dist.barrier(group)
    finally:
        it.close()
        if heartbeat is not None:
            heartbeat.stop()
        if own_writer:
            writer.close()
    return state
