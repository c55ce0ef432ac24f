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

Eager PyTorch compiles nothing per batch shape, so ``train.precompile``
has nothing to do here and is ignored. ``train.profile_dir`` wraps the
loop in a ``torch.profiler`` trace (``utils.profiling``). The mesh,
multi-process and sequence-parallel regimes are not ported yet
(ROADMAP.md A7/A8) and raise.

State: ``{"params": {k: tensor}, "opt_state": {...}, "step": int,
"generators": {"dropout": Generator, "specaugment": Generator}}`` on
the device; the generators are seeded from ``train.seed`` for a fresh
run and restored from the checkpoint on resume.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import checkpoint as ckpt_mod
from .config import Config
from .data import DataLoader, read_manifest
from .features import extract_features, spec_augment
from .metrics import MetricsWriter, ThroughputMeter
from .models.encoder import apply_encoder, init_params
from .ops.ctc_cuda import ctc_loss
from .ops.dispatch import resolve_device
from .optim import Adam
from .utils.profiling import maybe_trace

_GENERATORS = ("dropout", "specaugment")


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
                     rng_states: dict, dev: torch.device) -> dict:
    """Move CPU parameters and moments to ``dev`` (parameters as leaves
    that want a gradient) and set the generators.

    Saved generator states restore exactly; one saved on another kind
    of device (a CPU generator's state does not fit a CUDA one) raises,
    since reseeding would change the dropout and SpecAugment draws of
    the resumed run."""
    params = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
    opt_state = {"count": opt_state["count"],
                 "mu": {k: v.to(dev) for k, v in opt_state["mu"].items()},
                 "nu": {k: v.to(dev) for k, v in opt_state["nu"].items()}}
    gens = _seed_generators(cfg.train.seed, step, dev)
    for name, st in rng_states.items():
        if name not in gens or st.numel() != gens[name].get_state().numel():
            raise ValueError(
                f"the checkpoint's generator state {name!r} does not fit a "
                f"generator on {dev}: it was saved by a run on another kind "
                f"of device, and resuming it here would not be exact")
        gens[name].set_state(st)
    return {"params": params, "opt_state": opt_state, "step": step,
            "generators": gens}


def state_to_flat(cfg: Config, state: dict) -> dict:
    """The state as a checkpoint's flat dict (``checkpoint.state_to_flat``)."""
    return ckpt_mod.state_to_flat(
        state["params"], state["opt_state"], state["step"],
        {k: g.get_state() for k, g in state["generators"].items()},
        cfg.train, cfg.train.seed)


def make_step_fn(cfg: Config):
    """``(state, samples, sample_lens, labels, label_lens) -> metrics``:
    one train step on the state's device, updating ``state`` in place.
    Inputs are tensors on that device; metrics are 0-d device tensors
    (and ``lr`` a float) so the step needs no host round trip."""
    tcfg = cfg.train
    opt = Adam(tcfg)

    def step_fn(state, samples, sample_lengths, labels, label_lengths):
        gens = state["generators"]
        with torch.no_grad():
            feats, flens = extract_features(samples, sample_lengths,
                                            cfg.features)
            if tcfg.specaugment:
                feats = spec_augment(feats, flens, tcfg.sa_time_masks,
                                     tcfg.sa_time_ratio, tcfg.sa_freq_masks,
                                     tcfg.sa_freq_width,
                                     gens["specaugment"])
        params = state["params"]
        logits, logit_lens = apply_encoder(params, feats, flens, cfg.model,
                                           train=True,
                                           generator=gens["dropout"])
        loss = ctc_loss(logits, logit_lens, labels, label_lengths,
                        use_kernel=tcfg.use_pallas_ctc)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        lr = opt.schedule(state["step"])
        gnorm = opt.step(params, grads, state["opt_state"])
        state["step"] += 1
        return {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}

    return step_fn


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
        arrs = [torch.from_numpy(np.ascontiguousarray(a)) for a in host]
        if dev.type == "cuda":
            arrs = [a.pin_memory().to(dev, non_blocking=True) for a in arrs]
        if pending is not None:
            if loader is not None:
                loader.consumed = (pending[0].epoch, pending[0].position)
            yield pending
        pending = (b, arrs)
    if pending is not None:
        if loader is not None:
            loader.consumed = (pending[0].epoch, pending[0].position)
        yield pending


def check_single_process(cfg: Config) -> None:
    """Raise for a parallel regime the port does not have yet: more than
    one process, a coordinator, or a model or sequence axis. Training,
    evaluation and transcription call it first, so that such a config
    never runs as if it were one process (the reference branches on
    these settings: ``ctc_asr_tpu/evaluate.py:133-148``, ``:206-228``)."""
    m = cfg.mesh
    if m.num_processes > 1 or m.coordinator_address or m.model_axis > 1 \
            or m.seq_axis > 1:
        raise NotImplementedError(
            "the port runs on one device in one process; the mesh, "
            "multi-process and sequence-parallel regimes are not ported "
            "yet (ROADMAP.md A7/A8)")


def train(cfg: Config, device="cuda", max_steps: int | None = None,
          loader: DataLoader | None = None, eval_fn=None,
          writer: MetricsWriter | None = None) -> dict:
    """Run the training loop on ``device``; returns the final state.

    ``eval_fn(state) -> dict`` runs every ``train.eval_every`` steps;
    ``max_steps`` overrides ``train.total_steps``. Resumes from the
    newest checkpoint under ``train.train_dir/ckpt`` when one exists
    (written by either package)."""
    check_single_process(cfg)
    tcfg = cfg.train
    dev = resolve_device(device)
    total = max_steps if max_steps is not None else tcfg.total_steps
    if loader is None:
        loader = DataLoader(read_manifest(cfg.data.train_manifest), cfg.data,
                            cfg.features)
    own_writer = writer is None
    if own_writer:
        writer = MetricsWriter(tcfg.train_dir)
    ckpt_dir = tcfg.train_dir + "/ckpt"
    flat, meta = ckpt_mod.restore_latest(ckpt_dir)
    if flat is not None:
        state = state_from_parts(cfg, *ckpt_mod.state_from_flat(flat, cfg),
                                 dev)
        if "loader" in meta:
            loader.load_state_dict(meta["loader"])
        print(f"[train] resumed from step {state['step']}", flush=True)
    else:
        state = init_train_state(cfg, dev)
    step_fn = make_step_fn(cfg)
    meter = ThroughputMeter()
    best_wer = meta.get("best_wer", float("inf"))

    heartbeat = None
    if tcfg.heartbeat_seconds > 0:
        from .utils.heartbeat import Heartbeat
        heartbeat = Heartbeat(tcfg.heartbeat_seconds).start()

    def save(step, batch, is_best=False):
        ckpt_mod.save_checkpoint(
            ckpt_dir, step, state_to_flat(cfg, state),
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
                    eval_metrics = eval_fn(state)
                    writer.write(step, **{f"eval_{k}": v
                                          for k, v in eval_metrics.items()})
                    wer = eval_metrics.get("wer", float("inf"))
                    if wer < best_wer:
                        best_wer = wer
                        save(step, batch, is_best=True)
                if step == total or (tcfg.checkpoint_every > 0 and
                                     step % tcfg.checkpoint_every == 0):
                    save(step, batch)
    finally:
        it.close()
        if heartbeat is not None:
            heartbeat.stop()
        if own_writer:
            writer.close()
    return state
