"""Frozen dataclass configuration tree.

The port's own copy of ``ctc_asr_tpu/config.py``: the same sections
(model / features / data / train / decode / mesh), fields, defaults and
presets, so that ``to_json`` of a preset is byte-identical between the
two packages and a train dir's ``config.json`` written by one loads in
the other. CLI ``--section.key=value`` overrides apply on top.

The ``use_pallas*`` flags keep their names: in the port they select the
hand-written CUDA kernel (true) or its plain PyTorch version (false).
It reads every field, ``train.precompile`` included (one warm step
per bucket shape before step 0, ``train.precompile_bucket_shapes``),
and every field of ``mesh``, and refuses what the reference refuses
(``train.check_regime``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

from . import text as text_mod


@dataclass(frozen=True)
class FeatureConfig:
    """STFT/mel/MFCC frontend parameters (reference: asr/load_sample.py —
    25 ms window / 10 ms hop, MFCC or log-mel, per-feature normalization)."""

    sample_rate: int = 16000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    n_fft: int = 512
    n_mels: int = 80
    n_mfcc: int = 13
    fmin: float = 20.0
    fmax: float = 7600.0
    feature_type: str = "mel"  # "mel" | "mfcc"
    # "global" (dataset-level), "utterance" (per-utterance), or "none"
    normalization: str = "utterance"
    # Dataset-level per-feature stats npz (mean/var [F]) for "global"
    # mode; computed by `cli compute-stats`. Empty -> batch statistics.
    stats_path: str = ""
    use_pallas: bool = True  # STFT kernel vs its plain version

    @property
    def win_length(self) -> int:
        return int(self.sample_rate * self.win_ms / 1000.0)

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.hop_ms / 1000.0)

    @property
    def feature_dim(self) -> int:
        return self.n_mfcc if self.feature_type == "mfcc" else self.n_mels


@dataclass(frozen=True)
class ModelConfig:
    """Acoustic encoder (reference: asr/model.py — dense or conv2d frontend,
    (bi)RNN stack, dense projection to vocab). The port's other kind of
    encoder, the Conformer, is ``ConformerModelConfig``: a model section
    whose ``frontend`` is ``"conformer"`` loads as that class."""

    frontend: str = "dense"  # "dense" (DS1-style) | "conv" (DS2-style)
    # dense frontend
    dense_layers: int = 2
    dense_units: int = 512
    relu_clip: float = 20.0
    dropout: float = 0.05
    # conv frontend (time x freq 2-D convs, stride-2 time downsampling)
    conv_channels: tuple = (32, 32)
    conv_kernels: tuple = ((11, 41), (11, 21))  # (time, freq)
    conv_strides: tuple = ((2, 2), (1, 2))
    # conv formulation: the 2-D conv as a 1-D time conv over a banded
    # matrix (models/layers.py), in frequency blocks where they tile
    conv_as_matmul: bool = True
    conv_blocked_fwd: bool = True
    # recurrent stack
    rnn_type: str = "lstm"  # "lstm" | "gru" | "rnn" (plain tanh cell)
    rnn_layers: int = 2
    rnn_units: int = 512
    bidirectional: bool = False
    # head
    num_classes: int = text_mod.NUM_CLASSES
    # numerics
    compute_dtype: str = "bfloat16"  # matmul/activation dtype
    param_dtype: str = "float32"
    # LSTM sequence kernels vs the plain per-step loop (only applies
    # to rnn_type == "lstm")
    use_pallas_rnn: bool = True
    # rematerialize each RNN layer in the backward pass (reference only)
    remat: bool = False


@dataclass(frozen=True)
class ConformerModelConfig:
    """Conformer-CTC encoder (Gulati et al., arXiv:2005.08100, as NVIDIA
    NeMo's ``ConformerEncoder`` computes it with relative-position
    self-attention; ``models/conformer.py``): striding-conv subsampling,
    ``n_layers`` blocks of macaron feed-forward halves around
    self-attention and a depthwise-conv module, and a dense head. It
    stands in ``Config.model`` in place of ``ModelConfig``, which the
    JAX package's presets share, so those stay as they are; ``from_json``
    picks it where the model section's ``frontend`` is ``"conformer"``.
    The defaults are NeMo's Large row (``conformer_ctc_char.yaml``)."""

    frontend: str = "conformer"
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 18
    ff_expansion: int = 4
    conv_kernel: int = 31
    # "striding" subsampling: log2(factor) 3x3 stride-2 convs
    subsampling_factor: int = 4
    subsampling_channels: int = 512
    xscaling: bool = True      # scale the subsampled input by sqrt(d_model)
    untie_biases: bool = True  # per-layer u / v biases of the attention
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    dropout: float = 0.1
    num_classes: int = text_mod.NUM_CLASSES
    compute_dtype: str = "bfloat16"   # parameters stay f32


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline (reference: asr/input_functions.py — CSV manifests
    sorted by length, bucketed padded batches, shuffle window)."""

    train_manifest: str = ""
    eval_manifest: str = ""
    batch_size: int = 16  # per-process batch (split over local devices)
    max_audio_seconds: float = 17.0  # reference filtered long utterances
    min_audio_seconds: float = 0.7
    max_label_len: int = 256
    num_buckets: int = 8
    shuffle_buffer: int = 4096
    sortagrad: bool = True  # first epoch in length order (reference behavior)
    seed: int = 0
    prefetch: int = 2
    # wav-decode worker threads (features run on-device). 0 = auto
    # (2x cores, capped at 16)
    num_workers: int = 0
    # host->device sample transport: "int16" (default; half the bytes,
    # exact for int16-PCM sources, device rescales — audio.
    # float_to_wire16), "ulaw" (uint8 companded, quarter the bytes,
    # ~13-bit near-zero resolution), or "float32"
    wire_dtype: str = "int16"
    # precomputed-feature cache dir built by the prepare-features CLI
    # ("" = off). When set, the loader ships [B, T, F] float16 features
    # instead of raw samples: no wav decode or STFT at train time, and
    # ~half the wire bytes again (data/feature_cache.py).
    feature_cache: str = ""


@dataclass(frozen=True)
class TrainConfig:
    """Optimization: Adam, LR schedules, gradient clipping, SpecAugment,
    the train loop's cadences."""

    learning_rate: float = 1e-4
    lr_schedule: str = "constant"  # "constant" | "exponential" | "warmup_cosine"
    lr_decay_rate: float = 0.9
    lr_decay_steps: int = 50000
    warmup_steps: int = 500
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip_norm: float = 5.0
    weight_decay: float = 0.0
    # SpecAugment (train-only time/freq feature masking;
    # features.spec_augment). Off by default.
    specaugment: bool = False
    sa_time_masks: int = 2
    sa_time_ratio: float = 0.05  # max time-mask width as fraction of len
    sa_freq_masks: int = 2
    sa_freq_width: int = 15
    # CTC alpha/beta kernels vs the plain log-space DP
    use_pallas_ctc: bool = True
    # profiler trace dir ("" = off) and heartbeat period (0 = off).
    profile_dir: str = ""
    heartbeat_seconds: float = 0.0
    # warm every length bucket's step shape at startup (one step on a
    # zeros copy of the state each; train.precompile_bucket_shapes)
    precompile: bool = True
    total_steps: int = 100000
    # host-device sync cadence of the train loop: the host blocks on
    # a step's loss (a scalar fetch, which also NaN-traps it) every
    # sync_every steps, so it runs at most that many batches ahead.
    sync_every: int = 8
    log_every: int = 50
    eval_every: int = 2500
    checkpoint_every: int = 1000
    keep_checkpoints: int = 5
    seed: int = 42
    train_dir: str = "/tmp/ctc_asr_tpu/train"


@dataclass(frozen=True)
class DecodeConfig:
    """Decoding: greedy, or prefix beam search with optional char-LM
    fusion and word-LM N-best rescoring."""

    method: str = "greedy"  # "greedy" | "beam"
    beam_width: int = 64
    lm_path: str = ""  # char n-gram LM arrays (empty = no fusion)
    lm_weight: float = 0.8
    word_bonus: float = 1.0
    # beam kernel vs the plain PyTorch beam search
    use_pallas: bool = True
    # host-side word-LM N-best rescoring (reference's 2nd LM mode)
    word_lm_path: str = ""
    rescore_alpha: float = 1.0
    rescore_beta: float = 0.0
    nbest: int = 8
    # max emitted transcript length in characters. 0 = derive from
    # data.max_audio_seconds at MAX_CHARS_PER_SECOND (ops/beam.py) so a
    # long-audio config grows the decode buffer instead of silently
    # truncating
    max_decode_len: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh / parallelism (data, model and sequence axes,
    multi-host coordination). The port runs one process a device:
    ``coordinator_address``, ``num_processes`` and ``process_id`` form
    the ``torch.distributed`` group (``parallel.initialize_distributed``:
    NCCL on CUDA, gloo on the CPU), laid out as ``data_axis`` x
    ``model_axis`` processes (``parallel.build_mesh``); ``shard_model``
    shards the wide leaves over the model axis (``parallel.tp``).
    ``seq_axis > 1`` is sequence parallelism in one process over that
    many devices (``parallel.seqpar``)."""

    data_axis: int = -1  # -1 = all remaining devices on the data axis
    model_axis: int = 1
    # sharding of the RNN hidden / projection dims over the 'model' axis
    shard_model: bool = False
    # sequence parallelism: >1 shards the time axis of activations
    seq_axis: int = 1
    # multi-host coordination; empty = single-process
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0


@dataclass(frozen=True)
class Config:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# (De)serialization + CLI overrides
# ---------------------------------------------------------------------------

def _to_dict(cfg) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return [_to_dict(v) for v in cfg]
    return cfg


def to_json(cfg: Config) -> str:
    return json.dumps(_to_dict(cfg), indent=2, sort_keys=True)


def _coerce(value: Any, target_type) -> Any:
    """Coerce a parsed value to a dataclass field's declared type."""
    if target_type is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is tuple and isinstance(value, (list, tuple)):
        return tuple(tuple(v) if isinstance(v, list) else v for v in value)
    if target_type in (int, float, str) and not isinstance(value, target_type):
        return target_type(value)
    return value


def _model_class(d: dict) -> type:
    """The model section's class: the Conformer's where its frontend says
    so, else ``ModelConfig``."""
    return (ConformerModelConfig if d.get("frontend") == "conformer"
            else ModelConfig)


def _from_dict(cls, d: dict):
    # `from __future__ import annotations` stringifies f.type, so resolve
    # field types from the field defaults (every field here has one).
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.default_factory is not dataclasses.MISSING:  # nested dataclass
            sub = f.default_factory()
            if dataclasses.is_dataclass(sub):
                sub_cls = (_model_class(v) if isinstance(sub, ModelConfig)
                           else type(sub))
                kwargs[f.name] = _from_dict(sub_cls, v)
                continue
            kwargs[f.name] = _coerce(v, type(sub))
        else:
            kwargs[f.name] = _coerce(v, type(f.default))
    return cls(**kwargs)


def from_json(s: str) -> Config:
    return _from_dict(Config, json.loads(s))


def apply_overrides(cfg: Config, overrides: dict[str, Any]) -> Config:
    """Apply flat {"section.key": value} overrides, returning a new Config.

    This is the CLI surface replacing the reference's FLAGS: e.g.
    ``--train.learning_rate=3e-4 --model.rnn_layers=5``.
    """
    d = _to_dict(cfg)
    for dotted, value in overrides.items():
        parts = dotted.split(".")
        node = d
        for p in parts[:-1]:
            if p not in node:
                raise KeyError(f"unknown config section {p!r} in {dotted!r}")
            node = node[p]
        leaf = parts[-1]
        if leaf not in node:
            raise KeyError(f"unknown config key {dotted!r}")
        if isinstance(value, str):
            try:
                value = json.loads(value)
            except (json.JSONDecodeError, ValueError):
                pass  # keep as string
        node[leaf] = value
    return _from_dict(Config, d)


def parse_cli_overrides(argv: list[str]) -> dict[str, Any]:
    """Parse ``--a.b=c`` style args into an override dict."""
    out: dict[str, Any] = {}
    for arg in argv:
        if not arg.startswith("--") or "=" not in arg:
            raise ValueError(f"expected --section.key=value, got {arg!r}")
        k, v = arg[2:].split("=", 1)
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# Presets: the five configurations of the reference
# ---------------------------------------------------------------------------

def preset(name: str) -> Config:
    presets = {
        # MFCC + 2-layer uni-RNN + greedy, CPU-runnable.
        "pr1_mfcc_uni": Config(
            features=FeatureConfig(feature_type="mfcc", n_mfcc=26),
            model=ModelConfig(frontend="dense", dense_layers=2,
                              dense_units=256, rnn_layers=2, rnn_units=256,
                              bidirectional=False),
            decode=DecodeConfig(method="greedy"),
        ),
        # Conv2D + 3-layer BiLSTM, train-clean-100, greedy.
        "conv_bilstm3": Config(
            features=FeatureConfig(feature_type="mel", n_mels=80),
            model=ModelConfig(frontend="conv", rnn_layers=3, rnn_units=512,
                              bidirectional=True),
            decode=DecodeConfig(method="greedy"),
        ),
        # DeepSpeech-style conv + 5x BiRNN + beam=64.
        "deepspeech_beam": Config(
            features=FeatureConfig(feature_type="mel", n_mels=80),
            model=ModelConfig(frontend="conv", rnn_layers=5, rnn_units=800,
                              bidirectional=True),
            decode=DecodeConfig(method="beam", beam_width=64),
        ),
        # + n-gram LM shallow fusion, 960h.
        "lm_fusion_960h": Config(
            features=FeatureConfig(feature_type="mel", n_mels=80),
            model=ModelConfig(frontend="conv", rnn_layers=5, rnn_units=800,
                              bidirectional=True),
            decode=DecodeConfig(method="beam", beam_width=64,
                                lm_weight=0.8, word_bonus=1.0),
        ),
        # multi-host DP + distributed decode.
        "multihost_dp": Config(
            features=FeatureConfig(feature_type="mel", n_mels=80),
            model=ModelConfig(frontend="conv", rnn_layers=5, rnn_units=800,
                              bidirectional=True),
            decode=DecodeConfig(method="beam", beam_width=64),
            mesh=MeshConfig(shard_model=False),
        ),
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; have {sorted(presets)}")
    return presets[name]
