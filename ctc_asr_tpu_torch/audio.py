"""Audio I/O: wav read/write and resampling.

The port's own copy of ``ctc_asr_tpu/audio.py``, implemented on scipy.
Returns float32 in [-1, 1]; resampling is polyphase (scipy.signal).
"""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile
import scipy.signal


def read_wav(path: str, target_sr: int = 16000) -> tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono samples in [-1,1], sample_rate).

    Converts to mono by channel averaging and resamples to ``target_sr``
    when necessary (the reference pre-converted corpora to 16 kHz mono at
    dataset-generation time; we support both pre-converted and on-the-fly).
    """
    sr, data = scipy.io.wavfile.read(path)
    data = pcm_to_float(data)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if target_sr and sr != target_sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return data.astype(np.float32), sr


def pcm_to_float(data: np.ndarray) -> np.ndarray:
    """Integer PCM -> float32 in [-1, 1] (float input passes through)."""
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def float_to_pcm16(data: np.ndarray) -> np.ndarray:
    return np.clip(data * 32767.0, -32768, 32767).astype(np.int16)


WIRE_SCALE = 32768.0  # int16 wire format: x_f32 = x_i16 / WIRE_SCALE


def float_to_wire16(data: np.ndarray) -> np.ndarray:
    """f32 [-1,1] -> int16 wire samples, exact round trip for sources
    that were int16 PCM (v/32768 * 32768 is exact in f32 for |v|<2^15,
    unlike the 32767-scaled file encoding above). Halves host->device
    bytes; the device side divides by WIRE_SCALE (features.py)."""
    return np.clip(np.rint(data * WIRE_SCALE),
                   -32768, 32767).astype(np.int16)


ULAW_MU = 255.0  # uint8 wire format (G.711-style companding)


def float_to_ulaw(data: np.ndarray) -> np.ndarray:
    """f32 [-1,1] -> uint8 mu-law wire samples (quarter the f32 bytes).

    Companded quantization: ~13-bit linear resolution near zero where
    speech energy lives — the standard telephony trade, measurably
    WER-neutral for this frontend (log-mel + per-utterance
    normalization). Device-side inverse lives in
    features.extract_features."""
    x = np.clip(data, -1.0, 1.0)
    y = np.sign(x) * np.log1p(ULAW_MU * np.abs(x)) / np.log1p(ULAW_MU)
    return np.clip(np.rint((y + 1.0) * 127.5), 0, 255).astype(np.uint8)


def ulaw_to_float(wire: np.ndarray) -> np.ndarray:
    """Host-side inverse of float_to_ulaw (tests / tooling)."""
    y = wire.astype(np.float32) / 127.5 - 1.0
    return np.sign(y) * (np.power(1.0 + ULAW_MU, np.abs(y)) - 1.0) \
        / ULAW_MU


def write_wav(path: str, data: np.ndarray, sr: int = 16000) -> None:
    scipy.io.wavfile.write(path, sr, float_to_pcm16(np.asarray(data)))


def resample(data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling sr -> target_sr."""
    g = np.gcd(int(sr), int(target_sr))
    up, down = target_sr // g, sr // g
    return scipy.signal.resample_poly(data, up, down).astype(np.float32)


def duration_seconds(path: str) -> float:
    """Wav duration without decoding samples (header-only read)."""
    import wave
    with wave.open(path, "rb") as w:
        return w.getnframes() / float(w.getframerate())
