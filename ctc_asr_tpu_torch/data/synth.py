"""Synthetic speech-like corpus for tests, smoke training, and benches.

The port's own copy of ``ctc_asr_tpu/data/synth.py`` (the two generate
the same corpus from the same seed). Where no speech corpus is on disk,
this is a deterministic synthetic corpus with a *learnable* audio->text mapping:
each character is rendered as a held two-tone chord with a character-
specific frequency pair plus noise, so a CTC model genuinely has to learn
frame->char alignment. Used by tests/ (loss decreases, WER < 100%) and as
the fallback bench dataset.
"""

from __future__ import annotations

import os

import numpy as np

from .. import audio as audio_mod
from .. import text as text_mod
from .manifest import Manifest, Utterance, write_manifest

_WORDS = ("the quick brown fox jumps over a lazy dog while she sells sea "
          "shells by the shore and we all know that time flies when you "
          "are having fun with speech models on big machines").split()

# Syllable inventory for the procedurally generated "hard" vocabulary
# (see build_vocabulary). Plain a-z so every word stays in the CTC
# charset (text.ALPHABET).
_ONSETS = ("b ch d f g h j k l m n p r s sh t th v w z "
           "bl br cl cr dr fl fr gr pl pr sk sl sm sn sp st sw tr").split()
_VOWELS = "a e i o u ai ee oo ou".split()
_CODAS = ("b d f g k l m n p r s t ck ng nk nt rd rk rm rn rt sh st").split()


def char_frequencies(ch: str) -> tuple[float, float]:
    """Two deterministic formant-like frequencies for a character."""
    i = text_mod.ALPHABET.index(ch)
    f1 = 220.0 + 55.0 * i           # 220..1705 Hz
    f2 = 2200.0 + 90.0 * i          # 2200..4630 Hz
    return f1, f2


def render_transcript(transcript: str, sr: int = 16000,
                      char_seconds: float = 0.09,
                      noise: float = 0.05,
                      seed: int = 0) -> np.ndarray:
    """Transcript -> float32 waveform. Spaces render as near-silence."""
    rng = np.random.default_rng(seed)
    n_char = max(1, int(char_seconds * sr))
    pieces = []
    for ch in transcript:
        t = np.arange(n_char) / sr
        if ch == " ":
            seg = np.zeros(n_char, np.float32)
        else:
            f1, f2 = char_frequencies(ch)
            seg = (0.5 * np.sin(2 * np.pi * f1 * t)
                   + 0.3 * np.sin(2 * np.pi * f2 * t)).astype(np.float32)
            # attack/decay envelope so adjacent identical chars are separable
            env = np.minimum(1.0, np.minimum(np.arange(n_char),
                                             n_char - np.arange(n_char))
                             / (0.15 * n_char))
            seg = seg * env.astype(np.float32)
        pieces.append(seg)
    sig = np.concatenate(pieces) if pieces else np.zeros(n_char, np.float32)
    sig = sig + noise * rng.standard_normal(len(sig)).astype(np.float32)
    return (0.8 * sig / max(1e-6, np.abs(sig).max())).astype(np.float32)


def random_transcript(rng: np.random.Generator, min_words: int = 2,
                      max_words: int = 7) -> str:
    n = int(rng.integers(min_words, max_words + 1))
    return " ".join(rng.choice(_WORDS) for _ in range(n))


def build_vocabulary(n_words: int = 384, seed: int = 1234) -> tuple:
    """Deterministic pseudo-word inventory of ``n_words`` words.

    The base _WORDS plus syllable-structured pseudo-words (onset+vowel
    [+coda], 1-3 syllables). Syllable structure matters: it gives a
    character n-gram LM real statistics to learn, so LM fusion
    has something to contribute on this corpus.
    """
    rng = np.random.default_rng(seed)
    seen = set()
    out = []
    for w in _WORDS:  # dedupe the base sentence ("the" repeats)
        if w not in seen:
            seen.add(w)
            out.append(w)
    while len(out) < n_words:
        w = ""
        for _ in range(int(rng.integers(1, 4))):
            w += str(rng.choice(_ONSETS)) + str(rng.choice(_VOWELS))
            if rng.random() < 0.4:
                w += str(rng.choice(_CODAS))
        if 2 <= len(w) <= 12 and w not in seen:
            seen.add(w)
            out.append(w)
    return tuple(out)


def build_oov_vocabulary(n_base: int = 384, n_oov: int = 384,
                         seed: int = 1234) -> tuple:
    """``n_oov`` pseudo-words DISJOINT from ``build_vocabulary(n_base,
    seed)`` but drawn from the same syllable inventory/structure.

    build_vocabulary's generation loop is prefix-stable (it appends from
    a deterministic rng stream and never revisits earlier words), so the
    tail of the (n_base + n_oov)-word inventory is exactly the
    continuation of the same distribution — acoustically and
    phonotactically matched to the base vocabulary while sharing zero
    word types with it. This is the open-vocabulary generalization axis: a model trained on the base vocabulary has
    seen every CHARACTER and syllable pattern but no OOV WORD."""
    full = build_vocabulary(n_base + n_oov, seed=seed)
    oov = tuple(full[n_base:])
    assert len(oov) == n_oov and not (set(oov) & set(full[:n_base]))
    return oov


def generate_hard_split(out_dir: str, split: str, vocab: tuple,
                        count: int, seed: int = 0, sr: int = 16000,
                        min_words: int = 2, max_words: int = 7,
                        snr_db: tuple = (5.0, 20.0),
                        spk_base: int = 0, n_speakers: int = 32,
                        split_id: int = 0,
                        exclude_transcripts: set | None = None) -> str:
    """One extra manifest in generate_hard_corpus's exact distribution.

    Same per-utterance recipe (uniform word count, uniform speaker from
    the pool, uniform SNR, render seed = seed*100003 +
    split_id*1000003 + i) so a split generated later — a larger test
    set, or an OOV split over a disjoint ``vocab`` — is
    distribution-matched to an existing corpus. ``exclude_transcripts``
    keeps the no-memorization guarantee against already-generated
    splits. Returns the manifest path."""
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    used = set(exclude_transcripts or ())
    utts = []
    for i in range(count):
        for _ in range(100):
            n = int(rng.integers(min_words, max_words + 1))
            tr = " ".join(str(rng.choice(vocab)) for _ in range(n))
            if tr not in used:
                used.add(tr)
                break
        else:
            raise RuntimeError("vocabulary too small for disjoint split")
        speaker = spk_base + int(rng.integers(n_speakers))
        snr = float(rng.uniform(*snr_db))
        sig = render_transcript_hard(
            tr, sr=sr, speaker=speaker, snr_db=snr,
            seed=seed * 100003 + split_id * 1000003 + i)
        path = os.path.join(wav_dir, f"{split}{i:05d}.wav")
        audio_mod.write_wav(path, sig, sr)
        utts.append(Utterance(path, len(sig) / sr, tr))
    mpath = os.path.join(out_dir, f"{split}.csv")
    write_manifest(mpath, Manifest(utts))
    return mpath


def generate_lm_text(vocab: tuple, n_sentences: int, seed: int = 0,
                     min_words: int = 2, max_words: int = 7) -> list:
    """Text-only sentences over ``vocab`` in the corpus's transcript
    distribution — LM training material WITHOUT audio (the realistic
    asymmetry: LM text corpora are far larger than transcribed audio,
    and may cover words the acoustic model never heard)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sentences):
        n = int(rng.integers(min_words, max_words + 1))
        out.append(" ".join(str(rng.choice(vocab)) for _ in range(n)))
    return out


def speaker_params(speaker: int) -> dict:
    """Deterministic per-speaker rendering style.

    ``fscale`` is the difficulty lever: char_frequencies maps char i to
    (220+55i, 2200+90i) Hz, so a +-15% formant scale moves a tone by
    several char slots — the absolute frequency cue becomes ambiguous
    across speakers and the model must learn the scale-invariant
    f2/f1-ratio cue (plus context). ``speed`` perturbs CTC alignment
    rates; ``mix``/``vibrato`` vary timbre.
    """
    r = np.random.default_rng(0x5EA5 + 7919 * speaker)
    return {
        "fscale": float(r.uniform(0.85, 1.15)),
        "speed": float(r.uniform(0.8, 1.25)),
        "mix": float(r.uniform(0.2, 0.45)),      # second-tone amplitude
        "vib_rate": float(r.uniform(4.0, 7.0)),  # Hz
        "vib_depth": float(r.uniform(0.0, 0.02)),
    }


def render_transcript_hard(transcript: str, sr: int = 16000,
                           speaker: int = 0, snr_db: float = 10.0,
                           char_seconds: float = 0.09,
                           babble_db: float = 8.0,
                           seed: int = 0) -> np.ndarray:
    """Hard-corpus renderer: speaker style + noise + tone babble.

    Additive white noise is calibrated to ``snr_db`` against the voiced
    signal power; ``babble_db`` adds an interfering random chord track
    that many dB quieter (competing narrowband energy, which broadband
    noise alone does not provide).
    """
    rng = np.random.default_rng(seed)
    spk = speaker_params(speaker)
    pieces = []
    for ch in transcript:
        # per-char duration jitter on top of the speaker speed
        dur = char_seconds * spk["speed"] * float(rng.uniform(0.85, 1.15))
        n_char = max(1, int(dur * sr))
        t = np.arange(n_char) / sr
        if ch == " ":
            seg = np.zeros(n_char, np.float32)
        else:
            f1, f2 = char_frequencies(ch)
            f1 *= spk["fscale"]
            f2 *= spk["fscale"]
            vib = 1.0 + spk["vib_depth"] * np.sin(
                2 * np.pi * spk["vib_rate"] * t)
            amp = float(rng.uniform(0.7, 1.0))
            seg = amp * (0.5 * np.sin(2 * np.pi * f1 * vib * t)
                         + spk["mix"] * np.sin(2 * np.pi * f2 * vib * t))
            env = np.minimum(1.0, np.minimum(np.arange(n_char),
                                             n_char - np.arange(n_char))
                             / (0.15 * n_char))
            seg = (seg * env).astype(np.float32)
        pieces.append(seg.astype(np.float32))
    sig = np.concatenate(pieces) if pieces else np.zeros(
        int(char_seconds * sr), np.float32)
    n = len(sig)
    voiced = sig[np.abs(sig) > 1e-6]
    p_sig = float(np.mean(voiced ** 2)) if voiced.size else 1e-6

    # interfering chord track: random char tones at -babble_db
    babble = np.zeros(n, np.float32)
    n_tones = max(1, n // (sr // 2))  # ~2 tones/second
    for _ in range(n_tones):
        ch = str(rng.choice(list(text_mod.ALPHABET.replace(" ", ""))))
        f1, f2 = char_frequencies(ch)
        fb = float(rng.uniform(0.8, 1.2))
        start = int(rng.integers(0, max(1, n - sr // 4)))
        ln = min(int(rng.integers(sr // 8, sr // 3)), n - start)
        tt = np.arange(ln) / sr
        babble[start:start + ln] += (
            0.5 * np.sin(2 * np.pi * f1 * fb * tt)
            + 0.3 * np.sin(2 * np.pi * f2 * fb * tt)).astype(np.float32)
    b_pow = float(np.mean(babble ** 2)) + 1e-12
    babble *= np.sqrt(p_sig / b_pow / (10.0 ** (babble_db / 10.0)))

    noise_std = np.sqrt(p_sig / (10.0 ** (snr_db / 10.0)))
    sig = sig + babble + noise_std * rng.standard_normal(n).astype(
        np.float32)
    return (0.8 * sig / max(1e-6, np.abs(sig).max())).astype(np.float32)


def generate_hard_corpus(out_dir: str, n_train: int = 512,
                         n_dev: int = 64, n_test: int = 96,
                         seed: int = 0, sr: int = 16000,
                         min_words: int = 2, max_words: int = 7,
                         vocab_size: int = 384,
                         snr_db: tuple = (5.0, 20.0),
                         n_train_speakers: int = 32,
                         n_test_speakers: int = 12) -> dict:
    """The discriminating corpus for the configuration ladder.

    Disjoint splits:
    - transcripts are unique corpus-wide (no utterance memorization);
    - test uses speakers 1000.. (styles never seen in training), so the
      model must interpolate the formant-scale axis;
    - dev shares the train speaker pool (for LM-weight selection) but
      not transcripts.

    Returns {"train": path, "dev": path, "test": path, "vocab": words}.
    """
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    vocab = build_vocabulary(vocab_size, seed=seed + 1234)
    rng = np.random.default_rng(seed)
    used = set()

    def fresh_transcript():
        for _ in range(100):
            n = int(rng.integers(min_words, max_words + 1))
            tr = " ".join(str(rng.choice(vocab)) for _ in range(n))
            if tr not in used:
                used.add(tr)
                return tr
        raise RuntimeError("vocabulary too small for disjoint splits")

    manifests = {}
    splits = (("train", n_train, 0, 0), ("dev", n_dev, 0, 1),
              ("test", n_test, 1000, 2))
    for split, count, spk_base, split_id in splits:
        utts = []
        for i in range(count):
            transcript = fresh_transcript()
            if spk_base:  # held-out speakers
                speaker = spk_base + int(rng.integers(n_test_speakers))
            else:
                speaker = int(rng.integers(n_train_speakers))
            snr = float(rng.uniform(*snr_db))
            sig = render_transcript_hard(
                transcript, sr=sr, speaker=speaker, snr_db=snr,
                seed=seed * 100003 + split_id * 1000003 + i)
            path = os.path.join(wav_dir, f"{split}{i:05d}.wav")
            audio_mod.write_wav(path, sig, sr)
            utts.append(Utterance(path, len(sig) / sr, transcript))
        mpath = os.path.join(out_dir, f"{split}.csv")
        write_manifest(mpath, Manifest(utts))
        manifests[split] = mpath
    manifests["vocab"] = vocab
    return manifests


def generate_corpus(out_dir: str, num_utterances: int = 64,
                    seed: int = 0, sr: int = 16000,
                    min_words: int = 2, max_words: int = 7) -> str:
    """Write wavs + manifest; returns the manifest path."""
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    utts = []
    for i in range(num_utterances):
        transcript = random_transcript(rng, min_words, max_words)
        sig = render_transcript(transcript, sr=sr, seed=seed * 100003 + i)
        path = os.path.join(wav_dir, f"utt{i:05d}.wav")
        audio_mod.write_wav(path, sig, sr)
        utts.append(Utterance(path, len(sig) / sr, transcript))
    manifest_path = os.path.join(out_dir, "manifest.csv")
    write_manifest(manifest_path, Manifest(utts))
    return manifest_path
