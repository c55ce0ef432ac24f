"""Corpus generators: raw corpus layouts -> normalized wav + CSV manifests.

The port's own copy of ``ctc_asr_tpu/data/generate.py`` (no tensor code;
the two write the same manifests from the same corpus tree): per-corpus
convert/filter functions producing CSV manifests, resampled to 16 kHz
mono wav, merged and sorted by length. Supported corpus layouts:
LibriSpeech, Common Voice, TED-LIUM, TIMIT, Tatoeba.

Audio conversion: wav inputs decode natively (audio.py) and FLAC through
the native decoder; other codecs (mp3/sph) shell out to ffmpeg or sox
when available. Without a converter on PATH, such corpora raise a clear
error (the synthetic corpus in synth.py needs neither tool nor corpus).

Corpus acquisition is documented rather than automated: fetch and
extract the corpus yourself, then point the matching ``prepare_*`` /
CLI command at the extracted root:

- **LibriSpeech** (https://www.openslr.org/12): archives
  ``train-clean-100.tar.gz`` (6.3 GB), ``train-clean-360.tar.gz``
  (23 GB), ``train-other-500.tar.gz`` (30 GB), ``dev-clean.tar.gz``,
  ``dev-other.tar.gz``, ``test-clean.tar.gz``, ``test-other.tar.gz``
  from ``https://www.openslr.org/resources/12/<name>``; MD5 checksums
  are published beside each archive on that page — verify with
  ``md5sum`` before extracting. Layout after ``tar xzf``:
  ``LibriSpeech/<split>/<speaker>/<chapter>/*.flac`` +
  ``*.trans.txt`` (what ``prepare_librispeech`` expects).
- **Common Voice** (https://commonvoice.mozilla.org/datasets):
  versioned ``cv-corpus-*-en.tar.gz`` with ``validated.tsv`` +
  ``clips/*.mp3`` (requires ffmpeg/sox on PATH).
- **TED-LIUM release 2** (https://www.openslr.org/19):
  ``TEDLIUM_release2.tar.gz`` (35 GB) — ``<split>/sph/*.sph`` +
  ``<split>/stm/*.stm``.
- **TIMIT** (LDC catalog LDC93S1 — licensed, no public URL):
  ``TIMIT/{TRAIN,TEST}/<dialect>/<speaker>/*.{WAV,TXT}``.
- **Tatoeba** (https://tatoeba.org/en/downloads): ``sentences.csv``
  plus per-sentence audio from
  ``https://audio.tatoeba.org/sentences/<lang>/<id>.mp3``.

``merge_manifests`` merges several corpora's manifests into one
length-sorted train CSV; the README's "Getting real data" section lists
the same sources.
"""

from __future__ import annotations

import csv
import os
import shutil
import subprocess

from .. import audio as audio_mod
from .. import text as text_mod
from .manifest import Manifest, Utterance, write_manifest


def _converter() -> list | None:
    """Command template to convert any-audio -> 16 kHz mono wav."""
    if shutil.which("ffmpeg"):
        return ["ffmpeg", "-nostdin", "-y", "-i", "{src}", "-ac", "1",
                "-ar", "16000", "-f", "wav", "{dst}"]
    if shutil.which("sox"):
        return ["sox", "{src}", "-r", "16000", "-c", "1", "{dst}"]
    return None


def convert_audio(src: str, dst: str, sr: int = 16000) -> None:
    """Any supported audio file -> 16 kHz mono wav at ``dst``.

    wav and FLAC decode first-party (FLAC via the native decoder,
    native/flac_decode.cc — LibriSpeech needs no external tools);
    other formats (mp3/sph) fall back to ffmpeg/sox when on PATH.
    """
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    if src.lower().endswith(".wav"):
        samples, _ = audio_mod.read_wav(src, sr)
        audio_mod.write_wav(dst, samples, sr)
        return
    if src.lower().endswith(".flac"):
        from . import native_io
        if native_io.available():
            n, file_sr = native_io.wav_info(src)
            out, lens, rates = native_io.decode_batch([src], n)
            if lens[0] == n and n > 0:
                samples = out[0]
                if file_sr != sr:
                    samples = audio_mod.resample(samples, file_sr, sr)
                audio_mod.write_wav(dst, samples, sr)
                return
    tmpl = _converter()
    if tmpl is None:
        raise RuntimeError(
            f"cannot convert {src!r}: no ffmpeg/sox on PATH and input is "
            "not wav/flac (or native decode failed)")
    cmd = [a.format(src=src, dst=dst) for a in tmpl]
    subprocess.run(cmd, check=True, capture_output=True)


def _finalize(utts: list, out_manifest: str) -> str:
    """Sort by duration (length-sorted CSVs) and write."""
    man = Manifest(utts).sorted_by_duration()
    write_manifest(out_manifest, man)
    return out_manifest


# ---------------------------------------------------------------------------
# LibriSpeech: <root>/<subset>/<spk>/<chap>/<spk>-<chap>-<utt>.flac
#              + <spk>-<chap>.trans.txt ("<utt_id> TRANSCRIPT...")
# ---------------------------------------------------------------------------

def iter_librispeech_transcripts(subset_dir: str):
    """Yield (utt_id, audio_path, transcript) from a LibriSpeech subset."""
    for dirpath, _dirnames, filenames in sorted(os.walk(subset_dir)):
        for fn in sorted(filenames):
            if not fn.endswith(".trans.txt"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    utt_id, transcript = line.split(" ", 1)
                    for ext in (".flac", ".wav"):
                        ap = os.path.join(dirpath, utt_id + ext)
                        if os.path.exists(ap):
                            yield utt_id, ap, transcript
                            break


def prepare_librispeech(root: str, out_dir: str,
                        subsets: list | None = None,
                        convert: bool = True) -> list:
    """Build LibriSpeech manifests under ``root``; returns manifest paths.

    ``convert=True`` (default) transcodes each .flac to 16 kHz mono wav
    under ``out_dir`` (first-party FLAC decode, native/flac_decode.cc).
    ``convert=False`` points the manifest straight at the original
    .flac files — no disk duplication and no conversion pass; the
    loader's native batch decoder handles FLAC transparently (the
    scipy fallback does not, so this mode requires the native lib —
    checked here with a clear error)."""
    subsets = subsets or [d for d in sorted(os.listdir(root))
                          if os.path.isdir(os.path.join(root, d))]
    if not convert:
        from . import native_io
        if not native_io.available():
            raise RuntimeError(
                "prepare_librispeech(convert=False) needs the native "
                "decoder (direct-.flac manifests); build native/ or "
                "use convert=True")
    out_paths = []
    for subset in subsets:
        sdir = os.path.join(root, subset)
        wav_dir = os.path.join(out_dir, subset, "wav")
        utts = []
        for utt_id, ap, transcript in iter_librispeech_transcripts(sdir):
            if convert:
                dst = os.path.join(wav_dir, utt_id + ".wav")
                if not os.path.exists(dst):
                    convert_audio(ap, dst)
                dur = audio_mod.duration_seconds(dst)
            else:
                from . import native_io
                dst = ap
                n, sr = native_io.wav_info(ap)
                if sr <= 0:
                    raise RuntimeError(f"cannot decode {ap!r}")
                dur = n / float(sr)
            utts.append(Utterance(
                dst, dur, text_mod.normalize_transcript(transcript)))
        out_paths.append(_finalize(
            utts, os.path.join(out_dir, f"{subset}.csv")))
    return out_paths


# ---------------------------------------------------------------------------
# Common Voice: clips/*.mp3 + {train,dev,test}.tsv (path \t sentence cols)
# ---------------------------------------------------------------------------

def prepare_common_voice(root: str, out_dir: str,
                         split_tsv: str = "validated.tsv") -> str:
    tsv = os.path.join(root, split_tsv)
    wav_dir = os.path.join(out_dir, "wav")
    utts = []
    with open(tsv, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            rel = row.get("path") or row.get("filename")
            sentence = row.get("sentence") or row.get("text") or ""
            if not rel or not sentence:
                continue
            src = os.path.join(root, "clips", rel)
            if not os.path.exists(src):
                continue
            utt_id = os.path.splitext(os.path.basename(rel))[0]
            dst = os.path.join(wav_dir, utt_id + ".wav")
            if not os.path.exists(dst):
                convert_audio(src, dst)
            utts.append(Utterance(
                dst, audio_mod.duration_seconds(dst),
                text_mod.normalize_transcript(sentence)))
    base = os.path.splitext(split_tsv)[0]
    return _finalize(utts, os.path.join(out_dir, f"common_voice_{base}.csv"))


# ---------------------------------------------------------------------------
# TED-LIUM: sph/*.sph + stm/*.stm
# stm line: <talk> <ch> <spk> <t0> <t1> <flags> transcript...
# ---------------------------------------------------------------------------

def parse_stm_line(line: str):
    """Returns (talk_id, t0, t1, transcript) or None for comments/empty."""
    line = line.strip()
    if not line or line.startswith(";;"):
        return None
    parts = line.split(None, 6)
    if len(parts) < 7:
        return None
    talk, _ch, _spk, t0, t1, _flags, transcript = parts
    if "ignore_time_segment" in transcript:
        return None
    return talk, float(t0), float(t1), transcript


def prepare_tedlium(root: str, out_dir: str, split: str = "train") -> str:
    stm_dir = os.path.join(root, split, "stm")
    sph_dir = os.path.join(root, split, "sph")
    wav_dir = os.path.join(out_dir, split, "wav")
    utts = []
    for fn in sorted(os.listdir(stm_dir)):
        if not fn.endswith(".stm"):
            continue
        talk_samples, talk_sr = None, None
        with open(os.path.join(stm_dir, fn)) as f:
            for i, line in enumerate(f):
                parsed = parse_stm_line(line)
                if parsed is None:
                    continue
                talk, t0, t1, transcript = parsed
                seg_path = os.path.join(wav_dir, f"{talk}_{i:04d}.wav")
                if not os.path.exists(seg_path):
                    if talk_samples is None:
                        # decode the talk ONCE; slicing 500 segments by
                        # re-reading a 1h wav per segment is O(n^2) I/O
                        src = os.path.join(sph_dir, talk + ".sph")
                        talk_wav = os.path.join(wav_dir, talk + ".wav")
                        if not os.path.exists(talk_wav):
                            convert_audio(src, talk_wav)
                        talk_samples, talk_sr = audio_mod.read_wav(talk_wav)
                    seg = talk_samples[int(t0 * talk_sr):
                                       int(t1 * talk_sr)]
                    audio_mod.write_wav(seg_path, seg, talk_sr)
                utts.append(Utterance(
                    seg_path, t1 - t0,
                    text_mod.normalize_transcript(transcript)))
    return _finalize(utts, os.path.join(out_dir, f"tedlium_{split}.csv"))


# ---------------------------------------------------------------------------
# TIMIT: <root>/{TRAIN,TEST}/DR*/SPK/*.WAV + .TXT ("<s> <e> transcript")
# ---------------------------------------------------------------------------

def prepare_timit(root: str, out_dir: str, split: str = "TRAIN") -> str:
    split_dir = os.path.join(root, split)
    wav_dir = os.path.join(out_dir, split.lower(), "wav")
    utts = []
    for dirpath, _d, filenames in sorted(os.walk(split_dir)):
        for fn in sorted(filenames):
            if not fn.upper().endswith(".TXT") or fn.upper().startswith("SA"):
                continue  # SA* are dialect-calibration sentences (skip)
            stem = os.path.splitext(fn)[0]
            src = None
            for ext in (".WAV", ".wav"):
                c = os.path.join(dirpath, stem + ext)
                if os.path.exists(c):
                    src = c
                    break
            if src is None:
                continue
            with open(os.path.join(dirpath, fn)) as f:
                line = f.read().strip()
            transcript = line.split(None, 2)[2] if len(line.split()) > 2 \
                else ""
            rel = os.path.relpath(dirpath, split_dir).replace(os.sep, "_")
            dst = os.path.join(wav_dir, f"{rel}_{stem}.wav")
            if not os.path.exists(dst):
                convert_audio(src, dst)  # NIST sphere-wavs may need sox
            utts.append(Utterance(
                dst, audio_mod.duration_seconds(dst),
                text_mod.normalize_transcript(transcript)))
    return _finalize(utts, os.path.join(out_dir, f"timit_{split.lower()}.csv"))


# ---------------------------------------------------------------------------
# Tatoeba: audio/<id>.mp3 + sentences.csv "<id>\t<lang>\t<text>"
# ---------------------------------------------------------------------------

def prepare_tatoeba(root: str, out_dir: str, lang: str = "eng") -> str:
    sentences = {}
    with open(os.path.join(root, "sentences.csv")) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3 and parts[1] == lang:
                sentences[parts[0]] = parts[2]
    audio_dir = os.path.join(root, "audio")
    wav_dir = os.path.join(out_dir, "wav")
    utts = []
    if os.path.isdir(audio_dir):
        for fn in sorted(os.listdir(audio_dir)):
            sid = os.path.splitext(fn)[0]
            if sid not in sentences:
                continue
            dst = os.path.join(wav_dir, sid + ".wav")
            if not os.path.exists(dst):
                convert_audio(os.path.join(audio_dir, fn), dst)
            utts.append(Utterance(
                dst, audio_mod.duration_seconds(dst),
                text_mod.normalize_transcript(sentences[sid])))
    return _finalize(utts, os.path.join(out_dir, f"tatoeba_{lang}.csv"))


# ---------------------------------------------------------------------------
# Merge several corpora into one train CSV
# ---------------------------------------------------------------------------

def merge_manifests(manifest_paths: list, out_path: str) -> str:
    from .manifest import read_manifest
    utts = []
    for p in manifest_paths:
        utts.extend(read_manifest(p).utterances)
    return _finalize(utts, out_path)
