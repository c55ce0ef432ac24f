"""Character vocabulary and text <-> id conversion.

The port's own copy of ``ctc_asr_tpu/text.py``: char<->id maps for
a-z, space and apostrophe, plus one CTC blank => 29 classes.

- Encoding produces fixed-shape int32 arrays padded with ``PAD_ID``.
- The CTC blank is the LAST class index (``blank_id == num_classes - 1``).
"""

from __future__ import annotations

import numpy as np

# 28 "real" symbols + 1 blank = 29 classes.
ALPHABET = " abcdefghijklmnopqrstuvwxyz'"
NUM_CLASSES = len(ALPHABET) + 1  # 29
BLANK_ID = NUM_CLASSES - 1  # 28
# Padding id for label arrays. Must NOT collide with a real label; we reuse
# the blank id (labels never contain blank) so padded label arrays stay in
# [0, NUM_CLASSES).
PAD_ID = BLANK_ID

_CHAR_TO_ID = {c: i for i, c in enumerate(ALPHABET)}
_ID_TO_CHAR = {i: c for i, c in enumerate(ALPHABET)}


def normalize_transcript(text: str) -> str:
    """Lowercase and strip characters outside the vocabulary.

    The reference's dataset generators cleaned transcripts to the a-z/space/
    apostrophe charset at corpus-build time; we expose the
    same cleaning as a reusable function.
    """
    text = text.lower()
    out = []
    prev_space = True
    for ch in text:
        if ch in ("-", "_", "\t", "\n"):
            ch = " "
        if ch not in _CHAR_TO_ID:
            continue
        if ch == " ":
            if prev_space:
                continue
            prev_space = True
        else:
            prev_space = False
        out.append(ch)
    return "".join(out).strip()


def encode(text: str) -> np.ndarray:
    """Text -> int32 id array (no padding)."""
    return np.asarray([_CHAR_TO_ID[c] for c in text if c in _CHAR_TO_ID],
                      dtype=np.int32)


def decode_ids(ids) -> str:
    """Id sequence -> text. Ids >= len(ALPHABET) (blank/pad) are dropped."""
    return "".join(_ID_TO_CHAR[int(i)] for i in np.asarray(ids).ravel()
                   if 0 <= int(i) < len(ALPHABET))


def encode_batch(texts, max_len: int | None = None):
    """Encode a list of transcripts to a padded [B, U] batch + lengths [B].

    Pads with ``PAD_ID``. ``max_len`` fixes the static width (one per
    length bucket); defaults to the longest transcript.
    """
    encoded = [encode(t) for t in texts]
    lengths = np.asarray([len(e) for e in encoded], dtype=np.int32)
    if max_len is None:
        max_len = max(1, int(lengths.max(initial=1)))
    out = np.full((len(texts), max_len), PAD_ID, dtype=np.int32)
    for i, e in enumerate(encoded):
        n = min(len(e), max_len)
        out[i, :n] = e[:n]
    lengths = np.minimum(lengths, max_len)
    return out, lengths
