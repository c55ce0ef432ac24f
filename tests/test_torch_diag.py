"""``scripts/diag_oov_boundaries`` on the CPU: the character alignment's
boundary counts on crafted pairs and on seeded random edits, the greedy
path's frame ownership against the port's greedy decoder, and the
script end to end on a random checkpoint, where its per-utterance
records must equal ``evaluate``'s and a sidecar's (and a sidecar that
differs makes it exit 1)."""

import json

import numpy as np
import pytest
import torch

from ctc_asr_tpu_torch import checkpoint as t_ckpt
from ctc_asr_tpu_torch import train as t_train
from ctc_asr_tpu_torch.data.synth import generate_corpus
from ctc_asr_tpu_torch.ops.greedy import greedy_decode
from ctc_asr_tpu_torch.scripts import diag_oov_boundaries as diag
from ctc_asr_tpu_torch.scripts.run_ladder_hard import eval_split
from ctc_asr_tpu_torch.scripts.run_oov import arm_cfg, with_decode
from ctc_asr_tpu_torch.text import ALPHABET, BLANK_ID, decode_ids
from torch_threads import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("ref,hyp,inside,dropped", [
    ("hello world", "hello world", [0, 0], [False]),
    ("hello world", "hel lo world", [1, 0], [False]),     # a split
    ("hello world", "he lo world", [1, 0], [False]),      # l -> space
    ("abc", "a b c", [2], []),
    ("hello world", "helloworld", [0, 0], [True]),        # a merge
    ("hello world", "hellxworld", [0, 0], [True]),        # space -> x
    ("ab cd ef", "ab ef", [0, 0, 0], [False, False]),     # cd deleted
    ("ab cd", "ab cd xy", [0, 0], [False]),               # a word added
    ("ab cd", "", [0, 0], [False]),
    ("ab cd", "x", [0, 0], [False]),
    # boundaries moved by a character: each is a split and a merge
    ("ab cde fg", "a bcd efg", [1, 1, 0], [True, True]),
])
def test_boundary_errors_on_crafted_pairs(ref, hyp, inside, dropped):
    be = diag.boundary_errors(ref, hyp)
    assert be["spaces_inside"] == inside
    assert be["dropped"] == dropped


def test_boundary_errors_count_random_splits_and_merges():
    """Spaces put inside words of a random reference are each counted as
    one split of that word; spaces taken out are each one dropped
    boundary; a letter misspelt inside a word, apart from the spaces,
    changes neither. (Next to an edit of a space a misspelling is
    ambiguous: 'jd mcou' -> 'jdl cou' is as well a letter moved across
    an intact boundary.)"""
    rng = np.random.default_rng(0)
    letters = ALPHABET[1:27]
    for _ in range(200):
        words = ["".join(rng.choice(list(letters), rng.integers(3, 9)))
                 for _ in range(rng.integers(2, 7))]
        ref = " ".join(words)
        want_in, want_drop = [0] * len(words), [False] * (len(words) - 1)
        out = []
        for w, word in enumerate(words):
            k = int(rng.integers(1, len(word) - 1))
            if rng.random() < 0.3:
                word = word[:k] + str(rng.choice(list(letters))) + word[k + 1:]
            cuts = [c for c in range(1, len(word)) if c not in (k, k + 1)]
            if cuts and rng.random() < 0.3:
                cut = int(rng.choice(cuts))
                word = word[:cut] + " " + word[cut:]
                want_in[w] = 1
            out.append(word)
            if w < len(words) - 1:
                if rng.random() < 0.2:
                    want_drop[w] = True
                else:
                    out.append(" ")
        hyp = "".join(out)
        be = diag.boundary_errors(ref, hyp)
        assert be["spaces_inside"] == want_in, (ref, hyp)
        assert be["dropped"] == want_drop, (ref, hyp)


def test_greedy_frames_own_their_runs_and_trailing_blanks():
    c, e, sp = ALPHABET.index("c"), ALPHABET.index("e"), 0
    path = np.array([BLANK_ID, c, c, BLANK_ID, c, sp, sp, BLANK_ID, e])
    text, owned = diag.greedy_frames(path)
    assert text == "cc e"
    assert owned == [(1, 4), (4, 5), (5, 8), (8, 9)]
    # the port's greedy decoder gives the same text on random logits
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(6, 40, len(ALPHABET) + 1, generator=g) * 3
    lens = torch.tensor([40, 33, 17, 5, 1, 0], dtype=torch.int32)
    ids, n = greedy_decode(logits, lens)
    for b in range(6):
        path = logits[b, :int(lens[b])].argmax(-1).numpy()
        assert diag.greedy_frames(path)[0] == decode_ids(ids[b, :n[b]])


def test_diagnose_utt_assigns_frames_to_reference_words():
    """'ab cd' decoded greedily as 'ab c d': word cd is split once and
    owns the frames of c, the inserted space and d with their blanks;
    the posteriors are summed over exactly those frames."""
    a, b, c, d = (ALPHABET.index(x) for x in "abcd")
    path = np.array([a, BLANK_ID, b, 0, c, BLANK_ID, 0, d, d, BLANK_ID])
    p_blank = np.linspace(0.0, 0.9, len(path))
    p_space = np.full(len(path), 0.01)
    rec = diag.diagnose_utt("ab cd", "ab c d", path, p_blank, p_space,
                            {"ab"})
    assert rec["greedy_hyp"] == "ab c d" and rec["record"] == [2, 2, 1, 5]
    ab, cd = rec["words"]
    assert ab[:5] == ["ab", True, 0, False, 3]
    assert cd[:5] == ["cd", False, 1, False, 6]
    np.testing.assert_allclose(cd[5], p_blank[4:].sum())
    np.testing.assert_allclose(cd[6], 0.06)
    s = diag.summarize([rec])
    assert s["oov"]["split_words"] == 1 and s["in_vocab"]["words"] == 1
    assert s["utts_more_hyp_words"] == 1


def test_diag_script_end_to_end_matches_the_sidecar(tmp_path):
    """A random conv_bilstm3 checkpoint decodes eight utterances greedily
    through ``evaluate``; the script's records equal ``evaluate``'s and
    a sidecar's written from another ``evaluate`` of the same
    checkpoint; an altered sidecar fails it."""
    man = generate_corpus(str(tmp_path / "synth"), num_utterances=8, seed=3)
    cfg = with_decode(arm_cfg("conv_bilstm3", man, batch=4),
                      method="greedy")
    state = t_train.init_train_state(cfg)
    t_ckpt.save_checkpoint(str(tmp_path / "ckpt"), 0,
                           t_train.state_to_flat(cfg, state))
    ckpt = str(tmp_path / "ckpt" / "step_00000000.npz")
    params = t_ckpt.load_params(ckpt, cfg)
    with torch.no_grad():
        r = eval_split(cfg, params, man, "cpu", log_samples=0)
    side = tmp_path / "side.json"
    side.write_text(json.dumps({"per_utt": r["per_utt"]}))
    out = tmp_path / "diag.json"
    args = ["--preset", "conv_bilstm3", "--ckpt", ckpt, "--manifest", man,
            "--vocab-manifest", man, "--decode", "greedy", "--sidecar",
            str(side), "--out", str(out), "--device", "cpu"]
    assert diag.main(args) == 0
    got = json.loads(out.read_text())
    assert len(got["utts"]) == 8 and got["summary"]["matches_sidecar"]
    assert [u["record"] for u in got["utts"]] == \
        [list(x) for x in r["per_utt"]]
    assert got["summary"]["oov"]["words"] == 0        # all words seen
    bad = [list(x) for x in r["per_utt"]]
    bad[3][0] += 1
    side.write_text(json.dumps({"per_utt": bad}))
    assert diag.main(args) == 1
