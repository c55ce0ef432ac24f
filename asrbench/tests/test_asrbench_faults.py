"""A run with the timed path broken underneath comes out ``correct:
false``: once for each fault a cell can have (one card, so no exchange
between chips to leave out). The runs are the tiny CPU cut, past the
look for a chip."""

import numpy as np
import pytest


def _stuck_adam(monkeypatch):
    from ctc_asr_tpu_torch import optim

    def step(self, params, grads, state, gnorm=None):
        return optim.global_norm(grads)     # the state is left unchanged
    monkeypatch.setattr(optim.Adam, "step", step)


def _half_batch(monkeypatch):
    from ctc_asr_tpu_torch import train
    orig = train.ctc_loss

    def loss(logits, lens, labels, label_lens, **kw):
        h = logits.shape[0] // 2
        return orig(logits[:h], lens[:h], labels[:h], label_lens[:h], **kw)
    monkeypatch.setattr(train, "ctc_loss", loss)


def _alter(ids, lens):
    ids = np.array(ids, copy=True)
    lens = np.array(lens, copy=True)
    for i in range(len(lens)):
        if lens[i]:
            ids[i, 0] = (ids[i, 0] + 1) % 27 + 1 if ids[i, 0] != 1 else 2
        else:
            ids[i, 0], lens[i] = 5, 1
    return ids, lens


def _token_greedy(monkeypatch):
    from ctc_asr_tpu_torch.ops import greedy
    orig = greedy.greedy_decode

    def decode(logits, lens, **kw):
        ids, n = orig(logits, lens, **kw)
        a, b = _alter(ids.cpu().numpy(), n.cpu().numpy())
        import torch
        return torch.as_tensor(a), torch.as_tensor(b)
    monkeypatch.setattr(greedy, "greedy_decode", decode)


def _token_fusion(monkeypatch):
    from ctc_asr_tpu_torch import evaluate
    orig = evaluate.make_nbest_decoder

    def make(cfg):
        decode, pick = orig(cfg)
        return decode, lambda *a: _alter(*pick(*a))
    monkeypatch.setattr(evaluate, "make_nbest_decoder", make)


def _head_scaled(monkeypatch):
    """The eval step's logits scaled: every frame keeps its top class,
    so only the distance between the distributions sees it."""
    from ctc_asr_tpu_torch import evaluate
    orig = evaluate.make_eval_step

    def make(cfg, dev):
        step = orig(cfg, dev)

        def scaled(params, samples, lengths):
            logits, lens = step(params, samples, lengths)
            return logits * 1.5, lens
        return scaled
    monkeypatch.setattr(evaluate, "make_eval_step", make)


@pytest.mark.parametrize("cell,fault", [
    ("ds2_train_b64", _stuck_adam), ("ds3_train_b64", _half_batch),
    ("ds2_train_b64", _half_batch), ("ds2_decode_greedy_b128", _token_greedy),
    ("ds3_decode_fusion_b128", _token_fusion),
    ("ds2_decode_greedy_b128", _head_scaled),
    ("ds3_decode_fusion_b128", _head_scaled)])
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = tiny("--workload", cell, "--seed", "21", "--seconds", "0.2",
                "--trace", "0")
    assert line["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in line["checks"].values())
