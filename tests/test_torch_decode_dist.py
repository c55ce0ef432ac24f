"""The port's row-sharded char-LM beam decoder
(``ctc_asr_tpu_torch.parallel.decode_dist``) on the CPU: four OS
processes in a gloo group, held against the replicated-table decoders of
both packages (``tests/test_decode_dist.py``).

Each rank of a model group holds its rows of the order-2 table (28 rows)
and decodes its data row's utterances; the ids must equal the
replicated-table decoders' at 'model' 2 (a 2 x 2 grid) and 4 (1 x 4). A
table whose rows do not split over the model group is refused. Workers
are this file run as a script and import torch and the port alone.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
B, T, C, K = 4, 16, 29, 8
LM_WEIGHT, WORD_BONUS = 1.5, 0.5
CORPUS = ["the quick brown fox jumps", "she sells sea shells",
          "a lazy dog sleeps all day"] * 3


def _logits() -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.standard_normal((B, T, C)).astype(np.float32)


def _lens() -> np.ndarray:
    return np.asarray([T, T - 3, 5, T], np.int32)


def _worker(argv) -> int:
    ap = argparse.ArgumentParser()
    for k in ("rank", "world", "port", "model"):
        ap.add_argument(f"--{k}", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from ctc_asr_tpu_torch.config import Config, DecodeConfig, MeshConfig
    from ctc_asr_tpu_torch.ops import lm as lm_mod
    from ctc_asr_tpu_torch.parallel import initialize_distributed
    from ctc_asr_tpu_torch.parallel.decode_dist import (
        make_sharded_lm_beam_decoder)
    from ctc_asr_tpu_torch.parallel.dist import grid_groups
    from ctc_asr_tpu_torch.parallel.mesh import build_mesh
    torch.set_num_threads(1)
    mcfg = MeshConfig(coordinator_address=f"127.0.0.1:{args.port}",
                      num_processes=args.world, process_id=args.rank,
                      model_axis=args.model)
    assert initialize_distributed(mcfg, "cpu")
    try:
        mesh = build_mesh(mcfg)
        group = grid_groups(mesh).model
        cfg = Config(decode=DecodeConfig(method="beam", beam_width=K,
                                         lm_weight=LM_WEIGHT,
                                         word_bonus=WORD_BONUS))
        lm = lm_mod.train_char_lm(CORPUS, order=2)
        decode, place = make_sharded_lm_beam_decoder(cfg, group, lm)
        table = place(torch.device("cpu"))
        per = B // mesh.data
        rows = slice(mesh.data_row * per, (mesh.data_row + 1) * per)
        ids, lens = decode(torch.from_numpy(_logits()[rows]),
                           torch.from_numpy(_lens()[rows]), table)
        refusal = ""
        try:
            make_sharded_lm_beam_decoder(
                cfg, group, {"order": 2, "table": np.zeros((30, 28))})
        except ValueError as e:
            refusal = str(e)
        out = {"ids": [ids[b, :int(lens[b])].tolist()
                       for b in range(ids.shape[0])],
               "table_shape": list(table.shape), "refusal": refusal}
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp: str, model: int, world: int = 4) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    outs = [os.path.join(tmp, f"m{model}_rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(world), "--port", str(port), "--model", str(model),
         "--out", outs[r]], cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, t in zip(procs, texts):
        assert p.returncode == 0, f"rank failed:\n{t[-4000:]}"
    recs = []
    for o in outs:
        with open(o) as f:
            recs.append(json.load(f))
    return recs


def _replicated_ids():
    """The replicated-table decoders of the port (plain) and of the
    reference, on the whole batch."""
    import jax.numpy as jnp
    from ctc_asr_tpu.ops import lm as j_lm
    from ctc_asr_tpu.ops.beam import make_beam_decoder as j_decoder
    from ctc_asr_tpu_torch.ops import lm as t_lm
    from ctc_asr_tpu_torch.ops.beam import make_beam_decoder
    out = []
    for decoder, lm, arr in (
            (make_beam_decoder, t_lm.train_char_lm(CORPUS, order=2),
             torch.from_numpy),
            (j_decoder, j_lm.train_char_lm(CORPUS, order=2), jnp.asarray)):
        ids, lens = decoder(beam_width=K, lm=lm, lm_weight=LM_WEIGHT,
                            word_bonus=WORD_BONUS)(arr(_logits()),
                                                   arr(_lens()))
        ids, lens = np.asarray(ids), np.asarray(lens)
        out.append([ids[b, :int(lens[b])].tolist() for b in range(B)])
    return out


@pytest.mark.parametrize("model", [2, 4])
def test_sharded_lm_matches_replicated(tmp_path, model):
    recs = _launch(str(tmp_path), model)
    port, ref = _replicated_ids()
    assert port == ref
    data = 4 // model
    for r, rec in enumerate(recs):
        row = r // model
        per = B // data
        assert rec["ids"] == port[row * per:(row + 1) * per], r
        assert rec["table_shape"] == [28 // model, C - 1]
    # the decode is not trivial: the LM changes some hypothesis
    from ctc_asr_tpu_torch.ops.beam import make_beam_decoder
    ids, lens = make_beam_decoder(beam_width=K)(torch.from_numpy(_logits()),
                                                torch.from_numpy(_lens()))
    assert [ids[b, :int(lens[b])].tolist() for b in range(B)] != port
    if model == 4:
        assert all(rec["refusal"] == "LM rows 30 not divisible by model "
                   "axis 4" for rec in recs)


def test_lm_rows_not_divisible_raises(monkeypatch):
    """The reference's case: 28 rows over a model axis of 8, in one
    process: a group of one whose size reads 8 (the rule is the group's
    size against the rows). A group of one holds the whole table and
    decodes as the replicated decoder does."""
    import torch.distributed as dist
    from ctc_asr_tpu_torch.config import Config, DecodeConfig
    from ctc_asr_tpu_torch.ops import lm as lm_mod
    from ctc_asr_tpu_torch.parallel.decode_dist import (
        make_sharded_lm_beam_decoder)
    lm = lm_mod.train_char_lm(CORPUS, order=2)
    cfg = Config(decode=DecodeConfig(beam_width=4))
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        with monkeypatch.context() as m:
            m.setattr(dist, "get_world_size", lambda group=None: 8)
            with pytest.raises(ValueError, match="LM rows 28 not divisible "
                               "by model axis 8"):
                make_sharded_lm_beam_decoder(cfg, dist.group.WORLD, lm)
        decode, place = make_sharded_lm_beam_decoder(cfg, dist.group.WORLD,
                                                     lm)
        ids, lens = decode(torch.from_numpy(_logits()),
                           torch.from_numpy(_lens()),
                           place(torch.device("cpu")))
    finally:
        dist.destroy_process_group()
    from ctc_asr_tpu_torch.ops.beam import make_beam_decoder
    want_ids, want_lens = make_beam_decoder(
        beam_width=4, lm=lm, lm_weight=cfg.decode.lm_weight,
        word_bonus=cfg.decode.word_bonus)(
        torch.from_numpy(_logits()), torch.from_numpy(_lens()))
    assert torch.equal(lens, want_lens)
    assert all(torch.equal(ids[b, :lens[b]], want_ids[b, :lens[b]])
               for b in range(B))


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
