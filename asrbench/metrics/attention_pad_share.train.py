"""The share of the Conformer's attention score entries that padding took
in the traced steps, in %: 100 x (1 - real / entries), where a step's
entries are B x T'_pad^2 (every row at the batch's padded encoder length,
the family's ``encoder_frames`` of the padded sample count) and its real
entries the sum of each row's T'^2 at its own length; heads and layers
scale both alike. Read from a traced run on the card where the port's
``attention.core`` range launched kernels; nothing otherwise."""

from asrbench.trace import kernels_in_range

RANGE = "attention.core"


def read(run):
    tr = run.out.get("trace")
    if run.kind != "train" or tr is None or not tr.records \
            or not tr.kernels:
        return None
    if not kernels_in_range(tr, RANGE):
        run.log(f"attention_pad_share.train: the trace holds no kernel of "
                f"the {RANGE!r} range")
        return None
    frames = run.family.encoder_frames
    entries = real = 0
    for r in tr.records:
        pad = frames(int(r["S"]), run.cfg)
        entries += r["B"] * pad * pad
        real += sum(frames(int(n), run.cfg) ** 2 for n in r["lengths"])
    return 100.0 * (1.0 - real / entries)
