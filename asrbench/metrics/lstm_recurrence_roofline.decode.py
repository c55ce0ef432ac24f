"""The LSTM recurrences' share of their roofline in decoding, in %: the
least time of K2's forward of every layer on each traced batch's padded
shape (``flops.lstm_bounds``) over the device time of the kernel named
below."""

from asrbench import flops

KERNELS = ("lstm_fwd_persistent_kernel",)


def read(run):
    tr = run.out.get("trace")
    if run.kind != "decode" or tr is None or not tr.records:
        return None
    ms = tr.kernel_ms(KERNELS)
    if ms <= 0:
        run.log(f"lstm_recurrence_roofline.decode: the work was done but no "
                f"kernel named {KERNELS} was found")
        return None
    m = run.cfg["model"]
    nd = 2 if m["bidirectional"] else 1
    bound = sum(m["rnn_layers"] * flops.lstm_bounds(
        nd, run.family.encoder_frames(r["S"], run.cfg), r["B"],
        m["rnn_units"])[0]["bound_ms"] for r in tr.records)
    return 100.0 * bound / ms
