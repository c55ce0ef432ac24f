"""The LSTM recurrences' share of their roofline in training, in %: the
least time of K2's forward and K3's backward of every layer on each
traced step's padded shape (``flops.lstm_bounds``) over the device time
of the kernels named below. The recurrences are bound by their chain of
T steps, which no roofline counts."""

from asrbench import flops

KERNELS = ("lstm_fwd_persistent_kernel", "lstm_bwd_persistent_kernel")


def read(run):
    tr = run.out.get("trace")
    if run.kind != "train" or tr is None or not tr.records:
        return None
    ms = tr.kernel_ms(KERNELS)
    if ms <= 0:
        run.log(f"lstm_recurrence_roofline.train: the work was done but no "
                f"kernel named {KERNELS} was found")
        return None
    m = run.cfg["model"]
    nd = 2 if m["bidirectional"] else 1
    bound = 0.0
    for r in tr.records:
        T = run.family.encoder_frames(r["S"], run.cfg)
        k2, k3 = flops.lstm_bounds(nd, T, r["B"], m["rnn_units"])
        bound += m["rnn_layers"] * (k2["bound_ms"] + k3["bound_ms"])
    return 100.0 * bound / ms
