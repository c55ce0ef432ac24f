"""The share of the traced decode window, on the device's clock, in which
no kernel or copy ran, in %: the host's part of each batch (upload,
rescoring, text) shows here."""


def read(run):
    tr = run.out.get("trace")
    if run.kind != "decode" or tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
