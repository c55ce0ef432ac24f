"""K3 launches a train step that ran in clusters of two blocks splitting
K: the LSTM's backward recurrence kernels in the traced window a step,
times the share of the process's K3 launches that the port's counter
``lstm_cuda.lstm_bwd.clustered_launches`` counted as clustered (the
warm-up, the window and the traced cycles; the judge's reference
launches no kernel). Reads the model's LSTM layers where every layer's
K3 is clustered. Read from a traced run on the card only; a program
without the counter reads nothing."""

KERNEL = "lstm_bwd_persistent_kernel"


def read(run):
    tr = run.out.get("trace")
    if run.kind != "train" or tr is None or not tr.kernels or not tr.steps:
        return None
    from ctc_asr_tpu_torch.ops import lstm_cuda
    launches = getattr(lstm_cuda.lstm_bwd, "launches", 0)
    clustered = getattr(lstm_cuda.lstm_bwd, "clustered_launches", None)
    if clustered is None or not launches:
        run.log("k3_clustered_launches.train: the program counted no "
                "clustered K3 launches")
        return None
    k3 = sum(1 for name, *_ in tr.kernels if KERNEL in name)
    return k3 / tr.steps * clustered / launches
