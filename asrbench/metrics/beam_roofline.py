"""K8's share of its roofline, in %: ``flops.beam_bound`` on each traced
batch's encoder lengths (beam K, the N-best emitted whole, the decode
buffer's U, the char-LM table) over the device time of the kernel named
below."""

from asrbench import flops
from asrbench.drivers.decode import max_decode_len

KERNELS = ("beam_search_kernel",)


def read(run):
    tr = run.out.get("trace")
    if run.kind != "decode" or tr is None or not tr.records \
            or run.cfg["decode"]["method"] != "beam":
        return None
    ms = tr.kernel_ms(KERNELS)
    if ms <= 0:
        run.log(f"beam_roofline: the work was done but no kernel named "
                f"{KERNELS} was found")
        return None
    d, C = run.cfg["decode"], run.cfg["model"]["num_classes"]
    umax = max_decode_len(run.cfg)
    bound = 0.0
    for r in tr.records:
        T = run.family.encoder_frames(r["S"], run.cfg)
        lens = [run.family.encoder_frames(int(n), run.cfg)
                for n in r["lengths"]]
        bound += flops.beam_bound(lens, r["B"], d["beam_width"], C,
                                  min(umax, T), d["beam_width"],
                                  run.out["lm_table_bytes"])["bound_ms"]
    return 100.0 * bound / ms
