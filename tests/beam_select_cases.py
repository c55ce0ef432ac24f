"""Crafted candidate sets for K8's top-K selection alone, shared by its
card test (``test_torch_kernels.py``), its CPU test (``test_torch_beam.py``)
and ``chip_smoke.phase_select``."""

import numpy as np

# (name, N, K): N = K * C candidates of the kernel's shapes; keys are make_key(score, h1).
SELECT_CASES = [
    ("all keys equal", 1856, 64),
    ("all NEG but one", 1856, 64),
    ("K-th and (K+1)-th tied", 1856, 64),
    ("positive scores", 1856, 64),
    ("-0 and +0", 1856, 64),
    ("N not a multiple of 64", 1000, 64),
    ("quantized", 1856, 1),
    ("quantized", 1856, 8),
    ("quantized", 1856, 64),
    ("quantized, C=2", 1024, 512),
    ("quantized, C=29", 14848, 512),
    ("chunks of 128", 2900, 100),
    ("more chunks than warps", 8415, 33),
]


def select_case(name: str, N: int, K: int):
    """Seeded scores (f32) and first hashes (uint32 bits as int32) of one
    SELECT_CASES entry. Scores are quantized to halves and hashes drawn
    from 64 values unless the case says otherwise, so that exact ties of
    whole keys are common."""
    rng = np.random.default_rng(N * 1000 + K)
    h1 = rng.integers(0, 1 << 32, N, dtype=np.uint64)
    scores = np.round(rng.standard_normal(N) * 4) / 2 - 10
    if name != "N not a multiple of 64":     # that one: any 32-bit hash
        h1 %= 64
    if name == "all keys equal":
        scores[:], h1[:] = -3.5, 12345
    elif name == "all NEG but one":
        scores[:], h1 = -1.0e30, h1 % 4
        scores[N // 2 + 7] = -20.0
    elif name == "K-th and (K+1)-th tied":
        scores = -rng.permutation(N) / 8.0               # distinct
        rank = np.argsort(-scores, kind="stable")
        a, b = rank[K - 1], rank[K]
        scores[b], h1[b] = scores[a], h1[a]
    elif name == "positive scores":
        scores, h1 = np.round(rng.uniform(-5, 30, N)) / 2, h1 % 16
    elif name == "-0 and +0":
        scores, h1 = rng.choice([-0.0, 0.0, -1.0, 1.0], N), h1 % 2
    return (scores.astype(np.float32),
            h1.astype(np.uint32).view(np.int32))
