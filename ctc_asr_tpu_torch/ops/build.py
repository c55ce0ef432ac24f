"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The build happens at first use, into
``ctc_asr_tpu_torch/_build/<hash of the sources>/``, so a fresh checkout
builds its kernels from its own sources and a changed source never
loads a stale library. Nothing is built or loaded at import time.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns the ``cudaError_t`` of its launches; the wrappers
in ``stft_cuda`` / ``lstm_cuda`` / ``gru_cuda`` / ``ctc_cuda`` /
``beam_cuda`` / ``attention_cuda`` raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libctc_asr_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes (restype is int = cudaError_t)
_SIGNATURES = {
    # samples, window, twiddle, mel_w, mel_lo, mel_off, dct, out, B, S, T,
    # W, hop, n_fft, NB, M, F, n_melw, use_dct, log_floor, stream
    "stft_mel_forward": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # samples, cos, sin, mel, dct, out, B, S, T, W, hop, NB, M, F, use_dct,
    # log_floor, stream
    "stft_dft_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _F, _P],
    # xproj, bias, wh, start, end, hb16, sync, h_out, c_out, gates_out, nd,
    # T, B, H, jt, bt, smem_bytes, stream
    "lstm_fwd_persistent": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _P],
    # g_out, gates, c_seq, wh, start, end, dxproj, db_part, sync, nd, T, B,
    # H, jt, bt, cluster, smem_bytes, stream
    "lstm_bwd_persistent": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P],
    # out (int)
    "lstm_bwd_cluster_capacity": [_P],
    # sync, blocks along x, row_blocks, nd, steps, cluster, smem_bytes,
    # stream
    "recurrence_barrier_probe": [_P, _I, _I, _I, _I, _I, _I, _P],
    # xproj, bias, wh, start, end, hb16, sync, h_out, gates_out, nd, T, B,
    # H, jt, bt, smem_bytes, stream
    "gru_fwd_persistent": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _I, _P],
    # g_out, gates, h_seq, wh, start, end, dhproj, dxproj, db_part, sync,
    # nd, T, B, H, jt, bt, smem_bytes, stream
    "gru_bwd_persistent": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _I, _P],
    # lpz, skip, lens, ends, alphas, nll, T, B, S, stream
    "ctc_alpha": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # lpz, alphas, skip, lens, ends, nll, grad, T, B, S, stream
    "ctc_beta_grad": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # log_probs, lens, table, back, out_ids, out_lens, out_scores, B, T, C,
    # K, U, NP, n_ctx, lm_vocab, space, init_ctx, lm_weight, word_bonus,
    # nbest, stream
    "beam_search": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _F, _F, _I, _P],
    # scores, h1, N, K, NP, reps, select, out_keys, out_flat, stream
    "beam_select_probe": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # q, u, v, k, v, pe, lens, qu, qv, o, lse, strides (host int64), B, H,
    # T, scale, stream
    "rel_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _F, _P],
    # qu, qv, k, v, pe, o, dout, lens, lse, delta, part, duv, dq, dk, dv,
    # dpe, strides (host int64), B, H, T, group, scale, stream
    "rel_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, PATH, or torch's detected root."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _nvcc(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> str:
    """Compile the kernel library if this source hash has none yet;
    returns its path. Records timing and ptxas output in build_info."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"     # concurrent builders never share files
    t0 = time.perf_counter()
    srcs = [p for p in sources() if p.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(p) + f".{tag}.o")
            for p in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, p]
            for p, o in zip(srcs, objs)]
    with ThreadPoolExecutor(len(cmds)) as pool:
        logs = list(pool.map(_nvcc, cmds))
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", f"{lib_path}.{tag}", *objs]
    logs.append(_nvcc(link))
    os.replace(f"{lib_path}.{tag}", lib_path)
    for o in objs:
        os.remove(o)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      log="".join(logs),
                      command="\n".join(" ".join(c) for c in cmds + [link]))
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = [_I]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        msg = load().kernels_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
