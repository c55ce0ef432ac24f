"""Device resolution and kernel dispatch.

Counterpart of ``ctc_asr_tpu/ops/dispatch.py``. The hand-written kernels
are compiled for ``sm_90a`` only, so they run on a device of compute
capability (9, 0). A kernel wrapper handed a CPU tensor uses its plain
PyTorch version; handed a CUDA tensor it launches the kernel or raises.
Nothing here falls back from CUDA to the CPU.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=1)
def cuda_supported() -> bool:
    """True when CUDA is present and device 0 is compute capability 9.0."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0))


def resolve_device(device: str | torch.device) -> torch.device:
    """``"cuda"``/``"cpu"`` -> torch.device; raises when CUDA is asked
    for on a machine without it (never silently runs on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def check_kernel_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                        shape: tuple) -> None:
    """Validate one CUDA kernel argument: device, dtype, shape, layout."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_kernel_device(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a device the kernels were built for."""
    if not cuda_supported():
        raise RuntimeError(
            "the CUDA kernels are built for sm_90a and need a device of "
            "compute capability (9, 0); this device is "
            f"{torch.cuda.get_device_name(t.device)} "
            f"{torch.cuda.get_device_capability(t.device)}")
