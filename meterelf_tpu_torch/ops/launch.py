"""Checks shared by the kernel wrappers before and after a launch."""
from __future__ import annotations

from typing import Optional

import torch


def check_cuda(kernel: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
               like: Optional[torch.Tensor] = None, align: int = 1) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` with
    ``ndim`` dimensions (on the device of ``like`` when given) whose data
    starts on a multiple of ``align`` bytes (the kernel's widest load)."""
    where = f"{kernel} kernel"
    if t.device.type != "cuda":
        raise ValueError(f"{where}: tensor on {t.device}, expected CUDA")
    if like is not None and t.device != like.device:
        raise ValueError(f"{where}: tensors on {t.device} and {like.device}")
    if t.dtype != dtype:
        raise TypeError(f"{where}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{where}: shape {tuple(t.shape)}, expected "
                         f"{ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{where}: tensor is not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{where}: tensor data at {t.data_ptr():#x} is not "
                         f"aligned to {align} bytes")


def stream_of(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(kernel: str, rc: int) -> None:
    """Raise if the C launcher reported a CUDA error (cudaError_t)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
