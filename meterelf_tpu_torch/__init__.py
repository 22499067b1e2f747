"""meterelf_tpu_torch: the meterelf-tpu dial-decode path on PyTorch and
CUDA (NVIDIA Hopper).

A second package beside the JAX one (``meterelf_tpu``), which stays the
reference it is tested against. It imports torch and numpy, never jax:
the host modules it needs (params, synthetic frames, errors, the
OpenCV-exact match score) are numpy-only copies, and it reads parameter
files and templates with its own YAML and PNG readers (no PyYAML, no
Pillow). The decode path runs hand-written CUDA kernels (``csrc/``,
built with nvcc at first use by ``_build.py``) on a CUDA device, and
each kernel's plain torch version on the CPU.

The public surface mirrors the JAX package's: the CLI
(``python -m meterelf_tpu_torch PARAMS IMAGE...``), ``get_meter_values``
and the batched ``MeterDecoder``.
"""
from .api import MeterImageData, get_meter_values
from .params import Params, load as load_params
from .pipeline.decode import BatchResult, MeterDecoder

__all__ = [
    "MeterImageData",
    "get_meter_values",
    "Params",
    "load_params",
    "MeterDecoder",
    "BatchResult",
]
