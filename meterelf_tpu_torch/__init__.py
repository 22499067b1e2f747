"""meterelf_tpu_torch: the meterelf-tpu dial-decode path on PyTorch and
CUDA (NVIDIA Hopper).

A second package beside the JAX one (``meterelf_tpu``), which stays the
reference it is tested against. It imports torch and numpy, never jax:
the host modules it needs (params, synthetic frames, errors) are
numpy-only copies. The decode path runs four hand-written CUDA kernels
(``csrc/``, built with nvcc at first use by ``_build.py``) on a CUDA
device, and each kernel's plain torch version on the CPU.

Entry point: ``meterelf_tpu_torch.pipeline.decode.MeterDecoder``.
"""
