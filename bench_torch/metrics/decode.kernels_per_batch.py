"""decode.kernels_per_batch (kernels): CUDA kernels launched a batch in
the traced window (the eager glue of pipeline/decode.py's step and
_decode_batch between the port's own kernels)."""


def read(w):
    if not w.device:
        return None
    return w.n_kernels() / w.units
