"""api.decode_numpy_ms (ms): MeterDecoder.decode_numpy of that batch's
packed crops, to host numpy, timed alone after the traced window."""


def read(w):
    return w.spans.mean_ms("api.decode_numpy")
