"""api.host_decode_ms (ms): the host whole-frame decode, crop and pack
(io/jpeg.load_packed_crops_from_bytes, io/native/decoder.c) of one batch
of the cell's files, timed alone after the traced window."""


def read(w):
    return w.spans.mean_ms("api.host_decode")
