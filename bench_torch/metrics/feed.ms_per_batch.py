"""feed.ms_per_batch (ms): the host entropy decode (io/jpeg.load_coef_feed,
io/native/coefs.c) of one of the cell's batches at the stream's thread
count, timed alone after the traced window (span "feed")."""


def read(w):
    return w.spans.mean_ms("feed")
