"""How the coefficient step's input placement costs on the card: the
step (pipeline/decode.make_coef_decode_fn) on the flagship camera at B
256, one batch ahead of the pull as the stream runs it, with its inputs
placed three ways: host numpy arrays (the stream's and the mesh's feed,
staged every batch), five distinct feeds on the card in turn (on the
graphs' path four read in place, the fifth staged), and a fresh device
copy of the feed each batch. Prints one JSON line: per placement the ms a
batch of each round of N batches, their median, the seconds of the first
20 batches (captures included) and the step_graph_* counters.

    python3 experiments/torch_step_placement.py [LABEL]

Run from the root of a checkout; it imports that checkout's package, so
two checkouts compare in turns on one card. Needs one CUDA card; imports
nothing of JAX.
"""
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
from meterelf_tpu_torch import synthetic  # noqa: E402
from meterelf_tpu_torch.io import jpeg as tio  # noqa: E402
from meterelf_tpu_torch.pipeline.decode import (  # noqa: E402
    MeterDecoder, make_coef_decode_fn, to_host_later)
from meterelf_tpu_torch.profiling import counts  # noqa: E402

B, N, ROUNDS = 256, 300, 5
cam = synthetic.DEFAULT_CAMERA
datas = [synthetic.encode_jpeg(f, 92)
         for f in cam.render_frames(synthetic.dial_positions(64))] * 4
feed = tio.load_coef_feed(datas, cam.meter_rect, (640, 480), (250, 250))
dev = torch.device("cuda", 0)
dec = MeterDecoder(cam.make_params(), device=dev)
step, _, _ = make_coef_decode_fn(dec, (640, 480))
on_card = [[torch.as_tensor(np.roll(a, 37 * k, axis=0)).to(dev)
            for a in feed[:5]] + list(feed[5:]) for k in range(5)]


def inputs(mode, i):
    if mode == "host":
        return feed
    if mode == "device5":
        return on_card[i % 5]
    return [t.clone() for t in on_card[0][:5]] + list(feed[5:])


def run(mode, n):
    t0 = time.perf_counter()
    pending = None
    for i in range(n):
        fetch = to_host_later(step(None, *inputs(mode, i)))
        if pending is not None:
            pending()
        pending = fetch
    pending()
    return (time.perf_counter() - t0) / n * 1e3


out = {"label": sys.argv[1] if len(sys.argv) > 1 else "."}
for mode in ("host", "device5", "fresh"):
    c0 = dict(counts())
    t0 = time.perf_counter()
    run(mode, 20)
    out[mode + "_warm_s"] = time.perf_counter() - t0
    ms = [run(mode, N) for _ in range(ROUNDS)]
    out[mode + "_ms"] = ms
    out[mode + "_median_ms"] = float(np.median(ms))
    out[mode + "_counts"] = {k: v - c0.get(k, 0) for k, v in counts().items()
                             if k.startswith("step_graph")}
print(json.dumps(out))
