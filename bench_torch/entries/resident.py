"""The device-resident entry: the coefficient step of
``pipeline.decode.make_coef_decode_fn`` looped over feeds that were
uploaded at set-up, each batch dispatched one ahead of the pull of the
previous one (``to_host_later``), as the stream dispatches. No host
entropy decode runs in the window, so the step's launches and kernels
set the pace.

Traffic parameters: ``batch`` (null: the configuration's), ``feeds``
(batches uploaded at set-up, each ``order(k)``), ``num_threads`` (the set-up
feed's threads), ``warm_batches``, ``trace_batches``, ``keep_every``
(one batch in so many, drawn from the seed, is kept for the comparison).

End-to-end: ``step_images_per_s``: rows whose result reached host numpy
inside the window, over the window's seconds."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np


class Entry:
    keep = "none"

    def __init__(self, ctx: Any) -> None:
        self.ctx = ctx
        self.tp = ctx.traffic
        self.kept: List[Tuple[int, tuple]] = []
        self.i = 0
        self.pending = None
        self.rng = np.random.default_rng([ctx.seed, 2])

    def setup(self) -> None:
        import torch

        from meterelf_tpu_torch.io import jpeg as jio
        from meterelf_tpu_torch.pipeline.decode import (make_coef_decode_fn,
                                                         to_host_later)

        c = self.ctx
        self.to_host_later = to_host_later
        self.step, _win, pad_hw = make_coef_decode_fn(c.decoder, c.frame_wh)
        self.feeds = []
        for k in range(self.tp["feeds"]):
            feed = jio.load_coef_feed(
                [c.datas[i] for i in c.order(k)], c.prm.meter_rect,
                c.frame_wh, pad_hw, num_threads=self.tp["num_threads"])
            dev = [torch.as_tensor(a).to(c.device) for a in feed[:5]]
            self.feeds.append((*dev, feed[5], feed[6]))
        self.compact = self.feeds[0][0].dtype == torch.int8
        for _ in range(self.tp["warm_batches"]):
            self._one(keep=False)
        self._drain(keep=False)

    def _one(self, keep: bool) -> float:
        """Dispatch the next batch, then pull the previous one; returns
        the time the previous batch reached the host."""
        k = self.i % len(self.feeds)
        nxt = (self.i, self.to_host_later(self.step(None, *self.feeds[k])))
        self.i += 1
        t = self._drain(keep)
        self.pending = nxt
        return t

    def _drain(self, keep: bool) -> float:
        if self.pending is None:
            return time.perf_counter()
        i, fetch = self.pending
        out = fetch()
        t = time.perf_counter()
        if keep and self.rng.integers(self.tp["keep_every"]) == 0:
            # a pageable copy: the pinned buffers go back to the cache
            self.kept.append((i, tuple(np.array(v) for v in out)))
        self.pending = None
        return t

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        rows = 0
        self.timeline = [t0]
        while self._one(keep=True) <= t0 + seconds:
            rows += self.ctx.batch
            self.timeline.append(time.perf_counter())
        # the pull that ended the window arrived late: it is not counted,
        # and the batch still in flight is drained outside the window
        self._drain(keep=True)
        return {"step_images_per_s": rows / seconds}

    def traced(self, trace: Any) -> int:
        n = self.tp["trace_batches"]
        with trace():
            for _ in range(n):
                self._one(keep=True)
            self._drain(keep=True)
        return n

    def probes(self) -> None:
        pass

    def context(self) -> Dict[str, Any]:
        return {"compact": self.compact}

    def rows(self):
        from meterelf_tpu_torch.pipeline.decode import BatchResult

        c = self.ctx
        frame = np.concatenate([c.order(i % len(self.feeds))
                                for i, _ in self.kept])
        got = [BatchResult(*out) for _, out in self.kept]
        self.close()
        return frame, got

    def own_numbers(self, frame: np.ndarray, ref: Dict) -> Dict[str, float]:
        return {}

    def close(self) -> None:
        self.feeds = []
        self.pending = None
