"""The stream entry: ``stream.stream_decode_bytes`` over an endless
backlog of the pool's JPEGs, its reports consumed as a spool daemon
consumes them (a closed loop: the next frame is handed over when the
stream asks for it).

Traffic parameters: ``batch`` (null: the configuration's), ``num_threads``
(the host entropy decode's threads), ``warm_reports`` (reports before the
window), ``trace_reports`` (reports under the profiler in a traced run),
``probe_batches`` (batches the feed alone decodes after a traced window).

End-to-end: ``stream_images_per_s`` (frames whose report the stream
yielded inside the window, over the window's seconds) and
``report_p95_ms`` (over those frames, the time from the frame leaving
the traffic's iterator to the yield of the report that covers it)."""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np


class Entry:
    keep = "decode"

    def __init__(self, ctx: Any) -> None:
        self.ctx = ctx
        self.tp = ctx.traffic
        self.handed: List[np.ndarray] = []   # per batch: hand-over times
        self.reported: List[float] = []      # per batch: report yield time
        self.last = None

    def _frames(self):
        c = self.ctx
        k = 0
        while True:
            idx = c.order(k)
            t = np.empty(len(idx))
            self.handed.append(t)
            for j, i in enumerate(idx):
                t[j] = time.perf_counter()
                yield str(i), c.datas[i]
            k += 1

    def setup(self) -> None:
        from meterelf_tpu_torch.profiling import StageTimers
        from meterelf_tpu_torch.stream import stream_decode_bytes

        c = self.ctx
        self.timers = StageTimers()
        c.decoder.keeping = True
        self.it = stream_decode_bytes(
            c.prm, self._frames(), c.frame_wh, decoder=c.decoder,
            batch_size=c.batch, num_threads=self.tp["num_threads"],
            timers=self.timers)
        for _ in range(self.tp["warm_reports"]):
            self._next()

    def _next(self) -> float:
        self.last = next(self.it)
        t = time.perf_counter()
        self.reported.append(t)
        return t

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        first = len(self.reported)
        while self._next() <= t0 + seconds:
            pass
        done = self.reported[first:-1]          # inside the window
        self.timeline = [t0] + done
        lat = np.concatenate([t - self.handed[first + i]
                              for i, t in enumerate(done)] or [[seconds]])
        return {"stream_images_per_s": len(done) * self.ctx.batch / seconds,
                "report_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def traced(self, trace: Any) -> int:
        self.timers.totals.clear()
        self.timers.counts.clear()
        n = self.tp["trace_reports"]
        with trace():
            for _ in range(n):
                self._next()
        return n

    def probes(self) -> None:
        """The feed alone on the cell's batches at the stream's threads."""
        from meterelf_tpu_torch.io import jpeg as jio

        c = self.ctx
        for k in range(self.tp["probe_batches"]):
            datas = [c.datas[i] for i in c.order(k)]
            with c.spans.span("feed"):
                jio.load_coef_feed(datas, c.prm.meter_rect, c.frame_wh,
                                   c.decoder.feed_pad_hw,
                                   num_threads=self.tp["num_threads"])

    def context(self) -> Dict[str, Any]:
        return {"timers": self.timers}

    def rows(self):
        """(pool frame per row, program fields) of every reported batch,
        and the entry's own numbers against the reference's errors."""
        from meterelf_tpu_torch.pipeline.decode import to_host_later

        c = self.ctx
        n = len(self.reported)
        kept = c.decoder.kept[:n]
        if len(kept) < n:
            raise RuntimeError(f"{n} reports but {len(kept)} decodes kept")
        got = [to_host_later(r)() for r in kept]
        frame = np.concatenate([c.order(k) for k in range(n)])
        self.close()
        return frame, got

    def own_numbers(self, frame: np.ndarray, ref: Dict) -> Dict[str, float]:
        """``reports_wrong``: the last report's frame counts against the
        reference's errors over every reported frame."""
        ok = int((ref["err"][frame] == 0).sum())
        rep = self.last
        return {"reports_wrong": float(
            abs(rep.frames_total - len(frame)) + abs(rep.frames_ok - ok)
            + abs(rep.frames_error - (len(frame) - ok)))}

    def close(self) -> None:
        if getattr(self, "it", None) is not None:
            self.it.close()
            self.it = None
        self.ctx.decoder.kept = []
