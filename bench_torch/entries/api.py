"""The file API entry: ``api.get_meter_values(params_file, files,
decoder=...)`` at its default batch over the pool's JPEGs written as
files at set-up and cycled, a few of them bad (empty, or cut short), as
a CLI or API caller reads a folder of camera files.

Traffic parameters: ``empty`` and ``truncated`` (bad files among the
pool's, drawn from the seed; a truncated file keeps the first half of
its bytes), ``warm_records``, ``trace_records``, ``probe_reps`` (host
decode and ``decode_numpy`` spans on one batch after a traced window).

End-to-end: ``api_images_per_s``: records the generator yielded inside
the window, over the window's seconds."""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Any, Dict, List

import numpy as np


class Entry:
    keep = "numpy"

    def __init__(self, ctx: Any) -> None:
        self.ctx = ctx
        self.tp = ctx.traffic
        self.codes: List[int] = []     # per record: its error's code
        self.values: List[float] = []  # per record: its value (nan: none)

    def setup(self) -> None:
        from meterelf_tpu_torch.api import get_meter_values

        from harness import program

        c = self.ctx
        self.dir = tempfile.mkdtemp(prefix="bench_api_")
        self.params_file = program.write_params(c.cfg, self.dir)
        self.files = []
        for i, data in enumerate(c.datas):
            path = os.path.join(self.dir, f"{i:04d}.jpg")
            with open(path, "wb") as fp:
                fp.write(data)
            self.files.append(path)
        self.batch = c.batch

        def cycle():
            while True:
                yield from self.files

        c.decoder.keeping = True
        self.it = get_meter_values(self.params_file, cycle(),
                                   batch_size=self.batch, decoder=c.decoder)
        for _ in range(self.tp["warm_records"]):
            self._next()

    def _next(self) -> float:
        rec = next(self.it)
        t = time.perf_counter()
        self.codes.append(0 if rec.error is None else int(rec.error.code))
        self.values.append(np.nan if rec.value is None else rec.value)
        return t

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        n = 0
        self.timeline = [t0]
        while True:
            t = self._next()
            if t > t0 + seconds:
                break
            n += 1
            if n % self.batch == 0:
                self.timeline.append(t)
        return {"api_images_per_s": n / seconds}

    def traced(self, trace: Any) -> int:
        n = self.tp["trace_records"]
        with trace():
            for _ in range(n):
                self._next()
        return -(-n // self.batch)

    def probes(self) -> None:
        """One batch's host whole-frame decode, then its decode_numpy."""
        from meterelf_tpu_torch.io import jpeg as jio

        c = self.ctx
        c.decoder.keeping = False
        datas = [c.datas[i] for i in range(self.batch)]
        for _ in range(self.tp["probe_reps"]):
            with c.spans.span("api.host_decode"):
                packed, ok = jio.load_packed_crops_from_bytes(
                    datas, c.prm.meter_rect, c.decoder.feed_pad_hw)
            with c.spans.span("api.decode_numpy"):
                c.decoder.decode_numpy(packed, ok)

    def context(self) -> Dict[str, Any]:
        return {}

    def rows(self):
        """Every decoded batch's rows (the last one may run past the
        records consumed)."""
        c = self.ctx
        got = c.decoder.kept
        n = sum(len(r.err) for r in got)
        frame = np.arange(n) % len(self.files)
        self.close()
        return frame, got

    def own_numbers(self, frame: np.ndarray, ref: Dict) -> Dict[str, float]:
        """``records_wrong``: records whose error kind is not the
        reference's, or that lack a value the reading has (an OK 4-dial
        reading) or carry one it has not; the value itself is the
        ``value_gap`` of the rows it came from."""
        n = len(self.codes)
        f = np.arange(n) % len(self.files)
        codes = np.array(self.codes)
        vals = np.array(self.values)
        want = ref["err"][f]
        wrong = codes != want
        four = len(self.ctx.cfg["dials"]) == 4
        ok = (want == 0) & (codes == 0)
        wrong |= ok & (np.isnan(vals) if four else ~np.isnan(vals))
        return {"records_wrong": float(wrong.sum())}

    def close(self) -> None:
        if getattr(self, "it", None) is not None:
            self.it.close()
            self.it = None
        self.ctx.decoder.kept = []
        if getattr(self, "dir", None):
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None
