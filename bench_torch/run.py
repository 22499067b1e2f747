"""The benchmark of meterelf_tpu_torch, one run of one cell:

    python3 bench_torch/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (BENCHMARK.json ``workloads``)
names a configuration (its file under bench_torch/configs/) and a traffic
mix (bench_torch/traffic/<traffic>.json), whose ``entry`` names the
driver in bench_torch/entries/. With ``--trace 0`` the run measures the
cell's end-to-end metrics over ``--seconds``; with ``--trace 1`` it
profiles a short window and reports the cell's per-layer metrics, each
read by bench_torch/metrics/<metric>.py. Either way it then holds every
row that the timed path produced to the plain reference
(harness/reference.py) and prints one JSON line last on stdout.

A run needs a CUDA card (it never falls back to the CPU); it exits with
code 2 and prints no result without one, or without BENCHMARK.json."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import compare, gen  # noqa: E402


def say(*a: Any) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_module(path: str, name: str) -> Any:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        return json.load(fp)


def cell_files(name: str) -> Dict[str, Any]:
    """The cell's BENCHMARK.json entries, configuration and traffic."""
    bench = benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as fp:
        cfg = json.load(fp)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fp:
        traffic = json.load(fp)

    def reports(m: Dict) -> bool:
        return name in m.get("workloads", [name])

    return {"bench": bench, "cell": cell, "cfg": cfg, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def per_second(timeline: List[float], seconds: float) -> List[int]:
    """Batches completed in each second of the window (``timeline``: its
    start, then each batch's completion), to see whether a rate drifts
    within a run or only between runs."""
    t = np.asarray(timeline[1:]) - timeline[0]
    return np.bincount(t.astype(int), minlength=int(seconds))[
        :int(seconds)].tolist()


def power_limit() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Card:
    """The card a run measures on. The CPU self-checks put a stand-in of
    their own in its place (bench_torch/tests/cpu.py); a measured run has
    no other path."""

    device = "cuda"
    platform = "gpu"

    def __init__(self, torch: Any, chips: int) -> None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"no CUDA card for {chips} chip(s): "
                             "this benchmark runs on the card only")
        from torch.profiler import ProfilerActivity

        self.cuda = torch.cuda
        self.activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def build(self) -> None:
        from meterelf_tpu_torch import _build

        _build.library()

    def sync(self) -> None:
        self.cuda.synchronize()

    def reset_peak(self) -> None:
        self.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return int(self.cuda.max_memory_allocated())

    def free(self) -> None:
        self.cuda.empty_cache()

    def describe(self) -> Dict[str, Any]:
        return {"platform": self.platform,
                "kind": self.cuda.get_device_name(0),
                "power": power_limit()}


RENDER_WORKERS = 5   # at most; a few cores stay free for torch's import


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """One run; returns the result line's object."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    files = cell_files(args.workload)
    cfg, cell = files["cfg"], files["cell"]
    traffic = files["traffic"]
    # kernel caches inside the checkout, at fixed paths
    cache = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")

    parts: Dict[str, float] = {}
    mark = [T0]

    def part(name: str) -> None:
        t = time.perf_counter()
        parts[name] = t - mark[0]
        mark[0] = t

    n_pool = traffic["pool"]
    # the frames render while torch imports, which is most of the set-up
    pool = gen.Pool(cfg, args.seed, n_pool,
                    min(RENDER_WORKERS, max(1, (os.cpu_count() or 4) - 3)))
    import torch

    try:
        card = Card(torch, cell["chips"])
    except SystemExit:
        pool.frames()
        raise
    from meterelf_tpu_torch import _build

    from harness import program, reference, trace

    part("import")
    card.build()
    _build.host_jpeg()
    part("library")
    frames = pool.frames()
    datas = [f[0] for f in frames]
    coefs = [np.stack([f[1][i] for f in frames]) for i in range(3)]
    load_ok = np.ones(n_pool, bool)
    empty, cut = gen.damage(n_pool, args.seed, traffic.get("empty", 0),
                            traffic.get("truncated", 0))
    if len(empty) or len(cut):
        from harness import jpegread

        for i in empty:
            datas[i] = b""
            load_ok[i] = False
        for i in cut:
            datas[i] = datas[i][:len(datas[i]) // 2]
            w = gen.window_coefs(cfg, jpegread.coefficients(datas[i], cfg))
            for k in range(3):
                coefs[k][i] = w[k]
    part("frames")
    entry_cls = load_module(os.path.join(HERE, "entries",
                                         traffic["entry"] + ".py"),
                            "entry_" + traffic["entry"]).Entry
    prm = program.params(cfg)
    spans = trace.Spans()
    ctx = SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=args.seed, device=card.device,
        prm=prm,
        batch=traffic.get("batch") or cfg["batch"],
        frame_wh=(cfg["frame"]["width"], cfg["frame"]["height"]),
        datas=datas, spans=spans,
        decoder=program.keeping_decoder(prm, card.device, entry_cls.keep))
    ctx.order = gen.Order(args.seed, n_pool, ctx.batch)
    entry = entry_cls(ctx)
    part("decoder")
    card.reset_peak()
    entry.setup()
    card.sync()
    part("warmup")
    setup_s = time.perf_counter() - T0
    say("setup_s " + " ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f" total {setup_s:.3f}")

    metrics: Dict[str, Dict[str, Any]] = {}
    dev_info: Dict[str, Any] = {}
    breakdown = None
    if args.trace:
        window = _traced(entry, ctx, traffic, spans, card)
        for m in files["per_layer"]:
            reader = load_module(os.path.join(HERE, "metrics",
                                              m["name"] + ".py"),
                                 "metric_" + m["name"].replace(".", "_"))
            v = reader.read(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info = {"busy_s": window.busy_s(), "window_s": window.window_s}
        breakdown = window.breakdown()
    else:
        e2e = entry.window(args.seconds)
        e2e["setup_s"] = setup_s
        say("window: batches a second " + " ".join(
            str(n) for n in per_second(entry.timeline, args.seconds)))
        for m in files["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    card.sync()
    peak = card.peak()

    # the comparison, once the program's state is freed
    frame, got = entry.rows()
    del ctx.decoder
    card.free()
    t = time.perf_counter()
    g = reference.geometry(cfg)
    ref = reference.read_frames(cfg, g, coefs, load_ok, card.device)
    nums = compare.numbers(frame, compare.stack(got, ref.keys() | {
        "converged"}), ref)
    nums.update(entry.own_numbers(frame, ref))
    check = compare.verdict(nums, compare.limits())
    say(f"reference: {len(frame)} rows, {time.perf_counter() - t:.3f} s")
    for k, c in check.items():
        say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    result = {
        "correct": compare.is_correct(check),
        "attempted": int(len(frame)),
        "failed": int(nums["rows_wrong"] + nums["rows_unconverged"]),
        "metrics": metrics,
        "device": dict(card.describe(), count=int(cell["chips"]),
                       memory_peak_bytes=peak, **dev_info),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    # set-up by part: a checkout's first run builds the library (nvcc)
    result["setup_parts_s"] = parts
    result["check"] = check
    return result


def _traced(entry: Any, ctx: Any, traffic: Dict, spans: Any,
            card: Card) -> Any:
    """The profiled window, then the entry's probes; a trace.Window."""
    import contextlib

    from torch.profiler import profile

    from harness import trace

    box: Dict[str, Any] = {}

    @contextlib.contextmanager
    def window():
        with trace.host_labels(traffic.get("host_labels", [])):
            with profile(activities=card.activities) as prof:
                t = time.perf_counter()
                yield
                card.sync()
                box["s"] = time.perf_counter() - t
        box["prof"] = prof

    units = entry.traced(window)
    entry.probes()
    return trace.Window(box["prof"], box["s"], units,
                        dict(entry.context(), cfg=ctx.cfg, batch=ctx.batch),
                        spans)


def main() -> int:
    try:
        result = run()
    except SystemExit as e:
        if isinstance(e.code, str):
            say(e.code)
            return 2
        raise
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
