"""Device time of K10 `backhalf_planes` (csrc/jpeg.cu) against other
builds of the same C interface, and the split of its time between its two
phases, in turns on one card.

    python3 experiments/torch_k10_ab.py [--variant NAME=PATH/jpeg.cu ...]
                                        [--split]

Builds csrc/jpeg.cu alone into its own library under _build/ ("new") and
each --variant, another jpeg.cu of the same C interface (an earlier
commit's, unpacked with `git show REV:meterelf_tpu_torch/csrc/jpeg.cu`
into the gitignored build/), with _build.build_source, all at once; the
ptxas lines give each build's registers, spills and shared memory, and
the CTAs of 256 threads an SM that its registers allow. With --split,
each source also gets two builds that run one phase of K10 alone:
"-idct", whose tail writes one checksum word a CTA so that the IDCT is
kept, and "-tail", which stages zeros in place of the IDCT. A source
with the K10_PHASES switch is built with it set; the one-CTA-per-16-rows
kernel of commit 2c84436 (before the switch) is patched by text.

Inputs: chip_smoke.py's flagship feed (B_MAIN quality-92 JPEGs,
N_DISTINCT distinct, through io.jpeg.load_coef_feed: compact planes),
the same planes dense, and the ALT_CAMERA feed. Each whole build must
equal the plain version (ops/jpegdec.backhalf_planes_to_packed) on all
three. Then every build is timed with CUDA events (chip_smoke.cuda_ms)
over REPS launches of its C entry (``kernel_ms``) and, for whole builds,
through the wrapper ops/jpeg_tail.backhalf_planes with the build swapped
in as the port's library (``ms``, as chip_smoke.py times every kernel)
and by the C entry one launch at a time after a read of FLUSH_BYTES
that empties the L2 cache of its inputs and output (``cold_ms``: they
come from device memory, as in a decode where other kernels ran
between; the read leaves no dirty line to write back), in turns
(builds in order, then reversed, ROUNDS times). --library adds the
port's library of all csrc/ as the build "lib". Needs one CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (B_ALT, B_MAIN, FEED_THREADS, FRAME_WH,  # noqa: E402
                        N_DISTINCT, cuda_ms, encode_frames, render,
                        tiled_jpegs)

ENTRY = "meterelf_backhalf_planes"
REPS = 20
ROUNDS = 2
THREADS = 256       # K10's CTA, parent and new
FLUSH_BYTES = 1 << 28   # read before each cold launch: 5x the L2 cache
REGS_PER_SM = 65536

# the parent kernel's phases, by text (commit 2c84436's csrc/jpeg.cu)
_PARENT_IDCT = re.compile(
    r"    for \(int j = tid; j < nl \+ 2 \* nc; j \+= kThreads\) \{\n"
    r".*?\n    \}\n(?=    __syncthreads\(\);\n  \}\n  int32_t\* o)", re.S)
_PARENT_TAIL = re.compile(
    r"  int32_t\* o = out \+ \(size_t\)img \* g\.ph \* g\.pw;\n.*?\n\}\n"
    r"(?=\n__global__ void __launch_bounds__\(kThreads\)\n"
    r"    upsample_color_pack_kernel)", re.S)
_PARENT_ZEROS = (
    "    for (int j = tid; j < kStageRows * 2 * g.lw / 4; j += kThreads)\n"
    "      ((uint32_t*)stage)[j] = 0;\n")
_PARENT_CHECKSUM = (
    "  if (y0 < yk && tid < 32) {\n"
    "    uint32_t s = ((const uint32_t*)stage)[tid];\n"
    "    for (int m = 16; m; m >>= 1) s ^= __shfl_xor_sync(~0u, s, m);\n"
    "    if (tid == 0) out[(size_t)img * g.ph * g.pw + blockIdx.x] = s;\n"
    "  }\n}\n")


def phase_source(name: str, source: Path, phase: str, out_dir: Path
                 ) -> Path:
    """A copy of the jpeg.cu ``source`` (build ``name``) under out_dir
    that runs K10's ``phase`` ("idct" or "tail") alone."""
    text = source.read_text()
    if "K10_PHASES" in text:
        text = f"#define K10_PHASES {1 if phase == 'idct' else 2}\n" + text
    else:
        pat, repl = ((_PARENT_TAIL, _PARENT_CHECKSUM) if phase == "idct"
                     else (_PARENT_IDCT, _PARENT_ZEROS))
        text, n = pat.subn(lambda _: repl, text)
        if n != 1:
            raise ValueError(f"{source}: no K10_PHASES switch, and not the "
                             "parent kernel's text either")
    path = out_dir / f"k10_{name}_{phase}.cu"
    path.write_text(text)
    return path


def build(name: str, source: Path):
    from meterelf_tpu_torch import _build

    return _build.build_source(source, f"k10_{name.replace('-', '_')}",
                               (ENTRY,))


def report_ptxas(name: str, lib) -> None:
    """The ptxas lines of the build, and the CTAs an SM its registers
    allow at THREADS threads (registers allotted per warp in units of
    256)."""
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {name} ptxas: {line.strip()}")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            per_warp = -(-int(m.group(1)) * 32 // 256) * 256
            print(f"  {name}: {REGS_PER_SM // (per_warp * THREADS // 32)} "
                  f"CTAs of {THREADS} threads an SM by registers")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another jpeg.cu with the same C interface")
    ap.add_argument("--split", action="store_true",
                    help="also time each source's two phases alone")
    ap.add_argument("--library", action="store_true",
                    help="also time the port's library of all csrc/ "
                    "(what the wrapper launches) as the build 'lib'")
    args = ap.parse_args()
    import torch

    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.ops import jpeg_tail, jpegdec
    from meterelf_tpu_torch.pipeline.decode import (MeterDecoder,
                                                    make_coef_decode_fn)

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    sources = {"new": _build.CSRC / "jpeg.cu"}
    sources.update((k, Path(v)) for k, v in
                   (s.split("=", 1) for s in args.variant))
    whole = list(sources)
    if args.split:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in whole:
            for phase in ("idct", "tail"):
                sources[f"{name}-{phase}"] = phase_source(
                    name, sources[name], phase, _build.BUILD_DIR)
    with ThreadPoolExecutor(len(sources)) as pool:
        futs = {n: pool.submit(build, n, p) for n, p in sources.items()}
        libs = {n: f.result() for n, f in futs.items()}
    if args.library:
        libs["lib"] = _build.library()
        whole.append("lib")
        sources["lib"] = _build.CSRC
    for name, lib in libs.items():
        print(f"{name}: built in {lib.build_seconds:.1f} s "
              f"from {sources[name]}")
        report_ptxas(name, lib)

    feeds = {}
    for label, cam, n in (("flagship", synthetic.DEFAULT_CAMERA, B_MAIN),
                          ("alt", synthetic.ALT_CAMERA, B_ALT)):
        _, pos = render(cam, n, *((1.7, 2.3) if label == "flagship"
                                  else (2.1, 1.3)))
        datas = (tiled_jpegs(cam, pos, N_DISTINCT, n)[1]
                 if label == "flagship" else encode_frames(cam, pos))
        _, win, pad_hw = make_coef_decode_fn(
            MeterDecoder(cam.make_params(), device=dev), FRAME_WH)
        feed = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad_hw,
                                  num_threads=FEED_THREADS)
        if not feed[4].all():
            raise RuntimeError(f"{label}: frames not loaded")
        t = [torch.as_tensor(a).to(dev) for a in feed[:4]]
        feeds[label] = (t, win, pad_hw)
        if label == "flagship":
            dense = [jpegdec.uncompact_plane(a) for a in t[:3]]
            feeds["flagship dense"] = (dense + t[3:], win, pad_hw)
    print(f"flagship window {feeds['flagship'][1]}, staging "
          f"{feeds['flagship'][2]}")

    loaded = _build._LOADED

    def c_call(lib, planes, win, pad_hw):
        a, out = jpeg_tail.backhalf_c_args(*planes, win, pad_hw)
        fn = getattr(lib, ENTRY)
        return (lambda: fn(*a)), out

    def wrapper(lib, planes, win, pad_hw):
        def run():
            loaded[:] = [lib]
            return jpeg_tail.backhalf_planes(*planes, win, pad_hw)
        return run

    calls = {}
    for fname, (planes, win, pad_hw) in feeds.items():
        ref = jpegdec.backhalf_planes_to_packed(*planes, win, pad_hw)
        for name, lib in libs.items():
            run, out = c_call(lib, planes, win, pad_hw)
            if run() != 0:
                raise RuntimeError(f"{name} {fname}: launch failed")
            torch.cuda.synchronize()
            if name in whole:
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} {fname}: differs from the "
                                         "plain version")
                if not torch.equal(wrapper(lib, planes, win, pad_hw)(), ref):
                    raise AssertionError(f"{name} {fname}: wrapper differs")
            calls[(fname, name, "kernel_ms")] = run
            if name in whole:
                calls[(fname, name, "ms")] = wrapper(lib, planes, win, pad_hw)
                calls[(fname, name, "cold_ms")] = run
    loaded.clear()
    print("every whole build equal to the plain version on "
          f"{', '.join(feeds)}")

    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def cold_ms(fn, reps):
        """Mean device time of fn() with the L2 cache emptied of its data
        (FLUSH_BYTES read, which leaves clean lines) before each call,
        events around each call."""
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(reps)]
        for a, b in ev:
            flush.max()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return float(np.mean([a.elapsed_time(b) for a, b in ev]))

    times = {k: [] for k in calls}
    names = list(libs)
    for _ in range(ROUNDS):
        for order in (names, names[::-1]):
            for name in order:
                for key, fn in calls.items():
                    if key[1] == name:
                        timer = cold_ms if key[2] == "cold_ms" else cuda_ms
                        times[key].append(timer(fn, REPS))
    loaded.clear()
    for (fname, name, what), t in times.items():
        print(f"{fname:15s} {name:14s} {what:9s} mean {np.mean(t):.6f} ms "
              f"runs {np.round(t, 6).tolist()}")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
