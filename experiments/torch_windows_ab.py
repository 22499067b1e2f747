"""Device time of K2 `windows`, K4 `stats`, K7 `stats_select` and K5
`frontend_windows` (beside K1 `frontend`) against other builds of the
same C interface, and the split of K2's and K4's time between their
phases, in turns on one card.

    python3 experiments/torch_windows_ab.py [--variant NAME=DIR[:K=V,...]
                                            ...] [--split]

Each source is a directory of kernel sources: "new" is
meterelf_tpu_torch/csrc, and each --variant another copy of it (an
earlier commit's, unpacked file by file with `git show
REV:meterelf_tpu_torch/csrc/FILE` into the gitignored build/), or a
copy of a directory patched to another CTA shape of the same kernels
(for example `k2w2=meterelf_tpu_torch/csrc:k2_threads=256,k2_wins=2`;
keys k2_threads, k2_wins, k4_threads: see SHAPES). From each,
windows.cu (K2), stats.cu (K4, K7) and frontend.cu (K1, K5) are built
alone into libraries of their own under _build/ with
_build.build_source, all at once; a source file includes the headers of
its own directory first, so each build takes its own window_bits.cuh,
exact_color.cuh and corr_mma.cuh. The ptxas lines give each kernel's
registers, spills and shared memory; where the toolkit has cuobjdump,
the SASS instructions of the K2 and K4 kernels are counted by opcode.
With --split, each source also gets builds that run one phase alone:
K2's HLS (with fixed colour bounds), colour sample, and close with
write-out; K4's histograms and its keymax scan. A source with the
K2_PHASES / K4_PHASES switches is built with them set; the parent's
sources (commit 8321c07, before the switches) are patched by text.

Inputs: chip_smoke.py's B_MAIN flagship crops; the plain versions give
K1's offsets, K2's bits, K3's okey3 (K4's input) and K6's okey with its
cell contributions (K7's). Each whole build must equal the plain
versions on them first. Then every build is timed with CUDA events
(chip_smoke.cuda_ms) over REPS launches of its C entry (``kernel_ms``)
and, for the whole builds of K2, K4 and K7, through the wrapper with the
build swapped in as the port's library (``ms``) and by the C entry one
launch at a time after a read of FLUSH_BYTES that empties the L2 cache
(``cold_ms``), in turns (builds in order, then reversed, ROUNDS times).
K5 - K1 is taken per run from the two C entries of one build. With
--ncu, prints whether ncu is on the machine and what it gives for K2 and
K4.
Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import B_MAIN, cold_ms, cuda_ms, render  # noqa: E402

REPS = 20
ROUNDS = 2
FLUSH_BYTES = 1 << 28   # read before each cold launch: 5x the L2 cache
ENTRIES = {
    "win": ("windows.cu", ("meterelf_windows",)),
    "stats": ("stats.cu", ("meterelf_stats", "meterelf_stats_select")),
    "fe": ("frontend.cu", ("meterelf_frontend", "meterelf_frontend_windows")),
}
PHASES = {"win": ("hls", "sample", "close"), "stats": ("hist", "keymax")}
SASS_KERNELS = ("windows_kernel", "stats_kernel")

# the parent's phases, by text (commit 8321c07's window_bits.cuh and
# stats.cu): each pair is (text, replacement), each text found once
_HLS_LOOP = (
    "  for (int i = tid; i < kPix; i += nthreads) {\n"
    "    const int y = i >> 6, x = i & 63;\n"
    "    int h, l, s;\n")
_HLS_STORE = (
    "    sm.h[i] = (uint8_t)h;\n"
    "    sm.l[i] = (uint8_t)l;\n"
    "    sm.s[i] = (uint8_t)s;\n"
    "  }\n"
    "  __syncthreads();\n")
_SAMPLE_END = (
    "    sm.hi[tid] = min(max(color + cr, 0), 255);\n"
    "  }\n"
    "  __syncthreads();\n")
_PARENT_PATCHES = {
    # the HLS of every pixel, summed a thread, no plane stored
    "hls": [(_HLS_LOOP, "  int acc = 0;\n" + _HLS_LOOP),
            (_HLS_STORE, "    acc += h + l + s;\n  }\n  out[tid] = acc;\n"
             "  return;\n")],
    # the three-thread 5x5 sample on planes that were not written
    "sample": [(re.compile(re.escape(_HLS_LOOP) + r".*?"
                           + re.escape(_HLS_STORE), re.S), ""),
               (_SAMPLE_END, _SAMPLE_END + "  if (tid < 3) out[tid] = "
                "sm.lo[tid] + sm.hi[tid];\n  return;\n")],
    # inRange, dilate, erode and write-out on planes that were not written
    "close": [(re.compile(re.escape(_HLS_LOOP) + r".*?"
                          + re.escape(_SAMPLE_END), re.S),
               "  if (tid < 3) {\n    sm.lo[tid] = 0;\n    sm.hi[tid] = 128;"
               "\n  }\n  __syncthreads();\n")],
    # both histograms, each thread's two bins summed in place of keymax
    "hist": [("  for (int o = tid; o < kPix; o += kThreads) {\n"
              "    if (bcount[o] > 0) best = max(best, area2[o] * kPix + o);\n"
              "  }\n", "  best = bcount[tid] + area2[tid];\n")],
    # the zeroed bins scanned for keymax, no histogram
    "keymax": [(re.compile(r"  __syncthreads\(\);\n  for \(int i = tid; i < "
                           r"kPix; i \+= kThreads\) \{\n    const int o = "
                           r"own\[i\];.*?\n  \}\n  __syncthreads\(\);\n", re.S),
                "  __syncthreads();\n")],
}
_SWITCH = {"hls": ("K2_PHASES", 1), "sample": ("K2_PHASES", 2),
           "close": ("K2_PHASES", 3), "hist": ("K4_PHASES", 1),
           "keymax": ("K4_PHASES", 2)}


# another CTA shape, by text: each key's (file, text, replacement) pairs,
# the value put in for {n}; each text found once
SHAPES = {
    # threads of K2's CTA (one window a CTA unless k2_wins says more)
    "k2_threads": [("windows.cu", "constexpr int kThreads = 128;",
                    "constexpr int kThreads = {n};")],
    # windows of one K2 CTA, its warps split evenly (B * D a multiple)
    "k2_wins": [
        ("windows.cu", "__shared__ uint64_t words[winbits::kWin];",
         "__shared__ uint64_t words[{n} * winbits::kWin];"),
        ("windows.cu", "const int k = blockIdx.x;",
         "const int k = blockIdx.x * {n} + (threadIdx.x >> 5) / "
         "(kThreads / 32 / {n});"),
        ("windows.cu", "window_bits<kThreads / 32, 1>",
         "window_bits<kThreads / 32, {n}>"),
        ("windows.cu", "  windows_kernel<<<B * D,",
         "  if (B * D % {n}) return (int)cudaErrorInvalidValue;\n"
         "  windows_kernel<<<B * D / {n},")],
    # threads of the K4/K7 CTA
    "k4_threads": [("stats.cu", "constexpr int kThreads = 256;",
                    "constexpr int kThreads = {n};")],
}


def copy_dir(name: str, src: Path, out: Path) -> Path:
    """A fresh copy of the source directory ``src`` as ``out / name``."""
    d = out / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(src, d)
    return d


def patch_text(path: Path, pat, repl: str, what: str) -> None:
    """Replace the one match of ``pat`` (text or regex) in ``path``."""
    text = path.read_text()
    if isinstance(pat, str):
        n = text.count(pat)
        text = text.replace(pat, repl)
    else:
        text, n = pat.subn(lambda _: repl, text)
    if n != 1:
        raise ValueError(f"{path}: {what}: its text is found {n} times, "
                         "not once")
    path.write_text(text)


def shape_dir(name: str, src: Path, shape: str, out: Path) -> Path:
    """A copy of ``src`` patched to the CTA shape ``shape`` ("key=value,
    ...", keys of SHAPES)."""
    d = copy_dir(name, src, out)
    for item in shape.split(","):
        key, value = item.split("=")
        for fname, pat, repl in SHAPES[key]:
            patch_text(d / fname, pat, repl.replace("{n}", str(int(value))),
                       item)
    return d


def phase_dir(name: str, src: Path, phase: str, out: Path) -> Path:
    """A copy of the source directory ``src`` under ``out`` whose K2 or K4
    runs ``phase`` alone: the switch defined at the top of the kernel's
    .cu where its sources have it, else the parent's text patched."""
    d = copy_dir(f"{name}-{phase}", src, out)
    macro, value = _SWITCH[phase]
    kind = "win" if macro == "K2_PHASES" else "stats"
    cu = d / ENTRIES[kind][0]
    patched = d / ("window_bits.cuh" if kind == "win" else "stats.cu")
    if macro in patched.read_text():
        cu.write_text(f"#define {macro} {value}\n" + cu.read_text())
        return d
    for pat, repl in _PARENT_PATCHES[phase]:
        patch_text(patched, pat, repl, f"no {macro} switch, and not the "
                   f"parent kernel's text either ({phase})")
    return d


def build(label: str, src_dir: Path, kind: str):
    from meterelf_tpu_torch import _build

    fname, entries = ENTRIES[kind]
    return _build.build_source(src_dir / fname,
                               "ab_" + re.sub(r"\W", "_", label), entries)


def report_ptxas(label: str, lib) -> None:
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {label} ptxas: {line.strip().split('ptxas info    : ')[-1]}")


def report_sass(label: str, lib) -> None:
    """SASS instructions of the K2 and K4/K7 kernels by opcode
    (cuobjdump), where the toolkit has it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print(f"  {label} sass: cuobjdump not found")
        return
    r = subprocess.run([tool, "-sass", str(lib.path)], capture_output=True,
                       text=True, timeout=120)
    func, ops = None, {}
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            ops[func] = {}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if func and m:
            op = m.group(2)
            ops[func][op] = ops[func].get(op, 0) + 1
    for func, hist in ops.items():
        if not any(k in func for k in SASS_KERNELS):
            continue
        top = sorted(hist.items(), key=lambda kv: -kv[1])[:14]
        print(f"  {label} sass {func[:60]}: {sum(hist.values())} "
              f"instructions; {top}")


def report_ncu() -> None:
    """Whether ncu is on this machine, and the first lines it prints for
    a K2 and a K4 launch when it is."""
    tool = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not os.path.exists(tool):
        print("ncu: not found on this machine (no shared-memory wavefronts "
              "or stall reasons)")
        return
    try:
        r = subprocess.run(
            [tool, "--kernel-name", "regex:windows_kernel|stats_kernel",
             "--launch-count", "2", "--section", "WarpStateStats",
             "--section", "MemoryWorkloadAnalysis_Tables", sys.executable,
             os.path.abspath(__file__), "--ncu-child"],
            capture_output=True, text=True, timeout=120)
        print(f"ncu: exit {r.returncode}\n{r.stdout[-6000:]}\n"
              f"{r.stderr[-2000:]}")
    except subprocess.TimeoutExpired:
        print("ncu: timed out after 120 s")


def inputs(dev):
    """The flagship crops and, from the plain versions, every kernel's
    input and reference output."""
    import torch

    from meterelf_tpu_torch import synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.ops import components, frontend, stats, windows
    from meterelf_tpu_torch.pipeline.decode import MeterDecoder

    cam = synthetic.DEFAULT_CAMERA
    crops, _ = render(cam, B_MAIN, 1.7, 2.3)
    dec = MeterDecoder(cam.make_params(), device=dev)
    packed = torch.as_tensor(tio.pack_crops(crops)).to(dev)
    tmpl = dec.param_arrays.template_u8
    fe_ref = frontend.frontend_plain(packed, tmpl, dec.score_c1,
                                     dec.score_c0)
    mx, my = fe_ref[1], fe_ref[2]
    bits = windows.windows_plain(packed, mx, my, dec.geom, dec.disk,
                                 dec.hue_shift)
    flat = bits.reshape(-1, 64, 64)
    okey3 = components.propagate(flat)[0]
    okey = components.propagate(flat, pack_closed=False)[0]
    contrib = stats.cell_contrib(okey >> 2)
    return dict(dec=dec, packed=packed, tmpl=tmpl, mx=mx, my=my, bits=bits,
                fe_ref=fe_ref, okey3=okey3, okey=okey, contrib=contrib,
                stats_ref=stats.stats_plain(okey3),
                k7_ref=stats.stats_select_plain(okey, contrib))


def c_calls(kind: str, lib, x):
    """{kernel: (call of the C entry, its outputs)} of one build."""
    from meterelf_tpu_torch.ops import frontend, stats, windows

    dec = x["dec"]
    if kind == "win":
        a, bits = windows.c_args(x["packed"], x["mx"], x["my"], dec.geom,
                                 dec.disk, dec.hue_shift)
        return {"K2": (lambda: lib.meterelf_windows(*a), bits)}
    if kind == "stats":
        a4, out4 = stats.c_args(x["okey3"])
        a7, out7 = stats.c_args(x["okey"], x["contrib"])
        return {"K4": (lambda: lib.meterelf_stats(*a4), out4),
                "K7": (lambda: lib.meterelf_stats_select(*a7), out7)}
    fe = (x["packed"], x["tmpl"], dec.score_c1, dec.score_c0)
    a1, out1 = frontend.c_args(*fe)
    a5, out5 = frontend.c_args(*fe, dec.geom, dec.disk, dec.hue_shift)
    return {"K1": (lambda: lib.meterelf_frontend(*a1), out1),
            "K5": (lambda: lib.meterelf_frontend_windows(*a5), out5)}


def check_equal(label: str, kernel: str, out, x) -> None:
    import torch

    if kernel == "K2":
        ok = torch.equal(out, x["bits"])
    elif kernel == "K4":
        ok = (torch.equal(out[0], x["stats_ref"][0])
              and torch.equal(out[1], x["stats_ref"][1]))
    elif kernel == "K7":
        ok = torch.equal(out, x["k7_ref"])
    else:
        ref = x["fe_ref"]
        ok = (out[0].cpu().numpy().tobytes() == ref[0].cpu().numpy().tobytes()
              and torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2]))
        if kernel == "K5":
            ok = ok and torch.equal(out[3], x["bits"])
    if not ok:
        raise AssertionError(f"{label} {kernel}: differs from the plain "
                             "version")


def wrapper_call(kernel: str, lib, x):
    from meterelf_tpu_torch import _build
    from meterelf_tpu_torch.ops import stats, windows

    dec = x["dec"]

    def run():
        _build._LOADED[:] = [lib]
        if kernel == "K2":
            return windows.windows(x["packed"], x["mx"], x["my"], dec.geom,
                                   dec.disk, dec.hue_shift)
        if kernel == "K4":
            return stats.stats(x["okey3"])
        return stats.stats_select(x["okey"], x["contrib"])
    return run


def ncu_child() -> int:
    """One launch of each K2 and K4 build found in _build/ (for ncu)."""
    import ctypes

    import torch

    from meterelf_tpu_torch import _build

    dev = torch.device("cuda", 0)
    x = inputs(dev)
    for path in sorted(_build.BUILD_DIR.glob("libab_*.so")):
        if "_win" not in path.name and "_stats" not in path.name:
            continue
        kind = "win" if "_win" in path.name else "stats"
        lib = _build._bind(ctypes.CDLL(str(path)), ENTRIES[kind][1])
        for run, _ in c_calls(kind, lib, x).values():
            run()
    torch.cuda.synchronize()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR[:KEY=VALUE,...]",
                    help="another csrc/ directory of the same C interface, "
                    "or one patched to another CTA shape (SHAPES)")
    ap.add_argument("--split", action="store_true",
                    help="also time K2's and K4's phases alone")
    ap.add_argument("--ncu", action="store_true",
                    help="also try ncu on K2 and K4 (it did not run on the "
                    "card's machine: LibraryNotLoaded)")
    ap.add_argument("--ncu-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    from meterelf_tpu_torch import _build

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    if args.ncu_child:
        return ncu_child()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    out = _build.BUILD_DIR / "windows_ab"
    srcs = {"new": _build.CSRC}
    for v in args.variant:
        name, where = v.split("=", 1)
        path, _, shape = where.partition(":")
        srcs[name] = (shape_dir(name, Path(path), shape, out) if shape
                      else Path(path))
    jobs = {}      # label -> (source dir, kind, whole)
    for name, src in srcs.items():
        for kind in ENTRIES:
            jobs[f"{name}-{kind}"] = (src, kind, True)
        if args.split:
            for kind, phases in PHASES.items():
                for ph in phases:
                    jobs[f"{name}-{kind}-{ph}"] = (
                        phase_dir(name, src, ph, out), kind, False)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(build, k, d, kind)
                for k, (d, kind, _) in jobs.items()}
        libs = {k: f.result() for k, f in futs.items()}
    for label, lib in libs.items():
        print(f"{label}: built in {lib.build_seconds:.1f} s "
              f"from {jobs[label][0]}")
        report_ptxas(label, lib)
        if jobs[label][1] != "fe":
            report_sass(label, lib)

    x = inputs(dev)
    calls = {}      # (kernel, label, what) -> fn
    for label, lib in libs.items():
        src, kind, whole = jobs[label]
        for kernel, (run, res) in c_calls(kind, lib, x).items():
            if run() != 0:
                raise RuntimeError(f"{label} {kernel}: launch failed")
            torch.cuda.synchronize()
            if whole:
                check_equal(label, kernel, res, x)
            calls[(kernel, label, "kernel_ms")] = run
            if whole and kernel in ("K2", "K4", "K7"):
                w = wrapper_call(kernel, lib, x)
                got = w()
                check_equal(label, kernel, got, x)
                calls[(kernel, label, "ms")] = w
                calls[(kernel, label, "cold_ms")] = run
    _build._LOADED.clear()
    print("every whole build equal to the plain versions (K1, K2, K4, K5, "
          "K7; through the wrapper too for K2, K4, K7)")

    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    times = {k: [] for k in calls}
    labels = list(libs)
    for _ in range(ROUNDS):
        for order in (labels, labels[::-1]):
            for label in order:
                for key, fn in calls.items():
                    if key[1] == label:
                        times[key].append(
                            cold_ms(fn, REPS, flush) if key[2] == "cold_ms"
                            else cuda_ms(fn, REPS))
    _build._LOADED.clear()
    for (kernel, label, what), t in sorted(times.items()):
        print(f"{kernel} {label:22s} {what:9s} median {np.median(t):.6f} ms "
              f"min {np.min(t):.6f} max {np.max(t):.6f} runs "
              f"{np.round(t, 6).tolist()}")
    for name in srcs:
        k1 = times.get(("K1", f"{name}-fe", "kernel_ms"))
        k5 = times.get(("K5", f"{name}-fe", "kernel_ms"))
        d = np.array(k5) - np.array(k1)
        print(f"K5-K1 {name:22s} kernel_ms median {np.median(d):.6f} ms "
              f"min {d.min():.6f} max {d.max():.6f} runs "
              f"{np.round(d, 6).tolist()}")
    if args.ncu:
        report_ncu()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
