"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, with nothing built beforehand:

1. prints the card (torch and CUDA versions, nvidia-smi name and power
   limit); exits non-zero when no CUDA device is present;
2. builds the twelve CUDA kernels from meterelf_tpu_torch/csrc with nvcc
   and the host JPEG readers (io/native/*.c) with gcc; renders 256
   flagship, 64 ALT_CAMERA and 256 FIVE_DIAL_CAMERA frames and encodes
   flagship (64 distinct, tiled), ALT and five-dial (32 distinct, tiled)
   frames as quality-92 JPEGs with the port's encoder, plus a fallback
   batch: the flagship feed with 8 rows re-encoded 4:4:4 and 2 rows cut
   below the meter window; reads them with the host coefficient feed;
3. runs each kernel at the main paths' shapes (256 flagship crops and
   their 1024 dial windows; the flagship JPEG feed's compact planes for
   K10 and its block-branch planes for K11; the five-dial camera's 1280
   windows for K6; the flagship lightness maps for K8 and K9; K5 on the
   flagship crops, K7 on K6's okey of the flagship windows, K12 on K3's
   okey3 and K4's keymax of the flagship windows and on the needle
   regions of the flagship and five-dial windows) and holds it against
   its plain torch version on the same CUDA tensors: exact equality of
   every output (f32 and f64 outputs bitwise), and K5 against K1 then
   K2, K7's keymax against K4's, K9's v1 map against K8's; times both
   with CUDA events, and times the library yardstick where one PyTorch
   call computes the same function (K1's, K8's and K9's correlation as an
   fp32 conv2d, TF32 off); prints the int8 tensor-core instructions the
   correlation kernels (K1, K5, K8, K9) execute beside the MACs the
   function needs; for K3 and K6 counts the passes each window runs per
   phase (from the kernel's flags under single-phase caps, equal to the
   plain version's), bounds the work those passes need, times the kernel
   through its wrapper (``ms``, as every kernel) and over launches of its
   C entry alone (``kernel_ms``), and repeats all of it on the flagship
   crops with 1 % speckle; for K10 times its C entry alone too
   (``kernel_ms``; one launch at a time after a read that empties L2,
   ``cold_ms``) and prints the full IDCTs and single chroma rows an
   image its bands run beside the blocks the crop needs; holds K11 to its
   plain version also on random planes of the windows only it takes
   (``K11_WINDOWS``: past the valid chroma rows, past the valid chroma
   columns, 4,960 columns wide), times its C entry (``kernel_ms``,
   ``cold_ms``) and the whole block branch beside its plain IDCT; for
   K1, K2, K4, K5, K7 and K12 times the C entry alone too (``kernel_ms``;
   K2 and K12 also one launch at a time after a read that empties L2,
   ``cold_ms``)
   and prints K2's registers and shared memory and K5 - K1;
4. drives each path with every launch count reset to 0 first: the crop
   decode (MeterDecoder(device="cuda").decode_numpy) and the coefficient
   path (make_coef_decode_fn's step) of both cameras (quad branch), the
   general-geometry branch (FIVE_DIAL_CAMERA through decode_numpy and
   the coefficient step: K1, K2, K6, no K3/K4), the scorer-only branch
   (flagship crops with static_win_origin=None: K8, K2, K6) and the
   fallback batch (every frame loaded, the 4:4:4 rows in the fallback
   slots), the quad branch's decode variants (METERELF_FRONTEND=merged
   with METERELF_QUAD_STATS=hist_pallas through decode_numpy and the
   coefficient step: K5, K6, K7; merged with fused: K5, K3, K4) and the
   v1 scorer (match.match_scores_v1: K9): readings within 0.1 of the
   rendered positions, the first 16 rows equal to the CPU (plain
   versions), the variants equal to the default decode, the kernels of
   each path launched as the path requires (K12 once a decode on every
   path); the coefficient step's CUDA graph counters, a second flagship
   step replaying its two graphs (no capture), equal to the first and
   with K12 and K13 once; then a dense-noise window
   through the CCL kernel and through the hist_pallas variant's analysis
   (K6, K7), non-converged under the default caps and converged under the
   rescue caps, equal to the plain version both times;
5. prints the throughput of the paths (the four quad-branch variants
   timed in turns, split/merged x fused/hist_pallas), the host feed time
   with fallback frames, and the device time of a steady batch of the
   quad, coefficient, general, scorer-only and merged + hist_pallas paths
   by kernel (torch.profiler) with the device busy share;
6. runs the CLI (``python3 -m meterelf_tpu_torch``) on the card over the
   ``write_params`` directories of the flagship and ALT: 256 distinct
   flagship and 64 ALT JPEG files and one of each error kind
   (CLI_ERRORS), at the CLI's default batch; the same files in process
   through ``get_meter_values`` (K1-K4 and K12 launched and no other kernel,
   readings within 0.1, images/s over the batches after the first,
   exact and fast); the CPU on a subset of every kind, exact,
   METERELF_EXACT=0 and DEBUG=1 (overlays written), byte-equal to the
   card; prints the CLI's process wall, its start-up alone and the
   OpenCV-exact match val's host time;
7. streams (meterelf_tpu_torch.stream): 64 rising flagship frames with
   capture stamps through stream_decode_bytes and stream_decode, card
   against CPU report for report; 11 batches of 256 JPEGs through
   stream_decode_bytes at 2 and 8 feed threads and 8 feed workers
   (images/s, busy share, readings within 0.1); the warm dispatches of
   the crop decode and the coefficient step under
   torch.cuda.set_sync_debug_mode("error"); the --watch daemon with a
   truncated file, files dropped while it runs, --state, --debug-http
   and --trace, then a run resumed from its --state; and calibrates
   (python3 -m meterelf_tpu_torch.calibration) over 64 flagship JPEGs at
   random offsets, card stdout equal to the CPU's;
8. runs the mesh (meterelf_tpu_torch.parallel.mesh) over every card:
   make_mesh(), the flagship crop batch through MeshDecoder and 64
   adversarial frames of tests/fuzz_frames.py as quality-92 JPEGs,
   tiled to 256, through MeshCoefStep with 8 fallback slots (negative,
   out of range, on either side of a shard boundary), each equal to the
   plain decoder bit for bit in every field, its aggregate equal to a
   numpy reduction and, bit for bit, to the same reduction over CPU
   replicas, the kernels launched once a device; the warm dispatches
   under set_sync_debug_mode("error"); the mesh against the plain path
   in turns (crop decode and coefficient step to numpy, 10 rounds);
   stream_decode_bytes over the mesh beside the plain stream; and the
   stream CLI with --mesh all as a one-rank NCCL group
   (METERELF_DISTRIBUTED=1), its lines equal to METERELF_DEVICE=cpu
   --mesh 1's;
9. prints a JSON line of per-kernel results (launches from the
   coefficient path; K6's from the general branch, K8's from the
   scorer-only branch, K5's and K7's from the merged + hist_pallas crop
   decode, K9's from match_scores_v1; "mesh_launches" from the mesh
   phase's decode and step), the card, then, only if every phase
   passed, {"ok": true, "device": {...}} as the last line.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B_MAIN = 256      # decode batch on the card
B_ALT = 64        # ALT_CAMERA frames
N_DISTINCT = 64   # distinct flagship JPEGs, tiled to B_MAIN
N_FIVE = 32       # distinct FIVE_DIAL_CAMERA JPEGs, tiled to B_MAIN
FB_444 = tuple(range(1, 16, 2))   # feed rows re-encoded 4:4:4 (fallback)
FB_CUT = (2, 6)   # feed rows truncated below the meter window
N_CPU_CHECK = 16  # rows compared with the CPU decode
POS_TOL = 0.1     # reading vs rendered position (dial units)
ANGLE_TOL = 1e-9  # f64 dial positions, card vs CPU (one order of sums)
QUALITY = 92      # JPEG quality of the encoded frames
FRAME_WH = (640, 480)
FEED_THREADS = 8  # host entropy-decode threads
DEVICE = "cuda:0"
CLI_BATCH = 64    # get_meter_values' batch in process (the CLI's default)
CLI_CPU = 10      # flagship files the CLI reads again on the CPU
# the CPU runs of the CLI: a batch that holds the subset, and 2 threads
# each, as 4 run at once beside the card's
CLI_CPU_ENV = {"METERELF_DEVICE": "cpu", "METERELF_BATCH_SIZE": "16",
               "OMP_NUM_THREADS": "2"}
CLI_DEBUG = 8     # OK files the CLI reads again under DEBUG=1
# the CLI phase's error files: name -> what its line must say
CLI_ERRORS = {
    "stub": "UNKNOWN Cannot determine angle of a dial",
    "blind": "UNKNOWN Cannot find needle contours of a dial",
    "zeros": "UNKNOWN Dials not found (match val = 0.0)",
    "noise": "UNKNOWN Dials not found (match val = ",
    "garbage": "UNKNOWN Unable to load image",
    "missing": "UNKNOWN Unable to load image",
}

# the stream and calibration phases
N_SHORT = 64      # frames of the short stream, card against the CPU
B_SHORT = 16      # its batch
RISE_START = 123.4  # value of the first rising frame (litres, mod 1000)
RISE_STEP = 0.37    # litres a frame: steady flow, so the leak flag trips
FRAME_SECONDS = 60  # capture interval in the rising frames' names
T0 = 1792238400     # 2026-10-18 00:00:00 UTC, the first frame's stamp
N_BACKLOG = 16    # watch: files in the spool before the daemon starts
N_DRIP = 24       # watch: frames dropped, one at a time and in a cycle
#                   under new names, until the daemon's pages are read
DRIP_SECONDS = 0.1  # between dropped files (the daemon polls every 0.2 s)
N_RESUME = 8      # files of the second run, resumed from --state
N_RISE = N_SHORT + N_BACKLOG + N_DRIP + N_RESUME
B_LONG = 256      # the long stream's batch (the stream's default)
N_LONG = 11       # its batches: timed over 2-5, profiled over 6-9, and
#                   a last one, so that the profiled window feeds a batch
LONG_TIMED = (1, 5)      # reports whose stamps bound the timed batches
LONG_PROFILED = (5, 9)   # reports whose stamps bound the profiled ones
N_CAL = 64        # calibration frames at random offsets
N_FUZZ = 64       # mesh phase: distinct fuzz JPEGs, tiled to B_MAIN
FUZZ_SEED = 2027  # their tests/fuzz_frames.py seed (the slots' is +1)
MESH_ROUNDS = 10  # mesh phase: rounds of the in-turn timings
# the coefficient step's CUDA graph counters (pipeline/graphs.py)
GRAPH_COUNTERS = ("step_graph_captures", "step_graph_replays")

# Rates of the bounds (NVIDIA H100 SXM at 700 W): HBM3 and the dense int8
# tensor-core and fp32 peaks of NVIDIA's H100 SXM specification. int32:
# the CUDA C++ Programming Guide's arithmetic-instruction throughput table
# gives compute capability 9.0 64 results per clock per SM for 32-bit
# integer add, shift, compare and logic, and 64 for 32-bit multiply-add,
# which issues on the FP32 pipe beside them; the bound takes both full,
# 128 per clock on 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9

REPLACES = {
    "frontend": "meterelf_tpu/ops/pallas_frontend.py:416",
    "windows": "meterelf_tpu/ops/pallas_windows.py:241",
    "ccl": "meterelf_tpu/ops/pallas_ccl.py:501",
    "stats": "meterelf_tpu/ops/pallas_stats.py:247",
    "backhalf_planes": "meterelf_tpu/ops/pallas_jpeg.py:308",
    "upsample_color_pack": "meterelf_tpu/ops/pallas_jpeg.py:387",
    "propagate": "meterelf_tpu/ops/pallas_ccl.py:439",
    "match_scores": "meterelf_tpu/ops/pallas_match2.py:118",
    "frontend_windows": "meterelf_tpu/ops/pallas_frontend.py:478",
    "stats_select": "meterelf_tpu/ops/pallas_stats.py:304",
    "match_corr": "meterelf_tpu/ops/pallas_match.py:109",
    # no Pallas kernel: XLA ops of read_dial_from_okey and assemble_value
    "readout": "meterelf_tpu/ops/angles.py:read_dial_from_okey "
               "+ assemble_value (plain graph)",
    # no Pallas kernel: XLA ops of _decode_batch's error priority
    "result_pack": "meterelf_tpu/pipeline/decode.py:_decode_batch error "
                   "codes + converged (plain graph)",
}
SOURCES = {k: f"meterelf_tpu_torch/csrc/{k}.cu" for k in REPLACES}
SOURCES["backhalf_planes"] = SOURCES["upsample_color_pack"] = (
    "meterelf_tpu_torch/csrc/jpeg.cu")
SOURCES["propagate"] = "meterelf_tpu_torch/csrc/ccl.cu"
SOURCES["match_scores"] = SOURCES["match_corr"] = (
    "meterelf_tpu_torch/csrc/match.cu")
SOURCES["frontend_windows"] = "meterelf_tpu_torch/csrc/frontend.cu"
SOURCES["stats_select"] = "meterelf_tpu_torch/csrc/stats.cu"
SOURCES["readout"] = "meterelf_tpu_torch/csrc/angles.cu"
SOURCES["result_pack"] = "meterelf_tpu_torch/csrc/result.cu"


def say(*a: object) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def speckle(crops: np.ndarray) -> np.ndarray:
    """The crops with 1 % of their pixels set to red (seed 3): windows
    that need more label passes than the clean ones."""
    out = crops.copy()
    rng = np.random.default_rng(3)
    out[rng.random(out.shape[:3]) < 0.01] = (40, 40, 200)
    return out


def window_bits(dec, packed):
    """K1 then K2 on packed crops: the dial windows' bits [K, 64, 64]."""
    from meterelf_tpu_torch.ops import frontend, windows

    _, mx, my = frontend.frontend(packed, dec.param_arrays.template_u8,
                                  dec.score_c1, dec.score_c0)
    return windows.windows(packed, mx, my, dec.geom, dec.disk,
                           dec.hue_shift).reshape(-1, 64, 64)


def render(camera, n: int, step: float, spread: float):
    from meterelf_tpu_torch.synthetic import dial_positions

    pos = dial_positions(n, step, spread, len(camera.dial_specs))
    return camera.render_crops(pos), np.array(pos)


def encode_frames(camera, pos: np.ndarray, subsampling: str = "4:2:0"):
    """Full frames at the crop offsets of render_crops, as JPEG bytes."""
    from meterelf_tpu_torch.synthetic import encode_jpeg

    return [encode_jpeg(f, QUALITY, subsampling=subsampling)
            for f in camera.render_frames(pos.tolist())]


def tiled_jpegs(camera, pos: np.ndarray, n_distinct: int, n: int):
    """The JPEGs of the first n_distinct frames of pos, and the list of n
    that tiles them (a batch)."""
    jpegs = encode_frames(camera, pos[:n_distinct])
    return jpegs, [jpegs[i % n_distinct] for i in range(n)]


def write_cli_files(camera, jpegs, d: str) -> list:
    """The JPEG files of the CLI phase in directory d: ``jpegs`` as
    f000.jpg, ... then the error files of CLI_ERRORS (a stubbed dial, a
    blind dial, an all-zero frame, dark noise, garbage bytes, a missing
    path), all frames encoded at QUALITY by the port's encoder."""
    from meterelf_tpu_torch.synthetic import blind_dial, encode_jpeg

    rng = np.random.default_rng(17)
    off = (30, 40)
    stub = camera.render_frame([1.0, 3.0, 5.0, 7.0], offset=off,
                               stub_dials=(1,))
    frames = {"stub": stub, "blind": blind_dial(stub, camera, off, 1),
              "zeros": np.zeros_like(stub),
              "noise": rng.integers(0, 64, stub.shape, np.uint8)}
    blobs = [(f"f{i:03d}.jpg", data) for i, data in enumerate(jpegs)]
    blobs += [(f"{k}.jpg", encode_jpeg(f, QUALITY))
              for k, f in frames.items()]
    blobs.append(("garbage.jpg", rng.integers(0, 256, 4000, np.uint8)
                  .tobytes()))
    files = []
    for name, data in blobs:
        files.append(os.path.join(d, name))
        with open(files[-1], "wb") as fp:
            fp.write(data)
    return files + [os.path.join(d, "missing.jpg")]


def start_cli(yml: str, files: list, **env: str) -> subprocess.Popen:
    """Start ``python3 -m meterelf_tpu_torch yml files...`` from the
    checkout, the CLI's knobs cleared and then set from ``env``."""
    return start_module("meterelf_tpu_torch", [yml, *files], **env)


def rising_positions(n: int, first: int = 0) -> np.ndarray:
    """Dial positions [n, 4] of frames first, first+1, ... whose value
    rises RISE_STEP litres a frame from RISE_START: the (0.0001, 0.001,
    0.01, 0.1) dials show value*10, value, value/10 and value/100, mod
    10."""
    v = RISE_START + RISE_STEP * np.arange(first, first + n)
    return np.stack([(v * 10) % 10, v % 10, (v / 10) % 10, (v / 100) % 10],
                    axis=1)


def stamp_name(i: int) -> str:
    """The file name of rising frame i: its capture time
    (YYYYMMDDHHMMSS, FRAME_SECONDS apart), as the stream reads it."""
    return time.strftime("%Y%m%d%H%M%S",
                         time.gmtime(T0 + FRAME_SECONDS * i)) + f"-{i:03d}.jpg"


def render_jpeg(task) -> bytes:
    """One frame of a synthetic camera as a QUALITY JPEG: task =
    (camera name in meterelf_tpu_torch.synthetic, positions, offset)."""
    from meterelf_tpu_torch import synthetic

    name, pos, offset = task
    cam = getattr(synthetic, name)
    frame = cam.render_frame([float(p) for p in pos],
                             offset=tuple(int(o) for o in offset))
    return synthetic.encode_jpeg(frame, QUALITY)


def rising_tasks(camera) -> list:
    """The render_jpeg tasks of the stream phase's N_RISE rising frames
    (offsets in a cycle), then of the N_CAL calibration frames (random
    positions and offsets, seed 2026)."""
    rng = np.random.default_rng(2026)
    (x0, y0), (x1, y1) = camera.meter_rect
    max_ox = (x1 - x0) - camera.template_w - 1
    max_oy = (y1 - y0) - camera.template_h - 1
    tasks = [("DEFAULT_CAMERA", p, (20 + (i % 3) * 7, 30 + (i % 5) * 5))
             for i, p in enumerate(rising_positions(N_RISE))]
    return tasks + [("DEFAULT_CAMERA", p, (int(rng.integers(0, max_ox)),
                                           int(rng.integers(0, max_oy))))
                    for p in rng.uniform(0, 10, (N_CAL, 4))]


def fuzz_jpegs(task) -> list:
    """tests/fuzz_frames.py's adversarial frames of a synthetic camera as
    QUALITY JPEGs: task = (camera name, n, seed)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from fuzz_frames import fuzz_frames

    from meterelf_tpu_torch import synthetic

    name, n, seed = task
    return [synthetic.encode_jpeg(f, QUALITY)
            for f in fuzz_frames(getattr(synthetic, name), n, seed)]


def start_render(tasks: list, workers: int, fn=render_jpeg):
    """Start fn (render_jpeg) over tasks in spawned processes that see no
    card (they start at the submission); returns the pool and the
    iterator of the results in order."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        pool = ProcessPoolExecutor(workers, mp.get_context("spawn"))
        return pool, pool.map(fn, tasks, chunksize=4)
    finally:
        if old is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


def device_rows(prof, reps: int) -> list:
    """(ms a rep, launches a rep, name) of every device activity of a
    torch.profiler run over reps repetitions, largest first."""
    found = []    # device kernels only: aten rows repeat their time
    for e in prof.key_averages():
        if str(e.device_type).endswith("CPU"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            found.append((us / reps / 1e3, e.count // reps, e.key))
    return sorted(found, reverse=True)


def start_module(module: str, args: list, **env: str) -> subprocess.Popen:
    """Start ``python3 -m module args...`` from the checkout with the
    METERELF_ knobs cleared and then set from ``env``."""
    e = {k: v for k, v in os.environ.items()
         if k != "DEBUG" and not k.startswith("METERELF_")}
    e.update(PYTHONPATH=ROOT, **env)
    return subprocess.Popen(
        [sys.executable, "-m", module, *args], env=e, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def cli_lines(proc, label: str) -> list:
    """The stdout lines of a finished CLI process; fails on a non-zero
    exit."""
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0,
          f"cli {label} exited {proc.returncode}: {err[-3000:]}")
    return out.splitlines()


def first_difference(a: list, b: list) -> str:
    """The first line where two outputs differ, for a failure message."""
    for x, y in zip(a, b):
        if x != y:
            return f": {x!r} != {y!r}"
    return f": {len(a)} lines != {len(b)}"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def circ_err(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs((a - b + 5.0) % 10.0 - 5.0)


def rows(res, n: int):
    return type(res)(*[v[:n] for v in res])


def to_numpy(res):
    return type(res)(*[v.cpu().numpy() for v in res])


def compare_results(gpu, cpu, label: str) -> None:
    """Decode results of the card vs the CPU plain versions: discrete
    fields exact, match_val bitwise, dial positions within ANGLE_TOL,
    value digits exact."""
    for f in ("err", "first_bad_dial", "unreadable_bits", "match_x",
              "match_y", "readable", "converged"):
        if not np.array_equal(getattr(gpu, f), getattr(cpu, f)):
            raise AssertionError(f"{label}: {f} differs")
    if not np.array_equal(gpu.match_val.view(np.uint32),
                          cpu.match_val.view(np.uint32)):
        raise AssertionError(f"{label}: match_val differs")
    rd = cpu.readable
    d = np.abs(np.where(rd, gpu.dial_pos - cpu.dial_pos, 0.0)).max()
    if d > ANGLE_TOL:
        raise AssertionError(f"{label}: dial_pos differs by {d}")
    ok = cpu.err == 0
    if not np.array_equal(np.floor(gpu.value[ok]), np.floor(cpu.value[ok])):
        raise AssertionError(f"{label}: value digits differ")
    lines_g = [f"{v:07.3f}" for v in gpu.value[ok]]
    lines_c = [f"{v:07.3f}" for v in cpu.value[ok]]
    if lines_g != lines_c:
        raise AssertionError(f"{label}: rendered values differ")


def check_readings(label: str, res, pos: np.ndarray) -> None:
    check((res.err == 0).all(), f"{label}: err {np.unique(res.err)}")
    check(res.converged.all(), f"{label}: not converged")
    e = circ_err(res.dial_pos, pos).max()
    say(f"{label}: max reading error {e:.4f} (limit {POS_TOL})")
    check(e < POS_TOL, f"{label}: reading error {e}")


def bound(nbytes: float, ops: float, ops_per_s: float,
          more_ops: tuple = ()) -> dict:
    """The least time of a kernel's work on the card (ms) and what bounds
    it: each input byte read once and each output byte written once over
    the HBM rate, against the operations over their type's peak rate
    (plus, for a kernel with work of two types, more_ops's (ops, rate)
    pairs, each type's time added)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s + sum(n / r for n, r in more_ops)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# int32 operations the JPEG back-half needs (each add, multiply, shift,
# compare or mask one; what the function needs, not what csrc/jpeg.cu
# executes). Per 8x8 block: 16 ISLOW butterflies of 62 (jidctint.c: 32
# adds, 12 multiplies, 2 shifts, then 8 rounding adds and 8 descale
# shifts), and per coefficient 1 dequantising multiply, 3 for the level
# shift and clamp, and 4 to unpack the compact wire (nibble, merge,
# sign). Per crop pixel: for each chroma plane 1 for its share of the
# vertical 3:1 column sum (one multiply-add per chroma column and output
# row) and 4 for the horizontal 3:1 filter and its rounding shift
# (jdsample.c); then 26 for colour, clamp and pack (jdcolor.c).
OPS_PER_BLOCK = 16 * 62 + (1 + 3) * 64
OPS_PER_BLOCK_COMPACT_UNPACK = 4 * 64
OPS_PER_PIXEL_TAIL = 2 * (1 + 4) + 26


def backhalf_blocks_needed(win) -> int:
    """The 8x8 blocks (luma and both chroma planes) that the crop's pixels
    depend on: the luma blocks under the crop, and the chroma blocks under
    its chroma rows and columns plus the one-sample filter halo, clamped
    at the valid chroma (the rest of the window is not needed)."""
    def span(lo: int, hi: int) -> int:
        return (hi >> 3) - (lo >> 3) + 1

    luma = (span(win.oy, win.oy + win.rh - 1)
            * span(win.ox, win.ox + win.rw - 1))
    chroma = (span(max((win.oy >> 1) - 1, 0),
                   min(((win.oy + win.rh - 1) >> 1) + 1, win.ch_valid - 1))
              * span(max((win.ox >> 1) - 1, 0),
                     min(((win.ox + win.rw - 1) >> 1) + 1, win.cw_valid - 1)))
    return luma + 2 * chroma


# K11 windows that K10 refuses (ops/jpegdec.backhalf_ok), as (rect (x0,
# y0, x1, y1), frame_wh, staging or None for the bare crop): a crop past
# the frame's valid chroma rows (frame 470 rows high, crop to row 476: the
# rows below chroma row 90 read it as their down neighbour), one past the
# valid chroma columns (frame 470 wide, crop to column 476), and a window
# 4,960 columns wide (too wide for K10's shared memory; 20 column tiles,
# staging rows and columns past the crop, pw = 2 mod 4)
K11_WINDOWS = {
    "past_chroma_rows": ((50, 300, 300, 476), (640, 470), None),
    "past_chroma_cols": ((300, 50, 476, 300), (470, 640), (252, 178)),
    "wide": ((18, 10, 4974, 70), (4976, 80), (64, 4958)),
}


def k11_window(name: str):
    """K11_WINDOWS[name] as (CoefWindow, staging)."""
    from meterelf_tpu_torch.ops import jpegdec
    from meterelf_tpu_torch.types import Rect

    (x0, y0, x1, y1), wh, pad_hw = K11_WINDOWS[name]
    win = jpegdec.coef_window(Rect((x0, y0), (x1, y1)), *wh)
    return win, pad_hw or (win.rh, win.rw)


def k11_random_planes(win, B: int, rng, dev, fill=None) -> list:
    """Spatial u8 planes for K11 on ``dev``: sy [B, lh, lw], scb and scr
    [B, lh/2, lw/2], uniform from ``rng``, or all ``fill``."""
    import torch

    lh, lw = 8 * win.lbh, 8 * win.lbw
    shapes = ((B, lh, lw), (B, lh // 2, lw // 2), (B, lh // 2, lw // 2))
    return [torch.as_tensor(
        np.full(s, fill, np.uint8) if fill is not None
        else rng.integers(0, 256, s, dtype=np.uint8)).to(dev)
        for s in shapes]


def cold_ms(fn, reps: int, flush) -> float:
    """Mean device time of fn() with the L2 cache emptied of its data
    (``flush``, a tensor several times the cache, read before each call:
    it leaves clean lines), events around each call."""
    import torch

    fn()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(reps)]
    for a, b in ev:
        flush.max()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in ev]))


# fp32 operations of K2's colour chain a window pixel (unpack, max, min,
# lightness, saturation, hue, scale, round, clamp), each IEEE division
# counted as one operation of the function; every pixel counted, though
# csrc/window_bits.cuh skips the saturation and hue where no lane of a
# warp needs them: the byte time bounds K2 either way
K2_FP32_OPS_PX = 30

# int32 operations one CCL pass needs (the function, not what csrc/ccl.cu
# executes): a label half-pass 15 a masked pixel (the 3x3 min and its
# select 9, each of the two segmented sweeps 3); an outside half-pass 128
# a 64-pixel row (on bit planes one int32 operation covers 32 pixels: any4
# 16, the row fill's six steps 60, the column fill's 48, the compare 4); a
# fill pass 10 an enclosed pixel; then 6 a pixel to read the bits and
# pack the key. Counted over the passes each window runs (ccl_passes).
CCL_OPS_LABEL_PX = 15
CCL_OPS_OUTSIDE_ROW = 128
CCL_OPS_FILL_PX = 10
CCL_OPS_PX = 6


def ccl_passes(propagate, bits) -> list:
    """Passes each window runs in each phase (labels, outside, fill) under
    the default caps, read from the converged flags of
    propagate(bits, caps): the labels converge within k passes iff the flag
    is set under caps (k, 0, 0) (a zero cap leaves its phase's flag set),
    the outside under (0, k, 0) (it reads no label), the fill under the
    rescue caps' label and outside passes and k; a window that does not
    converge within a cap runs the cap."""
    import torch
    from meterelf_tpu_torch.ops import components

    rl, ro, _ = components.RESCUE_CAPS
    phases = ((components.K_LABEL, lambda k: (k, 0, 0)),
              (components.K_OUTSIDE, lambda k: (0, k, 0)),
              (components.K_FILL, lambda k: (rl, ro, k)))
    out = []
    for cap, caps_of in phases:
        n = torch.full((bits.shape[0],), cap, dtype=torch.int64,
                       device=bits.device)
        for k in range(cap, 0, -1):
            n = torch.where(propagate(bits, caps_of(k))[1], k, n)
        out.append(n)
    return out


def ccl_ops_needed(bits, passes: list, owner) -> int:
    """The int32 operations of CCL_OPS_* over the passes each window runs;
    the enclosed pixels are the non-masked ones that the fill gave an
    owner under the rescue caps (``owner``): every enclosed hole borders
    a masked pixel, since the window's edge lies off the disk."""
    masked = (bits & 1) != 0
    enclosed = (~masked & (owner < 64 * 64)).flatten(1).sum(1)
    n_lab, n_out, n_fill = passes
    return (int((n_lab * masked.flatten(1).sum(1)).sum()) * CCL_OPS_LABEL_PX
            + int(n_out.sum()) * 64 * CCL_OPS_OUTSIDE_ROW
            + int((n_fill * enclosed).sum()) * CCL_OPS_FILL_PX
            + bits.numel() * CCL_OPS_PX)


def histogram(n) -> dict:
    import torch

    k, c = torch.unique(n, return_counts=True)
    return {int(a): int(b) for a, b in zip(k.tolist(), c.tolist())}


def corr_mma(H: int, W: int, th: int, tw: int) -> int:
    """mma.sync.m16n8k32 instructions the tensor-core correlation
    (csrc/corr_mma.cuh) executes for one image: 16-wide x tiles times
    8-high y tiles, times th template rows, times the k32 steps of each
    x tile's band, ceil((tw + 15) / 32)."""
    oh, ow = H - th + 1, W - tw + 1
    return -(-ow // 16) * -(-oh // 8) * th * -(-(tw + 15) // 32)


def profile_ms(label: str, fn, reps: int = 5) -> None:
    """Device time by kernel over reps steady calls of fn
    (torch.profiler): the largest twelve and every kernel of the port's
    own, and the device busy share against their wall time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / reps
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = device_rows(prof, reps)
    n_ops = sum(e.count for e in prof.key_averages()
                if str(e.device_type).endswith("CPU")
                and e.key.startswith("aten::"))
    busy = sum(r[0] for r in found)
    say(f"profile {label} (B={B_MAIN}): wall {wall_ms:.3f} ms/batch, device "
        f"busy {busy:.3f} ms/batch ({100 * busy / wall_ms:.1f}%), "
        f"{sum(r[1] for r in found)} kernels and {n_ops // reps} aten "
        "ops per batch")
    # the 12 largest, and the port's own kernels wherever they rank
    for i, (ms, n, key) in enumerate(found):
        if i < 12 or "(anonymous namespace)::" in key:
            say(f"  {ms:8.4f} ms  x{n:<3d} {key[:90]}")


def main() -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    import torch

    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    say(f"card: {card}")

    import torch.nn.functional as F

    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.ops import angles, components, frontend
    from meterelf_tpu_torch.ops import jpeg_tail, jpegdec, match, stats
    from meterelf_tpu_torch.ops import result as result_ops
    from meterelf_tpu_torch.ops import ccl as ccl_ops
    from meterelf_tpu_torch.ops import windows as win_ops
    from meterelf_tpu_torch.ops.color import (lightness_from_planes,
                                              unpack_planes)
    from meterelf_tpu_torch.ops.frontend import locate
    from meterelf_tpu_torch.pipeline.decode import (MeterDecoder,
                                                    make_coef_decode_fn)

    t0 = time.perf_counter()
    lib = _build.library()
    say(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {lib.build_seconds:.1f} s) -> {lib.path.name}")
    entry = ""
    state = {"k2_ptxas": "ptxas: not in the build log (library built "
                         "earlier)"}
    for line in lib.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            say("  ptxas:", line.strip().split("ptxas info    : ")[-1])
        entry = line if "Compiling entry" in line else entry
        if "Used" in line and "windows_kernel" in entry:
            state["k2_ptxas"] = "ptxas: " + line.split("Used")[-1].strip()
    t0 = time.perf_counter()
    _build.host_jpeg()
    say(f"host JPEG readers (gcc): {time.perf_counter() - t0:.1f} s")

    dev = torch.device(DEVICE)
    failures = []
    results = {k: {"name": k, "route": "cuda", "source": SOURCES[k],
                   "replaces": REPLACES[k], "library_ms": None}
               for k in REPLACES}

    # the stream and calibration phases' JPEGs, in spawned processes
    # beside the renders below; joined before anything is timed
    t_rise = time.perf_counter()
    rise_pool, rise_jpegs = start_render(
        rising_tasks(synthetic.DEFAULT_CAMERA), FEED_THREADS)
    # the mesh phase's fuzz JPEGs and its fallback slots' frames
    fuzz_pool, fuzz_out = start_render(
        [("DEFAULT_CAMERA", N_FUZZ, FUZZ_SEED),
         ("DEFAULT_CAMERA", 8, FUZZ_SEED + 1)], 2, fuzz_jpegs)
    t0 = time.perf_counter()
    cam = synthetic.DEFAULT_CAMERA
    crops, true_pos = render(cam, B_MAIN, 1.7, 2.3)
    alt = synthetic.ALT_CAMERA
    alt_crops, alt_pos = render(alt, B_ALT, 2.1, 1.3)
    five = synthetic.FIVE_DIAL_CAMERA
    five_crops, five_pos = render(five, B_MAIN, 1.3, 1.9)
    say(f"rendered {B_MAIN} flagship + {B_ALT} ALT + {B_MAIN} five-dial "
        f"crops in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    flag_jpegs, datas = tiled_jpegs(cam, true_pos, N_DISTINCT, B_MAIN)
    alt_jpegs = encode_frames(alt, alt_pos)
    five_jpegs, five_datas = tiled_jpegs(five, five_pos, N_FIVE, B_MAIN)
    # the fallback batch: rows FB_444 re-encoded 4:4:4 (the coefficient
    # reader rejects them: they go to the fallback slots), rows FB_CUT cut
    # below the meter window (its general reader reads them)
    fb_datas = list(datas)
    for i, d in zip(FB_444, encode_frames(cam, true_pos[list(FB_444)],
                                          "4:4:4")):
        fb_datas[i] = d
    for i in FB_CUT:
        fb_datas[i] = datas[i][:int(len(datas[i]) * 0.95)]
    say(f"encoded {N_DISTINCT} flagship + {B_ALT} ALT + {N_FIVE} five-dial "
        f"+ {len(FB_444)} 4:4:4 frames ({FRAME_WH[0]}x{FRAME_WH[1]}, "
        f"quality {QUALITY}) in {time.perf_counter() - t0:.1f} s: "
        f"{np.mean([len(d) for d in flag_jpegs]):.0f} and "
        f"{np.mean([len(d) for d in alt_jpegs]):.0f} bytes/frame; "
        f"flagship and five-dial tiled to {B_MAIN}")
    with rise_pool:
        jpegs = list(rise_jpegs)
    say(f"rendered and encoded {N_RISE} rising + {N_CAL} calibration "
        f"flagship frames in {FEED_THREADS} processes beside the above: "
        f"{time.perf_counter() - t_rise:.1f} s from their start")
    state["rise"] = ([stamp_name(i) for i in range(N_RISE)],
                     jpegs[:N_RISE], rising_positions(N_RISE))
    state["cal"] = jpegs[N_RISE:]

    dec = MeterDecoder(cam.make_params(), device=dev)
    alt_dec = MeterDecoder(alt.make_params(), device=dev)
    pa = dec.param_arrays
    packed = torch.as_tensor(tio.pack_crops(crops)).to(dev)
    step, win, pad_hw = make_coef_decode_fn(dec, FRAME_WH)
    alt_step, alt_win, alt_pad = make_coef_decode_fn(alt_dec, FRAME_WH)
    five_dec = MeterDecoder(five.make_params(), device=dev)
    five_step, _, five_pad = make_coef_decode_fn(five_dec, FRAME_WH)
    five_packed = torch.as_tensor(tio.pack_crops(five_crops)).to(dev)
    # the scorer-only branch: the flagship with static_win_origin=None
    sc_dec = MeterDecoder(cam.make_params(), device=dev)
    sc_dec.static_kwargs["static_win_origin"] = None
    # the quad branch's decode variants (METERELF_FRONTEND x
    # METERELF_QUAD_STATS), the default decoder being split + fused
    variants = {(fe, qs): MeterDecoder(cam.make_params(), device=dev,
                                       frontend=fe, quad_stats=qs)
                for fe in ("split", "merged")
                for qs in ("fused", "hist_pallas")
                if (fe, qs) != ("split", "fused")}
    variants[("split", "fused")] = dec

    def phase(name, fn) -> None:
        t = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, fail at the end
            failures.append(name)
            say(f"FAIL {name}:\n{traceback.format_exc()}")
        say(f"phase {name}: {time.perf_counter() - t:.1f} s")

    # read before each cold launch: 5x the L2 cache
    state["flush"] = torch.zeros(1 << 28, dtype=torch.uint8, device=dev)

    # ---- host coefficient feed ----
    def host_feed() -> None:
        t = time.perf_counter()
        reps = 3
        for _ in range(reps):
            feed = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH,
                                      pad_hw, num_threads=FEED_THREADS)
        per = (time.perf_counter() - t) / reps
        alt_feed = tio.load_coef_feed(alt_jpegs, alt.meter_rect, FRAME_WH,
                                      alt_pad, num_threads=FEED_THREADS)
        block = tio.load_coef_feed_shard(
            datas, tuple(win), False, cam.meter_rect, FRAME_WH, pad_hw,
            num_threads=FEED_THREADS)
        for label, f in (("flagship", feed), ("alt", alt_feed),
                         ("flagship block", block)):
            check(f[4].all(), f"{label}: frames not loaded "
                  f"{np.nonzero(~f[4])[0].tolist()}")
        wire = sum(a[0].nbytes for a in feed[:3])
        say(f"host feed: load_coef_feed {per * 1e3:.3f} ms/batch of "
            f"{B_MAIN} ({FEED_THREADS} threads, {B_MAIN / per:.0f} frames/s);"
            f" layout {feed[0].dtype} {feed[0].shape[1:]}, {wire} B of "
            f"coefficients + {feed[3][0].nbytes} B of quant tables a frame "
            "to the card; every frame loaded (both cameras, both layouts)")
        state["feed"], state["alt_feed"], state["block"] = (feed, alt_feed,
                                                            block)
        state["feed_dev"] = [torch.as_tensor(a).to(dev) for a in feed[:5]]

    phase("host feed", host_feed)

    # ---- phase 3: each kernel vs its plain version on the card ----
    def k1() -> None:
        args = (packed, pa.template_u8, dec.score_c1, dec.score_c0)
        got = frontend.frontend(*args)
        ref = frontend.frontend_plain(*args)
        torch.cuda.synchronize()
        mv_g, mv_r = got[0].cpu().numpy(), ref[0].cpu().numpy()
        err = max(float(np.abs(mv_g - mv_r).max()),
                  float((got[1] - ref[1]).abs().max()),
                  float((got[2] - ref[2]).abs().max()))
        results["frontend"]["max_abs_err"] = err
        check(np.array_equal(mv_g.view(np.uint32), mv_r.view(np.uint32)),
              "max_val not bitwise equal")
        check(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
              "mx/my differ")
        state["mx"], state["my"] = got[1], got[2]
        results["frontend"]["ms"] = cuda_ms(
            lambda: frontend.frontend(*args), 10)
        c_args, c_out = frontend.c_args(*args)
        check(lib.meterelf_frontend(*c_args) == 0, "C entry: launch failed")
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(c_out, got)),
              "C entry differs from the wrapper")
        results["frontend"]["kernel_ms"] = cuda_ms(
            lambda: lib.meterelf_frontend(*c_args), 10)
        results["frontend"]["plain_ms"] = cuda_ms(
            lambda: frontend.frontend_plain(*args), 3)
        # yardstick: the correlation alone as one fp32 convolution (exact:
        # every partial sum is an integer below 2^24), TF32 off
        torch.backends.cudnn.allow_tf32 = False
        lp = (lightness_from_planes(*unpack_planes(packed)) - 128).to(
            torch.float32)[:, None]
        tp = (pa.template_u8.to(torch.float32) - 128)[None, None]
        results["frontend"]["library_ms"] = cuda_ms(
            lambda: F.conv2d(lp, tp), 10)
        B, H, W = packed.shape
        th, tw = pa.template_u8.shape
        macs = B * (H - th + 1) * (W - tw + 1) * th * tw
        results["frontend"].update(bound(
            packed.numel() * 4 + th * tw + 12 * B, 2 * macs,
            INT8_TC_OPS_PER_S))
        n_mma = B * corr_mma(H, W, th, tw)
        say(f"correlation (K1, K5, K8, K9; B={B}, {H}x{W} crop, {th}x{tw} "
            f"template): {n_mma} mma.sync.m16n8k32 = {n_mma * 4096 / 1e9:.3f}"
            f" G int8 MACs executed, {n_mma * 4096 / macs:.3f}x the "
            f"function's {macs / 1e9:.3f} G")

    def k2() -> None:
        args = (packed, state["mx"], state["my"], dec.geom, dec.disk,
                dec.hue_shift)
        got = win_ops.windows(*args)
        ref = win_ops.windows_plain(*args)
        results["windows"]["max_abs_err"] = float((got - ref).abs().max())
        check(torch.equal(got, ref), "bits differ")
        state["bits"] = got.reshape(-1, 64, 64)
        results["windows"]["ms"] = cuda_ms(lambda: win_ops.windows(*args), 20)
        # the C entry alone: back to back (kernel_ms; the windows' pixels
        # stay in L2) and after a read that empties L2 (cold_ms: a decode)
        c_args, c_out = win_ops.c_args(*args)
        check(lib.meterelf_windows(*c_args) == 0, "C entry: launch failed")
        torch.cuda.synchronize()
        check(torch.equal(c_out, ref), "C entry: bits differ")
        results["windows"]["kernel_ms"] = cuda_ms(
            lambda: lib.meterelf_windows(*c_args), 20)
        results["windows"]["cold_ms"] = cold_ms(
            lambda: lib.meterelf_windows(*c_args), 20, state["flush"])
        results["windows"]["plain_ms"] = cuda_ms(
            lambda: win_ops.windows_plain(*args), 5)
        # window pixels read, bits written; K2_FP32_OPS_PX a window pixel
        px = got.numel()
        results["windows"].update(bound(
            px * 4 + px * 4 + dec.disk.numel() + 8 * packed.shape[0],
            K2_FP32_OPS_PX * px, FP32_OPS_PER_S))
        say(f"K2: wrapper {results['windows']['ms']} ms, C entry "
            f"{results['windows']['kernel_ms']} ms (L2 emptied first "
            f"{results['windows']['cold_ms']} ms); {state['k2_ptxas']}")

    def ccl_case(label: str, name: str, kernel, bits) -> dict:
        """K3 (``ccl``) or K6 (``propagate``) on window bits: bit-equal to
        the plain version, the passes each window runs per phase (equal to
        the plain version's, printed as histograms), the wrapper's time
        (``ms``) and the device time over back-to-back launches of the C
        entry alone (``kernel_ms``: no bool cast, no host work), and the
        bound of the work these passes need."""
        pack_closed = name == "ccl"

        def plain(b, caps=None):
            return components.propagate(b, caps, pack_closed=pack_closed)

        ok_g, cv_g = kernel(bits)
        ok_r, cv_r = plain(bits)
        check(torch.equal(ok_g, ok_r), f"{label}: okey differs")
        check(torch.equal(cv_g, cv_r), f"{label}: converged differs")
        passes = ccl_passes(kernel, bits)
        check(all(torch.equal(a, b)
                  for a, b in zip(passes, ccl_passes(plain, bits))),
              f"{label}: passes differ from the plain version's")
        owner = kernel(bits, components.RESCUE_CAPS)[0] >> (
            3 if pack_closed else 2)
        K = bits.shape[0]
        okey = torch.empty_like(bits)
        conv = torch.empty(K, dtype=torch.uint8, device=dev)
        entry = getattr(lib, f"meterelf_{name}")
        args = ccl_ops.c_args(bits, None, okey, conv)
        check(entry(*args) == 0, f"{label}: launch failed")
        r = {"max_abs_err": float((ok_g - ok_r).abs().max()),
             "ms": cuda_ms(lambda: kernel(bits), 20),
             "kernel_ms": cuda_ms(lambda: entry(*args), 20),
             **bound(bits.numel() * 8 + K,
                     ccl_ops_needed(bits, passes, owner), INT32_OPS_PER_S)}
        say(f"{label}: {K} windows, passes a window (labels, outside, "
            f"fill) {[histogram(n) for n in passes]} (equal to the plain "
            f"version's); wrapper {r['ms']} ms, C entry {r['kernel_ms']} "
            f"ms; bound {r['bound_ms']} ms ({r['bound_by']})")
        return r

    def k3() -> None:
        bits = state["bits"]
        results["ccl"].update(ccl_case("K3 flagship", "ccl", ccl_ops.ccl,
                                       bits))
        state["okey3"] = ccl_ops.ccl(bits)[0]
        results["ccl"]["plain_ms"] = cuda_ms(
            lambda: components.propagate(bits), 3)
        # the second input: the flagship crops with 1 % speckle, K1 + K2
        state["speckled_bits"] = window_bits(
            dec, torch.as_tensor(tio.pack_crops(speckle(crops))).to(dev))
        ccl_case("K3 speckled flagship", "ccl", ccl_ops.ccl,
                 state["speckled_bits"])

    def k4() -> None:
        okey3 = state["okey3"]
        km_g, ha_g = stats.stats(okey3)
        km_r, ha_r = stats.stats_plain(okey3)
        results["stats"]["max_abs_err"] = float((km_g - km_r).abs().max())
        check(torch.equal(km_g, km_r), "keymax differs")
        check(torch.equal(ha_g, ha_r), "has_any differs")
        state["keymax"] = km_g
        results["stats"]["ms"] = cuda_ms(lambda: stats.stats(okey3), 20)
        c_args, c_out = stats.c_args(okey3)
        check(lib.meterelf_stats(*c_args) == 0, "C entry: launch failed")
        torch.cuda.synchronize()
        check(torch.equal(c_out[0], km_r) and torch.equal(c_out[1], ha_r),
              "C entry differs from the plain version")
        results["stats"]["kernel_ms"] = cuda_ms(
            lambda: lib.meterelf_stats(*c_args), 20)
        results["stats"]["plain_ms"] = cuda_ms(
            lambda: stats.stats_plain(okey3), 5)
        # okey3 read, keymax/has_any written; ~8 int32 ops a pixel (the
        # 2x2 cell minimum and its corner count)
        px = okey3.numel()
        results["stats"].update(bound(px * 4 + 5 * okey3.shape[0], 8 * px,
                                      INT32_OPS_PER_S))

    def k12() -> None:
        """K12 on the flagship windows' okey3 and keymax (K3, K4), and on
        the needle regions (K6 and the sort selection) of the flagship
        and five-dial windows: the wrapper and the C entry bit-equal to
        the plain angle stage; on the okey3 gather the wrapper and the C
        entry timed, warm and after a read that empties L2."""
        D = len(dec.geom)
        src = state["okey3"].reshape(B_MAIN, D, -1)
        km = state["keymax"].reshape(B_MAIN, D)

        def same(a, b) -> bool:   # floats bit for bit
            def bits(t):
                return t.view(torch.int64) if t.is_floating_point() else t
            return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))

        def held(label, src, km, p) -> float:
            got = angles.readout(src, km, p)
            c_args, c_out = angles.c_args(src, km, p)
            check(lib.meterelf_readout(*c_args) == 0,
                  f"{label}: C entry launch failed")
            ref = angles.readout_plain(src, km, p)
            torch.cuda.synchronize()
            check(same(got, ref), f"{label}: positions, readable or values "
                  "differ from the plain version")
            check(same(c_out, ref), f"{label}: C entry differs from the "
                  "plain version")
            return max(float((got[0] - ref[0]).abs().max()),
                       float((got[2] - ref[2]).abs().max()))

        errs = [held("okey3 gather, flagship", src, km, pa)]
        for label, d, wbits in (("flagship", dec, state["bits"]),
                               ("five-dial", five_dec, state["five_bits"])):
            region = ccl_ops.analyze_batch(
                wbits, d.static_kwargs["static_bbox"]).needle_region
            shape = (B_MAIN, len(d.geom), -1)
            errs.append(held(f"region gather, {label} {shape[:2]}",
                             region.reshape(shape), None, d.param_arrays))
        results["readout"]["max_abs_err"] = max(errs)
        results["readout"]["ms"] = cuda_ms(
            lambda: angles.readout(src, km, pa), 20)
        c_args, _ = angles.c_args(src, km, pa)
        results["readout"]["kernel_ms"] = cuda_ms(
            lambda: lib.meterelf_readout(*c_args), 20)
        results["readout"]["cold_ms"] = cold_ms(
            lambda: lib.meterelf_readout(*c_args), 20, state["flush"])
        results["readout"]["plain_ms"] = cuda_ms(
            lambda: angles.readout_plain(src, km, pa), 5)
        # the okey3 pixels the slots gather (the annulus lies in the disk:
        # each pixel once) and keymax read, the geometry read once, the
        # positions, readable flags and values written; its f64 adds take
        # far less
        host = dec.params.arrays()
        px = sum(len(np.union1d(host.disk_idx[d][host.disk_valid[d]],
                                host.ann_idx[d][host.ann_valid[d]]))
                 for d in range(D))
        geom = sum(getattr(host, k).nbytes for k in host._fields
                   if k.startswith(("disk_", "ann_"))
                   or k in ("neg_sign", "zero_turn"))
        results["readout"].update(bound(
            B_MAIN * (px * 4 + D * 4) + geom + B_MAIN * (D * 9 + 8), 0,
            INT32_OPS_PER_S))
        say(f"K12: wrapper {results['readout']['ms']} ms, C entry "
            f"{results['readout']['kernel_ms']} ms (L2 emptied first "
            f"{results['readout']['cold_ms']} ms); {px} okey3 pixels an "
            f"image, geometry {geom} B; equal to plain on the okey3 gather "
            f"and on the flagship and five-dial regions")

    def k13() -> None:
        """K13 on the flagship decode's inputs (K1's match, K3's
        convergence, K4's has_any, K12's outputs; rows 5 and 9 not loaded,
        row 7's match NaN, row 11's at the threshold): the wrapper and the
        C entry bit-equal to the plain result stage, then timed, warm and
        after a read that empties L2."""
        D = len(dec.geom)
        max_val, mx, my = frontend.frontend(packed, pa.template_u8,
                                            dec.score_c1, dec.score_c0)
        max_val = max_val.clone()
        max_val[7] = float("nan")
        max_val[11] = dec._threshold
        okey3, conv = ccl_ops.ccl(state["bits"])
        keymax, has_any = stats.stats(okey3)
        out = angles.readout(okey3.reshape(B_MAIN, D, -1),
                             keymax.reshape(B_MAIN, D), pa)
        load_ok = torch.ones(B_MAIN, dtype=torch.bool, device=dev)
        load_ok[[5, 9]] = False
        args = (load_ok, max_val, mx, my, dec._threshold, has_any, conv,
                *out)
        got = result_ops.result_pack(*args)
        c_args, c_out = result_ops.c_args(*args)
        check(lib.meterelf_result_pack(*c_args) == 0,
              "K13 C entry: launch failed")
        ref = result_ops.result_pack_plain(*args)
        torch.cuda.synchronize()

        def bits(t):
            return t.view(torch.int64) if t.dtype == torch.float64 else (
                t.view(torch.int32) if t.is_floating_point() else t)

        for label, o in (("wrapper", got), ("C entry", c_out)):
            check(all(torch.equal(bits(a), bits(b)) for a, b in zip(o, ref)),
                  f"K13 {label} differs from the plain version")
        codes = sorted(set(got[0].tolist()))
        results["result_pack"]["max_abs_err"] = 0.0
        results["result_pack"]["ms"] = cuda_ms(
            lambda: result_ops.result_pack(*args), 20)
        results["result_pack"]["kernel_ms"] = cuda_ms(
            lambda: lib.meterelf_result_pack(*c_args), 20)
        results["result_pack"]["cold_ms"] = cold_ms(
            lambda: lib.meterelf_result_pack(*c_args), 20, state["flush"])
        results["result_pack"]["plain_ms"] = cuda_ms(
            lambda: result_ops.result_pack_plain(*args), 5)
        # the inputs read once (13 B a row, 11 B a dial, the value) and
        # the buffer written once
        nbytes = result_ops.layout(B_MAIN, D)[1]
        results["result_pack"].update(bound(
            B_MAIN * (13 + 11 * D + 8) + nbytes, 0, INT32_OPS_PER_S))
        say(f"K13: wrapper {results['result_pack']['ms']} ms, C entry "
            f"{results['result_pack']['kernel_ms']} ms (L2 emptied first "
            f"{results['result_pack']['cold_ms']} ms); buffer {nbytes} B; "
            f"error codes {codes}; equal to plain")

    def k10() -> None:
        fy, fcb, fcr, qt = state["feed_dev"][:4]
        args = (fy, fcb, fcr, qt, win, pad_hw)
        got = jpeg_tail.backhalf_planes(*args)
        ref = jpegdec.backhalf_planes_to_packed(*args)
        torch.cuda.synchronize()
        results["backhalf_planes"]["max_abs_err"] = float(
            (got - ref).abs().max())
        check(torch.equal(got, ref), "packed crops differ")
        results["backhalf_planes"]["ms"] = cuda_ms(
            lambda: jpeg_tail.backhalf_planes(*args), 20)
        # the C entry alone (no wrapper checks, no allocation): back to
        # back and after a read that empties L2 (cold_ms: a decode)
        c_args, c_out = jpeg_tail.backhalf_c_args(*args)
        entry = lib.meterelf_backhalf_planes
        check(entry(*c_args) == 0, "C entry: launch failed")
        torch.cuda.synchronize()
        check(torch.equal(c_out, ref), "C entry: packed crops differ")
        results["backhalf_planes"]["kernel_ms"] = cuda_ms(
            lambda: entry(*c_args), 20)
        results["backhalf_planes"]["cold_ms"] = cold_ms(
            lambda: entry(*c_args), 20, state["flush"])
        results["backhalf_planes"]["plain_ms"] = cuda_ms(
            lambda: jpegdec.backhalf_planes_to_packed(*args), 2)
        unpack = OPS_PER_BLOCK_COMPACT_UNPACK if fy.dtype == torch.int8 else 0
        ops = (fy.shape[0] * backhalf_blocks_needed(win)
               * (OPS_PER_BLOCK + unpack)
               + fy.shape[0] * win.rh * win.rw * OPS_PER_PIXEL_TAIL)
        nbytes = sum(t.numel() * t.element_size() for t in (fy, fcb, fcr, qt))
        results["backhalf_planes"].update(bound(
            nbytes + got.numel() * 4, ops, INT32_OPS_PER_S))
        bands, full, single = jpeg_tail.backhalf_bands(win)
        say(f"K10 input: {tuple(fy.shape)} {fy.dtype} + 2 x "
            f"{tuple(fcb.shape)}, output {tuple(got.shape)}; {bands} bands "
            f"an image: {full} full 8x8 IDCTs and {single} single chroma "
            f"rows an image, against {backhalf_blocks_needed(win)} blocks "
            f"the crop needs; wrapper {results['backhalf_planes']['ms']} "
            f"ms, C entry {results['backhalf_planes']['kernel_ms']} ms "
            f"(L2 emptied first {results['backhalf_planes']['cold_ms']} "
            "ms)")

    def k11() -> None:
        blocks = [torch.as_tensor(a).to(dev) for a in state["block"][:4]]
        sy, scb, scr = jpegdec.idct_planes(*blocks, win)
        args = (sy, scb, scr, win, pad_hw)
        got = jpeg_tail.upsample_color_pack(*args)
        ref = jpegdec.tail_to_packed(*args)
        torch.cuda.synchronize()
        results["upsample_color_pack"]["max_abs_err"] = float(
            (got - ref).abs().max())
        check(torch.equal(got, ref), "packed crops differ")
        k10_out = jpeg_tail.backhalf_planes(*state["feed_dev"][:4], win,
                                            pad_hw)
        check(torch.equal(got, k10_out),
              "block branch (plain IDCT + K11) differs from K10")
        # the windows only K11 takes, on random planes
        rng = np.random.default_rng(11)
        for name in K11_WINDOWS:
            kwin, kpad = k11_window(name)
            check(not jpegdec.backhalf_ok(kwin, kpad),
                  f"{name}: K10 takes the window")
            planes = k11_random_planes(kwin, 4, rng, dev)
            check(torch.equal(
                jpeg_tail.upsample_color_pack(*planes, kwin, kpad),
                jpegdec.tail_to_packed(*planes, kwin, kpad)),
                f"{name}: packed crops differ")
        results["upsample_color_pack"]["ms"] = cuda_ms(
            lambda: jpeg_tail.upsample_color_pack(*args), 20)
        # the C entry alone: back to back (kernel_ms; the planes stay in
        # L2) and after a read that empties L2 (cold_ms: a decode)
        c_args, c_out = jpeg_tail.upsample_c_args(*args)
        entry = lib.meterelf_upsample_color_pack
        check(entry(*c_args) == 0, "C entry: launch failed")
        torch.cuda.synchronize()
        check(torch.equal(c_out, ref), "C entry: packed crops differ")
        results["upsample_color_pack"]["kernel_ms"] = cuda_ms(
            lambda: entry(*c_args), 20)
        results["upsample_color_pack"]["cold_ms"] = cold_ms(
            lambda: entry(*c_args), 20, state["flush"])
        results["upsample_color_pack"]["plain_ms"] = cuda_ms(
            lambda: jpegdec.tail_to_packed(*args), 5)
        nbytes = sum(t.numel() for t in (sy, scb, scr)) + got.numel() * 4
        results["upsample_color_pack"].update(bound(
            nbytes, sy.shape[0] * win.rh * win.rw * OPS_PER_PIXEL_TAIL,
            INT32_OPS_PER_S))
        # the whole block branch, and its plain-torch IDCT alone
        branch_ms = cuda_ms(
            lambda: jpeg_tail.backhalf_blocks(*blocks, win, pad_hw), 5)
        idct_ms = cuda_ms(lambda: jpegdec.idct_planes(*blocks, win), 5)
        r = results["upsample_color_pack"]
        say(f"K11: wrapper {r['ms']} ms, C entry {r['kernel_ms']} ms (L2 "
            f"emptied first {r['cold_ms']} ms); equal to plain on the "
            f"flagship and {', '.join(K11_WINDOWS)}; block branch "
            f"(backhalf_blocks) {branch_ms} ms = plain IDCT (idct_planes) "
            f"{idct_ms} ms + K11")

    def k6() -> None:
        # the general branch's windows: FIVE_DIAL_CAMERA at B_MAIN, K1 + K2
        bits = window_bits(five_dec, five_packed)
        state["five_bits"] = bits
        results["propagate"].update(ccl_case(
            "K6 five-dial", "propagate", ccl_ops.propagate, bits))
        results["propagate"]["plain_ms"] = cuda_ms(
            lambda: components.propagate(bits, pack_closed=False), 3)
        ccl_case("K6 speckled flagship", "propagate", ccl_ops.propagate,
                 state["speckled_bits"])
        say(f"K6 input: {tuple(bits.shape)} windows "
            f"({B_MAIN} five-dial crops)")

    def k8() -> None:
        L = lightness_from_planes(*unpack_planes(packed)).to(torch.float32)
        args = (L, pa.template_u8, dec.tmean)
        got = match.match_scores(*args)
        ref = match.match_scores_plain(*args)
        torch.cuda.synchronize()
        g, r = got.cpu().numpy(), ref.cpu().numpy()
        results["match_scores"]["max_abs_err"] = float(np.abs(g - r).max())
        check(np.array_equal(g.view(np.uint32), r.view(np.uint32)),
              "scores not bitwise equal")
        results["match_scores"]["ms"] = cuda_ms(
            lambda: match.match_scores(*args), 10)
        results["match_scores"]["plain_ms"] = cuda_ms(
            lambda: match.match_scores_plain(*args), 3)
        # yardstick: the correlation alone as one fp32 convolution, TF32
        # off (sum L*T, without the box sum)
        torch.backends.cudnn.allow_tf32 = False
        tf = pa.template_u8.to(torch.float32)[None, None]
        results["match_scores"]["library_ms"] = cuda_ms(
            lambda: F.conv2d(L[:, None], tf), 10)
        B, H, W = L.shape
        th, tw = pa.template_u8.shape
        macs = B * got.shape[1] * got.shape[2] * th * tw
        results["match_scores"].update(bound(
            L.numel() * 4 + th * tw + got.numel() * 4, 2 * macs,
            INT8_TC_OPS_PER_S))

    def k5() -> None:
        args = (packed, pa.template_u8, dec.score_c1, dec.score_c0, dec.geom,
                dec.disk, dec.hue_shift)
        got = frontend.frontend_windows(*args)
        ref = frontend.frontend_windows_plain(*args)
        torch.cuda.synchronize()
        mv_g, mv_r = got[0].cpu().numpy(), ref[0].cpu().numpy()
        results["frontend_windows"]["max_abs_err"] = max(
            float(np.abs(mv_g - mv_r).max()),
            *(float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:])))
        check(np.array_equal(mv_g.view(np.uint32), mv_r.view(np.uint32)),
              "max_val not bitwise equal")
        check(all(torch.equal(a, b) for a, b in zip(got[1:], ref[1:])),
              "mx/my/bits differ from the plain version")
        # the split kernels' outputs (phases K1, K2) on the same crops
        check(torch.equal(got[1], state["mx"]) and torch.equal(
            got[2], state["my"]) and torch.equal(
                got[3].reshape(-1, 64, 64), state["bits"]),
              "K5 differs from K1 then K2")
        results["frontend_windows"]["ms"] = cuda_ms(
            lambda: frontend.frontend_windows(*args), 10)
        c_args, c_out = frontend.c_args(*args)
        check(lib.meterelf_frontend_windows(*c_args) == 0,
              "C entry: launch failed")
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(c_out, got)),
              "C entry differs from the wrapper")
        k5 = results["frontend_windows"]["kernel_ms"] = cuda_ms(
            lambda: lib.meterelf_frontend_windows(*c_args), 10)
        say(f"K5: C entry {k5} ms, K5 - K1 (C entries) "
            f"{k5 - results['frontend']['kernel_ms']} ms")
        results["frontend_windows"]["plain_ms"] = cuda_ms(
            lambda: frontend.frontend_windows_plain(*args), 3)
        B, H, W = packed.shape
        th, tw = pa.template_u8.shape
        macs = B * (H - th + 1) * (W - tw + 1) * th * tw
        px = got[3].numel()
        # K1's bytes and operations plus K2's: the bits written, the disk,
        # and K2's fp32 HLS work (the window pixels are re-read on chip)
        results["frontend_windows"].update(bound(
            packed.numel() * 4 + th * tw + 12 * B + px * 4 + dec.disk.numel(),
            2 * macs, INT8_TC_OPS_PER_S,
            ((K2_FP32_OPS_PX * px, FP32_OPS_PER_S),)))

    def k7() -> None:
        # K6's okey of the flagship windows (the hist_pallas variant's
        # input), contributions outside the kernel as the JAX graph makes
        bits = state["bits"]
        okey, _ = ccl_ops.propagate(bits)
        contrib = stats.cell_contrib(okey >> 2)
        got = stats.stats_select(okey, contrib)
        ref = stats.stats_select_plain(okey, contrib)
        results["stats_select"]["max_abs_err"] = float(
            (got - ref).abs().max())
        check(torch.equal(got, ref), "keymax differs from the plain version")
        check(torch.equal(got, state["keymax"]),
              "K7's keymax differs from K4's on the same windows")
        results["stats_select"]["ms"] = cuda_ms(
            lambda: stats.stats_select(okey, contrib), 20)
        c_args, c_out = stats.c_args(okey, contrib)
        check(lib.meterelf_stats_select(*c_args) == 0,
              "C entry: launch failed")
        torch.cuda.synchronize()
        check(torch.equal(c_out, ref), "C entry differs")
        results["stats_select"]["kernel_ms"] = cuda_ms(
            lambda: lib.meterelf_stats_select(*c_args), 20)
        results["stats_select"]["plain_ms"] = cuda_ms(
            lambda: stats.stats_select_plain(okey, contrib), 5)
        # okey and contrib read, keymax written; 4 int32 ops a pixel (the
        # owner shift and bound, the boundary and contribution masks)
        px = okey.numel()
        results["stats_select"].update(bound(
            px * 8 + 4 * okey.shape[0], 4 * px, INT32_OPS_PER_S))

    def k9() -> None:
        L = lightness_from_planes(*unpack_planes(packed)).to(torch.float32)
        tm = pa.template_u8
        got = match.match_corr(L, tm)
        ref = match.match_corr_plain(L, tm)
        torch.cuda.synchronize()
        g, r = got.cpu().numpy(), ref.cpu().numpy()
        results["match_corr"]["max_abs_err"] = float(np.abs(g - r).max())
        check(np.array_equal(g.view(np.uint32), r.view(np.uint32)),
              "corr not bitwise equal")
        v1 = match.match_scores_v1(L, tm, dec.tmean).cpu().numpy()
        k8 = match.match_scores(L, tm, dec.tmean).cpu().numpy()
        check(np.array_equal(v1.view(np.uint32), k8.view(np.uint32)),
              "match_scores_v1 differs from K8's map")
        results["match_corr"]["ms"] = cuda_ms(
            lambda: match.match_corr(L, tm), 10)
        results["match_corr"]["plain_ms"] = cuda_ms(
            lambda: match.match_corr_plain(L, tm), 3)
        torch.backends.cudnn.allow_tf32 = False
        tf = tm.to(torch.float32)[None, None]
        results["match_corr"]["library_ms"] = cuda_ms(
            lambda: F.conv2d(L[:, None], tf), 10)
        th, tw = tm.shape
        macs = L.shape[0] * got.shape[1] * got.shape[2] * th * tw
        results["match_corr"].update(bound(
            L.numel() * 4 + th * tw + got.numel() * 4, 2 * macs,
            INT8_TC_OPS_PER_S))
        state["L"] = L

    kernel_phases = (("frontend", k1), ("windows", k2), ("ccl", k3),
                     ("stats", k4), ("backhalf_planes", k10),
                     ("upsample_color_pack", k11), ("propagate", k6),
                     ("match_scores", k8), ("frontend_windows", k5),
                     ("stats_select", k7), ("match_corr", k9),
                     ("readout", k12), ("result_pack", k13))
    for name, fn in kernel_phases:
        phase(f"kernel {name}", fn)
        r = results[name]
        say(f"{name}: max_abs_err {r.get('max_abs_err')} "
            f"kernel {r.get('ms')} ms plain {r.get('plain_ms')} ms "
            f"library {r.get('library_ms')} ms bound {r.get('bound_ms')} ms "
            f"({r.get('bound_by')}) (B={B_MAIN})")
        if failures:
            break   # later kernels consume this one's output

    # ---- phase 4: the crop decode path and the coefficient path ----
    from meterelf_tpu_torch.profiling import counts as program_counts

    crop_kernels = (frontend.frontend, win_ops.windows, ccl_ops.ccl,
                    stats.stats, angles.readout, result_ops.result_pack)
    coef_kernels = crop_kernels + (jpeg_tail.backhalf_planes,
                                   jpeg_tail.upsample_color_pack)
    general_kernels = (ccl_ops.propagate, match.match_scores)
    variant_kernels = (frontend.frontend_windows, stats.stats_select,
                       match.match_corr)
    all_kernels = coef_kernels + general_kernels + variant_kernels

    def reset(fns) -> None:
        for fn in fns:
            fn.launches = 0

    def counts(fns) -> dict:
        return {fn.__name__: fn.launches for fn in fns}

    def check_readout(launches: dict, label: str) -> None:
        """K12 and K13 read each decode once: a decode launches K3 (fused)
        or K6 (every other branch) once, a rescue decodes again."""
        n = launches["ccl"] + launches["propagate"]
        check(n > 0 and launches["readout"] == n
              and launches["result_pack"] == n,
              f"{label}: K12 and K13 must launch once a decode: {launches}")

    def crop_run() -> None:
        dec.decode_numpy(crops[:8])   # warm-up (library, allocator)
        torch.cuda.synchronize()
        reset(all_kernels)
        t = time.perf_counter()
        res = dec.decode_numpy(crops)
        res_alt = alt_dec.decode_numpy(alt_crops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = counts(crop_kernels)
        say(f"crop decode path: {B_MAIN} flagship + {B_ALT} ALT crops in "
            f"{wall:.3f} s; launches {launches}")
        check_readout(counts(all_kernels), "crop decode path")
        check_readings("crop flagship", res, true_pos)
        check_readings("crop alt", res_alt, alt_pos)
        cpu_dec = MeterDecoder(cam.make_params(), device="cpu")
        cpu_alt = MeterDecoder(alt.make_params(), device="cpu")
        compare_results(rows(res, N_CPU_CHECK),
                        cpu_dec.decode_numpy(crops[:N_CPU_CHECK]),
                        "crop flagship vs CPU")
        compare_results(rows(res_alt, N_CPU_CHECK),
                        cpu_alt.decode_numpy(alt_crops[:N_CPU_CHECK]),
                        "crop alt vs CPU")
        say(f"first {N_CPU_CHECK} rows equal the CPU decode (both cameras)")
        check(all(n > 0 for n in launches.values()),
              f"a kernel of the crop path was not launched: {launches}")

    def cut(feed, n):
        return [a[:n] for a in feed[:5]] + list(feed[5:])

    def coef_run() -> None:
        feed, alt_feed, block = state["feed"], state["alt_feed"], \
            state["block"]
        step(None, *cut(feed, 8))     # warm-up
        torch.cuda.synchronize()
        reset(all_kernels)
        t = time.perf_counter()
        res = to_numpy(step(None, *feed))
        res_alt = to_numpy(alt_step(None, *alt_feed))
        res_blk = to_numpy(step(None, *block))
        wall = time.perf_counter() - t
        launches = counts(coef_kernels)
        for name, n in launches.items():
            results[name]["launches"] = n
        check(launches["readout"] == 3 and launches["result_pack"] == 3,
              f"K12 and K13 must read each of the 3 steps once: {launches}")
        check_readout(counts(all_kernels), "coefficient path")
        say(f"coefficient path: {B_MAIN} flagship + {B_ALT} ALT JPEG feeds "
            f"(compact planes) and {B_MAIN} flagship (block layout) in "
            f"{wall:.3f} s; launches {launches}")
        flag_pos = true_pos[np.arange(B_MAIN) % N_DISTINCT]
        check_readings("coef flagship", res, flag_pos)
        check_readings("coef alt", res_alt, alt_pos)
        check_readings("coef flagship block branch", res_blk, flag_pos)
        for f in res._fields:
            check(np.array_equal(getattr(res, f), getattr(res_blk, f)),
                  f"block branch differs from the compact feed in {f}")
        cpu_step, _, _ = make_coef_decode_fn(
            MeterDecoder(cam.make_params(), device="cpu"), FRAME_WH)
        cpu_alt, _, _ = make_coef_decode_fn(
            MeterDecoder(alt.make_params(), device="cpu"), FRAME_WH)
        compare_results(rows(res, N_CPU_CHECK),
                        to_numpy(cpu_step(None, *cut(feed, N_CPU_CHECK))),
                        "coef flagship vs CPU")
        compare_results(rows(res_alt, N_CPU_CHECK),
                        to_numpy(cpu_alt(None, *cut(alt_feed, N_CPU_CHECK))),
                        "coef alt vs CPU")
        say(f"first {N_CPU_CHECK} rows equal the CPU step (both cameras)")
        check(all(n > 0 for n in launches.values()),
              f"a kernel of the coefficient path was not launched: "
              f"{launches}")
        check(not any(counts(general_kernels + variant_kernels).values()),
              "the default quad branch launched K5-K9")
        # the step's CUDA graphs (pipeline/graphs.py): a second flagship
        # step of one shape replays its pair and captures nothing
        g0 = program_counts()
        reset(all_kernels)
        again = to_numpy(step(None, *feed))
        g1 = program_counts()
        graph = {k: g1.get(k, 0) - g0.get(k, 0) for k in GRAPH_COUNTERS}
        total = {k: g1.get(k, 0) for k in GRAPH_COUNTERS}
        say(f"coefficient path graphs: {total} so far; a second flagship "
            f"step {graph}")
        check(total["step_graph_captures"] > 0
              and graph == {"step_graph_captures": 0,
                            "step_graph_replays": 2},
              f"the second flagship step must replay its two graphs: "
              f"{graph}")
        check_readout(counts(all_kernels), "coefficient path, replayed")
        for f in res._fields:
            check(np.array_equal(getattr(res, f), getattr(again, f)),
                  f"the replayed step differs from the first in {f}")

    def general_run() -> None:
        """FIVE_DIAL_CAMERA (D = 5: the general-geometry branch, K1, K2,
        K6) through MeterDecoder and through make_coef_decode_fn."""
        five_dec.decode_numpy(five_crops[:8])       # warm-up
        torch.cuda.synchronize()
        reset(all_kernels)
        t = time.perf_counter()
        res = five_dec.decode_numpy(five_crops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = counts(all_kernels)
        results["propagate"]["launches"] = launches["propagate"]
        say(f"general branch, crops: {B_MAIN} five-dial crops in {wall:.3f} "
            f"s; launches {launches}")
        check_readings("general five-dial", res, five_pos)
        # K6 twice when a row needs the rescue
        check(launches["frontend"] == 1 and launches["windows"] == 1
              and launches["propagate"] in (1, 2)
              and launches["ccl"] == 0 and launches["stats"] == 0
              and launches["match_scores"] == 0,
              f"general branch launches {launches}")
        check_readout(launches, "general branch, crops")
        cpu = MeterDecoder(five.make_params(), device="cpu")
        compare_results(rows(res, N_CPU_CHECK),
                        cpu.decode_numpy(five_crops[:N_CPU_CHECK]),
                        "general five-dial vs CPU")
        feed = tio.load_coef_feed(five_datas, five.meter_rect, FRAME_WH,
                                  five_pad, num_threads=FEED_THREADS)
        check(feed[4].all(), "five-dial feed: frames not loaded")
        reset(all_kernels)
        res_c = to_numpy(five_step(None, *feed))
        launches = counts(all_kernels)
        say(f"general branch, coefficient step: {B_MAIN} five-dial JPEG "
            f"feeds; launches {launches}")
        check(launches["propagate"] == 1 and launches["backhalf_planes"] == 1
              and launches["ccl"] == 0 and launches["stats"] == 0,
              f"general coefficient step launches {launches}")
        check_readout(launches, "general branch, coefficient step")
        check_readings("general five-dial coef", res_c,
                       five_pos[np.arange(B_MAIN) % N_FIVE])
        cpu_step, _, _ = make_coef_decode_fn(cpu, FRAME_WH)
        compare_results(rows(res_c, N_CPU_CHECK),
                        to_numpy(cpu_step(None, *cut(feed, N_CPU_CHECK))),
                        "general five-dial coef vs CPU")
        say(f"first {N_CPU_CHECK} rows equal the CPU (crops and step)")

    def scorer_run() -> None:
        """The flagship crops down the scorer-only branch
        (static_win_origin=None: K8, locate, K2, K6)."""
        sc_dec.decode_numpy(crops[:8])              # warm-up
        torch.cuda.synchronize()
        reset(all_kernels)
        t = time.perf_counter()
        res = sc_dec.decode_numpy(crops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = counts(all_kernels)
        results["match_scores"]["launches"] = launches["match_scores"]
        say(f"scorer-only branch: {B_MAIN} flagship crops in {wall:.3f} s; "
            f"launches {launches}")
        check_readings("scorer-only flagship", res, true_pos)
        check(launches["match_scores"] == 1 and launches["frontend"] == 0
              and launches["propagate"] >= 1 and launches["ccl"] == 0,
              f"scorer-only launches {launches}")
        check_readout(launches, "scorer-only branch")
        cpu = MeterDecoder(cam.make_params(), device="cpu")
        cpu.static_kwargs["static_win_origin"] = None
        compare_results(rows(res, N_CPU_CHECK),
                        cpu.decode_numpy(crops[:N_CPU_CHECK]),
                        "scorer-only vs CPU")
        say(f"first {N_CPU_CHECK} rows equal the CPU decode")

    def fallback_run() -> None:
        """A flagship coefficient batch with 4:4:4 frames (fallback slots)
        and frames cut below the window (the general coefficient
        reader)."""
        def feed_ms(batch) -> float:
            t = time.perf_counter()
            tio.load_coef_feed(batch, cam.meter_rect, FRAME_WH, pad_hw,
                               num_threads=FEED_THREADS)
            return (time.perf_counter() - t) * 1e3

        feed_ms(fb_datas)                           # warm-up
        ms = {"clean": [], "fallback": []}
        for kind in ("clean", "fallback", "fallback", "clean") * 2:
            ms[kind].append(feed_ms(datas if kind == "clean" else fb_datas))
        t = time.perf_counter()
        tio.load_packed_crops_from_bytes([fb_datas[i] for i in FB_444],
                                         cam.meter_rect, pad_hw,
                                         num_threads=FEED_THREADS)
        whole = (time.perf_counter() - t) * 1e3
        say(f"host feed, interleaved (clean, fallback, fallback, clean) x2, "
            f"B={B_MAIN}, {FEED_THREADS} threads: clean "
            f"{np.mean(ms['clean']):.3f} ms/batch {np.round(ms['clean'], 3)}"
            f", with fallback frames {np.mean(ms['fallback']):.3f} ms/batch "
            f"{np.round(ms['fallback'], 3)} ({len(FB_444)} 4:4:4 frames "
            f"decoded whole into the slots, {len(FB_CUT)} cut frames); the "
            f"{len(FB_444)} whole-frame decodes alone {whole:.3f} ms")
        feed = tio.load_coef_feed(fb_datas, cam.meter_rect, FRAME_WH,
                                  pad_hw, num_threads=FEED_THREADS)
        check(feed[4].all(), f"fallback batch: frames not loaded "
              f"{np.nonzero(~feed[4])[0].tolist()}")
        check(sorted(feed[6].tolist()) == list(FB_444),
              f"fallback slots {feed[6].tolist()}")
        reset(all_kernels)
        res = to_numpy(step(None, *feed))
        launches = counts(all_kernels)
        say(f"fallback batch through the coefficient step: launches "
            f"{launches}")
        check_readout(launches, "fallback batch")
        check_readings("fallback batch", res,
                       true_pos[np.arange(B_MAIN) % N_DISTINCT])
        cpu_step, _, _ = make_coef_decode_fn(
            MeterDecoder(cam.make_params(), device="cpu"), FRAME_WH)
        compare_results(rows(res, N_CPU_CHECK),
                        to_numpy(cpu_step(None, *cut(feed, N_CPU_CHECK))),
                        "fallback batch vs CPU")
        say(f"fallback batch: every frame loaded, slots {sorted(FB_444)}, "
            f"first {N_CPU_CHECK} rows (all fallback rows) equal the CPU")

    def variant_run() -> None:
        """The quad branch under the decode knobs: merged + hist_pallas
        (K5, K6, K7) through decode_numpy and the coefficient step, merged
        + fused (K5, K3, K4) through decode_numpy; every field equal to
        the default decode's."""
        mh, mf = variants[("merged", "hist_pallas")], \
            variants[("merged", "fused")]
        base = dec.decode_numpy(crops)
        for d in (mh, mf):
            d.decode_numpy(crops[:8])                # warm-up
        torch.cuda.synchronize()
        cpu = {}
        for (fe, qs), d, want in (
                (("merged", "hist_pallas"), mh,
                 {"frontend_windows": 1, "propagate": 1, "stats_select": 1,
                  "readout": 1, "result_pack": 1}),
                (("merged", "fused"), mf,
                 {"frontend_windows": 1, "ccl": 1, "stats": 1,
                  "readout": 1, "result_pack": 1})):
            reset(all_kernels)
            t = time.perf_counter()
            res = d.decode_numpy(crops)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = counts(all_kernels)
            if qs == "hist_pallas":
                for name in ("frontend_windows", "stats_select"):
                    results[name]["launches"] = launches[name]
            say(f"variant {fe} + {qs}, crops: {B_MAIN} flagship crops in "
                f"{wall:.3f} s; launches {launches}")
            check(launches == {k: want.get(k, 0) for k in launches},
                  f"variant {fe} + {qs} launches {launches}, want {want}")
            check_readings(f"variant {fe} + {qs}", res, true_pos)
            cpu[qs] = MeterDecoder(cam.make_params(), device="cpu",
                                   frontend=fe, quad_stats=qs)
            compare_results(rows(res, N_CPU_CHECK),
                            cpu[qs].decode_numpy(crops[:N_CPU_CHECK]),
                            f"variant {fe} + {qs} vs CPU")
            compare_results(res, base, f"variant {fe} + {qs} vs default")
        vstep, _, _ = make_coef_decode_fn(mh, FRAME_WH)
        feed = state["feed"]
        vstep(None, *cut(feed, 8))                  # warm-up
        torch.cuda.synchronize()
        reset(all_kernels)
        res = to_numpy(vstep(None, *feed))
        launches = counts(all_kernels)
        say(f"variant merged + hist_pallas, coefficient step: {B_MAIN} "
            f"flagship JPEG feeds; launches {launches}")
        check(launches == {k: int(k in ("frontend_windows", "propagate",
                                        "stats_select", "backhalf_planes",
                                        "readout", "result_pack"))
                           for k in launches},
              f"variant coefficient step launches {launches}")
        check_readings("variant merged + hist_pallas coef", res,
                       true_pos[np.arange(B_MAIN) % N_DISTINCT])
        cpu_step, _, _ = make_coef_decode_fn(cpu["hist_pallas"], FRAME_WH)
        compare_results(rows(res, N_CPU_CHECK),
                        to_numpy(cpu_step(None, *cut(feed, N_CPU_CHECK))),
                        "variant coef vs CPU")
        compare_results(res, to_numpy(step(None, *feed)),
                        "variant coef vs default coef")
        say(f"variants: first {N_CPU_CHECK} rows equal the CPU, every row "
            "equal to the default decode (crops and step)")

    def v1_run() -> None:
        """The v1 scorer through its entry point, match_scores_v1 (the JAX
        package's tests and experiments call pallas_match's): K9."""
        L = state["L"]
        reset(all_kernels)
        scores = match.match_scores_v1(L, pa.template_u8, dec.tmean)
        torch.cuda.synchronize()
        launches = counts(all_kernels)
        results["match_corr"]["launches"] = launches["match_corr"]
        say(f"v1 scorer: {B_MAIN} flagship lightness maps; launches "
            f"{launches}")
        check(launches == {k: int(k == "match_corr") for k in launches},
              f"v1 scorer launches {launches}")
        _, mx, my = locate(scores)
        check(torch.equal(mx, state["mx"]) and torch.equal(my, state["my"]),
              "v1 scorer's first maximum differs from K1's")

    def throughput() -> None:
        ms = cuda_ms(lambda: dec(packed), 10)
        say(f"crop decode (device-resident packed crops, B={B_MAIN}): "
            f"{ms:.3f} ms/batch = {B_MAIN / ms * 1e3:.0f} images/s")
        t = time.perf_counter()
        reps = 5
        for _ in range(reps):
            dec.decode_numpy(crops)
        per = (time.perf_counter() - t) / reps
        say(f"crop decode_numpy (host u8 crops in, numpy out, B={B_MAIN}): "
            f"{per * 1e3:.3f} ms/batch = {B_MAIN / per:.0f} images/s")
        fd = state["feed_dev"]
        fb = state["feed"][5:]
        ms = cuda_ms(lambda: step(None, *fd, *fb), 10)
        say(f"coefficient step (device-resident feed, B={B_MAIN}): "
            f"{ms:.3f} ms/batch = {B_MAIN / ms * 1e3:.0f} images/s")
        t = time.perf_counter()
        for _ in range(reps):
            f = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad_hw,
                                   num_threads=FEED_THREADS)
            to_numpy(step(None, *f))
        per = (time.perf_counter() - t) / reps
        say(f"coefficient path end to end (JPEG bytes -> host feed -> H2D "
            f"-> step -> numpy, B={B_MAIN}): {per * 1e3:.3f} ms/batch = "
            f"{B_MAIN / per:.0f} images/s")
        ms = cuda_ms(lambda: five_dec(five_packed), 10)
        say(f"general branch decode (five-dial, device-resident crops, "
            f"B={B_MAIN}): {ms:.3f} ms/batch = {B_MAIN / ms * 1e3:.0f} "
            "images/s")
        ms = cuda_ms(lambda: sc_dec(packed), 10)
        say(f"scorer-only branch decode (flagship, device-resident crops, "
            f"B={B_MAIN}): {ms:.3f} ms/batch = {B_MAIN / ms * 1e3:.0f} "
            "images/s")
        # the quad branch's variants in turns (ABCD DCBA), same crops
        order = [("split", "fused"), ("merged", "fused"),
                 ("split", "hist_pallas"), ("merged", "hist_pallas")]
        ms = {k: [] for k in order}
        for k in order + order[::-1]:
            ms[k].append(cuda_ms(lambda: variants[k](packed), 10))
        for k in order:
            m = float(np.mean(ms[k]))
            say(f"quad variant {k[0]} + {k[1]} (device-resident crops, "
                f"B={B_MAIN}): {m:.3f} ms/batch = {B_MAIN / m * 1e3:.0f} "
                f"images/s (runs {np.round(ms[k], 3).tolist()})")

    def rescue() -> None:
        yy, xx = np.mgrid[:64, :64]
        disk = (yy - 32) ** 2 + (xx - 32) ** 2 <= 23 ** 2
        closed = (np.random.default_rng(0).random((8, 64, 64)) < 0.35)[0]
        masked = closed & disk
        bits = torch.as_tensor(
            (masked + 2 * disk + 4 * closed).astype(np.int32)[None]).to(dev)
        for caps, want in ((None, False),
                           (components.RESCUE_CAPS, True)):
            ok_g, cv_g = ccl_ops.ccl(bits, caps)
            ok_r, cv_r = components.propagate(bits, caps)
            check(torch.equal(ok_g, ok_r) and torch.equal(cv_g, cv_r),
                  f"rescue window: kernel != plain under caps {caps}")
            check(bool(cv_g[0]) is want,
                  f"rescue window: converged {bool(cv_g[0])} under {caps}")
        say("rescue window: non-converged under default caps, converged "
            "under RESCUE_CAPS, kernel == plain both times")
        # the same window through the hist_pallas variant's analysis (K6,
        # then finalize with K7)
        n7 = stats.stats_select.launches
        for caps, want in ((None, False),
                           (components.RESCUE_CAPS, True)):
            got = ccl_ops.analyze_batch(bits, None, caps, "hist_pallas")
            ref = ccl_ops.analyze_batch(bits.cpu(), None, caps,
                                        "hist_pallas")
            check(all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)),
                  f"rescue window, hist_pallas: card != CPU under {caps}")
            check(bool(got.converged[0]) is want,
                  f"rescue window, hist_pallas: converged under {caps}")
        check(stats.stats_select.launches == n7 + 2,
              "rescue window, hist_pallas: K7 not launched")
        say("rescue window through the hist_pallas variant (K6, K7): the "
            "same, equal to the CPU both times")

    def profile() -> None:
        profile_ms("crop decode", lambda: dec(packed))
        fd, fb = state["feed_dev"], state["feed"][5:]
        profile_ms("coefficient step", lambda: step(None, *fd, *fb))
        profile_ms("general branch decode", lambda: five_dec(five_packed))
        profile_ms("scorer-only branch decode", lambda: sc_dec(packed))
        profile_ms("variant merged + hist_pallas decode",
                   lambda: variants[("merged", "hist_pallas")](packed))

    def cli_run() -> None:
        """The port's CLI on the card: the flagship (256 JPEG files and
        the error files of CLI_ERRORS) and ALT (64 and the same error
        kinds) through ``python3 -m meterelf_tpu_torch`` at its default
        batch (64), timed with and without files; the same files in
        process through get_meter_values (launch counts, steady
        images/s, readings against the rendered positions, exact and
        fast); the CPU (METERELF_DEVICE=cpu) on a subset of every kind,
        exact, METERELF_EXACT=0 and DEBUG=1, equal to the card byte for
        byte."""
        import shutil
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        from meterelf_tpu_torch import api, cli

        tmp = tempfile.mkdtemp(prefix="meterelf_cli_")
        procs = []
        try:
            t = time.perf_counter()
            yml = cam.write_params(os.path.join(tmp, "flagship"))
            alt_yml = alt.write_params(os.path.join(tmp, "alt"))
            with ThreadPoolExecutor(FEED_THREADS) as pool:
                rest = list(pool.map(
                    lambda p: encode_frames(cam, p[None])[0],
                    true_pos[N_DISTINCT:]))
            state["cli_jpegs"] = list(flag_jpegs) + rest
            files = write_cli_files(cam, state["cli_jpegs"],
                                    os.path.dirname(yml))
            alt_files = write_cli_files(alt, alt_jpegs,
                                        os.path.dirname(alt_yml))
            n_frames = len(true_pos)
            names = cam.make_params().dial_names
            say(f"cli: {len(files)} flagship and {len(alt_files)} ALT files "
                f"written in {time.perf_counter() - t:.1f} s")

            # in process: launches, steady images/s, readings
            def records(path, fns, exact, label):
                reset(all_kernels)
                dec_ = MeterDecoder(api.load_params(path), exact=exact,
                                    device=dev)
                stamps, recs = [], []
                for rec in api.get_meter_values(path, fns, decoder=dec_,
                                                batch_size=CLI_BATCH):
                    recs.append(rec)
                    stamps.append(time.perf_counter())
                # the flagship batches after the first; the error files
                # make a batch of their own (n_frames % CLI_BATCH == 0)
                steady = ((n_frames - CLI_BATCH)
                          / (stamps[n_frames - 1] - stamps[CLI_BATCH - 1]))
                launches = counts(all_kernels)
                say(f"cli {label}: get_meter_values over {len(fns)} files, "
                    f"batch {CLI_BATCH}: {steady:.0f} images/s over the "
                    f"flagship batches after the first; the "
                    f"{len(fns) - n_frames} error files "
                    f"{stamps[-1] - stamps[n_frames - 1]:.3f} s; launches "
                    f"{launches}")
                check(all(launches[fn.__name__] > 0 for fn in crop_kernels)
                      and sum(launches.values()) == sum(
                          launches[fn.__name__] for fn in crop_kernels),
                      f"cli {label}: K1-K4, K12 and K13 (and only they) "
                      "must launch")
                check_readout(launches, f"cli {label}")
                return recs, steady

            recs, steady = {}, {}
            for exact in (True, False):
                label = "exact" if exact else "fast"
                recs[exact], steady[exact] = records(yml, files, exact,
                                                     label)
                check(all(r.error is None for r in recs[exact][:n_frames]),
                      f"cli {label}: a flagship frame did not read")
                pos = np.array([[r.meter_values[n] for n in names]
                                for r in recs[exact][:n_frames]])
                e = circ_err(pos, true_pos).max()
                say(f"cli {label}: max reading error {e:.4f} "
                    f"(limit {POS_TOL})")
                check(e < POS_TOL, f"cli {label}: reading error {e}")
            want = [cli.format_result(r) for r in recs[True]]
            for (name, msg), line in zip(CLI_ERRORS.items(),
                                         want[n_frames:]):
                check(msg in line, f"cli: {name}.jpg printed {line!r}")

            # the card, timed alone; then the start-up alone (no files:
            # imports, params, the decoder on the card)
            t = time.perf_counter()
            card_lines = cli_lines(start_cli(yml, files), "card")
            wall = time.perf_counter() - t
            t = time.perf_counter()
            check(cli_lines(start_cli(yml, []), "start-up") == [],
                  "cli: output without files")
            startup = time.perf_counter() - t
            params = api.load_params(yml)
            params.arrays()
            t = time.perf_counter()
            for f, line in zip(files[n_frames:], card_lines[n_frames:]):
                if "Dials not found" in line:
                    api._parity_match_val(f, params)
            cvdft_s = time.perf_counter() - t
            check(card_lines == want, "cli: card stdout != get_meter_values"
                  + first_difference(card_lines, want))

            # the rest at once: fast mode on the card; the CPU subset
            # exact and fast; DEBUG=1 on OK files, card and CPU; ALT
            subset = files[:CLI_CPU] + files[n_frames:]
            alt_subset = alt_files[:4] + alt_files[len(alt_jpegs):]
            ok_files = files[:CLI_DEBUG]
            dbg = os.path.join(tmp, "debug")
            runs = {
                "card fast": (yml, files, {"METERELF_EXACT": "0"}),
                "cpu": (yml, subset, CLI_CPU_ENV),
                "cpu fast": (yml, subset, {**CLI_CPU_ENV,
                                           "METERELF_EXACT": "0"}),
                "card debug": (yml, ok_files, {
                    "DEBUG": "1", "METERELF_DEBUG_DIR": dbg + "_card"}),
                "cpu debug": (yml, ok_files, {
                    **CLI_CPU_ENV, "DEBUG": "1",
                    "METERELF_DEBUG_DIR": dbg + "_cpu"}),
                "alt card": (alt_yml, alt_files, {}),
                "alt cpu": (alt_yml, alt_subset, CLI_CPU_ENV),
            }
            t = time.perf_counter()
            for label, (path, fns, env) in runs.items():
                procs.append((label, start_cli(path, fns, **env)))
            out = {label: cli_lines(p, label) for label, p in procs}
            rest_wall = time.perf_counter() - t
            by_file = dict(zip(files, card_lines))
            cpu_want = [by_file[f] for f in subset]
            check(out["cpu"] == cpu_want, "cli: CPU stdout != card stdout "
                  "on the subset" + first_difference(out["cpu"], cpu_want))
            fast_want = [cli.format_result(r) for r in recs[False]]
            check(out["card fast"] == fast_want,
                  "cli: fast card stdout != get_meter_values(exact=False)"
                  + first_difference(out["card fast"], fast_want))
            fast_by_file = dict(zip(files, out["card fast"]))
            cpu_want = [fast_by_file[f] for f in subset]
            check(out["cpu fast"] == cpu_want,
                  "cli: fast CPU stdout != fast card stdout on the subset"
                  + first_difference(out["cpu fast"], cpu_want))
            debug_want = [cli.format_result(r, True)
                          for r in recs[True][:CLI_DEBUG]]
            check(out["card debug"] == debug_want,
                  "cli: DEBUG card stdout != the records with their dicts"
                  + first_difference(out["card debug"], debug_want))
            check(out["cpu debug"] == out["card debug"],
                  "cli: DEBUG CPU stdout != DEBUG card stdout"
                  + first_difference(out["cpu debug"], out["card debug"]))
            for d in (dbg + "_card", dbg + "_cpu"):
                made = sorted(os.listdir(d))
                check(made == sorted(os.path.basename(f)[:-4] + "_debug.png"
                                     for f in ok_files),
                      f"cli: DEBUG overlays {made}")
            alt_by_file = dict(zip(alt_files, out["alt card"]))
            alt_want = [alt_by_file[f] for f in alt_subset]
            check(out["alt cpu"] == alt_want, "cli: ALT CPU stdout != ALT "
                  "card stdout" + first_difference(out["alt cpu"], alt_want))
            alt_lines = out["alt card"]
            check(not any("UNKNOWN" in x for x in alt_lines[:len(alt_jpegs)]),
                  "cli: an ALT frame did not read")
            for (name, msg), line in zip(CLI_ERRORS.items(),
                                         alt_lines[len(alt_jpegs):]):
                check(msg.split(" (match")[0] in line,
                      f"cli: ALT {name}.jpg printed {line!r}")
            say(f"cli: python3 -m meterelf_tpu_torch, {len(files)} flagship "
                f"files on {card}: process wall {wall:.3f} s "
                f"({len(files) / wall:.0f} files/s with start-up), of which "
                f"start-up (no files) {startup:.3f} s and the OpenCV-exact "
                f"match val of the DIALS_NOT_FOUND files {cvdft_s:.3f} s; "
                f"get_meter_values {steady[True]:.0f} images/s over the "
                "flagship batches after the first")
            say(f"cli: card stdout == get_meter_values (exact and fast); "
                f"CPU == card on {len(subset)} files (exact and fast, every "
                f"error kind), DEBUG=1 on {CLI_DEBUG} (overlays written); ALT "
                f"{len(alt_files)} files, CPU == card on {len(alt_subset)}; "
                f"the other {len(runs)} runs together in {rest_wall:.1f} s")
        finally:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(tmp, ignore_errors=True)

    def stream_run() -> None:
        """The stream (meterelf_tpu_torch.stream): a short stream of
        rising frames through stream_decode_bytes and stream_decode on the
        card and on the CPU, report for report; the long stream at
        num_threads 2 and 8 and feed_workers 8 (images/s, busy share);
        the dispatches under set_sync_debug_mode("error"); and the
        daemon: python3 -m meterelf_tpu_torch.stream --watch with
        --state, --debug-http and --trace, then a resumed run."""
        errors = []

        def part(name, fn) -> None:
            t = time.perf_counter()
            try:
                fn()
            except Exception:  # report every part, fail at the end
                errors.append(name)
                say(f"FAIL stream/{name}:\n{traceback.format_exc()}")
            say(f"stream/{name}: {time.perf_counter() - t:.1f} s")

        part("short stream", short_stream)
        part("long stream", long_stream)
        part("dispatch sync", dispatch_sync)
        part("daemon", stream_daemon)
        check(not errors, f"stream parts failed: {errors}")

    def short_stream() -> None:
        import dataclasses

        from meterelf_tpu_torch import stream as st_mod

        names, jpegs, pos = state["rise"]
        names, jpegs = names[:N_SHORT], jpegs[:N_SHORT]
        params = cam.make_params()
        ts = [st_mod._filename_timestamp(n) for n in names]
        check(all(t is not None for t in ts), "stamp names not read")
        crops_u8, ok = tio.load_crop_bytes_u8(jpegs, cam.meter_rect)
        check(ok.all(), "a rising frame did not decode")
        reps = {}
        for where, d in (("card", dec),
                         ("cpu", MeterDecoder(params, device="cpu"))):
            reset(all_kernels)
            t = time.perf_counter()
            reps[where, "bytes"] = list(st_mod.stream_decode_bytes(
                params, zip(names, jpegs), FRAME_WH, decoder=d,
                batch_size=B_SHORT, timestamps=ts))
            wall_b = time.perf_counter() - t
            if where == "card":
                launches = counts(all_kernels)
                for k, n in launches.items():
                    results[k]["stream_launches"] = n
                want = {k: int(k in ("frontend", "windows", "ccl", "stats",
                                     "backhalf_planes", "readout",
                                     "result_pack"))
                        * N_SHORT // B_SHORT
                        for k in launches}
                say(f"stream (card): stream_decode_bytes launches {launches}")
            t = time.perf_counter()
            reps[where, "crops"] = list(st_mod.stream_decode(
                params, zip(names, crops_u8), decoder=d,
                batch_size=B_SHORT, timestamps=ts))
            say(f"short stream ({where}): {N_SHORT} rising frames in "
                f"batches of {B_SHORT}: bytes {wall_b:.3f} s, crops "
                f"{time.perf_counter() - t:.3f} s")

        def fields(rs) -> list:
            return [dataclasses.replace(r, images_per_sec=0.0) for r in rs]

        base = fields(reps["card", "bytes"])
        for key, rs in reps.items():
            check(fields(rs) == base, f"short stream {key} reports differ "
                  f"from the card's bytes stream: {fields(rs)} != {base}")
        last = reps["card", "bytes"][-1]
        say(f"short stream: last report {last}")
        check(len(base) == N_SHORT // B_SHORT and last.frames_ok == N_SHORT
              and last.frames_error == 0 and last.leak_suspected
              and last.flow_lph is not None, "short stream: want every "
              "frame read and the leak flag up")
        want_flow = RISE_STEP * 3600.0 / FRAME_SECONDS
        check(abs(last.flow_lph - want_flow) < 0.05 * want_flow,
              f"short stream flow {last.flow_lph}, rendered {want_flow}")
        say("short stream: card == CPU, bytes == crops, report for report "
            "(every field but images_per_sec); leak flag up")
        check(launches == want, f"stream launches {launches}, want {want}")

    class Recording(MeterDecoder):
        """A MeterDecoder that keeps each decode's device result."""

        def __init__(self, *a, **kw) -> None:
            super().__init__(*a, **kw)
            self.results = []

        def decode(self, *a, **kw):
            res = super().decode(*a, **kw)
            self.results.append(res)
            return res

    def long_stream() -> None:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        from meterelf_tpu_torch import stream as st_mod
        from meterelf_tpu_torch.profiling import StageTimers

        jpegs = state.get("cli_jpegs")
        if jpegs is None:
            jpegs = list(flag_jpegs) + encode_frames(
                cam, true_pos[N_DISTINCT:])
        n = B_LONG * N_LONG
        frames = [(f"l{i:05d}.jpg", jpegs[i % B_MAIN]) for i in range(n)]
        params = cam.make_params()
        rec = Recording(params, device=dev)
        batch = jpegs[:B_LONG]
        for threads in (2, 8):
            # the same batch unpipelined, and its host feed alone
            loop, feed_only = [], []
            for _ in range(3):
                t = time.perf_counter()
                f = tio.load_coef_feed(batch, cam.meter_rect, FRAME_WH,
                                       pad_hw, num_threads=threads)
                feed_only.append(time.perf_counter() - t)
                to_numpy(step(None, *f))
                loop.append(time.perf_counter() - t)
            say(f"long stream baseline, num_threads={threads}: host feed "
                f"alone {np.median(feed_only) * 1e3:.3f} ms a batch; feed -> "
                f"step -> numpy unpipelined {np.median(loop) * 1e3:.3f} ms "
                f"a batch (medians of 3, B={B_LONG})")
        for label, kw in (("num_threads=2", {"num_threads": 2}),
                          ("num_threads=8", {"num_threads": 8}),
                          ("feed_workers=8", {"feed_workers": 8})):
            rec.results.clear()
            tm = StageTimers()
            prof = torch_profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            stamps, t_leg = [], time.perf_counter()
            for k, rep in enumerate(st_mod.stream_decode_bytes(
                    params, iter(frames), FRAME_WH, decoder=rec,
                    batch_size=B_LONG, timers=tm, **kw)):
                stamps.append(time.perf_counter())
                if k == LONG_PROFILED[0]:
                    prof.start()
                    t_prof = time.perf_counter()   # after its start-up
                elif k == LONG_PROFILED[1]:
                    prof.stop()
            check(len(stamps) == N_LONG and rep.frames_ok == n,
                  f"long stream {label}: {len(stamps)} reports, {rep}")
            a, b = LONG_TIMED
            per = (stamps[b] - stamps[a]) / (b - a)
            a, b = LONG_PROFILED
            pwall = (stamps[b] - t_prof) / (b - a) * 1e3
            busy = sum(r[0] for r in device_rows(prof, b - a))
            res = [to_numpy(r) for r in rec.results]
            got = np.concatenate([r.dial_pos for r in res])
            check(all((r.err == 0).all() and r.converged.all() for r in res),
                  f"long stream {label}: a frame did not read")
            e = circ_err(got, true_pos[np.arange(n) % B_MAIN]).max()
            check(e < POS_TOL, f"long stream {label}: reading error {e}")
            timers = ", ".join(
                f"{s} {tm.totals[s] / tm.counts[s] * 1e3:.3f} ms"
                for s in ("dispatch", "drain"))
            say(f"long stream {label} on {card}: {B_LONG / per:.0f} images/s,"
                f" {per * 1e3:.3f} ms a batch (B={B_LONG}, batches "
                f"{LONG_TIMED[0] + 1}-{LONG_TIMED[1]} of {N_LONG}); device "
                f"busy {busy:.3f} ms a batch = {100 * busy / pwall:.1f}% of "
                f"{pwall:.3f} ms over batches {LONG_PROFILED[0] + 1}-"
                f"{LONG_PROFILED[1]} (torch.profiler on); per batch "
                f"{timers}; first report {stamps[0] - t_leg:.3f} s after the "
                f"start (the feed's start-up, two batches); max reading "
                f"error {e:.4f} over {n} frames")

    def dispatch_sync() -> None:
        from meterelf_tpu_torch.pipeline.decode import to_host_later

        feed = state["feed"]
        fb_feed = tio.load_coef_feed(fb_datas, cam.meter_rect, FRAME_WH,
                                     pad_hw, num_threads=FEED_THREADS)
        check((fb_feed[6] < B_MAIN).any(), "no fallback slot in use")
        calls = {
            "crop decode (u8 crops, quad split branch)": lambda: dec(crops),
            "coefficient step (plane feed)": lambda: step(None, *feed),
            "coefficient step with fallback slots":
                lambda: step(None, *fb_feed),
            "stream dispatch (step, then its result's pull queued)":
                lambda: to_host_later(step(None, *feed)),
        }
        bad = []
        for name, fn in calls.items():
            fn()                        # warm
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            except RuntimeError:
                bad.append(name)
                say(f"dispatch sync: {name} synchronised:\n"
                    f"{traceback.format_exc()}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        check(not bad, f"dispatches that wait on the card: {bad}")
        say(f"dispatch sync: {len(calls)} warm dispatches raise nothing under "
            f"torch.cuda.set_sync_debug_mode('error'): {list(calls)}")

    def stream_daemon() -> None:
        import glob
        import queue
        import re
        import shutil
        import tempfile
        import threading
        import urllib.request

        from meterelf_tpu_torch import stream as st_mod

        names, jpegs, _pos = state["rise"]
        line_re = re.compile(
            r"frames=(\d+) ok=(\d+) err=(\d+) last=\S+ cum=([\d.]+)L "
            r"flow=\S+L/h leak=(YES|no) rate=\d+img/s$")
        tmp = tempfile.mkdtemp(prefix="meterelf_stream_")
        procs, stop = [], threading.Event()
        try:
            yml = cam.write_params(os.path.join(tmp, "params"))
            state_f = os.path.join(tmp, "state.json")
            trace_d = os.path.join(tmp, "trace")

            def drop(d, i, data=None) -> None:
                p = os.path.join(d, f"w{i:03d}.jpg")
                with open(p + ".part", "wb") as fp:
                    fp.write(jpegs[i] if data is None else data)
                os.replace(p + ".part", p)

            def daemon(d, *extra):
                p = start_module("meterelf_tpu_torch.stream", [
                    yml, "--watch", d, "--coef", "640x480", "--poll", "0.2",
                    "--watch-idle-exit", "2", "--state", state_f,
                    "--batch", str(B_SHORT), *extra])
                procs.append(p)
                out, err = queue.Queue(), queue.Queue()
                p.readers = [threading.Thread(target=lambda f=f, q=q: [
                    q.put(x) for x in f], daemon=True)
                    for f, q in ((p.stdout, out), (p.stderr, err))]
                for t in p.readers:
                    t.start()
                return p, out, err

            def finish(p) -> int:
                rc = p.wait(timeout=120)
                for t in p.readers:
                    t.join(timeout=30)
                return rc

            def lines(q) -> list:
                got = []
                while not q.empty():
                    got.append(q.get().rstrip("\n"))
                return got

            spool = os.path.join(tmp, "spool")
            os.makedirs(spool)
            first = N_SHORT
            for i in range(first, first + N_BACKLOG):
                drop(spool, i)
            with open(os.path.join(spool, "w000t.jpg"), "wb") as fp:
                fp.write(jpegs[first][:len(jpegs[first]) // 2])   # no EOI
            t0 = time.perf_counter()
            p, out, err = daemon(spool, "--debug-http", "0",
                                 "--trace", trace_d)
            port, errs = None, []
            while port is None:
                try:
                    x = err.get(timeout=1)
                except queue.Empty:
                    check(p.poll() is None and time.perf_counter() - t0 < 120,
                          f"daemon not up (exit {p.poll()}): {errs[-30:]}")
                    continue
                errs.append(x)
                m = re.search(r"debug viewer: http://localhost:(\d+)/", x)
                port = int(m.group(1)) if m else None
            dropped = []

            def drip() -> None:
                # until the pages are read: a daemon out of files exits
                d0 = first + N_BACKLOG
                while not stop.is_set():
                    k = len(dropped)
                    drop(spool, d0 + k, jpegs[d0 + k % N_DRIP])
                    dropped.append(k)
                    time.sleep(DRIP_SECONDS)

            dripper = threading.Thread(target=drip, daemon=True)
            dripper.start()
            report1 = out.get(timeout=120)
            base = f"http://127.0.0.1:{port}"
            page = urllib.request.urlopen(base + "/", timeout=30).read()
            png = urllib.request.urlopen(base + "/frame.png",
                                         timeout=30).read()
            stop.set()
            dripper.join()
            check(p.poll() is None or p.returncode == 0,
                  "the daemon ended while files were still dropped")
            rc = finish(p)
            got = [report1] + lines(out)
            got = [x.rstrip("\n") for x in got]
            errs += lines(err)
            check(rc == 0, f"stream daemon exited {rc}: {errs[-20:]}")
            check(b"meterelf live debug" in page and b"/frame.png" in page,
                  f"debug page: {page[:200]!r}")
            check(png[:8] == b"\x89PNG\r\n\x1a\n", "frame.png is no PNG")
            m = [line_re.match(x) for x in got]
            check(all(m), f"report lines: {got}")
            n1 = N_BACKLOG + 1 + len(dropped)
            total, ok1, nerr, cum1 = (int(m[-1].group(1)), int(m[-1].group(2)),
                                      int(m[-1].group(3)),
                                      float(m[-1].group(4)))
            check(total == n1 and nerr == 1 and ok1 == n1 - 1,
                  f"daemon: last report {got[-1]!r}, want frames={n1} with "
                  "the truncated file as the one error")
            traces = [f for f in os.listdir(trace_d) if f.endswith(".json")]
            check(len(traces) == 1 and os.path.getsize(
                os.path.join(trace_d, traces[0])) > 0, f"trace: {traces}")
            st = st_mod.load_state(state_f)
            check(st.frames_total == n1, f"state: {st.frames_total} frames")
            wall1 = time.perf_counter() - t0
            # a second run, over more files, resumes from the checkpoint
            spool2 = os.path.join(tmp, "spool2")
            os.makedirs(spool2)
            nxt = first + N_BACKLOG + N_DRIP
            for i in range(nxt, nxt + N_RESUME):
                drop(spool2, i)
            p2 = start_module("meterelf_tpu_torch.stream", [
                yml, *sorted(glob.glob(os.path.join(spool2, "*.jpg"))),
                "--coef", "640x480", "--state", state_f,
                "--batch", str(B_SHORT)])
            procs.append(p2)
            o2, e2 = p2.communicate(timeout=120)
            got2 = o2.splitlines()
            check(p2.returncode == 0,
                  f"resumed run exited {p2.returncode}: {e2[-3000:]}")
            m2 = line_re.match(got2[-1]) if got2 else None
            check(m2 is not None and int(m2.group(1)) == n1 + N_RESUME
                  and int(m2.group(3)) == 1 and float(m2.group(4)) > cum1,
                  f"resumed run: {got2}, the daemon ended on {got[-1]!r}")
            say(f"stream daemon: {n1} files ({N_BACKLOG} backlog, "
                f"{len(dropped)} dropped while it ran, 1 truncated: retried, "
                f"then one error frame) in {wall1:.1f} s with --debug-http "
                f"(/ and /frame.png: {len(png)} B PNG) and --trace "
                f"({os.path.getsize(os.path.join(trace_d, traces[0]))} B); "
                f"last line {got[-1]!r}; resumed from --state over "
                f"{N_RESUME} more: {got2[-1]!r}")
        finally:
            stop.set()
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
            shutil.rmtree(tmp, ignore_errors=True)

    def calibration_run() -> None:
        """python3 -m meterelf_tpu_torch.calibration over N_CAL flagship
        JPEGs at random offsets, on the card and with METERELF_DEVICE=cpu:
        stdout equal byte for byte; the centres against the camera's."""
        import re
        import shutil
        import tempfile

        tmp = tempfile.mkdtemp(prefix="meterelf_cal_")
        procs = []
        try:
            yml = cam.write_params(os.path.join(tmp, "cal"))
            files = []
            for i, data in enumerate(state["cal"]):
                files.append(os.path.join(tmp, "cal", f"c{i:03d}.jpg"))
                with open(files[-1], "wb") as fp:
                    fp.write(data)
            t = time.perf_counter()
            for env in ({}, {"METERELF_DEVICE": "cpu"}):
                procs.append(start_module("meterelf_tpu_torch.calibration",
                                          [yml, *files], **env))
            outs = []
            for p in procs:
                o, e = p.communicate(timeout=600)
                check(p.returncode == 0,
                      f"calibration exited {p.returncode}: {e[-3000:]}")
                outs.append(o)
            wall = time.perf_counter() - t
            check(outs[0] == outs[1], "calibration: card stdout != CPU "
                  f"stdout:\n{outs[0]}\n{outs[1]}")
            got = [tuple(map(float, c)) for c in re.findall(
                r"center: \[([\d.]+), ([\d.]+)\]", outs[0])]
            true = [c for _n, c, _d in cam.dial_specs]
            check(len(got) == len(true), f"calibration: {outs[0]}")
            dist = max(float(np.hypot(a[0] - b[0], a[1] - b[1]))
                       for a, b in zip(got, true))
            say(f"calibration: {N_CAL} flagship JPEGs, card and CPU (in "
                f"parallel) in {wall:.1f} s; stdout equal byte for byte; "
                f"largest distance from the true dial centres {dist:.3f} px")
            say("calibration stdout:\n" + outs[0].rstrip())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(tmp, ignore_errors=True)

    def mesh_run() -> None:
        """Data parallelism (meterelf_tpu_torch.parallel.mesh) over every
        card: the flagship crop batch through MeshDecoder and N_FUZZ
        fuzz JPEGs (tiled to B_MAIN, fallback slots on both sides of a
        shard boundary) through MeshCoefStep, each bit for bit against
        the plain decoder, with its aggregate; warm dispatches under
        set_sync_debug_mode("error"); the mesh against the plain path in
        turns; the stream over the mesh; and the stream CLI as a
        one-rank NCCL group, its lines equal to the CPU's."""
        import re
        import shutil
        import socket
        import tempfile

        from meterelf_tpu_torch import stream as st_mod
        from meterelf_tpu_torch.parallel import mesh as mesh_mod
        from meterelf_tpu_torch.pipeline.decode import to_host_later

        def bits_equal(a, b, label) -> None:
            for f in a._fields:
                x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
                if x.dtype.kind == "f":
                    x, y = x.view(f"u{x.itemsize}"), y.view(f"u{y.itemsize}")
                check(x.dtype == y.dtype and np.array_equal(x, y),
                      f"mesh {label}: {f} differs from the plain path")

        def agg_check(agg, res, label) -> tuple:
            """The aggregate against a numpy reduction of the host result
            (counts exact, the mean within 1e-12 relative) and against
            aggregate_metrics over CPU replicas (the same order of sums:
            bit for bit)."""
            ok = res.err == 0
            got = (int(agg.n_ok), int(agg.n_err), float(agg.mean))
            want = float(res.value[ok].mean()) if ok.any() else 0.0
            check(got[:2] == (int(ok.sum()), int((~ok).sum())),
                  f"mesh {label}: counts {got[:2]}")
            check(abs(got[2] - want) <= 1e-12 * abs(want),
                  f"mesh {label}: mean {got[2]!r}, numpy {want!r}")
            cpu = mesh_mod.aggregate_metrics(
                res.value, res.err,
                mesh_mod.make_mesh(["cpu"] * len(mesh.devices)))
            check(float(cpu.mean).hex() == float(agg.mean).hex(),
                  f"mesh {label}: mean {got[2]!r} != CPU order "
                  f"{float(cpu.mean)!r}")
            return got

        t0 = time.perf_counter()
        with fuzz_pool:
            fuzz, slot_jpegs = list(fuzz_out)
        say(f"mesh: {N_FUZZ} + 8 fuzz JPEGs (tests/fuzz_frames.py, seed "
            f"{FUZZ_SEED}) ready {time.perf_counter() - t0:.1f} s into the "
            "phase")
        mesh = mesh_mod.make_mesh()
        n_dev = len(mesh.devices)
        check(B_MAIN % mesh.size == 0, f"{B_MAIN} rows on {mesh.size} devices")
        b = B_MAIN // n_dev
        say(f"mesh: make_mesh() over {n_dev} device(s) "
            f"{[str(d) for d in mesh.devices]}, size {mesh.size}, "
            f"{b} rows a device; on {card}")
        md = mesh_mod.MeshDecoder(dec, mesh)
        mesh_kernels = crop_kernels + (jpeg_tail.backhalf_planes,)

        # 1. the crop decode
        to_host_later(md(crops[:8 * n_dev]))()     # warm-up
        plain = dec.decode_numpy(crops)
        reset(all_kernels)
        res = md(crops)
        agg = md.aggregate(res)
        got = to_host_later(res)()
        launches = counts(all_kernels)
        want = {k: n_dev * int(k in ("frontend", "windows", "ccl", "stats",
                                     "readout", "result_pack"))
                for k in launches}
        check(launches == want, f"mesh decode launches {launches}")
        bits_equal(got, plain, "crop decode")
        check_readings("mesh crop decode", got, true_pos)
        a = agg_check(agg, got, "crop decode")
        say(f"mesh crop decode: B={B_MAIN} equal to MeterDecoder bit for bit "
            f"in every field; launches {launches}; aggregate (n_ok, n_err, "
            f"mean) = {a}")
        mesh_launches = dict(launches)

        # 2. the coefficient step on fuzz JPEGs with fallback slots
        fz = [fuzz[i % N_FUZZ] for i in range(B_MAIN)]
        feed = tio.load_coef_feed(fz, cam.meter_rect, FRAME_WH, pad_hw,
                                  num_threads=FEED_THREADS)
        check(feed[4].all(), "mesh: a fuzz JPEG did not load")
        fb_packed, fb_ok = tio.load_packed_crops_from_bytes(
            slot_jpegs, cam.meter_rect, pad_hw, num_threads=FEED_THREADS)
        check(fb_ok.all(), "mesh: a slot frame did not load")
        edge = b if n_dev > 1 else B_MAIN // 2
        fb_idx = np.array([-1, B_MAIN, edge - 1, edge, -B_MAIN - 1, 5,
                           edge + 7, -B_MAIN], np.int32)
        fb_feed = feed[:5] + (fb_packed, fb_idx)
        ms = mesh_mod.MeshCoefStep(dec, FRAME_WH, mesh)
        plain_c = to_host_later(step(None, *fb_feed))()
        reset(all_kernels)
        res = ms(None, *fb_feed)
        agg = ms.aggregate(res)
        got_c = to_host_later(res)()
        launches = counts(all_kernels)
        want = {k: n_dev * int(k in ("frontend", "windows", "ccl", "stats",
                                     "backhalf_planes", "readout",
                                     "result_pack"))
                for k in launches}
        check(launches == want, f"mesh step launches {launches}")
        bits_equal(got_c, plain_c, "coefficient step")
        nofb = to_host_later(step(None, *feed))()
        slots = [int(i) % B_MAIN for i in fb_idx
                 if -B_MAIN <= int(i) < B_MAIN]
        moved = [r for r in slots if nofb.match_x[r] != got_c.match_x[r]
                 or nofb.match_y[r] != got_c.match_y[r]
                 or nofb.value[r] != got_c.value[r]]
        check(moved == slots, f"mesh: slot rows {slots}, changed {moved}")
        check(got_c.converged.all(), "mesh step: not converged")
        a = agg_check(agg, got_c, "coefficient step")
        kinds = {int(e): int((got_c.err == e).sum())
                 for e in np.unique(got_c.err)}
        say(f"mesh coefficient step: {N_FUZZ} fuzz JPEGs tiled to {B_MAIN} "
            f"(K10 plane feed) with fallback slots {fb_idx.tolist()} (rows "
            f"{slots} taken; shard edge at {edge}): equal to the plain step "
            f"bit for bit in every field; error codes {kinds}; launches "
            f"{launches}; aggregate {a}")
        for k, n in launches.items():
            mesh_launches[k] += n
        for k, n in mesh_launches.items():
            results[k]["mesh_launches"] = n

        # 3. warm dispatches never wait for the card
        calls = {
            "MeshDecoder (u8 crops)": lambda: md(crops),
            "MeshCoefStep with fallback slots": lambda: ms(None, *fb_feed),
            "stream dispatch (MeshCoefStep, aggregate, pulls queued)":
                lambda: st_mod._fetch_later(*(lambda r: (r, ms.aggregate(r)))(
                    ms(None, *fb_feed))),
        }
        bad = []
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            except RuntimeError:
                bad.append(name)
                say(f"mesh dispatch sync: {name} synchronised:\n"
                    f"{traceback.format_exc()}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        check(not bad, f"mesh dispatches that wait on the card: {bad}")
        say(f"mesh dispatch sync: {len(calls)} warm dispatches raise nothing "
            f"under torch.cuda.set_sync_debug_mode('error'): {list(calls)}")

        # 4. the mesh against the plain path, in turns
        host_feed = feed[:5] + (fb_packed, fb_idx)
        fns = {
            "plain crop decode": lambda: dec.decode_numpy(crops),
            "mesh crop decode": lambda: to_host_later(md(crops))(),
            "plain coefficient step": lambda: to_host_later(
                step(None, *host_feed))(),
            "mesh coefficient step": lambda: to_host_later(
                ms(None, *host_feed))(),
        }
        times = {k: [] for k in fns}
        for r in range(MESH_ROUNDS):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fns[k]()
                times[k].append((time.perf_counter() - t) * 1e3)
        for k, v in times.items():
            say(f"mesh in turns on {card}: {k} to numpy (B={B_MAIN}): median "
                f"{np.median(v):.3f} ms [{min(v):.3f}, {max(v):.3f}] over "
                f"{MESH_ROUNDS} rounds")
        state["mesh_times"] = times

        # 5. the stream over the mesh beside the plain stream, in turns
        jpegs = state.get("cli_jpegs") or datas
        n = B_LONG * N_LONG
        frames = [(f"m{i:05d}.jpg", jpegs[i % B_MAIN]) for i in range(n)]
        params = cam.make_params()
        rates = {"plain": [], "mesh": []}
        for k in ("plain", "mesh", "mesh", "plain"):
            stamps = []
            last = None
            for last in st_mod.stream_decode_bytes(
                    params, iter(frames), FRAME_WH, decoder=dec,
                    batch_size=B_LONG, num_threads=FEED_THREADS,
                    mesh=mesh if k == "mesh" else None):
                stamps.append(time.perf_counter())
                if k == "mesh":
                    check(last.device_agg is not None
                          and last.device_agg[:2] == (B_LONG, 0),
                          f"mesh stream report {last}")
            check(len(stamps) == N_LONG and last.frames_ok == n,
                  f"stream {k}: {len(stamps)} reports, {last}")
            lo, hi = LONG_TIMED
            rates[k].append(B_LONG * (hi - lo) / (stamps[hi] - stamps[lo]))
        say(f"mesh stream on {card}: stream_decode_bytes(mesh=make_mesh()) "
            f"{', '.join(f'{r:.0f}' for r in rates['mesh'])} images/s, plain "
            f"{', '.join(f'{r:.0f}' for r in rates['plain'])} images/s "
            f"(num_threads={FEED_THREADS}, B={B_LONG}, batches "
            f"{LONG_TIMED[0] + 1}-{LONG_TIMED[1]} of {N_LONG}; order plain, "
            "mesh, mesh, plain); every mesh report carries device_agg")

        # 6. the stream CLI as a one-rank NCCL group, against the CPU
        names, rjpegs, _pos = state["rise"]
        tmp = tempfile.mkdtemp(prefix="meterelf_mesh_")
        procs = []
        try:
            yml = cam.write_params(os.path.join(tmp, "params"))
            files = []
            for nm, data in zip(names[:N_SHORT], rjpegs[:N_SHORT]):
                files.append(os.path.join(tmp, nm))
                with open(files[-1], "wb") as fp:
                    fp.write(data)
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                port = sk.getsockname()[1]
            args = [yml, *files, "--coef", "640x480", "--batch",
                    str(B_SHORT), "--mesh"]
            t = time.perf_counter()
            procs.append(start_module(
                "meterelf_tpu_torch.stream", args + ["all"],
                METERELF_DISTRIBUTED="1", METERELF_NUM_PROCS="1",
                METERELF_PROC_ID="0",
                METERELF_COORDINATOR=f"127.0.0.1:{port}"))
            # 4 threads: the CPU run shares the host with the card's feed
            procs.append(start_module("meterelf_tpu_torch.stream",
                                      args + ["1"], METERELF_DEVICE="cpu",
                                      OMP_NUM_THREADS="4"))
            outs = []
            for p, label in zip(procs, ("card (NCCL)", "cpu")):
                o, e = p.communicate(timeout=600)
                check(p.returncode == 0,
                      f"mesh cli {label} exited {p.returncode}: {e[-3000:]}")
                outs.append(([re.sub(r"rate=\d+img/s", "rate=*", x)
                              for x in o.splitlines()], e))
            wall = time.perf_counter() - t
            (card_lines, card_err), (cpu_lines, _) = outs
            check(card_lines == cpu_lines, "mesh cli: card lines != CPU "
                  f"lines{first_difference(card_lines, cpu_lines)}")
            check(len(card_lines) == N_SHORT // B_SHORT and all(
                " mesh[ok=" in x for x in card_lines),
                f"mesh cli lines: {card_lines}")
            warn = [x for x in card_err.splitlines() if "NCCL" in x
                    or "destroy_process_group" in x]
            say(f"mesh cli: python3 -m meterelf_tpu_torch.stream --coef "
                f"640x480 --batch {B_SHORT} --mesh all over {N_SHORT} rising "
                "frames as a one-rank NCCL group (METERELF_DISTRIBUTED=1) "
                "equals METERELF_DEVICE=cpu --mesh 1 line for line (rate= "
                f"masked); both in parallel {wall:.1f} s; NCCL lines on "
                f"stderr: {warn[:5]}; last line {card_lines[-1]!r}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(tmp, ignore_errors=True)

    if not failures:
        phase("crop decode path", crop_run)
        phase("coefficient path", coef_run)
        phase("general branch", general_run)
        phase("scorer-only branch", scorer_run)
        phase("fallback slots", fallback_run)
        phase("decode variants", variant_run)
        phase("v1 scorer", v1_run)
        phase("throughput", throughput)
        phase("rescue", rescue)
        phase("profile", profile)
        phase("cli", cli_run)
        phase("stream", stream_run)
        phase("calibration", calibration_run)
        phase("mesh", mesh_run)

    fuzz_pool.shutdown(cancel_futures=True)   # joined by the mesh phase
    kernels = [results[k] for k in REPLACES]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    if failures:
        say(f"FAILED phases: {failures}")
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
