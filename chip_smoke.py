"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, with nothing built beforehand:

1. prints the card (torch and CUDA versions, nvidia-smi name and power
   limit); exits non-zero when no CUDA device is present;
2. builds the four CUDA kernels from meterelf_tpu_torch/csrc with nvcc;
3. runs each kernel at the decode path's shapes (256 flagship-camera
   crops, their 1024 dial windows) and holds it against its plain torch
   version on the same CUDA tensors: exact equality of every output
   (max_val bitwise); times both with CUDA events;
4. drives the decode path, MeterDecoder(device="cuda").decode_numpy, on
   256 synthetic flagship frames and 64 ALT_CAMERA frames with every
   kernel's launch count reset to 0 first: readings within 0.1 of the
   rendered positions, the first 16 rows equal to the CPU decode (plain
   versions), every kernel launched; then a dense-noise window through
   the CCL kernel, non-converged under the default caps and converged
   under the rescue caps, equal to the plain version both times;
5. prints the device time of a steady decode by kernel (torch.profiler)
   and the device busy share;
6. prints a JSON line of per-kernel results, then, only if every phase
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
N_CPU_CHECK = 16  # rows compared with the CPU decode
POS_TOL = 0.1     # reading vs rendered position (dial units)
ANGLE_TOL = 1e-9  # f64 dial positions, card vs CPU (reduction order)
DEVICE = "cuda:0"

REPLACES = {
    "frontend": "meterelf_tpu/ops/pallas_frontend.py:416",
    "windows": "meterelf_tpu/ops/pallas_windows.py:241",
    "ccl": "meterelf_tpu/ops/pallas_ccl.py:501",
    "stats": "meterelf_tpu/ops/pallas_stats.py:247",
}
SOURCES = {k: f"meterelf_tpu_torch/csrc/{k}.cu" for k in REPLACES}


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


def render(camera, n: int, step: float, spread: float):
    """n frames with dial d of frame i at (i*step + d*spread) % 10, the
    position pattern of tests/test_synthetic.py."""
    pos = np.array([[(i * step + d * spread) % 10 for d in range(4)]
                    for i in range(n)])
    return camera.render_crops(pos.tolist()), pos


def pack(crops: np.ndarray) -> np.ndarray:
    c = crops.astype(np.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def circ_err(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs((a - b + 5.0) % 10.0 - 5.0)


def compare_results(gpu, cpu, label: str) -> None:
    """Decode results of the card vs the CPU plain versions: discrete
    fields exact, match_val bitwise, dial positions within ANGLE_TOL
    (f64 sums in another order), value digits exact."""
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


def main() -> int:
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

    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch.ops import components, frontend, stats
    from meterelf_tpu_torch.ops import ccl as ccl_ops
    from meterelf_tpu_torch.ops import windows as win_ops
    from meterelf_tpu_torch.pipeline.decode import MeterDecoder

    t0 = time.perf_counter()
    lib = _build.library()
    say(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {lib.build_seconds:.1f} s) -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            say("  ptxas:", line.strip().split("ptxas info    : ")[-1])

    dev = torch.device(DEVICE)
    failures = []
    results = {k: {"name": k, "route": "cuda", "source": SOURCES[k],
                   "replaces": REPLACES[k]} for k in REPLACES}

    t0 = time.perf_counter()
    cam = synthetic.DEFAULT_CAMERA
    crops, true_pos = render(cam, B_MAIN, 1.7, 2.3)
    alt = synthetic.ALT_CAMERA
    alt_crops, alt_pos = render(alt, B_ALT, 2.1, 1.3)
    say(f"rendered {B_MAIN} + {B_ALT} frames in "
        f"{time.perf_counter() - t0:.1f} s")

    dec = MeterDecoder(cam.make_params(), device=dev)
    pa = dec.param_arrays
    packed = torch.as_tensor(pack(crops)).to(dev)

    # ---- phase 3: each kernel vs its plain version on the card ----
    def phase(name, fn) -> None:
        try:
            fn()
        except Exception:  # report every phase, fail at the end
            failures.append(name)
            say(f"FAIL {name}:\n{traceback.format_exc()}")

    state = {}

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
        results["frontend"]["plain_ms"] = cuda_ms(
            lambda: frontend.frontend_plain(*args), 3)

    def k2() -> None:
        args = (packed, state["mx"], state["my"], dec.geom, dec.disk,
                dec.hue_shift)
        got = win_ops.windows(*args)
        ref = win_ops.windows_plain(*args)
        results["windows"]["max_abs_err"] = float((got - ref).abs().max())
        check(torch.equal(got, ref), "bits differ")
        state["bits"] = got.reshape(-1, 64, 64)
        results["windows"]["ms"] = cuda_ms(lambda: win_ops.windows(*args), 20)
        results["windows"]["plain_ms"] = cuda_ms(
            lambda: win_ops.windows_plain(*args), 5)

    def k3() -> None:
        bits = state["bits"]
        ok_g, cv_g = ccl_ops.ccl(bits)
        ok_r, cv_r = components.propagate(bits)
        results["ccl"]["max_abs_err"] = float((ok_g - ok_r).abs().max())
        check(torch.equal(ok_g, ok_r), "okey3 differs")
        check(torch.equal(cv_g, cv_r), "converged differs")
        state["okey3"] = ok_g
        results["ccl"]["ms"] = cuda_ms(lambda: ccl_ops.ccl(bits), 20)
        results["ccl"]["plain_ms"] = cuda_ms(
            lambda: components.propagate(bits), 3)

    def k4() -> None:
        okey3 = state["okey3"]
        km_g, ha_g = stats.stats(okey3)
        km_r, ha_r = stats.stats_plain(okey3)
        results["stats"]["max_abs_err"] = float((km_g - km_r).abs().max())
        check(torch.equal(km_g, km_r), "keymax differs")
        check(torch.equal(ha_g, ha_r), "has_any differs")
        results["stats"]["ms"] = cuda_ms(lambda: stats.stats(okey3), 20)
        results["stats"]["plain_ms"] = cuda_ms(
            lambda: stats.stats_plain(okey3), 5)

    for name, fn in (("frontend", k1), ("windows", k2), ("ccl", k3),
                     ("stats", k4)):
        phase(f"kernel {name}", fn)
        r = results[name]
        say(f"{name}: max_abs_err {r.get('max_abs_err')} "
            f"kernel {r.get('ms')} ms plain {r.get('plain_ms')} ms "
            f"(shape: B={B_MAIN}, K={4 * B_MAIN})")
        if failures:
            break   # later kernels consume this one's output

    # ---- phase 4: the decode path through the kernels ----
    kernel_fns = (frontend.frontend, win_ops.windows, ccl_ops.ccl,
                  stats.stats)
    alt_dec = MeterDecoder(alt.make_params(), device=dev)

    def slice_run() -> None:
        dec.decode_numpy(crops[:8])   # warm-up (library, allocator)
        torch.cuda.synchronize()
        for fn in kernel_fns:
            fn.launches = 0
        t = time.perf_counter()
        res = dec.decode_numpy(crops)
        res_alt = alt_dec.decode_numpy(alt_crops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {fn.__name__: fn.launches for fn in kernel_fns}
        for name, n in launches.items():
            results[name]["launches"] = n
        say(f"decode path: {B_MAIN} flagship + {B_ALT} ALT frames in "
            f"{wall:.3f} s; launches {launches}")
        for label, r, pos in (("flagship", res, true_pos),
                              ("alt", res_alt, alt_pos)):
            check((r.err == 0).all(), f"{label}: err {np.unique(r.err)}")
            check(r.converged.all(), f"{label}: not converged")
            e = circ_err(r.dial_pos, pos).max()
            say(f"{label}: max reading error {e:.4f} (limit {POS_TOL})")
            check(e < POS_TOL, f"{label}: reading error {e}")
        cpu_dec = MeterDecoder(cam.make_params(), device="cpu")
        cpu_alt = MeterDecoder(alt.make_params(), device="cpu")
        compare_results(type(res)(*[v[:N_CPU_CHECK] for v in res]),
                        cpu_dec.decode_numpy(crops[:N_CPU_CHECK]),
                        "flagship vs CPU")
        compare_results(type(res_alt)(*[v[:N_CPU_CHECK] for v in res_alt]),
                        cpu_alt.decode_numpy(alt_crops[:N_CPU_CHECK]),
                        "alt vs CPU")
        say(f"first {N_CPU_CHECK} rows equal the CPU decode (both cameras)")
        check(all(n > 0 for n in launches.values()),
              f"a kernel of the path was not launched: {launches}")

    def throughput() -> None:
        ms = cuda_ms(lambda: dec(packed), 10)
        say(f"decode (device-resident packed crops, B={B_MAIN}): "
            f"{ms:.3f} ms/batch = {B_MAIN / ms * 1e3:.0f} images/s")
        t = time.perf_counter()
        reps = 5
        for _ in range(reps):
            dec.decode_numpy(crops)
        per = (time.perf_counter() - t) / reps
        say(f"decode_numpy (host u8 crops in, numpy out, B={B_MAIN}): "
            f"{per * 1e3:.3f} ms/batch = {B_MAIN / per:.0f} images/s")

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

    def profile() -> None:
        """Device time by kernel over 5 steady decodes (torch.profiler),
        and the device busy share against their wall time."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        reps = 5
        dec(packed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            dec(packed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                dec(packed)
            torch.cuda.synchronize()
        rows = []     # device kernels only: aten rows repeat their time
        n_ops = 0
        for e in prof.key_averages():
            if str(e.device_type).endswith("CPU"):
                n_ops += e.count if e.key.startswith("aten::") else 0
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                rows.append((us / reps / 1e3, e.count // reps, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        say(f"profile (B={B_MAIN}): wall {wall_ms:.3f} ms/batch, device "
            f"busy {busy:.3f} ms/batch ({100 * busy / wall_ms:.1f}%), "
            f"{sum(r[1] for r in rows)} kernels and {n_ops // reps} aten "
            "ops per batch")
        for ms, n, key in rows[:12]:
            say(f"  {ms:8.4f} ms  x{n:<3d} {key[:90]}")

    if not failures:
        phase("decode path", slice_run)
        phase("throughput", throughput)
        phase("rescue", rescue)
        phase("profile", profile)

    kernels = [results[k] for k in REPLACES]
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
