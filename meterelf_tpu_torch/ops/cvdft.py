"""Bit-exact replica of OpenCV's f32-DFT template matching (TM_CCOEFF).

Why this exists: the reference pipeline prints cv2.matchTemplate's
max_val inside DialsNotFoundError strings (reference:
meterelf/_utils.py:88-99, pinned at tests/test_meterelf.py:164-167 as
"match val = 0.0" / "match val = 17495704.0"). Those floats carry
cv2's single-precision DFT rounding, ~1e-6 relative away from the
mathematically exact correlation, so golden parity on match-failure
frames requires reproducing cv2's computation bit for bit — without
importing cv2 at runtime.

This module replicates OpenCV's plain C++ crossCorr path (OpenCV 3.4
modules/imgproc/src/templmatch.cpp + modules/core/src/dxt.cpp), with
every dataflow decision validated empirically against cv2 (IPP
disabled; cv2.matchTemplate's result is IPP-independent for these
shapes, verified on the golden frames). Findings baked in here:

- DFTFactorize: the power-of-two part as ONE leading factor, then odd
  factors in DESCENDING order. Permutation: little-endian digit
  reversal over the factor bases, bit-reversal inside the pow2 digit.
- Twiddles: double-precision cos/sin of -2*pi*k/n, rounded to f32; the
  inverse is bitwise conj(dft(conj(x))) on the forward tables.
- Stages: radix-4 (+ one radix-2) for the pow2 factor, dedicated
  radix-3 / radix-5 butterflies (the only odd factors reachable from
  getOptimalDFTSize sizes), all f32 with no FMA contraction.
- Real rows, even n: half-size complex transform over (even, odd)
  interleave + conjugate-symmetry untangle (the 0.5s are exact).
  Odd n, and BOTH edge columns of the 2D column stage regardless of
  parity: full-length complex transform with zero imaginary input,
  CCS-packed (cv2's column stage does NOT reuse the half-size row
  dataflow — found by element-level probing).
- CCS inverse: unnormalized untangle (no 0.5), half-size complex
  inverse, DFT_SCALE multiplied onto the final real output.
- mulSpectrums: each complex product accumulated in float64, rounded
  once to f32 (cv2 5.x behavior; verified 0 mismatches on 60k+
  elements).
- TM_CCOEFF post-pass: result = corr_f32 - window_sum * templ_mean in
  float64, cast to f32 (integral image in f64, templ mean = exact
  integer sum / N).

Validation (tests/test_cvdft.py): bit-exact vs cv2.matchTemplate on
random u8 images across one-block, multi-block, and odd-size
geometries, and reproduces the two pinned golden strings exactly.

Everything is vectorized over rows/columns only — per-element operation
order matches the scalar C++ loops exactly (IEEE ops round identically
lane-by-lane). Runtime cost is irrelevant: this runs only on
match-failure frames (a rare error path).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np

F = np.float32


def factorize(n: int) -> List[int]:
    """Power-of-two part as one leading factor, then odd descending."""
    factors = []
    f = 1
    while n % 2 == 0:
        f *= 2
        n //= 2
    if f > 1:
        factors.append(f)
    d = 3
    odd = []
    while n > 1:
        while n % d == 0:
            odd.append(d)
            n //= d
        d += 2
    factors.extend(sorted(odd, reverse=True))
    return factors


@lru_cache(maxsize=64)
def _tables(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(itab, wave_re, wave_im) for size n (forward tables; the inverse
    conjugates around them)."""
    factors = factorize(n)
    if factors and factors[0] & 1 == 0:
        m = factors[0].bit_length() - 1

        def rev0(d: int) -> int:
            return int(f"{d:0{m}b}"[::-1], 2) if m else 0
    else:
        def rev0(d: int) -> int:
            return d
    itab = np.zeros(n, np.int64)
    for q in range(n):
        rem = q
        stride = n
        val = 0
        for fi, fct in enumerate(factors):
            d = rem % fct
            rem //= fct
            if fi == 0:
                d = rev0(d)
            stride //= fct
            val += d * stride
        itab[q] = val
    wave_re = np.zeros(n, np.float64)
    wave_im = np.zeros(n, np.float64)
    t = -(math.pi * 2 / n)
    wave_re[0] = 1.0
    if n % 2 == 0:
        wave_re[n // 2] = -1.0
    for i in range(1, (n + 1) // 2):
        wr = math.cos(t * i)
        wi = math.sin(t * i)
        wave_re[i] = wr
        wave_im[i] = wi
        wave_re[n - i] = wr
        wave_im[n - i] = -wi
    return itab, wave_re.astype(F), wave_im.astype(F)


def cdft(re: np.ndarray, im: np.ndarray,
         inv: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Complex DFT of each row of (re, im) [B, n] f32, OpenCV's plain
    dataflow (reference: OpenCV 3.4 dxt.cpp template DFT)."""
    re = np.ascontiguousarray(re, F)
    im = np.ascontiguousarray(im, F)
    _, n = re.shape
    factors = factorize(n)
    itab, wre, wim = _tables(n)
    dre = re[:, itab].copy()
    dim = (-im[:, itab]).copy() if inv else im[:, itab].copy()

    def rd(a, k):
        return a[:, k].copy()

    cur = 1
    fstart = 0
    if factors[0] & 1 == 0:
        f0 = factors[0]
        dw0 = n
        while cur * 4 <= f0:
            nx = cur
            cur *= 4
            dw0 //= 4
            for i in range(0, n, cur):
                v0 = i
                v1 = i + nx * 2
                r0 = rd(dre, v1); i0 = rd(dim, v1)
                r4 = rd(dre, v1 + nx); i4 = rd(dim, v1 + nx)
                r1 = r0 + r4; i1 = i0 + i4
                r3 = i0 - i4; i3 = r4 - r0
                r2 = rd(dre, v0); i2 = rd(dim, v0)
                r4 = rd(dre, v0 + nx); i4 = rd(dim, v0 + nx)
                r0 = r2 + r4; i0 = i2 + i4
                r2 = r2 - r4; i2 = i2 - i4
                dre[:, v0] = r0 + r1; dim[:, v0] = i0 + i1
                dre[:, v1] = r0 - r1; dim[:, v1] = i0 - i1
                dre[:, v0 + nx] = r2 + r3; dim[:, v0 + nx] = i2 + i3
                dre[:, v1 + nx] = r2 - r3; dim[:, v1 + nx] = i2 - i3
                for j in range(1, nx):
                    dw = dw0 * j
                    v0 = i + j
                    v1 = v0 + nx * 2
                    r2 = rd(dre, v0 + nx) * wre[dw * 2] \
                        - rd(dim, v0 + nx) * wim[dw * 2]
                    i2 = rd(dre, v0 + nx) * wim[dw * 2] \
                        + rd(dim, v0 + nx) * wre[dw * 2]
                    r0 = rd(dre, v1) * wim[dw] + rd(dim, v1) * wre[dw]
                    i0 = rd(dre, v1) * wre[dw] - rd(dim, v1) * wim[dw]
                    r3 = rd(dre, v1 + nx) * wim[dw * 3] \
                        + rd(dim, v1 + nx) * wre[dw * 3]
                    i3 = rd(dre, v1 + nx) * wre[dw * 3] \
                        - rd(dim, v1 + nx) * wim[dw * 3]
                    r1 = i0 + i3; i1 = r0 + r3
                    r3 = r0 - r3; i3 = i3 - i0
                    r4 = rd(dre, v0); i4 = rd(dim, v0)
                    r0 = r4 + r2; i0 = i4 + i2
                    r2 = r4 - r2; i2 = i4 - i2
                    dre[:, v0] = r0 + r1; dim[:, v0] = i0 + i1
                    dre[:, v1] = r0 - r1; dim[:, v1] = i0 - i1
                    dre[:, v0 + nx] = r2 + r3; dim[:, v0 + nx] = i2 + i3
                    dre[:, v1 + nx] = r2 - r3; dim[:, v1 + nx] = i2 - i3
        while cur < f0:
            nx = cur
            cur *= 2
            dw0 //= 2
            for i in range(0, n, cur):
                v = i
                r0 = rd(dre, v) + rd(dre, v + nx)
                i0 = rd(dim, v) + rd(dim, v + nx)
                r1 = rd(dre, v) - rd(dre, v + nx)
                i1 = rd(dim, v) - rd(dim, v + nx)
                dre[:, v] = r0; dim[:, v] = i0
                dre[:, v + nx] = r1; dim[:, v + nx] = i1
                for j in range(1, nx):
                    dw = dw0 * j
                    v = i + j
                    r1 = rd(dre, v + nx) * wre[dw] - rd(dim, v + nx) * wim[dw]
                    i1 = rd(dim, v + nx) * wre[dw] + rd(dre, v + nx) * wim[dw]
                    r0 = rd(dre, v); i0 = rd(dim, v)
                    dre[:, v] = r0 + r1; dim[:, v] = i0 + i1
                    dre[:, v + nx] = r0 - r1; dim[:, v + nx] = i0 - i1
        fstart = 1

    for f_idx in range(fstart, len(factors)):
        factor = factors[f_idx]
        nx = cur
        cur *= factor
        dw0 = n // cur
        if factor == 3:
            sin_120 = F(0.86602540378443864676372317075294)
            half = F(0.5)
            for i in range(0, n, cur):
                for j in range(nx):
                    dw = dw0 * j
                    v = i + j
                    if j == 0:
                        r1 = rd(dre, v + nx) + rd(dre, v + nx * 2)
                        i1 = rd(dim, v + nx) + rd(dim, v + nx * 2)
                        r0 = rd(dre, v); i0 = rd(dim, v)
                        r2 = sin_120 * (rd(dim, v + nx) - rd(dim, v + nx * 2))
                        i2 = sin_120 * (rd(dre, v + nx * 2) - rd(dre, v + nx))
                    else:
                        r0 = rd(dre, v + nx) * wre[dw] \
                            - rd(dim, v + nx) * wim[dw]
                        i0 = rd(dre, v + nx) * wim[dw] \
                            + rd(dim, v + nx) * wre[dw]
                        i2 = rd(dre, v + nx * 2) * wre[dw * 2] \
                            - rd(dim, v + nx * 2) * wim[dw * 2]
                        r2 = rd(dre, v + nx * 2) * wim[dw * 2] \
                            + rd(dim, v + nx * 2) * wre[dw * 2]
                        r1 = r0 + i2; i1 = i0 + r2
                        r2 = sin_120 * (i0 - r2); i2 = sin_120 * (i2 - r0)
                        r0 = rd(dre, v); i0 = rd(dim, v)
                    dre[:, v] = r0 + r1; dim[:, v] = i0 + i1
                    r0 = r0 - half * r1; i0 = i0 - half * i1
                    dre[:, v + nx] = r0 + r2; dim[:, v + nx] = i0 + i2
                    dre[:, v + nx * 2] = r0 - r2; dim[:, v + nx * 2] = i0 - i2
        elif factor == 5:
            fft5_2 = F(0.559016994374947424102293417182819)
            fft5_3 = F(-0.951056516295153572116439333379382)
            fft5_4 = F(-1.538841768587626701285145288018455)
            fft5_5 = F(0.363271264002680442947733378740309)
            quarter = F(0.25)
            for i in range(0, n, cur):
                for j in range(nx):
                    dw = dw0 * j
                    v0 = i + j
                    v1 = v0 + nx * 2
                    v2 = v1 + nx * 2
                    r3 = rd(dre, v0 + nx) * wre[dw] - rd(dim, v0 + nx) * wim[dw]
                    i3 = rd(dre, v0 + nx) * wim[dw] + rd(dim, v0 + nx) * wre[dw]
                    r2 = rd(dre, v2) * wre[dw * 4] - rd(dim, v2) * wim[dw * 4]
                    i2 = rd(dre, v2) * wim[dw * 4] + rd(dim, v2) * wre[dw * 4]
                    r1 = r3 + r2; i1 = i3 + i2
                    r3 = r3 - r2; i3 = i3 - i2
                    r4 = rd(dre, v1 + nx) * wre[dw * 3] \
                        - rd(dim, v1 + nx) * wim[dw * 3]
                    i4 = rd(dre, v1 + nx) * wim[dw * 3] \
                        + rd(dim, v1 + nx) * wre[dw * 3]
                    r0 = rd(dre, v1) * wre[dw * 2] - rd(dim, v1) * wim[dw * 2]
                    i0 = rd(dre, v1) * wim[dw * 2] + rd(dim, v1) * wre[dw * 2]
                    r2 = r4 + r0; i2 = i4 + i0
                    r4 = r4 - r0; i4 = i4 - i0
                    r0 = rd(dre, v0); i0 = rd(dim, v0)
                    r5 = r1 + r2; i5 = i1 + i2
                    dre[:, v0] = r0 + r5; dim[:, v0] = i0 + i5
                    r0 = r0 - quarter * r5; i0 = i0 - quarter * i5
                    r1 = fft5_2 * (r1 - r2); i1 = fft5_2 * (i1 - i2)
                    r2 = -fft5_3 * (i3 + i4); i2 = fft5_3 * (r3 + r4)
                    i3 = i3 * (-fft5_5); r3 = r3 * fft5_5
                    i4 = i4 * (-fft5_4); r4 = r4 * fft5_4
                    r5 = r2 + i3; i5 = i2 + r3
                    r2 = r2 - i4; i2 = i2 - r4
                    r3 = r0 + r1; i3 = i0 + i1
                    r0 = r0 - r1; i0 = i0 - i1
                    dre[:, v0 + nx] = r3 + r2; dim[:, v0 + nx] = i3 + i2
                    dre[:, v2] = r3 - r2; dim[:, v2] = i3 - i2
                    dre[:, v1] = r0 + r5; dim[:, v1] = i0 + i5
                    dre[:, v1 + nx] = r0 - r5; dim[:, v1 + nx] = i0 - i5
        else:
            raise NotImplementedError(
                f"radix {factor}: not reachable from getOptimalDFTSize "
                "sizes (2^a 3^b 5^c)")

    if inv:
        dim = -dim
    return dre, dim


def _zero_im_ccs(x: np.ndarray) -> np.ndarray:
    """Real rows -> CCS rows via full-length complex transforms with
    zero imaginary input (cv2's odd-n row path and 2D edge-column
    path)."""
    B, n = x.shape
    zr, zi = cdft(x, np.zeros_like(x))
    out = np.empty((B, n), F)
    out[:, 0] = zr[:, 0]
    if n % 2 == 0:
        m = n // 2
        out[:, n - 1] = zr[:, m]
        ks = np.arange(1, m)
    else:
        ks = np.arange(1, (n - 1) // 2 + 1)
    out[:, 2 * ks - 1] = zr[:, ks]
    out[:, 2 * ks] = zi[:, ks]
    return out


def rdft_rows(x: np.ndarray) -> np.ndarray:
    """Real forward DFT of each row [B, n] f32 -> CCS rows."""
    x = np.ascontiguousarray(x, F)
    B, n = x.shape
    if n % 2:
        return _zero_im_ccs(x)
    m = n // 2
    zr, zi = cdft(x[:, 0::2], x[:, 1::2])
    _, wre, wim = _tables(n)
    out = np.empty((B, n), F)
    out[:, 0] = zr[:, 0] + zi[:, 0]
    out[:, n - 1] = zr[:, 0] - zi[:, 0]
    half = F(0.5)
    ks = np.arange(1, m)
    zr_k = zr[:, ks]; zi_k = zi[:, ks]
    zr_mk = zr[:, m - ks]; zi_mk = zi[:, m - ks]
    wr = wre[ks]; wi = wim[ks]
    h1r = half * (zr_k + zr_mk)
    h1i = half * (zi_k - zi_mk)
    h2r = half * (zi_k + zi_mk)
    h2i = half * (zr_mk - zr_k)
    out[:, 2 * ks - 1] = h1r + (wr * h2r - wi * h2i)
    out[:, 2 * ks] = h1i + (wr * h2i + wi * h2r)
    return out


def ccsidft_rows(ccs: np.ndarray, scale: float = None) -> np.ndarray:
    """CCS rows [B, n] -> real inverse rows, times `scale`. cv2's
    inverse untangle is UNNORMALIZED (no 0.5); DFT_SCALE multiplies the
    final real output."""
    ccs = np.ascontiguousarray(ccs, F)
    B, n = ccs.shape
    if n % 2:
        # full conjugate-symmetric spectrum -> complex inverse
        m = (n - 1) // 2
        zr = np.empty((B, n), F)
        zi = np.empty((B, n), F)
        zr[:, 0] = ccs[:, 0]; zi[:, 0] = 0
        ks = np.arange(1, m + 1)
        zr[:, ks] = ccs[:, 2 * ks - 1]
        zi[:, ks] = ccs[:, 2 * ks]
        zr[:, n - ks] = ccs[:, 2 * ks - 1]
        zi[:, n - ks] = -ccs[:, 2 * ks]
        out, _ = cdft(zr, zi, inv=True)
    else:
        m = n // 2
        _, wre, wim = _tables(n)
        zr = np.empty((B, m), F)
        zi = np.empty((B, m), F)
        ks = np.arange(1, m)
        xr_k = ccs[:, 2 * ks - 1]; xi_k = ccs[:, 2 * ks]
        xr_mk = ccs[:, 2 * (m - ks) - 1]; xi_mk = -ccs[:, 2 * (m - ks)]
        wr = wre[ks]; wi = wim[ks]
        h1r = xr_k + xr_mk
        h1i = xi_k + xi_mk
        h2r = xr_k - xr_mk
        h2i = xi_k - xi_mk
        br = wr * h2r + wi * h2i
        bi = wr * h2i - wi * h2r
        zr[:, ks] = h1r - bi
        zi[:, ks] = h1i + br
        zr[:, 0] = ccs[:, 0] + ccs[:, n - 1]
        zi[:, 0] = ccs[:, 0] - ccs[:, n - 1]
        yr, yi = cdft(zr, zi, inv=True)
        out = np.empty((B, n), F)
        out[:, 0::2] = yr
        out[:, 1::2] = yi
    if scale is not None:
        out = F(scale) * out
    return out


def rdft2(a: np.ndarray) -> np.ndarray:
    """2D real forward DFT -> 2D CCS (rows first, then columns; the
    edge columns run as zero-imaginary full complex transforms)."""
    a = np.ascontiguousarray(a, F)
    H, W = a.shape
    rows = rdft_rows(a)
    out = rows.copy()
    edge_cols = [0] + ([W - 1] if W % 2 == 0 else [])
    cols = np.stack([rows[:, c] for c in edge_cols])
    ccs_cols = _zero_im_ccs(cols)
    for r, c in enumerate(edge_cols):
        out[:, c] = ccs_cols[r]
    js = np.arange(1, (W + 1) // 2)
    if len(js):
        cre = rows[:, 2 * js - 1].T.copy()
        cim = rows[:, 2 * js].T.copy()
        yre, yim = cdft(cre, cim)
        out[:, 2 * js - 1] = yre.T
        out[:, 2 * js] = yim.T
    return out


def _ccs_sym_inverse(packed: np.ndarray) -> np.ndarray:
    """CCS rows -> real rows via full conjugate-symmetric spectrum
    reconstruction + full-length complex inverse (the mirror of
    _zero_im_ccs; cv2's 2D column stage uses this for the edge columns
    in BOTH parities, unlike its half-size row inverse)."""
    B, n = packed.shape
    zr = np.empty((B, n), F)
    zi = np.empty((B, n), F)
    zr[:, 0] = packed[:, 0]
    zi[:, 0] = 0
    if n % 2 == 0:
        m = n // 2
        zr[:, m] = packed[:, n - 1]
        zi[:, m] = 0
        ks = np.arange(1, m)
    else:
        ks = np.arange(1, (n - 1) // 2 + 1)
    zr[:, ks] = packed[:, 2 * ks - 1]
    zi[:, ks] = packed[:, 2 * ks]
    zr[:, n - ks] = packed[:, 2 * ks - 1]
    zi[:, n - ks] = -packed[:, 2 * ks]
    yr, _ = cdft(zr, zi, inv=True)
    return yr


def ccsidft2(ccs: np.ndarray, scale: bool = True) -> np.ndarray:
    """2D CCS -> real inverse with DFT_SCALE = 1/(H*W) (columns first;
    the full scale rides the row stage's final output)."""
    ccs = np.ascontiguousarray(ccs, F)
    H, W = ccs.shape
    work = ccs.copy()
    edge_cols = [0] + ([W - 1] if W % 2 == 0 else [])
    packed = np.stack([ccs[:, c] for c in edge_cols])
    real_cols = _ccs_sym_inverse(packed)
    for r, c in enumerate(edge_cols):
        work[:, c] = real_cols[r]
    js = np.arange(1, (W + 1) // 2)
    if len(js):
        cre = ccs[:, 2 * js - 1].T.copy()
        cim = ccs[:, 2 * js].T.copy()
        yre, yim = cdft(cre, cim, inv=True)
        work[:, 2 * js - 1] = yre.T
        work[:, 2 * js] = yim.T
    return ccsidft_rows(work, scale=(1.0 / (H * W)) if scale else None)


def mul_spectrums_conj(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mulSpectrums(a, b, conjB=True) on 2D CCS: complex products
    accumulated in float64, rounded once (cv2 5.x plain path)."""
    a64 = np.ascontiguousarray(a, np.float64)
    b64 = np.ascontiguousarray(b, np.float64)
    H, W = a64.shape
    out = np.empty((H, W), F)
    js = np.arange(1, (W + 1) // 2)
    if len(js):
        ar = a64[:, 2 * js - 1]; ai = a64[:, 2 * js]
        br = b64[:, 2 * js - 1]; bi = b64[:, 2 * js]
        out[:, 2 * js - 1] = (ar * br + ai * bi).astype(F)
        out[:, 2 * js] = (ai * br - ar * bi).astype(F)
    edge_cols = [0] + ([W - 1] if W % 2 == 0 else [])
    for c in edge_cols:
        out[0, c] = F(a64[0, c] * b64[0, c])
        if H % 2 == 0:
            out[H - 1, c] = F(a64[H - 1, c] * b64[H - 1, c])
            is_ = np.arange(1, H // 2)
        else:
            is_ = np.arange(1, (H - 1) // 2 + 1)
        ar = a64[2 * is_ - 1, c]; ai = a64[2 * is_, c]
        br = b64[2 * is_ - 1, c]; bi = b64[2 * is_, c]
        out[2 * is_ - 1, c] = (ar * br + ai * bi).astype(F)
        out[2 * is_, c] = (ai * br - ar * bi).astype(F)
    return out


@lru_cache(maxsize=None)
def get_optimal_dft_size(n: int) -> int:
    """Smallest 2^a 3^b 5^c >= n (cv2.getOptimalDFTSize)."""
    best = None
    a = 1
    while a < n * 2:
        b = a
        while b < n * 2:
            c = b
            while c < n * 2:
                if c >= n and (best is None or c < best):
                    best = c
                c *= 5
            b *= 3
        a *= 2
    return best


def cross_corr(img_u8: np.ndarray, templ_u8: np.ndarray) -> np.ndarray:
    """OpenCV crossCorr, f32 DFT path, u8 single-channel inputs
    (reference: OpenCV 3.4 templmatch.cpp crossCorr: blockScale 4.5,
    minBlockSize 256, per-block forward/mul/inverse)."""
    ih, iw = img_u8.shape
    th, tw = templ_u8.shape
    ch, cw = ih - th + 1, iw - tw + 1
    bw = min(max(round(tw * 4.5), 256 - tw + 1), cw)
    bh = min(max(round(th * 4.5), 256 - th + 1), ch)
    dw = max(get_optimal_dft_size(bw + tw - 1), 2)
    dh = get_optimal_dft_size(bh + th - 1)
    bw = min(dw - tw + 1, cw)
    bh = min(dh - th + 1, ch)

    dft_templ = np.zeros((dh, dw), F)
    dft_templ[:th, :tw] = templ_u8.astype(F)
    spec_t = rdft2(dft_templ)

    corr = np.empty((ch, cw), F)
    for y in range(0, ch, bh):
        for x in range(0, cw, bw):
            bsz_h = min(bh, ch - y)
            bsz_w = min(bw, cw - x)
            y2 = min(ih, y + dh)
            x2 = min(iw, x + dw)
            blk = np.zeros((dh, dw), F)
            blk[:y2 - y, :x2 - x] = img_u8[y:y2, x:x2].astype(F)
            blk[bsz_h + th - 1:, :] = 0
            blk[:, bsz_w + tw - 1:] = 0
            res = ccsidft2(mul_spectrums_conj(rdft2(blk), spec_t))
            corr[y:y + bsz_h, x:x + bsz_w] = res[:bsz_h, :bsz_w]
    return corr


def match_template_ccoeff(img_u8: np.ndarray,
                          templ_u8: np.ndarray) -> np.ndarray:
    """cv2.matchTemplate(img, templ, TM_CCOEFF), bit-exact, no cv2.

    The CCOEFF post-pass subtracts window_sum * templ_mean in float64
    per result element and casts to f32 (reference: OpenCV 3.4
    templmatch.cpp common_matchTemplate numType==1)."""
    corr = cross_corr(img_u8, templ_u8)
    th, tw = templ_u8.shape
    ih, iw = img_u8.shape
    ch, cw = corr.shape
    tmean = float(templ_u8.astype(np.float64).sum()) / (th * tw)
    ii = np.zeros((ih + 1, iw + 1), np.float64)
    ii[1:, 1:] = np.cumsum(np.cumsum(img_u8.astype(np.float64), 0), 1)
    wnd = (ii[th:th + ch, tw:tw + cw] - ii[th:th + ch, :cw]
           - ii[:ch, tw:tw + cw] + ii[:ch, :cw])
    return (corr.astype(np.float64) - wnd * tmean).astype(F)


def match_template_max(img_u8: np.ndarray, templ_u8: np.ndarray) -> float:
    """max over the TM_CCOEFF map — the reference's printed `match val`
    (cv2.minMaxLoc max_val, reference meterelf/_utils.py:93-99)."""
    return float(match_template_ccoeff(img_u8, templ_u8).max())
