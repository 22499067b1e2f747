"""Public streaming API (reference: meterelf/_api.py:16-33) on the port's
batched decoder.

Port of meterelf_tpu/api.py. ``get_meter_values`` keeps the reference's
generator contract (one MeterImageData per filename, errors returned,
not raised, except under DEBUG) while decoding in batches: each batch of
files is decoded, cropped and packed by one C pass
(io/jpeg.load_packed_crops_from_bytes) and read by
``MeterDecoder.decode_numpy``. Error objects and message strings are
rebuilt from the error codes, so the CLI prints what the JAX package's
prints, byte for byte.

The decoder runs on ``device`` (None: the environment's
``METERELF_DEVICE``, default ``cuda``); without a card it raises, as
MeterDecoder does: nothing falls back to the CPU unless asked.
"""
from __future__ import annotations

import os
from typing import (Any, Dict, Iterable, Iterator, NamedTuple, Optional,
                    Sequence)

import numpy as np

from . import debugging
from .errors import (
    DialAngleDeterminingError,
    DialsNotFoundError,
    ErrCode,
    ImageLoadingError,
    ImageProcessingError,
    NeedleContoursNotFoundError,
)
from .io import jpeg as jpeg_io
from .params import Params, load as load_params
from .pipeline.decode import BatchResult, MeterDecoder


class MeterImageData(NamedTuple):
    filename: str
    value: Optional[float]
    error: Optional[ImageProcessingError]
    meter_values: Dict[str, float]


def _parity_match_val(filename: str, params: Params) -> Optional[float]:
    """cv2's printed TM_CCOEFF max_val for the DIALS_NOT_FOUND string:
    OpenCV's f32-DFT score differs from the exact one by ~1e-6 relative,
    and the reference's golden strings embed that rounding; ops/cvdft.py
    reproduces it bit for bit on the host (a rare error path)."""
    from .ops.cvdft import match_template_max

    img = jpeg_io.decode_file(filename)
    if img is None:
        return None
    crop = jpeg_io.crop_rect(img, params.meter_rect)
    hls = _host_hls(crop, params.hue_shift)
    return match_template_max(hls[:, :, 1], params.arrays().template_u8)


def _host_hls(bgr: np.ndarray, hue_shift: int) -> np.ndarray:
    """Host numpy twin of the exact BGR -> HLS_FULL conversion with the
    hue shift (uint8 output)."""
    scale = np.float32(1.0) / np.float32(255.0)
    b = bgr[..., 0].astype(np.float32) * scale
    g = bgr[..., 1].astype(np.float32) * scale
    r = bgr[..., 2].astype(np.float32) * scale
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    l = (vmax + vmin) * np.float32(0.5)
    diff = vmax - vmin
    nonzero = vmax != vmin
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(l < np.float32(0.5), diff / (vmax + vmin),
                     diff / (np.float32(2.0) - vmax - vmin)).astype(np.float32)
        d60 = (np.float32(60.0) / diff).astype(np.float32)
        h = np.where(vmax == r, (g - b) * d60,
                     np.where(vmax == g, (b - r) * d60 + np.float32(120.0),
                              (r - g) * d60 + np.float32(240.0))).astype(np.float32)
    h = np.where(h < 0, h + np.float32(360.0), h).astype(np.float32)
    h = np.where(nonzero, h, np.float32(0.0))
    s = np.where(nonzero, s, np.float32(0.0))

    def sat(x):
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)

    h8 = sat(h * (np.float32(256.0) / np.float32(360.0)))
    h8 = (h8.astype(np.int32) + hue_shift) % 256
    return np.stack(
        [h8.astype(np.uint8), sat(l * np.float32(255.0)),
         sat(s * np.float32(255.0))], axis=-1)


def result_to_data(
    filename: str,
    res: BatchResult,
    i: int,
    params: Params,
    *,
    parity_match_val: bool = True,
) -> MeterImageData:
    """Convert slot i of a host BatchResult into the reference's API
    record."""
    names = params.dial_names
    err_code = int(res.err[i])
    error: Optional[ImageProcessingError] = None
    meter_values: Dict[str, float] = {}

    readable_positions: Dict[str, float] = {}
    if err_code in (ErrCode.OK, ErrCode.DIAL_ANGLE):
        readable = np.asarray(res.readable[i])
        for d, name in enumerate(names):
            if readable[d]:
                readable_positions[name] = float(res.dial_pos[i, d])

    if err_code == ErrCode.LOAD:
        error = ImageLoadingError(filename)
    elif err_code == ErrCode.DIALS_NOT_FOUND:
        mv: Optional[float] = None
        if parity_match_val:
            mv = _parity_match_val(filename, params)
        if mv is None:
            mv = float(res.match_val[i])
        error = DialsNotFoundError(filename, extra_info={"match val": mv})
    elif err_code == ErrCode.NEEDLE_CONTOURS:
        bad = names[int(res.first_bad_dial[i])]
        error = NeedleContoursNotFoundError(extra_info={"dial": bad})
    elif err_code == ErrCode.DIAL_ANGLE:
        bits = int(res.unreadable_bits[i])
        unreadable = [n for d, n in enumerate(names) if bits & (1 << d)]
        extra: Dict[str, object] = {}
        if debugging.DEBUG:
            extra["dial positions"] = " (" + " | ".join(
                "{}: {}".format(k, "{:.2f}".format(v))
                for (k, v) in sorted(readable_positions.items())
            ) + ")"
        extra["unreadable dials"] = ", ".join(unreadable)
        error = DialAngleDeterminingError(filename, extra_info=extra)

    value: Optional[float] = None
    if err_code == ErrCode.OK:
        # the reference returns {} for errored images (the exception
        # propagates before meter_values is assigned, _api.py:22-31); on
        # success the dict holds the per-dial positions in params order,
        # plus 'value' when all four dials read
        meter_values = dict(readable_positions)
        if len(names) == 4 and len(readable_positions) == len(names):
            value = float(res.value[i])
            meter_values["value"] = value

    return MeterImageData(filename, value, error, meter_values)


def get_meter_values(
    params_file: str,
    filenames: Iterable[str],
    *,
    batch_size: int = 64,
    exact: bool = True,
    decoder: Optional[MeterDecoder] = None,
    device: Any = None,
) -> Iterator[MeterImageData]:
    """One MeterImageData per filename, in order, decoded ``batch_size``
    files at a time (empty slots pad the last batch) by ``decoder`` or a
    MeterDecoder(exact=exact) on ``device`` (None: ``METERELF_DEVICE``,
    default ``cuda``)."""
    params = load_params(params_file)
    if device is None:
        device = os.environ.get("METERELF_DEVICE", "cuda")
    dec = decoder or MeterDecoder(params, exact=exact, device=device)

    def flush(batch: Sequence[str]) -> Iterator[MeterImageData]:
        datas = []
        for fn in batch:
            try:
                with open(fn, "rb") as fp:
                    datas.append(fp.read())
            except OSError:
                datas.append(b"")
        datas += [b""] * (batch_size - len(batch))
        # one C pass: decode + crop + pack into the decoder's layout
        packed, ok = jpeg_io.load_packed_crops_from_bytes(
            datas, params.meter_rect, dec.feed_pad_hw)
        res = dec.decode_numpy(packed, ok)
        for i, fn in enumerate(batch):
            data = result_to_data(fn, res, i, params)
            if data.error is not None:
                debugging_reraise(data.error)
            yield data

    batch: list = []
    for fn in filenames:
        batch.append(fn)
        if len(batch) == batch_size:
            yield from flush(batch)
            batch = []
    if batch:
        yield from flush(batch)


def debugging_reraise(error: ImageProcessingError) -> None:
    """Reference: exceptions are re-raised under DEBUG (_api.py:26-30)."""
    if debugging.DEBUG:
        raise error
