"""The decode's last stage: the error codes, the converged reduction and
every BatchResult field in one buffer, and K13 ``result_pack``, its CUDA
kernel.

Port of the end of meterelf_tpu/pipeline/decode.py _decode_batch: the
reference's raise order (load failure, then the template match below
threshold, then the first dial with no needle contours, then any
unreadable dial) and the AND of a row's per-dial CCL convergence flags.

The ten fields lie in one contiguous byte buffer, in BatchResult's order,
each with its own dtype and shape, each starting on a multiple of 8 bytes
(``layout``: the offsets depend on (B, D) alone); each field is a typed
view of that buffer, so the result reaches the host in one copy
(pipeline/decode.py to_host_later). On the CPU ``result_pack`` runs the
plain torch version (``result_pack_plain``) into the same layout; on the
card K13 (csrc/result.cu) writes it in one launch, bit-equal to the plain
version run on the card.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .. import _build
from ..errors import ErrCode
from .launch import check_cuda, counted, raise_on_error, stream_of

ALIGN = 8          # every field starts on a multiple of 8 bytes
MAX_DIALS = 8      # csrc/result.cu kMaxDials
# BatchResult's fields in order: (dtype, per dial)
FIELDS = ((torch.int32, False),    # err
          (torch.int32, False),    # first_bad_dial
          (torch.int32, False),    # unreadable_bits
          (torch.float32, False),  # match_val
          (torch.int32, False),    # match_x
          (torch.int32, False),    # match_y
          (torch.float64, True),   # dial_pos
          (torch.bool, True),      # readable
          (torch.float64, False),  # value
          (torch.bool, False))     # converged

Layout = Tuple[Tuple[int, torch.dtype, Tuple[int, ...]], ...]


@functools.lru_cache(maxsize=64)
def layout(B: int, D: int) -> Tuple[Layout, int]:
    """The fields' (byte offset, dtype, shape) in BatchResult's order and
    the buffer's size in bytes, for B rows of D dials."""
    out, off = [], 0
    for dtype, per_dial in FIELDS:
        shape = (B, D) if per_dial else (B,)
        out.append((off, dtype, shape))
        n = B * (D if per_dial else 1) * dtype.itemsize
        off += -(-n // ALIGN) * ALIGN
    return tuple(out), off


def packed(B: int, D: int, device: torch.device
           ) -> Tuple[torch.Tensor, ...]:
    """The ten typed views of a fresh buffer for B rows of D dials."""
    return views(torch.empty(layout(B, D)[1], dtype=torch.uint8,
                             device=device), B, D)


def views(buf: torch.Tensor, B: int, D: int) -> Tuple[torch.Tensor, ...]:
    """The ten typed views of ``buf``, a u8 buffer of ``layout(B, D)``'s
    size."""
    fields, _ = layout(B, D)
    # one typed base a dtype, then one view a field
    bases = {dtype: buf.view(dtype) for dtype in {d for _, d, _ in fields}}
    return tuple(
        bases[dtype].as_strided(shape, (D, 1) if len(shape) == 2 else (1,),
                                off // dtype.itemsize)
        for off, dtype, shape in fields)


def copied(fields: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The ten typed views of a fresh copy of the buffer whose views
    ``fields`` are (as ``packed`` lays them): one copy on its device."""
    B, D = fields[6].shape      # dial_pos
    buf = torch.empty(0, dtype=torch.uint8, device=fields[0].device)
    return views(buf.set_(fields[0].untyped_storage()).clone(), B, D)


def error_codes(load_ok: torch.Tensor, match_ok: torch.Tensor,
                has_any: torch.Tensor, readable: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's raise order (decode.py:440-467): load failure,
    then template match below threshold, then the first dial with no
    needle contours, then any unreadable dial -> (err, first_bad_dial,
    unreadable_bits), each i32 [B]."""
    i32 = torch.int32
    D = has_any.shape[1]
    no_contours = ~has_any
    first_bad = torch.argmax(no_contours.to(i32), dim=1).to(i32)
    unreadable = ~readable
    # built on the device from Python scalars: no host-to-device copy
    weights = torch.arange(D, dtype=i32, device=readable.device)
    bits = (unreadable.to(i32) << weights).sum(dim=1).to(i32)
    err = torch.full_like(first_bad, int(ErrCode.OK))
    for cond, c in ((unreadable.any(dim=1), ErrCode.DIAL_ANGLE),
                    (no_contours.any(dim=1), ErrCode.NEEDLE_CONTOURS),
                    (~match_ok, ErrCode.DIALS_NOT_FOUND),
                    (~load_ok, ErrCode.LOAD)):
        err = torch.where(cond, int(c), err)
    return err, first_bad, bits


def result_pack_plain(load_ok: torch.Tensor, max_val: torch.Tensor,
                      mx: torch.Tensor, my: torch.Tensor, threshold: float,
                      has_any: torch.Tensor, conv: torch.Tensor,
                      position: torch.Tensor, readable: torch.Tensor,
                      value: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The plain stage: load_ok [B] bool, max_val [B] f32, mx and my [B]
    i32, the match threshold, has_any and conv [B * D] or [B, D] bool,
    K12's position [B, D] f64, readable [B, D] bool and value [B] f64 ->
    the ten BatchResult fields, views of one buffer (``packed``)."""
    B, D = position.shape
    has_any, conv = has_any.reshape(B, D), conv.reshape(B, D)
    err, first_bad, bits = error_codes(load_ok, max_val >= threshold,
                                       has_any, readable)
    out = packed(B, D, position.device)
    for o, v in zip(out, (err, first_bad, bits, max_val, mx, my, position,
                          readable, value, conv.all(dim=1))):
        o.copy_(v)
    return out


def c_args(load_ok: torch.Tensor, max_val: torch.Tensor, mx: torch.Tensor,
           my: torch.Tensor, threshold: float, has_any: torch.Tensor,
           conv: torch.Tensor, position: torch.Tensor,
           readable: torch.Tensor, value: torch.Tensor
           ) -> Tuple[tuple, Tuple[torch.Tensor, ...]]:
    """The arguments of K13's C entry meterelf_result_pack
    (csrc/meterelf_kernels.h) and the ten fields it writes, views of one
    fresh buffer."""
    B, D = position.shape
    dev = position.device
    out = packed(B, D, dev)
    return ((*(t.data_ptr() for t in (load_ok, max_val, mx, my)),
             threshold,
             *(t.data_ptr() for t in (has_any, conv, position, readable,
                                      value)),
             B, D, *(t.data_ptr() for t in out), stream_of(dev)), out)


def result_pack(load_ok: torch.Tensor, max_val: torch.Tensor,
                mx: torch.Tensor, my: torch.Tensor, threshold: float,
                has_any: torch.Tensor, conv: torch.Tensor,
                position: torch.Tensor, readable: torch.Tensor,
                value: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K13 wrapper: the ten BatchResult fields as views of one buffer, as
    ``result_pack_plain``."""
    if position.device.type == "cpu":
        return result_pack_plain(load_ok, max_val, mx, my, threshold,
                                 has_any, conv, position, readable, value)
    check_cuda("result_pack", position, torch.float64, 2, align=8)
    B, D = position.shape
    if not 1 <= D <= MAX_DIALS:
        raise ValueError(f"result_pack kernel takes 1..{MAX_DIALS} dials, "
                         f"got {D}")
    for name, t, dtype, numel, align in (
            ("load_ok", load_ok, torch.bool, B, 1),
            ("max_val", max_val, torch.float32, B, 4),
            ("mx", mx, torch.int32, B, 4), ("my", my, torch.int32, B, 4),
            ("has_any", has_any, torch.bool, B * D, 1),
            ("conv", conv, torch.bool, B * D, 1),
            ("readable", readable, torch.bool, B * D, 1),
            ("value", value, torch.float64, B, 8)):
        check_cuda("result_pack", t, dtype, t.dim(), like=position,
                   align=align)
        if t.numel() != numel:
            raise ValueError(f"result_pack kernel: {name} of shape "
                             f"{tuple(t.shape)}, expected {numel} elements")
    args, out = c_args(load_ok, max_val, mx, my, threshold, has_any, conv,
                       position, readable, value)
    if B == 0:
        return out
    with torch.cuda.device(position.device):
        rc = _build.library().meterelf_result_pack(*args)
    raise_on_error("result_pack", rc)
    result_pack.launches += 1
    return out


counted(result_pack)
