"""Window inputs of the K10/K11 tests: the CPU model
(test_torch_k11_tiles.py) and the card cases (test_torch_cuda.py) use
the same ones. Imports nothing of JAX (the card's machine has none).
chip_smoke.py holds the three windows only K11 takes that its K11 phase
runs (``K11_WINDOWS``) and the u8 plane helper; they are reached through
here.
"""
from chip_smoke import K11_WINDOWS, k11_random_planes, k11_window
from meterelf_tpu_torch import synthetic
from meterelf_tpu_torch.ops import jpegdec
from meterelf_tpu_torch.types import Rect

__all__ = ["JPEG_WINDOWS", "K11_MORE_WINDOWS", "K11_ALL", "K11_WINDOWS",
           "k11_random_planes", "k11_windows"]


# (rect, frame_wh, staging): both cameras' windows, an unaligned one
# (crop row origin 13, plane width 80, staging larger than the window),
# the JAX kernel's second camera geometry (oy = 14, lw = 240), crops that
# end on the last valid chroma row (the halo row clamps) or read it as
# the halo row below a band, and an odd crop origin (x and y)
JPEG_WINDOWS = {
    "flagship": (synthetic.DEFAULT_CAMERA.meter_rect, (640, 480), (250, 250)),
    "alt": (synthetic.ALT_CAMERA.meter_rect, (640, 480), (200, 210)),
    "unaligned": (Rect((9, 13), (70, 72)), (128, 96), (96, 128)),
    "oy14_lw240": (Rect((98, 158), (330, 400)), (640, 480), (248, 240)),
    "last_chroma_row": (Rect((17, 40), (150, 96)), (160, 96), (56, 136)),
    "halo_on_last_chroma_row": (Rect((5, 10), (60, 49)), (64, 50),
                                (40, 56)),
    "odd_origin": (Rect((51, 161), (290, 400)), (640, 480), (240, 240)),
}


# K11 windows beyond JPEG_WINDOWS and chip_smoke.K11_WINDOWS (rect,
# frame_wh, staging or None for the bare crop): the flagship at staging
# widths 251 and 253 (rows 16-byte aligned every fourth only), an odd ox
# with an odd pw, a pad far larger than the crop, a crop past both the
# valid chroma rows and columns, a window of three column tiles, and
# one whose first tile's last quads (ox = 7, a head of 3 on every fourth
# row) reach 3 columns past 256
K11_MORE_WINDOWS = {
    "flagship_pw251": (synthetic.DEFAULT_CAMERA.meter_rect, (640, 480),
                       (252, 251)),
    "flagship_pw253": (synthetic.DEFAULT_CAMERA.meter_rect, (640, 480),
                       (250, 253)),
    "odd_ox_odd_pw": (Rect((51, 161), (290, 400)), (640, 480), (241, 241)),
    "pad_past_crop": (Rect((5, 7), (30, 19)), (64, 48), (64, 99)),
    "past_rows_and_cols": (Rect((40, 30), (144, 110)), (141, 103), None),
    "three_tiles": (Rect((3, 5), (600, 40)), (606, 48), (37, 601)),
    "ox7_odd_pw": (Rect((23, 5), (323, 30)), (340, 40), (25, 301)),
}


def k11_windows():
    """name -> (CoefWindow, staging (ph, pw)) of every K11 window:
    JPEG_WINDOWS, chip_smoke.K11_WINDOWS, K11_MORE_WINDOWS, and
    "far_clamps", the wide window with cw_valid 100 and ch_valid 5 (no
    coef_window gives it; the kernel takes any window tail_ok admits):
    tiles 1-19 read the far column from outside their staged columns, and
    bands below the first read row 4 as the down neighbour; and
    "odd_lbw", the unaligned window 9 luma blocks wide, whose chroma rows
    (36 samples) are 4-byte aligned only."""
    out = {}
    for name, (rect, wh, pad) in {**JPEG_WINDOWS, **K11_MORE_WINDOWS}.items():
        win = jpegdec.coef_window(rect, *wh)
        out[name] = (win, pad or (win.rh, win.rw))
    for name in K11_WINDOWS:
        out[name] = k11_window(name)
    win, pad = out["wide"]
    out["far_clamps"] = (win._replace(cw_valid=100, ch_valid=5), pad)
    win, pad = out["unaligned"]
    out["odd_lbw"] = (win._replace(lbw=9, cw_valid=36), pad)
    return out


K11_ALL = k11_windows()
