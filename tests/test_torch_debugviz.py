"""The port's debugviz (render_overlay, render_masks) against the JAX
package's, pixel for pixel as PIL decodes their PNGs, on synthetic
frames of both cameras; and its numpy twin of the JAX package's
ops/color.hls_full_to_bgr, bit for bit over the HLS cube."""
import os

import numpy as np
import pytest
from PIL import Image

from meterelf_tpu import debugviz as j_viz
from meterelf_tpu import synthetic as j_syn
from meterelf_tpu.ops.color import hls_full_to_bgr as j_hls_full_to_bgr
from meterelf_tpu_torch import debugviz as t_viz
from meterelf_tpu_torch import synthetic as t_syn

CAMERAS = {"default": (j_syn.DEFAULT_CAMERA, t_syn.DEFAULT_CAMERA),
           "alt": (j_syn.ALT_CAMERA, t_syn.ALT_CAMERA)}


@pytest.mark.parametrize("hue_shift", [0, 128, 77])
def test_hls_full_to_bgr_twin(hue_shift):
    h, l, s = np.meshgrid(np.arange(256), np.arange(256),
                          np.arange(0, 256, 5), indexing="ij")
    hls = np.stack([h, l, s], -1).astype(np.int32)
    ref = np.asarray(j_hls_full_to_bgr(hls, hue_shift))
    got = t_viz.hls_full_to_bgr(hls, hue_shift)
    assert got.dtype == np.uint8 and np.array_equal(got, ref)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_overlays_and_masks_equal(cam, tmp_path):
    jc, tc = CAMERAS[cam]
    jp = jc.make_params(str(tmp_path / "p"))
    tp = tc.make_params()
    rng = np.random.default_rng(8)
    files = []
    for i, f in enumerate(tc.render_frames(rng.uniform(0, 10, (3, 4))
                                           .tolist())):
        if i == 1:
            f[rng.random(f.shape[:2]) < 0.004] = (40, 40, 200)
        p = str(tmp_path / f"frame{i}.jpg")
        Image.fromarray(f[..., ::-1]).save(p, quality=90)
        files.append(p)
    small = str(tmp_path / "small.jpg")
    Image.fromarray(np.zeros((100, 120, 3), np.uint8)).save(small)
    for fn in files:
        a = j_viz.render_overlay(fn, jp, str(tmp_path / "j"))
        b = t_viz.render_overlay(fn, tp, str(tmp_path / "t"))
        assert os.path.basename(a) == os.path.basename(b)
        ia, ib = Image.open(a), Image.open(b)
        assert ia.mode == ib.mode == "RGB" and ia.size == ib.size
        assert np.array_equal(np.asarray(ia), np.asarray(ib)), fn
    for viz, params, d in ((j_viz, jp, "j"), (t_viz, tp, "t")):
        assert viz.render_overlay(small, params, str(tmp_path / d)) is None
        assert viz.render_overlay(str(tmp_path / "missing.jpg"), params,
                                  str(tmp_path / d)) is None
    ma = j_viz.render_masks(jp, str(tmp_path / "jm"), scale=3)
    mb = t_viz.render_masks(tp, str(tmp_path / "tm"), scale=3)
    assert [os.path.basename(p) for p in ma] == [
        os.path.basename(p) for p in mb]
    for a, b in zip(ma, mb):
        ia, ib = Image.open(a), Image.open(b)
        assert ia.mode == ib.mode == "L"
        assert np.array_equal(np.asarray(ia), np.asarray(ib)), a
