"""CPU self-checks of the benchmark's yardstick (not part of the repo's
tier-1 suite): run with ``python -m pytest bench_torch/tests -q`` from
the root of the repository (~2 min).

- the traffic generator is the same for one seed and differs across
  seeds, and is the program's synthetic renderer and encoder, bit for bit;
- the copied bound arithmetic equals chip_smoke.py's at B=256;
- every name and unit in BENCHMARK.json keeps to the contract's
  characters and lengths, and every cell and metric has its files;
- the plain reference reads what the program's plain CPU path reads;
- the entropy decode of a cut file gives the program's pixels."""
from __future__ import annotations

import json
import os
import re
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

from control import config as cfg_of  # noqa: E402
from harness import gen, jpegread, reference, roofline  # noqa: E402


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        return json.load(fp)


def test_generator_seeded():
    cfg = cfg_of("flagship")
    a = [gen.render_task(t)[0] for t in gen.pool_tasks(cfg, 2**40 + 3, 3)]
    b = [gen.render_task(t)[0] for t in gen.pool_tasks(cfg, 2**40 + 3, 3)]
    c = [gen.render_task(t)[0] for t in gen.pool_tasks(cfg, 2**40 + 4, 3)]
    assert a == b
    assert all(x != y for x, y in zip(a, c))
    o1, o2 = gen.Order(5, 256, 256), gen.Order(5, 256, 256)
    assert all((o1(k) == o2(k)).all() for k in range(5))
    assert sorted(o1(3)) == list(range(256))


@pytest.mark.parametrize("name,camera", [("flagship", "DEFAULT_CAMERA"),
                                         ("five_dial", "FIVE_DIAL_CAMERA")])
def test_generator_is_the_synthetic_renderer(name, camera):
    from meterelf_tpu_torch import synthetic

    cfg = cfg_of(name)
    cam = getattr(synthetic, camera)
    assert (gen.make_template(cfg) == cam.make_template()).all()
    for _, pos, off in gen.pool_tasks(cfg, 11, 2):
        frame = gen.render_frame(cfg, gen.make_template(cfg), pos, off)
        assert (frame == cam.render_frame(list(pos), offset=off)).all()
        assert gen.encode_jpeg(frame, 92)[0] == synthetic.encode_jpeg(
            frame, 92)


@pytest.mark.parametrize("kernel,ms", [
    ("frontend", 0.048133), ("jpeg_tail", 0.035264),
    ("windows", 0.010022), ("ccl", 0.010017), ("stats", 0.005010)])
def test_bounds_equal_chip_smoke(kernel, ms):
    bound = getattr(roofline, kernel + "_ms")
    assert round(bound(cfg_of("flagship"), 256), 6) == ms


def test_benchmark_names_and_files():
    b = bench()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"]), m
    for c in b["configs"]:
        assert name.match(c["name"])
        assert all(name.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert cfg_of(c["name"])["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved["workloads"])
    assert len({m["name"] for m in metrics}) == len(metrics)


@pytest.mark.parametrize("name", ["flagship", "five_dial"])
def test_reference_reads_what_the_program_reads(name):
    """The program's plain CPU path (its coefficient step on the host
    feed) and the reference agree on every field of 6 frames."""
    from meterelf_tpu_torch.io import jpeg as jio
    from meterelf_tpu_torch.pipeline.decode import (_to_numpy,
                                                     make_coef_decode_fn)

    from harness import compare, program

    cfg = cfg_of(name)
    frames = [gen.render_task(t) for t in gen.pool_tasks(cfg, 21, 6)]
    prm = program.params(cfg)
    dec = program.keeping_decoder(prm, "cpu", "none")
    step, _win, pad_hw = make_coef_decode_fn(dec, (640, 480))
    feed = jio.load_coef_feed([f[0] for f in frames], prm.meter_rect,
                              (640, 480), pad_hw)
    got = _to_numpy(step(None, *feed))
    coefs = [np.stack([f[1][i] for f in frames]) for i in range(3)]
    ref = reference.read_frames(cfg, reference.geometry(cfg), coefs,
                                np.ones(6, bool), "cpu")
    nums = compare.numbers(np.arange(6), got._asdict(), ref)
    lim = compare.limits()
    assert all(v <= lim[k] for k, v in nums.items()), nums


def test_cut_file_decodes_as_the_program_decodes():
    from meterelf_tpu_torch.io import jpeg as jio
    import torch

    cfg = cfg_of("flagship")
    tmpl = gen.make_template(cfg)
    _, pos, off = gen.pool_tasks(cfg, 31, 1)[0]
    data, natural, _qt = gen.encode_jpeg(
        gen.render_frame(cfg, tmpl, pos, off), 92)
    full = jpegread.coefficients(data, cfg)
    assert all((a == b).all() for a, b in zip(full, natural))
    cut = data[:len(data) // 2]
    w = gen.window_coefs(cfg, jpegread.coefficients(cut, cfg))
    ref = reference.crops_from_coefs(
        cfg, [torch.as_tensor(a[None]) for a in w],
        torch.as_tensor(gen.qtables(cfg)))[0].numpy()
    from harness import program

    packed, ok = jio.load_packed_crops_from_bytes(
        [cut], program.params(cfg).meter_rect, (250, 250))
    p = packed[0]
    bgr = np.stack([p & 255, (p >> 8) & 255, (p >> 16) & 255], -1)
    assert ok[0] and (bgr == ref).all()
