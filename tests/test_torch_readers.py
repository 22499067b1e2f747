"""The port's own readers, which replace PyYAML and Pillow on the card's
machine, against those libraries: io/yaml_subset.load against
yaml.safe_load (both cameras' parameters in block and flow style, a
table of scalar edge cases, comments and quoting; what the subset
refuses raises), and io/png.read_gray against PIL's convert("L") (modes
L, LA, RGB, RGBA and P, every row filter, the synthetic templates; what
the reader refuses raises). The writers' output reads back equal through
yaml.safe_load and PIL."""
import os
import struct
import zlib

import numpy as np
import pytest
import yaml
from PIL import Image

from meterelf_tpu_torch import params as t_params
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.io import png, yaml_subset

CAMERAS = {"default": t_syn.DEFAULT_CAMERA, "alt": t_syn.ALT_CAMERA,
           "five": t_syn.FIVE_DIAL_CAMERA}


def _same(a, b):
    """Equal values of equal types, recursively (1 == 1.0 == True is not
    enough: the params schema checks types strictly)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return type(a) is type(b) and a == b


# ---------------------------------------------------------------- YAML

@pytest.mark.parametrize("style", [False, True, None])
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_yaml_params_dumps_equal_safe_load(cam, style):
    d = CAMERAS[cam].params_dict("x/synthetic_template.png")
    text = yaml.safe_dump(d, default_flow_style=style)
    assert _same(yaml_subset.load(text), yaml.safe_load(text))
    assert _same(yaml_subset.load(text), d)


SCALARS = [
    "90", "-4.5", "1.0", "1e3", "1.0e+3", "1.0e3", ".5", "+.5", "1.",
    "-0", "+12", "0x1F", "0o17", "017", "0b101", "1_000", "1:30", "1:30.5",
    "1_0.0_1", ".inf", "-.Inf", ".NaN", "~", "null", "Null", "NULL", "",
    "yes", "Yes", "YES", "yEs", "no", "on", "ON", "Off", "off", "y", "n",
    "true", "True", "TRUE", "tRue", "false", "'1.0'", '"90"', "'yes'",
    "'it''s'", '"a\\tb\\u00e9\\x41\\\\"', "a#b", "a #b", "v v  v",
    "http://x/y", "-x", "x%", "0.0001", "'0.0001'", "'*.jpg'",
]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_resolve_as_safe_load(text):
    doc = f"k: {text}\n"
    assert _same(yaml_subset.load(doc), yaml.safe_load(doc)), doc


def test_yaml_comments_quoting_and_nesting():
    docs = [
        "# head\nk: v # c\n# full\nj: w#x\n",
        "k:    # c\n  v\n",
        "'q': 1\n\"r\": [a, 'b c', \"d\"]\n",
        "k:\n- 1\n- 2\nj: 3\n",
        "- a: 1\n  b: 2\n- c\n- - d\n  - e\n",
        "k:\n  - a\n  -   b: 1\n      c: 2\n",
        "a:\n  b:\n  - 1\n  c: 2\n",
        "k: [a, b, ]\nj: {a, b: }\nl: {}\nm: []\n",
        "k: {a: {b: [1, {c: 2}]}, d: [e,\n    f]}\n",
        "k: [a #c\n   , b]\n",
        "1: a\ntrue: b\n~: c\n",
        "a: 1\na: 2\n",
        "k: v\r\nj: w\r\n",
        "k:\n- a\n-\n- b\n",
        "",
        "# only a comment\n",
        "[1, 2]\n",
        "scalar\n",
    ]
    for doc in docs:
        assert _same(yaml_subset.load(doc), yaml.safe_load(doc)), doc


@pytest.mark.parametrize("doc", [
    "k: &a v", "k: *a", "k: !!str 1", "k: |\n  x", "k: >\n  x",
    "? a\n: b", "---\nk: v", "k: v\n---\nj: w", "%YAML 1.1\n---\nk: v",
    "k: a\n  b", "k: 'a\n  b'", "k: [a\n  b]", "k: 2018-01-01",
    "k: <<", "k: [a: b]", "k: {a:1}", "k: \tv", "k: a: b",
    "  k: v\n j: w", "k:\n  a: 1\n b: 2", "k: 'a'b", "k: [a] b",
    "k: [a", "k: @x", "k: `x", "k: 0b_", "a: b\n- c",
])
def test_yaml_outside_the_subset_raises(doc):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.load(doc)


def test_yaml_params_load_error_message(tmp_path):
    """Params.load turns a refused document into the JAX package's
    LoadError message, and keeps the strict type checks: 90 stays an
    int, which the float field refuses, as in the reference."""
    path = tmp_path / "params.yml"
    path.write_text("k: &anchor v\n")
    with pytest.raises(t_params.LoadError,
                       match=f"Cannot load YAML data from {path}"):
        t_params.load(str(path))
    cam = t_syn.DEFAULT_CAMERA
    yml = cam.write_params(str(tmp_path / "p"))
    text = open(yml).read().replace("angle_of_zero: -4.5",
                                    "angle_of_zero: 90", 1)
    open(yml, "w").write(text)
    with pytest.raises(t_params.LoadError, match="expected float, got int"):
        t_params.load(yml)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_write_params_reads_back(cam, tmp_path):
    camera = CAMERAS[cam]
    yml = camera.write_params(str(tmp_path))
    tpath = os.path.join(str(tmp_path), "synthetic_template.png")
    want = camera.params_dict(tpath)
    text = open(yml).read()
    assert _same(yaml.safe_load(text), want)
    assert _same(yaml_subset.load(text), want)
    assert np.array_equal(np.asarray(Image.open(tpath)),
                          camera.make_template())
    a = t_params.load(yml).arrays()
    b = camera.make_params().arrays()
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


# ---------------------------------------------------------------- PNG

def _image(mode, shape, rng):
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 3}[mode]
    a = np.stack([((xx * 3 + yy * 5) * (c + 1) + rng.integers(0, 9, shape))
                  % 256 for c in range(ch)], -1).astype(np.uint8)
    if mode == "L":
        return Image.fromarray(a[..., 0], "L")
    if mode == "P":
        return Image.fromarray(a, "RGB").quantize(64)
    return Image.fromarray(a, mode)


@pytest.mark.parametrize("save", [{}, {"optimize": True},
                                  {"compress_level": 0},
                                  {"compress_level": 1},
                                  {"compress_level": 9}],
                         ids=["default", "optimize", "c0", "c1", "c9"])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_pil_files_read_as_convert_L(mode, save, tmp_path):
    rng = np.random.default_rng(len(mode) * 7 + len(save))
    for shape in ((37, 53), (119, 188), (3, 300)):
        p = str(tmp_path / f"{mode}_{shape[0]}.png")
        _image(mode, shape, rng).save(p, **save)
        want = np.asarray(Image.open(p).convert("L"))
        got = png.read_gray(p)
        assert got.dtype == np.uint8 and np.array_equal(got, want), shape


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filtered_png(a, color, filters):
    """A PNG of the u8 array ``a`` [h, w, ch], row y written under filter
    ``filters[y % len]`` (a plain loop over the PNG specification's
    predictors)."""
    h, w, bpp = a.shape
    rows = a.reshape(h, w * bpp).astype(int)
    raw = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        raw.append(f)
        for x in range(w * bpp):
            left = rows[y, x - bpp] if x >= bpp else 0
            up = rows[y - 1, x] if y else 0
            ul = rows[y - 1, x - bpp] if y and x >= bpp else 0
            pred = [0, left, up, (left + up) // 2, _paeth(left, up, ul)][f]
            raw.append((rows[y, x] - pred) % 256)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("color,ch", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_png_every_filter_type(color, ch, tmp_path):
    rng = np.random.default_rng(color)
    a = rng.integers(0, 256, (11, 17, ch), np.uint8)
    a[5:] = (a[5:].astype(int) // 16 * 16).astype(np.uint8)  # smooth rows
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        p = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        with open(p, "wb") as fp:
            fp.write(_filtered_png(a, color, filters))
        want = np.asarray(Image.open(p).convert("L"))
        assert np.array_equal(png.read_gray(p), want), filters


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_png_synthetic_templates(cam, tmp_path):
    """The JAX package's template PNG (PIL-written) and the port's
    (png.write) read as the template, through both readers."""
    from meterelf_tpu import synthetic as j_syn

    camera = CAMERAS[cam]
    j_cam = {"default": j_syn.DEFAULT_CAMERA, "alt": j_syn.ALT_CAMERA,
             "five": j_syn.DEFAULT_CAMERA}[cam]
    jp = j_cam.make_params(str(tmp_path / "j"))
    assert np.array_equal(png.read_gray(jp.dials_file),
                          np.asarray(Image.open(jp.dials_file).convert("L")))
    camera.write_params(str(tmp_path / "t"))
    tp = str(tmp_path / "t" / "synthetic_template.png")
    assert np.array_equal(png.read_gray(tp), camera.make_template())


def test_png_writer_reads_back_through_pil(tmp_path):
    rng = np.random.default_rng(3)
    for a in (rng.integers(0, 256, (17, 23), np.uint8),
              rng.integers(0, 256, (9, 31, 3), np.uint8)):
        p = str(tmp_path / "w.png")
        png.write(p, a)
        im = Image.open(p)
        assert im.mode == ("L" if a.ndim == 2 else "RGB")
        assert np.array_equal(np.asarray(im), a)
        assert np.array_equal(png.read_gray(p), np.asarray(im.convert("L")))
    with pytest.raises(ValueError):
        png.write(p, np.zeros((4, 4, 4), np.uint8))


def test_png_refused(tmp_path):
    rng = np.random.default_rng(4)
    good = str(tmp_path / "good.png")
    Image.fromarray(rng.integers(0, 256, (8, 8), np.uint8), "L").save(good)
    data = open(good, "rb").read()

    def write(name, blob):
        p = str(tmp_path / name)
        with open(p, "wb") as fp:
            fp.write(blob)
        return p

    i16 = str(tmp_path / "i16.png")
    Image.fromarray(rng.integers(0, 65535, (8, 8)).astype(np.uint16)
                    ).save(i16)
    one_bit = str(tmp_path / "one.png")
    Image.fromarray(rng.integers(0, 2, (8, 8)).astype(bool)).save(one_bit)
    ihdr_at = len(png.SIGNATURE) + 8
    laced = bytearray(data)
    laced[ihdr_at + 12] = 1                      # interlace method: Adam7
    laced[ihdr_at + 13:ihdr_at + 17] = struct.pack(
        ">I", zlib.crc32(bytes(laced[ihdr_at - 4:ihdr_at + 13])))
    bad_crc = bytearray(data)
    bad_crc[ihdr_at + 14] ^= 1
    cases = {
        i16: "bit depth 16",
        one_bit: "bit depth 1",
        write("laced.png", bytes(laced)): "Adam7",
        write("crc.png", bytes(bad_crc)): "bad CRC",
        write("cut.png", data[:len(data) - 20]): "truncated",
        write("jpeg.png", b"\xff\xd8\xff\xe0" + data): "not a PNG",
    }
    for path, what in cases.items():
        with pytest.raises(t_params.LoadError, match=what) as e:
            png.read_gray(path)
        assert path in str(e.value)
