"""The decode's result stage (ops/result.py) on the CPU: the plain
version of K13 ``result_pack`` gives the reference's error codes and the
converged reduction field by field (tests/result_cases.py: seeded rows
and hand-made rows reaching every error code and the edges of the match
test), into one buffer whose layout depends on (B, D) alone; every
branch of the decode returns such a packed BatchResult; and
to_host_later's numpy is the same for a packed and an unpacked result,
its card path run here with the card stubbed (``fake_card``)."""
import numpy as np
import pytest
import torch

import result_cases
from meterelf_tpu_torch import synthetic
from meterelf_tpu_torch.ops import result
from meterelf_tpu_torch.pipeline import decode
from meterelf_tpu_torch.pipeline.decode import (BatchResult, MeterDecoder,
                                                 to_host_later)

torch.set_num_threads(2)

SIZES = [(0, 4), (1, 4), (7, 4), (len(result_cases.HAND), 4), (64, 4),
         (0, 5), (1, 5), (7, 5), (len(result_cases.HAND), 5), (64, 5)]
CAMERAS = {"default": synthetic.DEFAULT_CAMERA,
           "five_dial": synthetic.FIVE_DIAL_CAMERA}


def pack(x, fn=result.result_pack):
    t = {k: torch.as_tensor(v) for k, v in result_cases.flat(x).items()}
    return fn(t["load_ok"], t["max_val"], t["mx"], t["my"],
              result_cases.THRESHOLD, t["has_any"], t["conv"],
              t["position"], t["readable"], t["value"])


def assert_fields_equal(got, want, label):
    """Every field: dtype, shape and bits (floats as integers: NaN and
    -0.0 count)."""
    for name, a, b in zip(BatchResult._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (label, name)
        if a.dtype.kind == "f":
            a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
        np.testing.assert_array_equal(a, b, err_msg=f"{label}: {name}")


@pytest.mark.parametrize("B,D", SIZES)
def test_plain_equals_reference_order(B, D):
    """Seeded and hand-made rows: the plain stage gives the reference's
    raise order, first bad dial, unreadable bits and converged AND, and
    passes the other fields through bit for bit."""
    for seed in (0, 1, 2):
        x = result_cases.cases(B, D, seed)
        want = result_cases.expected(x)
        assert_fields_equal([t.numpy() for t in pack(x)], want,
                            f"B={B} D={D} seed={seed}")


def test_hand_rows_reach_every_code():
    """The hand-made rows reach each of the five codes, NaN and the
    threshold itself, and a first bad dial past the first."""
    x = result_cases.cases(len(result_cases.HAND), 5, 0)
    got = dict(zip(BatchResult._fields, (t.numpy() for t in pack(x))))
    labels = [label for label, _ in result_cases.HAND]
    err = dict(zip(labels, got["err"].tolist()))
    assert set(err.values()) == {0, 1, 2, 3, 4}
    assert err["match_at_threshold"] == 0
    assert err["match_below_threshold"] == 2
    assert err["nan_match"] == 2 and err["load_before_all"] == 1
    bad = dict(zip(labels, got["first_bad_dial"].tolist()))
    assert bad["last_dial_no_contours"] == 4
    assert bad["later_dials_no_contours"] == 1
    bits = dict(zip(labels, got["unreadable_bits"].tolist()))
    assert bits["no_dial_readable"] == 0b11111
    conv = dict(zip(labels, got["converged"].tolist()))
    assert not conv["one_dial_unconverged"] and conv["ok"]


def test_match_compares_in_float32():
    """max_val equal to float32(threshold), below the float64 threshold,
    passes: the comparison is made in float32, as torch makes it."""
    assert float(result_cases.T32) < result_cases.THRESHOLD
    x = result_cases.cases(1, 4, 0)
    x["max_val"][0] = result_cases.T32
    assert pack(x)[0].item() == 0


@pytest.mark.parametrize("B,D", SIZES)
def test_layout(B, D):
    """Offsets in BatchResult's order, each on a multiple of 8 bytes (so
    of its dtype's size), the fields not overlapping and inside the
    buffer, a function of (B, D) alone; the ten fields are views of one
    buffer of that size, of the fields' dtypes and shapes."""
    fields, nbytes = result.layout(B, D)
    assert len(fields) == len(BatchResult._fields)
    assert (fields, nbytes) == result.layout(B, D)
    end = 0
    for off, dtype, shape in fields:
        assert off % result.ALIGN == 0 and off % dtype.itemsize == 0
        assert off >= end
        end = off + int(np.prod(shape)) * dtype.itemsize
    assert end <= nbytes < end + result.ALIGN
    out = pack(result_cases.cases(B, D, 3))
    storage = out[0].untyped_storage()
    assert storage.nbytes() == nbytes
    for t, (off, dtype, shape) in zip(out, fields):
        assert t.untyped_storage().data_ptr() == storage.data_ptr()
        assert t.dtype == dtype and tuple(t.shape) == shape
        assert t.storage_offset() * t.element_size() == off
        assert t.is_contiguous()


def test_plain_takes_flat_or_per_dial_flags():
    """has_any and conv as [B * D] (K4, K3) or [B, D] give one result."""
    x = result_cases.cases(9, 4, 4)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    a = pack(x)
    b = result.result_pack(t["load_ok"], t["max_val"], t["mx"], t["my"],
                           result_cases.THRESHOLD, t["has_any"], t["conv"],
                           t["position"], t["readable"], t["value"])
    assert_fields_equal([v.numpy() for v in a], [v.numpy() for v in b],
                        "shapes")


@pytest.mark.parametrize("branch", ["quad", "general", "scorer"])
def test_decode_returns_packed_result(branch):
    """Every branch's BatchResult is ten views of one buffer in the
    layout of (B, D); decode_numpy's fields are the same numbers."""
    cam = CAMERAS["five_dial" if branch == "general" else "default"]
    dec = MeterDecoder(cam.make_params(), device="cpu")
    if branch == "scorer":
        dec.static_kwargs["static_win_origin"] = None
    D = len(dec.geom)
    crops = cam.render_crops(synthetic.dial_positions(3, dials=D))
    res = dec(crops, np.array([True, False, True]))
    fields, nbytes = result.layout(3, D)
    ptr = res.err.untyped_storage().data_ptr()
    assert res.err.untyped_storage().nbytes() == nbytes
    for t, (off, dtype, shape) in zip(res, fields):
        assert t.untyped_storage().data_ptr() == ptr
        assert t.storage_offset() * t.element_size() == off
    assert res.err.tolist()[1] == 1 and res.converged.all()
    assert_fields_equal(dec.decode_numpy(crops, np.array([True, False,
                                                          True])),
                        [t.numpy() for t in res], branch)


class FakeEvent:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """to_host_later's card path on the CPU: every tensor counts as on a
    card, the pinned buffers are plain ones (each kept in the list
    returned) and the event is a stand-in."""
    made = []

    def pinned(n):
        made.append(torch.empty(n, dtype=torch.uint8))
        return made[-1]

    monkeypatch.setattr(decode, "_is_cuda", torch.is_tensor)
    monkeypatch.setattr(decode, "_pinned_bytes", pinned)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    return made


@pytest.mark.parametrize("B,D", [(11, 4), (7, 5), (64, 4)])
def test_to_host_later_packed_and_unpacked_equal(fake_card, B, D):
    """A packed result and the same fields as separate tensors give the
    same numpy from to_host_later: types, dtypes, shapes and values; the
    packed one through one buffer of the layout's size, its fields views
    of that buffer from the recipe, the separate ones through none."""
    res = BatchResult(*pack(result_cases.cases(B, D, 5)))
    loose = BatchResult(*(t.clone() for t in res))
    assert result.packed_recipe(res) is result.recipe(B, D)
    assert result.packed_recipe(loose) is None
    a = to_host_later(res)()
    (buf,) = fake_card
    assert buf.numel() == result.layout(B, D)[1]
    b = to_host_later(loose)()
    assert len(fake_card) == 1
    assert type(a) is type(b) is BatchResult
    assert all(isinstance(v, np.ndarray) for v in a)
    assert_fields_equal(a, b, "packed vs unpacked")
    assert all(np.shares_memory(v, buf.numpy()) for v in a)


def test_kept_arrays_survive_the_next_call(fake_card):
    """The decoder's graph path: one device buffer rewritten between
    calls, each call's result a fresh copy of it (result.copied) pulled
    by to_host_later. The arrays of call k are unchanged after call k + 1
    and equal what call k's buffer held: each call has its own host
    buffer."""
    B, D = 9, 4
    src = torch.empty(result.layout(B, D)[1], dtype=torch.uint8)
    kept = []
    for seed in range(3):
        for o, v in zip(result.views(src, B, D),
                        pack(result_cases.cases(B, D, seed))):
            o.copy_(v)
        res = BatchResult(*result.copied(src, B, D))
        want = [t.numpy().copy() for t in res]
        kept.append((to_host_later(res)(), want))
    assert len({b.data_ptr() for b in fake_card}) == 3
    for k, (got, want) in enumerate(kept):
        assert_fields_equal(got, want, f"call {k}")
    assert not np.array_equal(kept[0][0].dial_pos, kept[1][0].dial_pos)


@pytest.mark.parametrize("B,D", [(0, 4), (7, 5), (64, 4)])
def test_host_views_of_copied_bytes(B, D):
    """The numpy views of the recipe over a packed result's copied bytes
    equal each field's own numpy; a result with a field swapped for
    another view of the same buffer (an offset and a stride) is not taken
    for a packed one, and to_host_later copies its fields one by one."""
    res = BatchResult(*pack(result_cases.cases(B, D, 6)))
    raw = result.buffer_of(res).numpy().copy()
    r = result.packed_recipe(res)
    got = [np.ndarray(f.shape, f.np_dtype, raw, f.offset) for f in r.fields]
    assert_fields_equal(got, [t.numpy() for t in res], f"B={B} D={D}")
    if B:
        col = res.dial_pos[:, 1]
        odd = res._replace(dial_pos=col)
        assert result.packed_recipe(odd) is None
        np.testing.assert_array_equal(to_host_later(odd)().dial_pos,
                                      col.numpy())


def test_one_storage_needs_every_tensor():
    """packed_recipe takes the ten views of one buffer of the layout's
    size at the layout's places, and nothing else: no fields, a field
    copied elsewhere, a field of another dtype or shape, numpy fields,
    views of a larger buffer, a short tuple."""
    res = pack(result_cases.cases(6, 4, 7))
    assert result.packed_recipe(res) is result.recipe(6, 4)
    assert result.packed_recipe([]) is None
    assert result.packed_recipe(res[:9]) is None
    for i in range(10):
        other = list(res)
        other[i] = res[i].clone()
        assert result.packed_recipe(other) is None, i
    other = list(res)
    other[4] = res[4].view(torch.float32)
    assert result.packed_recipe(other) is None
    other = list(res)
    other[0] = res[0][:3]
    assert result.packed_recipe(other) is None
    assert result.packed_recipe([t.numpy() for t in res]) is None
    big = torch.zeros(result.layout(6, 4)[1] + 8, dtype=torch.uint8)
    assert result.packed_recipe(result.views(big, 6, 4)) is None
