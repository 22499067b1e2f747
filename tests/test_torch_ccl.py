"""The PyTorch port's CCL module (K3, plain version as it runs on the
CPU) against the JAX package: okey3 and per-window convergence from
pallas_ccl.propagate_quads (interpret mode, pack_closed), and the pass
caps against components._propagate_xla."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meterelf_tpu.ops import components as j_comp
from meterelf_tpu.ops import pallas_ccl as j_ccl
from meterelf_tpu_torch.ops import ccl as t_ccl
from meterelf_tpu_torch.ops import components as t_comp

torch.set_num_threads(2)

W = 64
_YY, _XX = np.mgrid[:W, :W]
DISK = (_YY - 32) ** 2 + (_XX - 32) ** 2 <= 23 ** 2


def _bits(masked, closed, disk):
    return (masked.astype(np.int32) + 2 * disk.astype(np.int32)
            + 4 * closed.astype(np.int32))


@pytest.mark.parametrize("density", [0.08, 0.3, 0.55])
def test_ccl_plain_matches_pallas_quads(density):
    """okey3 and converged exactly as propagate_quads(interpret=True,
    pack_closed=True), dequadded (inputs of tests/test_ops.py:572-591)."""
    rng = np.random.default_rng(int(density * 7919))
    B = 9
    K = 4 * B
    closed = rng.random((K, W, W)) < density
    for k in range(K // 2):
        cy, cx = rng.integers(16, 48, 2)
        closed[k] |= ((_YY - cy) ** 2 + (_XX - cx) ** 2) <= 64
    masked = closed & DISK
    bits = _bits(masked, closed, np.broadcast_to(DISK, masked.shape))
    bits_q = (bits.reshape(B, 4, W, W).transpose(0, 2, 1, 3)
              .reshape(B, W, 4 * W))
    okey_q, conv_q = jax.jit(functools.partial(
        j_ccl.propagate_quads, interpret=True, pack_closed=True))(
            jnp.asarray(bits_q))
    want = (np.asarray(okey_q).reshape(B, W, 4, W).transpose(0, 2, 1, 3)
            .reshape(K, W, W))

    okey3, conv = t_ccl.ccl(torch.as_tensor(bits))
    assert okey3.dtype == torch.int32 and conv.dtype == torch.bool
    np.testing.assert_array_equal(okey3.numpy(), want)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_q).reshape(K))


def _xla_okey3(masked, closed, disk, caps):
    okey, conv = j_comp._propagate_xla(
        jnp.asarray(masked), jnp.asarray(disk), caps=caps)
    okey = np.asarray(okey)
    return ((okey >> 2) * 8 + closed.astype(np.int32) * 4
            + (okey & 3)), np.asarray(conv)


def test_ccl_caps_flag_and_rescue_dense_noise():
    """The dense-noise window of tests/test_ops.py:478-483 (seed 0,
    p=0.35, disk r=23) does not converge under the default caps and does
    under RESCUE_CAPS, as in _propagate_xla; okey3 equal both times."""
    closed = (np.random.default_rng(0).random((8, W, W)) < 0.35)[0][None]
    masked = closed & DISK
    bits = torch.as_tensor(_bits(masked, closed, DISK[None]))
    assert t_comp.RESCUE_CAPS == j_comp.RESCUE_CAPS
    assert (t_comp.K_LABEL, t_comp.K_OUTSIDE, t_comp.K_FILL) == (
        j_comp.K_LABEL_HYBRID, j_comp.K_OUTSIDE_HYBRID, j_comp.K_FILL)
    for caps, want_conv in ((None, False), (t_comp.RESCUE_CAPS, True)):
        okey3, conv = t_ccl.ccl(bits, caps)
        ref, ref_conv = _xla_okey3(masked, closed, DISK[None], caps)
        assert bool(conv[0]) is want_conv
        np.testing.assert_array_equal(conv.numpy(), ref_conv)
        np.testing.assert_array_equal(okey3.numpy(), ref)


@pytest.mark.parametrize("caps", [(1, 1, 1), (4, 2, 2), (3, 5, 0)])
def test_ccl_capped_partial_states_match_xla(caps):
    """Under small caps (including odd and zero ones) the partial labels,
    outside flood and fill, and the flags, are those of _propagate_xla's
    schedule, not only the converged fixpoint."""
    rng = np.random.default_rng(sum(caps))
    K = 8
    closed = rng.random((K, W, W)) < 0.3
    masked = closed & DISK
    disk = np.broadcast_to(DISK, masked.shape)
    okey3, conv = t_ccl.ccl(torch.as_tensor(_bits(masked, closed, disk)),
                            caps)
    ref, ref_conv = _xla_okey3(masked, closed, disk, caps)
    np.testing.assert_array_equal(okey3.numpy(), ref)
    np.testing.assert_array_equal(conv.numpy(), ref_conv)
    assert not ref_conv.all()


def test_cell_contrib_matches_jax():
    rng = np.random.default_rng(5)
    owner = np.where(rng.random((6, W, W)) < 0.6,
                     rng.integers(0, 5, (6, W, W)) * 97, W * W)
    owner = owner.astype(np.int32)
    want = np.asarray(j_comp._cell_contrib(jnp.asarray(owner), W * W))
    got = t_comp.cell_contrib(torch.as_tensor(owner))
    np.testing.assert_array_equal(got.numpy(), want)
