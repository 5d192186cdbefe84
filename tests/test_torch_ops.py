"""The port's ops (mpc_iris_tpu_torch.ops) against the JAX package's, on the
same numpy inputs. Every comparison is exact: integers equal, f64 identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.constants import BITS_BYTES, COLS, ROWS
from mpc_iris_tpu.models import engines as jeng
from mpc_iris_tpu.ops import decode as jdec
from mpc_iris_tpu.ops import encode as jenc
from mpc_iris_tpu.ops import rotations as jrot
from mpc_iris_tpu_torch.models import engines as teng
from mpc_iris_tpu_torch.ops import decode as tdec
from mpc_iris_tpu_torch.ops import encode as tenc
from mpc_iris_tpu_torch.ops import rotations as trot
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.self_test import kernel_self_test


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(port, ref):
    port = [p.numpy() for p in port] if isinstance(port, tuple) else port.numpy()
    ref = [np.asarray(r) for r in ref] if isinstance(ref, tuple) else np.asarray(ref)
    np.testing.assert_array_equal(port, ref)


def test_unpack_pack_bits(rng):
    packed = rng.integers(0, 256, size=(5, BITS_BYTES), dtype=np.uint8)
    bits = tenc.unpack_bits(_t(packed))
    assert bits.dtype == torch.uint8
    _eq(bits, jenc.unpack_bits(packed))
    _eq(tenc.pack_bits(bits), jenc.pack_bits(np.asarray(bits.numpy())))
    _eq(tenc.pack_bits(bits), packed)
    with pytest.raises(ValueError):
        tenc.pack_bits(torch.zeros(3, 12, dtype=torch.uint8))


def test_encode_grid_i8(rng):
    p = rng.integers(0, 2, size=(4, ROWS, COLS), dtype=np.uint8)
    m = rng.integers(0, 2, size=(4, ROWS, COLS), dtype=np.uint8)
    got = tenc.encode_grid_i8(_t(p), _t(m))
    assert got.dtype == torch.int8
    _eq(got, jenc.encode_grid_i8(p, m))


@pytest.mark.parametrize("amount", [-15, -1, 0, 7, 200, 215])
def test_rotate_grid(rng, amount):
    g = rng.integers(-1, 2, size=(2, ROWS, COLS)).astype(np.int8)
    _eq(trot.rotate_grid(_t(g), amount), jrot.rotate_grid(jnp.asarray(g), amount))


def test_expand_rotations(rng):
    g = rng.integers(-1, 2, size=(3, ROWS, COLS)).astype(np.int8)
    _eq(trot.expand_rotations(_t(g)), jrot.expand_rotations(jnp.asarray(g)))
    _eq(trot.expand_rotations_flat(_t(g)), jrot.expand_rotations_flat(jnp.asarray(g)))


@pytest.mark.parametrize("b", [1, 5])
def test_prepare_query_planes(rng, b):
    pat = rng.integers(0, 256, size=(b, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, size=(b, BITS_BYTES), dtype=np.uint8)
    got = teng.prepare_query_planes(_t(pat), _t(msk))
    assert all(t.dtype == torch.int8 for t in got)
    _eq(got, jeng.prepare_query_planes(pat, msk))


def test_numerators(rng):
    dots = rng.integers(0, 1 << 16, size=(4, 31)).astype(np.int32)
    dens = rng.integers(0, 1 << 16, size=(4, 31)).astype(np.int32)
    _eq(tdec.numerators(_t(dots), _t(dens)), jdec.numerators(dots, dens))


def _tie_fractions(rng, shape):
    """Small dens (0..4) make exact ties common, as different pairs
    (1/2 vs 2/4) and as d == 0 (invalid) entries."""
    d = rng.integers(0, 5, size=shape).astype(np.int32)
    n = np.minimum(rng.integers(0, 5, size=shape), d).astype(np.int32)
    return n, d


def test_frac_less_and_select(rng):
    n1, d1 = _tie_fractions(rng, (1000,))
    n2, d2 = _tie_fractions(rng, (1000,))
    i1 = rng.integers(0, 50, size=1000).astype(np.int32)
    i2 = rng.integers(0, 50, size=1000).astype(np.int32)
    _eq(tdec._frac_less(_t(n1), _t(d1), _t(n2), _t(d2)), jdec._frac_less(n1, d1, n2, d2))
    _eq(tdec._frac_select(*map(_t, (n1, d1, i1, n2, d2, i2))),
        jdec._frac_select(n1, d1, i1, n2, d2, i2))


@pytest.mark.parametrize("axis", [1, -1])
def test_fraction_min_rotations(rng, axis):
    n, d = _tie_fractions(rng, (3, 31, 257))
    n[0, :, 3] = d[0, :, 3] = 3
    n[0, [4, 9], 3], d[0, [4, 9], 3] = (2, 1), (4, 2)  # 2/4 before 1/2
    d[1, :, 5] = 0  # all rotations invalid
    if axis == -1:
        n, d = np.moveaxis(n, 1, -1).copy(), np.moveaxis(d, 1, -1).copy()
    got = tdec.fraction_min_rotations(_t(n), _t(d), axis=axis)
    _eq(got, jdec.fraction_min_rotations(n, d, axis=axis))
    assert [int(t[0, 3]) for t in got] == [2, 4, 4]  # the earliest pair


@pytest.mark.parametrize("size,offset", [(1024, 0), (1000, 37), (1, 5)])
def test_fraction_argmin(rng, size, offset):
    n, d = _tie_fractions(rng, (4, size))
    if size > 257:
        n[:, 257], d[:, 257] = 0, 3  # index ties congruent mod 128
        n[:, 129], d[:, 129] = 0, 2
    d[3] = 0  # all invalid: lowest index with d == 0
    got = tdec.fraction_argmin(_t(n), _t(d), index_offset=offset)
    _eq(got, jdec.fraction_argmin(n, d, index_offset=offset))
    assert int(got[2][3]) == offset


def test_running_min(rng):
    state = tuple(_t(x) for x in (np.zeros(6, np.int32), np.zeros(6, np.int32),
                                  np.full(6, 2**31 - 1, np.int32)))
    jstate = tuple(jnp.asarray(s.numpy()) for s in state)
    for step in range(5):
        n, d = _tie_fractions(rng, (6,))
        i = (np.arange(6, dtype=np.int32) + 100 * step)
        state = tdec.running_min(state, _t(n), _t(d), _t(i))
        jstate = jdec.running_min(jstate, n, d, i)
    _eq(state, jstate)


def test_host_decode_copies(rng):
    dens = rng.integers(0, 40, size=(50, 31)).astype(np.uint16)
    nums = np.minimum(rng.integers(0, 40, size=(50, 31)), dens)
    dots = ((dens.astype(np.int64) - 2 * nums) & 0xFFFF).astype(np.uint16)
    np.testing.assert_array_equal(tdec.decode_distance_batch_np(dots, dens),
                                  jdec.decode_distance_batch_np(dots, dens))
    for n, d in ((0, 0), (3, 7), (1, 3), (6400, 12800)):
        assert tdec.fraction_to_f64(n, d) == jdec.fraction_to_f64(n, d)


def test_encode_template_equals_jax(rng):
    from mpc_iris_tpu.types import Template as JaxTemplate
    from mpc_iris_tpu_torch.types import Template

    t = Template.random(rng)
    jt = JaxTemplate.from_bytes(t.to_bytes())
    enc = tenc.encode_template(t)
    assert enc.data.dtype == np.uint16
    np.testing.assert_array_equal(enc.data, jenc.encode_template(jt).data)
    assert tenc.decode_encoded(enc).to_bytes() == jenc.decode_encoded(
        jenc.encode_template(jt)).to_bytes()
    for got, want in zip(tenc.template_grids(t), jenc.template_grids(jt)):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tenc.template_grids(t, device="cpu"), jenc.template_grids(jt)):
        assert got.dtype == torch.uint8 and got.shape == (ROWS, COLS)
        np.testing.assert_array_equal(got.numpy(), want)


def test_decrypt_roundtrip(rng):
    """tests/test_ops.py::TestEncode::test_decrypt_roundtrip through the port:
    encode -> decode recovers the mask exactly and the pattern up to the
    masked-out bits."""
    from mpc_iris_tpu_torch.types import Bits, Template

    t = Template.random(rng)
    back = tenc.decode_encoded(tenc.encode_template(t))
    assert back.mask == t.mask
    assert (back.pattern & back.mask) == (t.pattern & t.mask)
    assert (back.pattern & ~back.mask) == Bits()


def test_planes_roundtrip(rng):
    """tests/test_ops.py::TestDotKernels::test_planes_roundtrip through the
    port (its planes are int8 offset by -128; the round trip is exact)."""
    from mpc_iris_tpu_torch.ops import planes_to_shares, shares_to_planes

    s = rng.integers(0, 1 << 16, size=(4, 12_800), dtype=np.uint16)
    lo, hi = shares_to_planes(_t(s.view(np.int16)))
    assert lo.dtype == hi.dtype == torch.int8
    np.testing.assert_array_equal(planes_to_shares(lo, hi).numpy(), s)


def test_decode_distance_reference_semantics():
    """tests/test_ops.py::TestDecode::test_decode_distance_reference_semantics
    through the port: all 0/0 folds to +inf; one valid rotation decides."""
    dots = np.zeros(31, dtype=np.uint16)
    dens = np.zeros(31, dtype=np.uint16)
    assert tdec.decode_distance(dots, dens) == float("inf")
    dens[3] = 100
    dots[3] = 40  # num = 30, d = 100 -> 0.3
    assert tdec.decode_distance(dots, dens) == 0.3


def test_decode_batch_matches_scalar(rng):
    """tests/test_ops.py::TestDecode::test_decode_batch_matches_scalar
    through the port, and the scalar decode equal to the JAX package's."""
    dots = rng.integers(0, 1 << 16, size=(50, 31), dtype=np.uint16)
    dens = rng.integers(0, 12801, size=(50, 31), dtype=np.uint16)
    dens[7] = 0  # an all-invalid row
    batch = tdec.decode_distance_batch_np(dots, dens)
    for i in range(50):
        got = tdec.decode_distance(dots[i], dens[i])
        assert batch[i] == got == jdec.decode_distance(dots[i], dens[i]), i


def test_dot_bits_batch_and_self_test(rng):
    q = rng.integers(-1, 2, size=(17, 64)).astype(np.int8)
    db = rng.integers(-1, 2, size=(9, 64)).astype(np.int8)
    want = q.astype(np.int64) @ db.astype(np.int64).T
    np.testing.assert_array_equal(dot_bits_batch(_t(q), _t(db)).numpy(), want)
    kernel_self_test("cpu")  # the CPU canary: the int8 product only
