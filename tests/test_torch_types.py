"""The port's own copies of the JAX package's JAX-free modules
(mpc_iris_tpu_torch.constants and .types) against the originals: every
constant equal, Bits.rotated and Template.distance identical on the golden
pairs, and Template's 3,200-byte wire form the same."""

import json

import numpy as np
import pytest

import mpc_iris_tpu.constants as ref_constants
from mpc_iris_tpu.types import Bits as RefBits
from mpc_iris_tpu.types import Template as RefTemplate
import mpc_iris_tpu_torch.constants as port_constants
from mpc_iris_tpu_torch.types import Bits, Template
from test_golden import GOLDEN, generate_templates

with open(GOLDEN) as _f:
    _GOLDEN = json.load(_f)


def _port(t: RefTemplate) -> Template:
    return Template(Bits(t.pattern.data), Bits(t.mask.data))


def test_constants_equal_jax_package():
    names = sorted(n for n in vars(ref_constants) if n.isupper())
    assert names == sorted(n for n in vars(port_constants) if n.isupper())
    for n in names:
        assert getattr(port_constants, n) == getattr(ref_constants, n), n


@pytest.mark.parametrize("pair", range(len(_GOLDEN["distances"])))
def test_template_distance_equals_jax_package_on_golden_pairs(pair):
    rec = _GOLDEN["distances"][pair]
    templates = generate_templates(_GOLDEN["seed"])
    left, right = templates[rec["left"]], templates[rec["right"]]
    want = float("inf") if rec["distance"] is None else float(rec["distance"])
    got = _port(left).distance(_port(right))
    assert got == left.distance(right) == want


@pytest.mark.parametrize("amount", [-15, -1, 0, 7, 200, 213])
def test_bits_rotated_equals_jax_package(amount):
    rng = np.random.default_rng(0x7E5 + amount)
    ref = RefBits.random(rng)
    got = Bits(ref.data).rotated(amount)
    np.testing.assert_array_equal(got.data, ref.rotated(amount).data)
    np.testing.assert_array_equal(Bits.from_grid(ref.grid()).data, ref.data)


def test_template_bytes_equal_jax_package():
    """The 3,200-byte wire form (pattern plane, then mask plane) both ways."""
    ref = RefTemplate.random(np.random.default_rng(0x3200))
    raw = _port(ref).to_bytes()
    assert raw == ref.to_bytes()
    assert Template.from_bytes(raw) == _port(RefTemplate.from_bytes(raw))
    with pytest.raises(ValueError, match="3200"):
        Template.from_bytes(raw[:-1])
