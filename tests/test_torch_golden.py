"""The golden distances (tests/golden_distances.json) through the port's MPC
path, on the CPU: the reference's test_encrypted_distances (src/lib.rs:165-193)
as tests/test_golden.py::test_encoded_path_matches_golden runs it, and a
keyed variant. Every f64 must equal the golden value bit for bit; the golden
file, computed by the pure-Python oracle of tests/oracles.py, is the only
oracle here.
"""

import json

import numpy as np
import pytest
import torch

from mpc_iris_tpu_torch import native
from mpc_iris_tpu_torch.models import KeyedShareEngine, MasksEngine, ShareEngine
from mpc_iris_tpu_torch.ops.decode import decode_distance
from mpc_iris_tpu_torch.ops.encode import encode_template
from mpc_iris_tpu_torch.types import Template
from test_golden import GOLDEN, generate_templates

CPU = "cpu"
KEY = bytes(range(7, 39))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite's workers share the host's cores: torch's intra-op threads
    of several workers spin against each other on these small shapes (a
    25 ms match took 6 s with six workers), so these tests run torch on one
    thread and restore the setting after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        data = json.load(f)
    templates = [Template.from_bytes(t.to_bytes()) for t in generate_templates(data["seed"])]
    assert len(templates) == data["n_templates"]
    return templates, data["distances"]


def _expect(d):
    return float("inf") if d is None else float(d)


def test_encoded_path_matches_golden(golden):
    """Per golden pair: a 2-party share split of the entry's encoding, one
    ShareEngine a share, the dot shares summed mod 2^16, the MasksEngine's
    denominators, and ``decode_distance``."""
    templates, dists = golden
    rng = np.random.default_rng(5)
    for rec in dists:
        q, e = templates[rec["left"]], templates[rec["right"]]
        shares = encode_template(e).share(2, rng)
        engines = [ShareEngine(s.data[None], device=CPU, chunk=128) for s in shares]
        dots = sum(eng.dots(q.pattern.data[None], q.mask.data[None]).astype(np.int64)
                   for eng in engines) & 0xFFFF
        dens = MasksEngine(e.mask.data[None], device=CPU, chunk=128).dots(q.mask.data[None])
        got = decode_distance(dots[0, 0].astype(np.uint16), dens[0, 0])
        assert got == _expect(rec["distance"]), rec


def test_keyed_path_matches_golden(golden):
    """All 17 templates as one DB split by ``native.share_split`` under a
    key: party 0 a KeyedShareEngine that regenerates its share from the key's
    stream 0 (the plain version of kernel (d) on the CPU), party 1 a
    ShareEngine over the data share; every golden pair decoded from one
    batched query of the 7 left templates."""
    templates, dists = golden
    pat = np.stack([t.pattern.data for t in templates])
    msk = np.stack([t.mask.data for t in templates])
    enc = np.stack([encode_template(t).data for t in templates])
    shares = native.share_split(enc, 2, KEY)
    np.testing.assert_array_equal(native.share_sum(list(shares)), enc)
    parties = [KeyedShareEngine(KEY, 0, len(templates), device=CPU, chunk=8),
               ShareEngine(shares[1], device=CPU, chunk=8)]
    left = sorted({r["left"] for r in dists})
    dots = native.share_sum([p.dots(pat[left], msk[left]) for p in parties])
    np.testing.assert_array_equal(
        parties[0].dots(pat[left], msk[left]),
        ShareEngine(shares[0], device=CPU, chunk=8).dots(pat[left], msk[left]))
    dens = MasksEngine(msk, device=CPU, chunk=8).dots(msk[left])
    for rec in dists:
        qi = left.index(rec["left"])
        got = decode_distance(dots[qi, rec["right"]], dens[qi, rec["right"]])
        assert got == _expect(rec["distance"]), rec


def test_chip_smoke_golden_templates_are_the_golden_files():
    """chip_smoke.py builds the golden set with its own copy of
    ``generate_templates`` (it imports nothing of the JAX package): the same
    bytes as tests/test_golden.py's."""
    import chip_smoke

    with open(GOLDEN) as f:
        seed = json.load(f)["seed"]
    assert [t.to_bytes() for t in chip_smoke.golden_templates(seed)] == \
        [t.to_bytes() for t in generate_templates(seed)]


def test_chip_smoke_conformance_phase_on_cpu():
    """chip_smoke.py's conformance phase rehearsed on the CPU (the plain
    versions; no launch counts), with the walkthrough at 128 entries."""
    import chip_smoke

    launches = chip_smoke.conformance_phase(torch.device("cpu"), "cpu", demo_db=128)
    assert launches == {"select_chunk": 0, "match_packed_small_b": 0,
                        "fractions_packed_small_b": 0, "share_planes_kernel": 0}
