"""The port's PlaintextEngine (mpc_iris_tpu_torch.models) against the JAX
package's, on the same numpy DB and queries, on the CPU. Exact: winners
equal, f64 distances identical."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_iris_tpu.constants import BITS_BYTES
from mpc_iris_tpu.models import PlaintextEngine as JaxEngine
from mpc_iris_tpu_torch.models import PlaintextEngine
from mpc_iris_tpu_torch.ops import packed_match as tpm
from mpc_iris_tpu_torch.ops import select as tsel
from test_golden import GOLDEN, generate_templates

N_DB = 1000  # chunk 512 -> two chunks, the second padded


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0xE61E)
    pat = rng.integers(0, 256, (N_DB, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (N_DB, BITS_BYTES), dtype=np.uint8)
    msk[5] = 0                                 # all-invalid entry
    pat[900], msk[900] = pat[40], msk[40]      # duplicate rows, two chunks
    pat[600], msk[600] = pat[88], msk[88]
    qpat = rng.integers(0, 256, (16, BITS_BYTES), dtype=np.uint8)
    qmsk = rng.integers(0, 256, (16, BITS_BYTES), dtype=np.uint8)
    qpat[0], qmsk[0] = pat[40], msk[40]        # self-match of the duplicate
    qpat[1], qmsk[1] = pat[88], msk[88]
    qmsk[2] = 0                                # all-invalid query
    return pat, msk, qpat, qmsk


@pytest.fixture(scope="module", params=["packed", "dense"])
def engines(request, world):
    pat, msk, _, _ = world
    return (PlaintextEngine(pat, msk, device="cpu", chunk=512, storage=request.param),
            JaxEngine(pat, msk, chunk=512, storage=request.param))


def _rows(results):
    return [(r.index, r.distance, r.numerator, r.denominator) for r in results]


@pytest.mark.parametrize("b", [1, 8, 13, 16])
def test_match_equals_jax_engine(world, engines, b):
    _, _, qpat, qmsk = world
    port, ref = engines
    got = _rows(port.match(qpat[:b], qmsk[:b]))
    assert got == _rows(ref.match(qpat[:b], qmsk[:b]))
    assert got[0][:2] == (40, 0.0)  # the lower index of the duplicate pair
    if b > 2:
        assert got[2][0] == 0 and got[2][3] == 0  # all-invalid: index 0, d == 0


def test_distances_equal_jax_engine(world, engines):
    _, _, qpat, qmsk = world
    port, ref = engines
    got = port.distances(qpat[:3], qmsk[:3])
    assert got.shape == (3, N_DB) and got.dtype == np.float64
    np.testing.assert_array_equal(got, ref.distances(qpat[:3], qmsk[:3]))


def test_golden_distances():
    """tests/test_golden.py::test_plaintext_engine_matches_golden, through the port."""
    with open(GOLDEN) as f:
        data = json.load(f)
    templates = generate_templates(data["seed"])
    right = sorted({r["right"] for r in data["distances"]})
    left = sorted({r["left"] for r in data["distances"]})
    eng = PlaintextEngine(np.stack([templates[i].pattern.data for i in right]),
                          np.stack([templates[i].mask.data for i in right]),
                          device="cpu", chunk=4)
    mat = eng.distances(np.stack([templates[i].pattern.data for i in left]),
                        np.stack([templates[i].mask.data for i in left]))
    for rec in data["distances"]:
        want = float("inf") if rec["distance"] is None else float(rec["distance"])
        assert mat[left.index(rec["left"]), right.index(rec["right"])] == want, rec


def test_import_leaves_jax_out():
    """The port imports neither jax nor any module of the JAX package."""
    code = ("import sys, mpc_iris_tpu_torch, mpc_iris_tpu_torch.models, "
            "mpc_iris_tpu_torch.ops, mpc_iris_tpu_torch.protocol, mpc_iris_tpu_torch.parallel, "
            "mpc_iris_tpu_torch.parallel.party_smoke\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "ref = sorted(m for m in sys.modules\n"
            "             if m == 'mpc_iris_tpu' or m.startswith('mpc_iris_tpu.'))\n"
            "assert not ref, f'JAX package modules imported: {ref}'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parent.parent)


def test_cpu_tensors_never_launch(world):
    pat, msk, qpat, qmsk = world

    def counts():
        return (tsel.select_chunk.launches, tpm.match_packed_small_b.launches,
                tpm.fractions_packed_small_b.launches)

    before = counts()
    for storage in ("packed", "dense"):
        eng = PlaintextEngine(pat[:300], msk[:300], device="cpu", storage=storage)
        for b in (1, 13):
            eng.match(qpat[:b], qmsk[:b])
            eng.min_fractions(qpat[:b], qmsk[:b])
            eng.find_under(qpat[:b], qmsk[:b], 0.4, compact_k=16)
    assert counts() == before


def test_engine_needs_explicit_device(world):
    """The engines run on the card unless the caller asks for the CPU: with
    no device given they take "cuda", which raises without a card; a bad
    storage still raises ValueError."""
    from mpc_iris_tpu_torch.models import KeyedShareEngine, MasksEngine, ShareEngine

    pat, msk, _, _ = world
    with pytest.raises(ValueError):
        PlaintextEngine(pat, msk, device="cpu", storage="sparse")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot be shown")
    shares = np.zeros((4, 12800), dtype=np.uint16)
    for make in (lambda: PlaintextEngine(pat, msk),
                 lambda: ShareEngine(shares),
                 lambda: KeyedShareEngine(bytes(32), 0, 4),
                 lambda: MasksEngine(msk),
                 lambda: PlaintextEngine(pat, msk, device=torch.device("cuda"))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()


@pytest.mark.parametrize("engine", ["plaintext", "sharded plaintext", "masks", "sharded masks"])
def test_every_engine_refuses_an_unknown_storage(world, engine):
    """One storage rule for the plaintext DB (``PlainDB.resolve``) and one
    for the masks DB (``_masks_storage``, which takes the names the same
    way): each engine, single-card and sharded, raises on a name other than
    "auto", "packed" or "dense"."""
    from mpc_iris_tpu_torch.models import MasksEngine
    from mpc_iris_tpu_torch.parallel import ShardedMasksEngine, ShardedPlaintextEngine, make_mesh

    pat, msk, _, _ = world
    mesh = make_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    make = {"plaintext": lambda: PlaintextEngine(pat, msk, device="cpu", storage="sparse"),
            "sharded plaintext": lambda: ShardedPlaintextEngine(pat, msk, mesh,
                                                                storage="sparse"),
            "masks": lambda: MasksEngine(msk, device="cpu", storage="sparse"),
            "sharded masks": lambda: ShardedMasksEngine(msk, mesh, storage="sparse")}[engine]
    with pytest.raises(ValueError, match="unknown storage 'sparse'"):
        make()
