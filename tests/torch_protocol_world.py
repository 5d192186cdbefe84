"""Shared pieces of the port's protocol tests (``tests/test_torch_protocol*.py``).

A *stack* is one package's serving roles and engines, built alike: ``PORT``
is ``mpc_iris_tpu_torch`` on the CPU (``device="cpu"``), ``JAX`` the JAX
package. A scenario is written once as ``async def go(stack, ...)`` and
:func:`both` runs it on each stack from the same numpy inputs: the port's
roles over the port's engines must give the outcomes the JAX roles give over
the JAX engines (index, f64 distance bit for bit, total, audit lists).
"""

from __future__ import annotations

import asyncio
import struct

import numpy as np
import torch

import mpc_iris_tpu.models as jmodels
import mpc_iris_tpu.protocol as jprotocol
import mpc_iris_tpu_torch.models as tmodels
import mpc_iris_tpu_torch.protocol as tprotocol
from mpc_iris_tpu.ops.encode import encode_template
from mpc_iris_tpu.protocol import coordinator as jcoord
from mpc_iris_tpu.protocol import drain as jdrain
from mpc_iris_tpu.protocol import pump as jpump
from mpc_iris_tpu.protocol import wire as jwire
from mpc_iris_tpu.types import Bits as JBits
from mpc_iris_tpu.types import Template as JTemplate
from mpc_iris_tpu_torch.protocol import coordinator as tcoord
from mpc_iris_tpu_torch.protocol import drain as tdrain
from mpc_iris_tpu_torch.protocol import pump as tpump
from mpc_iris_tpu_torch.protocol import wire as twire
from mpc_iris_tpu_torch.types import Bits as TBits
from mpc_iris_tpu_torch.types import Template as TTemplate

CPU = torch.device("cpu")


class Stack:
    """One package's roles (``protocol``, its ``coordinator``, ``wire``,
    ``drain`` and ``pump`` modules) and engine constructors."""

    def __init__(self, name, protocol, coord, wire, drain, pump, models, bits, template,
                 **engine_kw):
        self.name = name
        self.protocol, self.coord, self.wire = protocol, coord, wire
        self.drain, self.pump, self.models = drain, pump, models
        self._bits, self._template = bits, template
        self._kw = engine_kw

    def __repr__(self):
        return self.name

    def share(self, m, chunk=8):
        return self.models.ShareEngine(m, chunk=chunk, **self._kw)

    def masks(self, m, chunk=8):
        return self.models.MasksEngine(m, chunk=chunk, **self._kw)

    def keyed(self, key, s, n, chunk=8):
        return self.models.KeyedShareEngine(key, s, n, chunk=chunk, **self._kw)

    def coordinator(self, masks_engine, participants, **kw):
        return self.protocol.Coordinator(masks_engine, participants, **kw, **self._kw)

    def participant(self, engine, host="127.0.0.1", port=0, **kw):
        return self.protocol.ParticipantServer(engine, host, port, **kw)

    def query_server(self, coordinator, **kw):
        return self.protocol.QueryServer(coordinator, "127.0.0.1", 0, **kw)

    def t(self, template):
        """``template`` (a JAX-package Template) as this package's Template."""
        return self._template(self._bits(template.pattern.data), self._bits(template.mask.data))


PORT = Stack("port", tprotocol, tcoord, twire, tdrain, tpump, tmodels, TBits, TTemplate,
             device=CPU)
JAX = Stack("jax", jprotocol, jcoord, jwire, jdrain, jpump, jmodels, JBits, JTemplate)


def build_party_data(rng, db, n_parties):
    """Additive u16 shares of the encoded DB, one matrix per party (as
    ``tests/test_protocol.py`` builds them)."""
    mats = [np.zeros((len(db), 12800), dtype=np.uint16) for _ in range(n_parties)]
    for i, t in enumerate(db):
        for p, s in enumerate(encode_template(t).share(n_parties, rng)):
            mats[p][i] = s.data
    return mats


def oracle_matrix(queries, db) -> np.ndarray:
    """``Template.distance`` of every (query, entry) pair, f64 [Q, N], by
    whole-array numpy: the same integer counts per rotation and the same f64
    division, NaN (no valid bit) skipped and +inf when every rotation is."""
    def grids(ts, plane):
        raw = np.stack([getattr(t, plane).data for t in ts])
        return np.unpackbits(raw, axis=1, bitorder="little").astype(bool).reshape(len(ts), 64, 200)

    qp, qm = grids(queries, "pattern"), grids(queries, "mask")
    dp, dm = grids(db, "pattern")[None], grids(db, "mask")[None]
    best = np.full((len(queries), len(db)), np.inf)
    for r in range(-15, 16):
        m = np.roll(qm, r, axis=2)[:, None] & dm
        num = ((np.roll(qp, r, axis=2)[:, None] ^ dp) & m).sum(axis=(2, 3))
        den = m.sum(axis=(2, 3))
        with np.errstate(invalid="ignore", divide="ignore"):
            v = num.astype(np.float64) / den.astype(np.float64)
        best = np.where(v < best, v, best)  # NaN compares false: skipped
    return best


def norm(o):
    """An outcome (or a list or tuple of them) as plain comparable values:
    the f64 distances as their 8 bytes, so equality is bit equality."""
    if isinstance(o, (list, tuple)):
        return [norm(x) for x in o]
    if hasattr(o, "matches"):
        return (norm(o.matches), o.total, o.limit_exceeded)
    if hasattr(o, "total"):
        return (o.index, struct.pack("<d", o.distance), o.total)
    if hasattr(o, "index") and hasattr(o, "distance"):
        return (o.index, struct.pack("<d", o.distance))
    return o


def both(go, *args):
    """Run the scenario ``go(stack, *args)`` on the port and on the JAX
    package; the outcomes must be equal. Returns the port's."""
    got = asyncio.run(go(PORT, *args))
    want = asyncio.run(go(JAX, *args))
    assert norm(got) == norm(want), (got, want)
    return got


async def close_all(*servers):
    for s in servers:
        await s.close()
