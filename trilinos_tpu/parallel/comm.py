"""Communicator abstraction.

JAX analogue of ``Teuchos::Comm``
(reference: packages/teuchos/comm/src/Teuchos_Comm.hpp:310 — abstract
reduceAll/broadcast/send-recv over MPI or a serial fake,
Teuchos_DefaultMpiComm.hpp / Teuchos_DefaultSerialComm.hpp).

Under JAX there is no message-passing API to wrap: collectives are *compiled
into* the jitted program. So the abstraction is much thinner:

  * ``SerialComm``   — single shard; reductions are identity. The analogue
    of ``Teuchos::SerialComm`` and what every solver sees on one device.
  * ``AxisComm``     — inside a ``shard_map`` over a mesh axis; reductions
    lower to ``lax.psum`` over ICI, index queries to ``lax.axis_index``.

Nonblocking semantics (``Tpetra::idot`` / ``Details::iallreduce``,
src/Tpetra_idot.hpp:370) need no explicit API: issuing the psum early and
consuming its value late lets XLA's latency-hiding scheduler overlap it
with compute — the pipelined solvers are written exactly that way.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


class Comm:
    """Reduction surface the solver/ortho layer is written against."""

    size: int

    def psum(self, x):
        raise NotImplementedError

    def pmax(self, x):
        raise NotImplementedError

    def pmin(self, x):
        raise NotImplementedError

    def index(self):
        """This shard's position along the solve axis (0 on serial)."""
        raise NotImplementedError

    def pvary(self, x):
        """Mark ``x`` as device-varying along the comm axes.

        Needed when a replicated literal (e.g. a zero-initialized carry)
        flows into ``lax.cond``/``lax.scan`` alongside sharded data under
        shard_map: JAX's varying-manual-axes check requires both branch
        outputs to agree. Identity on serial."""
        raise NotImplementedError


class SerialComm(Comm):
    size = 1

    def psum(self, x):
        return x

    def pmax(self, x):
        return x

    def pmin(self, x):
        return x

    def index(self):
        return 0

    def pvary(self, x):
        return x

    def __repr__(self):
        return "SerialComm()"


class AxisComm(Comm):
    """Collectives over one named mesh axis; valid only inside shard_map."""

    def __init__(self, axis_name: str, size: int):
        self.axis_name = axis_name
        self.size = size

    def psum(self, x):
        return lax.psum(x, self.axis_name)

    def pmax(self, x):
        return lax.pmax(x, self.axis_name)

    def pmin(self, x):
        return lax.pmin(x, self.axis_name)

    def index(self):
        return lax.axis_index(self.axis_name)

    def pvary(self, x):
        return jax.tree.map(
            lambda a: lax.pcast(a, self.axis_name, to="varying"), x)

    def __repr__(self):
        return f"AxisComm({self.axis_name!r}, size={self.size})"


def dot(comm: Comm, x: jax.Array, y: jax.Array) -> jax.Array:
    """Global columnwise dot: local GEMV/e-sum then one psum — the
    lclDot + reduceAll split of Tpetra::MultiVector::dot
    (src/Tpetra_MultiVector_def.hpp:1845)."""
    from ..ops.blas import local_dot

    return comm.psum(local_dot(x, y))


def norm2(comm: Comm, x: jax.Array) -> jax.Array:
    return jnp.sqrt(dot(comm, x, x))


def fused_dots(comm: Comm, pairs) -> jax.Array:
    """Several dot products in ONE reduction: stack local partials, single
    psum. This is the compiled form of Belos' single-reduce fusions
    (packages/belos/src/BelosCGSingleRedIter.hpp:477-483)."""
    from ..ops.blas import local_dot

    locs = jnp.stack([local_dot(x, y) for (x, y) in pairs])
    return comm.psum(locs)
