"""Evaluator-DAG field evaluation + physics-block assembly
(the Phalanx + Panzer analogue).

Reference: packages/phalanx/src — PHX::Evaluator (declares evaluated +
dependent fields, Phalanx_Evaluator.hpp:71-124), PHX::DAG_Manager
(requireField + topological sort of the evaluator graph,
Phalanx_DAG_Manager.hpp:89), AliasField (Phalanx_Evaluator_AliasField
.hpp); packages/panzer/disc-fe/src — Panzer_Workset.hpp (per-element
batches of basis/integration data), the gather(dof) -> evaluate closure
models -> scatter(residual) assembly pipeline.

Accelerator-first design: the reference evaluates the DAG node-by-node per
workset at runtime, with virtual dispatch per evaluator. Here the DAG is
resolved ONCE on host (topological sort with cycle/missing-provider
diagnostics) into a plain ordered list of pure functions; ``compile``
returns one Python closure that threads a field dict through them — so
the whole physics DAG inlines into a single XLA program when jitted,
and fields are (ne, q, ...) arrays batched over ALL elements (the
workset is the entire mesh; no per-workset loop). Because evaluators
are pure jnp functions, ``jax.jvp`` through the compiled residual IS
the Panzer Jacobian evaluation type (Sacado's role), which feeds the
framework's JFNK Newton directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

import jax.numpy as jnp

from .basis import Basis, hgrad_basis
from .cell_tools import (hgrad_transform_grad, jacobian, jacobian_det,
                         jacobian_inv, map_to_physical)
from .cubature import cubature
from .mesh import Mesh, fe_space


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """One DAG node: ``fn(*requires) -> provides`` (a single array when
    one field is provided, else a tuple matching ``provides``)."""
    name: str
    provides: tuple
    requires: tuple
    fn: Callable


class FieldManager:
    """Evaluator registry + DAG compiler (PHX::FieldManager /
    DAG_Manager). ``compile(outputs, inputs)`` topologically sorts the
    sub-DAG reachable from ``outputs`` and returns one pure function
    ``fields_in -> fields_out``."""

    def __init__(self):
        self._evaluators: list[Evaluator] = []
        self._provider: dict[str, Evaluator] = {}

    def register(self, evaluator: Evaluator):
        for f in evaluator.provides:
            if f in self._provider:
                raise ValueError(
                    f"field {f!r} already provided by evaluator "
                    f"{self._provider[f].name!r}")
            self._provider[f] = evaluator
        self._evaluators.append(evaluator)
        return evaluator

    def add(self, name: str, provides, requires=()):
        """Decorator form: ``@fm.add("flux", provides=("flux_qp",),
        requires=("grad_u_qp",))``."""
        provides = (provides,) if isinstance(provides, str) else \
            tuple(provides)
        requires = (requires,) if isinstance(requires, str) else \
            tuple(requires)

        def deco(fn):
            self.register(Evaluator(name, provides, requires, fn))
            return fn
        return deco

    def alias(self, new_name: str, existing: str):
        """AliasField: expose ``existing`` under ``new_name``
        (Phalanx_Evaluator_AliasField.hpp)."""
        self.register(Evaluator(f"alias:{new_name}", (new_name,),
                                (existing,), lambda x: x))

    def order(self, outputs: Sequence[str], inputs: Sequence[str] = ()):
        """Topological evaluator order producing ``outputs`` from
        ``inputs`` (DFS postorder; raises on cycles and on fields with
        no provider — the DAG_Manager diagnostics)."""
        inputs = set(inputs)
        seen: dict[str, int] = {}   # field -> 0 in-progress, 1 done
        sched: list[Evaluator] = []
        scheduled_evs = set()

        def visit(field, chain):
            if field in inputs or seen.get(field) == 1:
                return
            if seen.get(field) == 0:
                cyc = " -> ".join(chain + [field])
                raise ValueError(f"field dependency cycle: {cyc}")
            ev = self._provider.get(field)
            if ev is None:
                raise KeyError(
                    f"no evaluator provides field {field!r} and it is "
                    f"not an input (inputs: {sorted(inputs)})")
            seen[field] = 0
            for dep in ev.requires:
                visit(dep, chain + [field])
            for f in ev.provides:
                seen[f] = 1
            if id(ev) not in scheduled_evs:
                scheduled_evs.add(id(ev))
                sched.append(ev)

        for out in outputs:
            visit(out, [])
        return sched

    def compile(self, outputs: Sequence[str],
                inputs: Sequence[str] = ()):
        """Return ``fn(fields: dict) -> dict`` evaluating ``outputs``.
        The schedule is fixed at compile time; the returned closure is
        pure and jit-traceable."""
        outputs = tuple(outputs)
        sched = self.order(outputs, inputs)

        def run(fields: dict):
            vals = dict(fields)
            for ev in sched:
                got = ev.fn(*[vals[r] for r in ev.requires])
                if len(ev.provides) == 1:
                    got = (got,)
                vals.update(zip(ev.provides, got))
            return {f: vals[f] for f in outputs}
        return run


class PhysicsBlock:
    """Panzer-style physics block over one mesh/basis: precomputes the
    workset (weights, basis tables, physical gradients) once on host,
    then assembles a global residual from an evaluator DAG.

    The DAG sees the seeded fields
      ``x_qp`` (ne, q, dim), ``u_qp`` (ne, q), ``grad_u_qp`` (ne, q, dim)
    plus any user parameters passed at call time, and must provide
    ``flux_qp`` (ne, q, dim) and/or ``source_qp`` (ne, q); the weak-form
    residual assembled is

      r[a] = sum_e,q w_eq ( flux . grad phi_a  -  source phi_a )

    i.e. the Galerkin residual of  -div(flux) - source = 0.

    Dirichlet boundaries are enforced strongly: residual rows on
    ``dirichlet`` dofs are replaced by ``u - g`` (so the same global
    vector works for JFNK Newton with no condensation bookkeeping).
    """

    def __init__(self, mesh: Mesh, basis: Basis | None = None,
                 quad_degree: int | None = None, dtype=jnp.float32):
        self.basis = basis or hgrad_basis(mesh.topo, 1)
        deg = quad_degree if quad_degree is not None \
            else 2 * self.basis.degree
        qp, qw = cubature(mesh.topo, deg)
        geom = hgrad_basis(mesh.topo, 1)
        cc = mesh.cell_coords
        j = jacobian(cc, qp, geom)
        w = qw[None, :] * np.abs(jacobian_det(j))
        conn, dof_xy = fe_space(mesh, self.basis)
        self.n_dof = len(dof_xy)
        self.dof_coords = dof_xy
        self.conn = jnp.asarray(conn)
        self.w = jnp.asarray(w, dtype)                        # (ne, q)
        self.phi = jnp.asarray(self.basis.values(qp), dtype)  # (q, nb)
        self.gphys = jnp.asarray(
            hgrad_transform_grad(jacobian_inv(j), self.basis.grads(qp)),
            dtype)                                      # (ne, q, nb, dim)
        self.x_qp = jnp.asarray(map_to_physical(cc, qp, geom), dtype)

    def seed_fields(self, u_global):
        """Gather: global dof vector -> workset fields (Panzer
        GatherSolution)."""
        ue = u_global[self.conn]                              # (ne, nb)
        u_qp = jnp.einsum("qa,ea->eq", self.phi, ue,
                          precision="highest")
        grad_u_qp = jnp.einsum("eqai,ea->eqi", self.gphys, ue,
                               precision="highest")
        return {"x_qp": self.x_qp, "u_qp": u_qp,
                "grad_u_qp": grad_u_qp, "weights": self.w}

    def residual_function(self, fm: FieldManager, *,
                          dirichlet=None, g=None,
                          params: Sequence[str] = ()):
        """Build ``r(u_global, **params) -> global residual``.

        ``dirichlet``: dof index array for strong BCs; ``g``: their
        values (array or scalar, default 0). ``params``: extra input
        field names supplied as keyword arguments at call time."""
        outputs, seeds = [], ("x_qp", "u_qp", "grad_u_qp", "weights")
        have = {f for ev in fm._evaluators for f in ev.provides}
        if "flux_qp" in have:
            outputs.append("flux_qp")
        if "source_qp" in have:
            outputs.append("source_qp")
        if not outputs:
            raise ValueError(
                "field manager provides neither 'flux_qp' nor "
                "'source_qp'")
        run = fm.compile(outputs, inputs=seeds + tuple(params))
        bnd = None if dirichlet is None else jnp.asarray(dirichlet)
        gv = 0.0 if g is None else g

        def residual(u_global, **kw):
            fields = self.seed_fields(u_global)
            fields.update(kw)
            out = run(fields)
            re = 0.0
            if "flux_qp" in out:
                re = jnp.einsum("eq,eqi,eqai->ea", self.w,
                                out["flux_qp"], self.gphys,
                                precision="highest")
            if "source_qp" in out:
                re = re - jnp.einsum("eq,eq,qa->ea", self.w,
                                     out["source_qp"], self.phi,
                                     precision="highest")
            r = jnp.zeros(self.n_dof, re.dtype).at[
                self.conn.ravel()].add(re.ravel())
            if bnd is not None:
                r = r.at[bnd].set(u_global[bnd] - gv)
            return r
        return residual

    def boundary_dofs(self, tol=1e-9):
        """Dof ids on the boundary of the unit box (the structured-mesh
        convention shared with fem.assembly.poisson_dirichlet)."""
        xy = self.dof_coords
        on = np.zeros(len(xy), bool)
        for d in range(xy.shape[1]):
            on |= (np.abs(xy[:, d]) < tol) | (np.abs(xy[:, d] - 1) < tol)
        return np.nonzero(on)[0]
