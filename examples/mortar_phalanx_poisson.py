"""Multiphysics-style pipeline: nonlinear Poisson on TWO nonmatching
meshes glued by mortar constraints, with the residual defined by a
Phalanx-style evaluator DAG, solved matrix-free by JFNK, written to VTK.

    python examples/mortar_phalanx_poisson.py

Composition demonstrated (all round-2 packages working together):
  fem.phalanx    — PhysicsBlock + FieldManager closure-model DAG
  fem.mortar     — dual-multiplier projection P across the nonmatching
                   interface; the constraint enters MATRIX-FREE as
                   R_red(u) = C^T R_full(C u) (no condensed assembly)
  nonlinear      — Jacobian-free Newton-Krylov through the whole chain
                   (autodiff differentiates the DAG, the gather, AND the
                   mortar constraint)
  io.write_vtk   — one results file per mesh block (ParaView-readable)
"""
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import jax

if jax.default_backend() == "cpu":
    jax.config.update("jax_enable_x64", True)  # f64 tolerances on CPU
import jax.numpy as jnp

from trilinos_tpu.fem import (FieldManager, PhysicsBlock,
                              interface_dofs, mortar_projection_1d,
                              structured_quad_mesh)
from trilinos_tpu.fem.mortar import mortar_constraint
from trilinos_tpu.io import write_vtk
from trilinos_tpu.nonlinear import newton_krylov

DTYPE = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def strip_mesh(nx, ny, y0, y1):
    m = structured_quad_mesh(nx, ny)
    c = m.coords.copy()
    c[:, 1] = y0 + c[:, 1] * (y1 - y0)
    return dataclasses.replace(m, coords=c)


def physics():
    """-div((1 + u^2) grad u) = 8, the closure-model DAG."""
    fm = FieldManager()
    fm.add("kappa", provides="kappa_qp", requires="u_qp")(
        lambda u: 1.0 + u * u)
    fm.add("flux", provides="flux_qp",
           requires=("kappa_qp", "grad_u_qp"))(
        lambda k, g: k[..., None] * g)
    fm.add("source", provides="source_qp", requires="x_qp")(
        lambda x: 8.0 * jnp.ones(x.shape[:-1], x.dtype))
    return fm


def main():
    # two strips meshed independently: 9 vs 13 elements across the
    # interface at y = 0.5 (nonmatching)
    mesh_a = strip_mesh(9, 5, 0.0, 0.5)     # master side
    mesh_b = strip_mesh(13, 6, 0.5, 1.0)    # slave side
    pb_a = PhysicsBlock(mesh_a, dtype=DTYPE)
    pb_b = PhysicsBlock(mesh_b, dtype=DTYPE)
    r_a = pb_a.residual_function(physics())
    r_b = pb_b.residual_function(physics())

    master, xm = interface_dofs(pb_a.dof_coords, axis=1, value=0.5)
    slave, xs = interface_dofs(pb_b.dof_coords, axis=1, value=0.5)
    _, _, p = mortar_projection_1d(xs, xm, kind="dual")
    n_a, n_b = pb_a.n_dof, pb_b.n_dof
    c, red_of_full = mortar_constraint(n_a, n_b, slave, master, p)
    n_red = c.shape[1]

    # the constraint as matrix-free device closures (C and C^T applies)
    rows = jnp.asarray(np.repeat(np.arange(n_a + n_b),
                                 np.diff(c.row_ptr)))
    cols = jnp.asarray(c.cols.astype(np.int64))
    vals = jnp.asarray(c.vals, DTYPE)

    def c_apply(u_red):
        return jnp.zeros(n_a + n_b, u_red.dtype).at[rows].add(
            vals * u_red[cols])

    def ct_apply(r_full):
        return jnp.zeros(n_red, r_full.dtype).at[cols].add(
            vals * r_full[rows])

    # outer Dirichlet boundary in the reduced numbering
    keep_b = np.setdiff1d(np.arange(n_b), slave)
    xy_red = np.vstack([pb_a.dof_coords, pb_b.dof_coords[keep_b]])
    on_bnd = ((np.abs(xy_red[:, 0]) < 1e-9)
              | (np.abs(xy_red[:, 0] - 1) < 1e-9)
              | (np.abs(xy_red[:, 1]) < 1e-9)
              | (np.abs(xy_red[:, 1] - 1) < 1e-9))
    bnd = jnp.asarray(np.nonzero(on_bnd)[0])

    def residual(u_red):
        """R_red = C^T [R_a; R_b](C u_red), Dirichlet rows -> u."""
        u_full = c_apply(u_red)
        r_full = jnp.concatenate([r_a(u_full[:n_a]),
                                  r_b(u_full[n_a:])])
        r = ct_apply(r_full)
        return r.at[bnd].set(u_red[bnd])

    res = newton_krylov(residual, jnp.zeros(n_red, DTYPE), rtol=1e-10)
    u = np.asarray(res.x)
    print(f"JFNK through DAG+mortar: converged={bool(res.converged)} "
          f"iters={int(res.iters)} |F|={float(res.fnorm):.3e} "
          f"max u={u.max():.5f}")

    # interface continuity check: slave trace equals P @ master trace
    u_full = np.asarray(c_apply(res.x))
    gap = u_full[n_a + slave] - p @ u_full[master]
    print(f"mortar gap max |u_s - P u_m| = {np.abs(gap).max():.2e}")

    out = os.path.join(tempfile.gettempdir(), "mortar_poisson")
    write_vtk(out + "_a.vtk", mesh_a, point_data={"u": u_full[:n_a]})
    write_vtk(out + "_b.vtk", mesh_b, point_data={"u": u_full[n_a:]})
    print(f"wrote {out}_a.vtk / _b.vtk")


if __name__ == "__main__":
    main()
