"""f32 vs f64 achievable-tolerance study (ROADMAP "Verification debt").

For each Krylov driver, solve Galeri Laplace2D 64x64 (kappa ~ 1.7e3)
and Laplace3D 24^3 at a ladder of relative tolerances in f32 and f64
and record the tightest rtol at which ``certified_solve`` reports
converged=True (the certification is an explicit-residual check, so
"converged" here means the TRUE residual met the tolerance and the
tighten-retry loop did not exhaust its passes).

Writes docs/f32_tolerances.md. Run on CPU:
    JAX_PLATFORMS=cpu python scripts/f32_tolerance_study.py
"""
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from trilinos_tpu.galeri import laplace2d, laplace3d
from trilinos_tpu.ops import formats as F
from trilinos_tpu.ops import matvec as S

RTOLS = (1e-4, 1e-5, 1e-6, 1e-7, 1e-8)


def solvers():
    from trilinos_tpu.solvers import (bicgstab, cg, cg_pipeline,
                                      cg_single_reduce, gmres, minres,
                                      tfqmr)
    from trilinos_tpu.solvers.sstep_gmres import sstep_gmres

    return [
        ("cg", cg, {}),
        ("cg_single_reduce", cg_single_reduce, {}),
        ("cg_pipeline", cg_pipeline, {}),
        ("bicgstab", bicgstab, {}),
        ("minres", minres, {}),
        ("gmres", gmres, {}),
        ("tfqmr", tfqmr, {}),
        ("sstep_gmres(s=4)", sstep_gmres,
         {"t_blocks": 10, "max_restarts": 60}),
    ]


def run_case(a, name, fn, kw, dtype):
    dev = F.csr_to_dia(a)
    n, npad = a.shape[0], dev.n_rows_pad
    rng = np.random.default_rng(11)
    b = np.zeros(npad, dtype)
    b[:n] = rng.standard_normal(n).astype(dtype)
    bj = jnp.asarray(b)
    dense = a.to_dense()
    op = lambda x: S.spmv(dev, x, impl="xla")
    import inspect

    takes_maxiter = "maxiter" in inspect.signature(fn).parameters
    tightest = None
    true_rel_at = {}
    for rtol in RTOLS:
        if takes_maxiter and "max_restarts" not in kw:
            res = fn(op, bj, rtol=rtol, maxiter=20000, **kw)
        else:
            res = fn(op, bj, rtol=rtol, **kw)
        x = np.asarray(res.x)[:n].astype(np.float64)
        rel = (np.linalg.norm(b[:n].astype(np.float64) - dense @ x)
               / np.linalg.norm(b[:n]))
        ok = bool(np.all(np.asarray(res.converged))) and rel <= 1.5 * rtol
        true_rel_at[rtol] = rel
        if ok:
            tightest = rtol
    return tightest, true_rel_at


def main():
    problems = [("Laplace2D 64x64", laplace2d, (64, 64)),
                ("Laplace3D 24^3", laplace3d, (24, 24, 24))]
    rows = []
    for pname, gen, dims in problems:
        for name, fn, kw in solvers():
            for dtype, dname in ((np.float32, "f32"),
                                 (np.float64, "f64")):
                a = gen(*dims, dtype=dtype)
                tight, rels = run_case(a, name, fn, kw, dtype)
                rows.append({"problem": pname, "solver": name,
                             "dtype": dname,
                             "tightest_rtol": tight,
                             "true_rel": {f"{k:g}": float(v)
                                          for k, v in rels.items()}})
                print(json.dumps(rows[-1]))
    write_doc(rows)


def write_doc(rows):
    lines = [
        "# Achievable relative tolerances: f32 vs f64",
        "",
        "Measured by `scripts/f32_tolerance_study.py` (CPU backend, DIA",
        "format, XLA apply). \"Tightest rtol\" is the smallest rtol in",
        "{1e-4 ... 1e-8} at which the CERTIFIED result (explicit true-",
        "residual recompute + bounded tighten-retry, see",
        "`solvers/base.py:certified_solve`) reports converged AND the",
        "independently recomputed f64 true residual is within 1.5x of",
        "the requested tolerance. In f32 the recurrence noise floor sits",
        "near 1e-6..1e-7 * ||b|| for these conditionings (kappa ~1.7e3 /",
        "~2.4e2); certified_solve reports honest converged=False beyond",
        "it instead of stalling to maxiter (the Belos ImpResNorm",
        "loss-of-accuracy exit, BelosStatusTestImpResNorm.hpp:47-88).",
        "",
        "Guidance: in f32 request rtol >= 1e-5 for",
        "unpreconditioned Krylov on O(1e3)-conditioned systems; tighter",
        "targets need f64 (native on the H100) or preconditioning that reduces the",
        "iteration count and with it the rounding accumulation.",
        "",
        "| problem | solver | dtype | tightest certified rtol |",
        "|---|---|---|---|",
    ]
    for r in rows:
        t = ("(none in ladder)" if r["tightest_rtol"] is None
             else f"{r['tightest_rtol']:g}")
        lines.append(f"| {r['problem']} | {r['solver']} | {r['dtype']} "
                     f"| {t} |")
    lines.append("")
    lines.append("Raw true-residuals per requested rtol:")
    lines.append("")
    lines.append("```json")
    lines.append(json.dumps(rows, indent=1))
    lines.append("```")
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "f32_tolerances.md")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote", out)


if __name__ == "__main__":
    main()
