"""SolverManager / factory / LinearProblem / block GMRES / LSQR tests.

Mirrors the reference's parameter-driven solve pattern
(BelosBlockGmresSolMgr parameter surface; Stratimikos builder).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, recirc2d
from trilinos_tpu.ops import formats as F
import trilinos_tpu.ops.matvec as S
from trilinos_tpu.solvers import (LinearProblem, block_gmres, build,
                                  create_solver, fixed_point, lsqr,
                                  solver_names)


def make_problem(a_csr, nrhs=0, seed=7):
    dev = F.csr_to_dia(a_csr)
    n, npad = a_csr.shape[0], dev.n_rows_pad
    rng = np.random.default_rng(seed)
    shape = (npad,) if nrhs == 0 else (npad, nrhs)
    b = np.zeros(shape)
    b[:n] = rng.standard_normal((n,) if nrhs == 0 else (n, nrhs))
    op = lambda x: S.spmv(dev, x)
    op_t = lambda x: S.spmv(dev, x, transpose=True)
    return op, op_t, jnp.asarray(b), a_csr.to_dense(), n


def rel_res(b, dense, x, n):
    bb, xx = np.asarray(b)[:n], np.asarray(x)[:n]
    return np.linalg.norm(bb - dense @ xx, axis=0) / np.linalg.norm(bb, axis=0)


class TestSolverManager:
    @pytest.mark.parametrize("name", ["CG", "GMRES", "BiCGStab", "TFQMR",
                                      "MINRES",
                                      "Pipelined CG", "Single reduce CG"])
    def test_named_solvers_converge(self, name):
        a = laplace2d(14, 14)
        op, op_t, b, dense, n = make_problem(a)
        mgr = create_solver(name, {"Convergence Tolerance": 1e-9,
                                   "Maximum Iterations": 20000})
        res = mgr.solve(LinearProblem(op, b))
        assert rel_res(b, dense, res.x, n) <= 1e-6

    def test_unknown_name_raises(self):
        with pytest.raises(ValueError, match="unknown solver"):
            create_solver("Super Solver")

    def test_solver_names_listed(self):
        names = solver_names()
        assert "BLOCK GMRES" in names and "LSQR" in names

    def test_invalid_ortho_choice(self):
        with pytest.raises(ValueError):
            create_solver("GMRES", {"Orthogonalization": "QR-ish"})

    def test_lsqr_via_manager(self):
        a = laplace2d(10, 10)
        op, op_t, b, dense, n = make_problem(a)
        prob = LinearProblem(op, b)
        prob.op_t = op_t
        mgr = create_solver("LSQR", {"Convergence Tolerance": 1e-10,
                                     "Maximum Iterations": 5000})
        res = mgr.solve(prob)
        assert rel_res(b, dense, res.x, n) <= 1e-6


class TestBlockGmres:
    @pytest.mark.parametrize("ortho", ["CGS2", "DGKS"])
    def test_multirhs_shared_space(self, ortho):
        a = laplace2d(16, 16)
        op, _, b, dense, n = make_problem(a, nrhs=4)
        res = block_gmres(op, b, num_blocks=40, max_restarts=10, rtol=1e-8,
                          ortho=ortho)
        assert (rel_res(b, dense, res.x, n) <= 1e-7).all()
        assert bool(res.converged.all())

    def test_nonsymmetric(self):
        a = recirc2d(12, 12, diff=1e-1)
        op, _, b, dense, n = make_problem(a, nrhs=3)
        res = block_gmres(op, b, num_blocks=30, max_restarts=15, rtol=1e-8)
        assert (rel_res(b, dense, res.x, n) <= 1e-6).all()

    def test_with_jacobi_prec(self):
        a = laplace2d(12, 12)
        op, _, b, dense, n = make_problem(a, nrhs=2)
        dinv = np.ones(b.shape[0])
        dinv[:n] = 0.25
        prec = lambda v: jnp.asarray(dinv)[:, None] * v
        res = block_gmres(op, b, prec=prec, num_blocks=30, rtol=1e-8)
        assert (rel_res(b, dense, res.x, n) <= 1e-7).all()

    def test_via_manager_single_rhs(self):
        a = laplace2d(10, 10)
        op, _, b, dense, n = make_problem(a)
        mgr = create_solver("Block GMRES", {"Num Blocks": 25,
                                            "Convergence Tolerance": 1e-9})
        res = mgr.solve(LinearProblem(op, b))
        assert res.x.ndim == 1
        assert rel_res(b, dense, res.x, n) <= 1e-7


class TestLsqrDirect:
    def test_lsqr_square(self):
        a = recirc2d(10, 10, diff=1e-1)
        op, op_t, b, dense, n = make_problem(a)
        res = lsqr(op, op_t, b, rtol=1e-12, maxiter=20000)
        assert rel_res(b, dense, res.x, n) <= 1e-6

    def test_fixed_point_jacobi(self):
        a = laplace2d(8, 8)
        op, _, b, dense, n = make_problem(a)
        dinv = np.ones(b.shape[0]) * 0.25
        res = fixed_point(op, b, prec=lambda v: jnp.asarray(dinv) * v,
                          rtol=1e-8, maxiter=20000)
        assert rel_res(b, dense, res.x, n) <= 1e-6


class TestStratimikosBuilder:
    def test_build_solver_and_prec(self):
        a = laplace2d(16, 16)
        op, _, b, dense, n = make_problem(a)
        mgr, prec = build({
            "Linear Solver Type": "GMRES",
            "Solver Types": {"GMRES": {"Num Blocks": 30,
                                       "Convergence Tolerance": 1e-9}},
            "Preconditioner Type": "CHEBYSHEV",
            "Preconditioner Types": {"CHEBYSHEV": {"chebyshev: degree": 3}},
        }, a_csr=a)
        res = mgr.solve(LinearProblem(op, b, right_prec=prec))
        assert rel_res(b, dense, res.x, n) <= 1e-7

    def test_build_no_prec(self):
        mgr, prec = build({"Linear Solver Type": "CG"})
        assert prec is None
        assert mgr.kind == "cg"


class TestMvopTester:
    def test_valid_operator_passes(self):
        from trilinos_tpu.testing import validate_operator

        a = laplace2d(8, 8)
        dev = F.csr_to_dia(a)
        op = lambda x: S.spmv(dev, x)
        assert validate_operator(op, dev.n_rows_pad, symmetric=True) == []

    def test_nonlinear_operator_caught(self):
        from trilinos_tpu.testing import validate_operator

        bad = lambda x: x * x
        assert any("linear" in p for p in validate_operator(bad, 16))

    def test_shape_change_caught(self):
        from trilinos_tpu.testing import validate_operator

        bad = lambda x: jnp.concatenate([x, x[:1]]) if x.ndim == 1 else x
        assert any("shape" in p for p in validate_operator(bad, 8))

    def test_comm_contract(self):
        from trilinos_tpu.parallel import SerialComm
        from trilinos_tpu.testing import validate_comm

        assert validate_comm(SerialComm()) == []


class TestStepBasis:
    def test_newton_basis_via_manager(self):
        """'Step Basis': 'Newton' computes Leja-ordered Ritz shifts
        before the solve and converges like the monomial basis."""
        from trilinos_tpu.solvers import create_solver

        a = laplace2d(16, 16)
        op, op_t, b, dense, n = make_problem(a)
        for basis in ("Monomial", "Newton"):
            mgr = create_solver("CA-GMRES", {
                "Convergence Tolerance": 1e-8,
                "Step Size": 4, "Num Blocks": 24,
                "Maximum Restarts": 30, "Step Basis": basis})
            res = mgr.solve(LinearProblem(op=op, b=b))
            assert rel_res(b, dense, res.x, n) <= 1e-7, basis

    def test_invalid_basis_rejected(self):
        from trilinos_tpu.solvers import create_solver

        with pytest.raises(ValueError):
            create_solver("CA-GMRES", {"Step Basis": "Chebyshev"})


class TestHybridGmres:
    """GmresPolySolMgr analogue ('Hybrid Block GMRES',
    packages/belos/src/BelosGmresPolySolMgr.hpp): the GMRES polynomial
    built from the problem seeds the outer solve as the composed right
    preconditioner."""

    def test_hybrid_beats_plain_gmres(self, rng):
        from trilinos_tpu.galeri import recirc2d
        from trilinos_tpu.ops import choose_format
        from trilinos_tpu.ops import matvec as S

        a = recirc2d(24, 24, diff=1e-2)
        dev = choose_format(a)
        n, npad = a.shape[0], dev.n_rows_pad
        b = np.zeros(npad)
        b[:n] = rng.standard_normal(n)
        op = lambda v: S.spmv(dev, v)
        from trilinos_tpu.solvers.factory import SolverManager

        hy = SolverManager("Hybrid Block GMRES",
                           {"Convergence Tolerance": 1e-8,
                            "Maximum Degree": 20})
        r = hy.solve(LinearProblem(op, jnp.asarray(b)))
        gm = SolverManager("GMRES", {"Convergence Tolerance": 1e-8})
        r0 = gm.solve(LinearProblem(op, jnp.asarray(b)))
        assert bool(r.converged)
        # measured 14 vs 799 outer iterations at this size
        assert int(r.iters) * 10 <= int(r0.iters)
        x = np.asarray(r.x)[:n]
        rel = (np.linalg.norm(b[:n] - a.to_dense() @ x)
               / np.linalg.norm(b[:n]))
        assert rel <= 2e-8


def test_basis_precision_parameter():
    """Extension of the reference parameter surface: "Basis
    Precision": "bf16" routes gmres/block_gmres through the narrow
    Krylov-basis storage and still certifies convergence."""
    import jax.numpy as jnp
    from trilinos_tpu.galeri import laplace2d
    from trilinos_tpu.ops import formats as F
    from trilinos_tpu.ops import matvec as S
    from trilinos_tpu.solvers.factory import SolverManager
    from trilinos_tpu.solvers.linear_problem import LinearProblem

    a = laplace2d(16, 16)
    dev = F.csr_to_dia(a)
    n, npad = a.shape[0], dev.n_rows_pad
    rng = np.random.default_rng(3)
    b = np.zeros(npad)
    b[:n] = rng.standard_normal(n)
    op = lambda x: S.spmv(dev, x)
    for name in ("GMRES", "Block GMRES"):
        mgr = SolverManager(name, {"Convergence Tolerance": 1e-6,
                                   "Maximum Iterations": 2000,
                                   "Basis Precision": "bf16"})
        res = mgr.solve(LinearProblem(op, jnp.asarray(b)))
        assert bool(np.asarray(res.converged).all()), name
        x = np.asarray(res.x)[:n]
        rel = np.linalg.norm(b[:n] - a.to_dense() @ x) / np.linalg.norm(b[:n])
        assert rel <= 1e-6, name


def test_basis_precision_rejected_for_unsupported_kinds():
    """'Basis Precision': 'bf16' raises for kinds whose iteration has no
    narrow-basis implementation (no silent full-precision fallback)."""
    import jax.numpy as jnp
    from trilinos_tpu.galeri import laplace2d
    from trilinos_tpu.ops import formats as F
    from trilinos_tpu.ops import matvec as S
    from trilinos_tpu.solvers.factory import SolverManager
    from trilinos_tpu.solvers.linear_problem import LinearProblem

    a = laplace2d(8, 8)
    dev = F.csr_to_dia(a)
    b = np.zeros(dev.n_rows_pad)
    b[:a.shape[0]] = 1.0
    op = lambda x: S.spmv(dev, x)
    for name in ("CG", "Single Reduce GMRES", "GCRODR", "BiCGStab"):
        mgr = SolverManager(name, {"Basis Precision": "bf16"})
        with pytest.raises(ValueError, match="Basis Precision"):
            mgr.solve(LinearProblem(op, jnp.asarray(b)))
