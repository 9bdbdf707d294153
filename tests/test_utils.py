"""Service-layer tests: ParameterList/XML, perf archive, checkpoint,
timers, behavior flags, ILUT."""
import os

import numpy as np
import pytest

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d, recirc2d
from trilinos_tpu.utils import (ParameterList, PerfArchive, read_xml,
                                write_xml)
from trilinos_tpu.utils.checkpoint import (checkpointed_solve, load_state,
                                           save_state)
from trilinos_tpu.utils.params import Param


class TestParameterList:
    def test_get_records_default(self):
        p = ParameterList()
        assert p.get("tol", 1e-8) == 1e-8
        assert "tol" in p

    def test_sublist(self):
        p = ParameterList()
        p.sublist("prec")["sweeps"] = 3
        assert p["prec"]["sweeps"] == 3

    def test_validate_rejects_unknown(self):
        p = ParameterList({"tol": 1e-6, "oops": 1})
        with pytest.raises(ValueError, match="unknown"):
            p.validate({"tol": Param("tol", 1e-8)})

    def test_unused_tracking(self):
        p = ParameterList({"a": 1, "b": 2})
        _ = p["a"]
        assert p.unused() == ["b"]


class TestXmlParams:
    def test_round_trip(self):
        p = ParameterList({"Convergence Tolerance": 1e-8,
                           "Maximum Iterations": 100,
                           "Orthogonalization": "ICGS"}, name="Belos")
        p.sublist("Prec")["chebyshev: degree"] = 3
        s = write_xml(p)
        q = read_xml(s)
        assert q["Convergence Tolerance"] == 1e-8
        assert q["Maximum Iterations"] == 100
        assert q["Prec"]["chebyshev: degree"] == 3

    def test_reads_teuchos_format(self):
        xml = """<ParameterList name="test">
          <Parameter name="Block Size" type="int" value="4"/>
          <Parameter name="Tol" type="double" value="1e-10"/>
          <Parameter name="Flexible" type="bool" value="true"/>
          <ParameterList name="inner">
            <Parameter name="s" type="string" value="DGKS"/>
          </ParameterList>
        </ParameterList>"""
        p = read_xml(xml)
        assert p["Block Size"] == 4 and p["Flexible"] is True
        assert p["inner"]["s"] == "DGKS"


class TestPerfArchive:
    def test_lifecycle(self, tmp_path):
        path = str(tmp_path / "perf.json")
        ar = PerfArchive(path)
        assert ar.check("cg_time", 1.0).status == "new"
        ar2 = PerfArchive(path)
        assert ar2.check("cg_time", 1.05).status == "pass"
        assert ar2.check("cg_time", 1.5).status == "regression"
        assert ar2.check("cg_time", 0.8).status == "faster"
        # faster value archived
        assert PerfArchive(path).check("cg_time", 0.85).status == "pass"

    def test_higher_is_better(self, tmp_path):
        ar = PerfArchive(str(tmp_path / "p.json"))
        ar.check("gbps", 100.0, higher_is_better=True)
        assert ar.check("gbps", 150.0,
                        higher_is_better=True).status == "faster"
        assert ar.check("gbps", 80.0,
                        higher_is_better=True).status == "regression"


class TestCheckpoint:
    def test_save_load_pytree(self, tmp_path):
        tree = {"x": jnp.arange(5.0), "h": jnp.eye(3)}
        p = str(tmp_path / "st.npz")
        save_state(p, tree)
        out = load_state(p, tree)
        np.testing.assert_array_equal(np.asarray(out["x"]), np.arange(5.0))

    def test_checkpointed_solve_resumes(self, tmp_path):
        from trilinos_tpu.ops import formats as F
        import trilinos_tpu.ops.matvec as S
        from trilinos_tpu.solvers import cg

        a = laplace2d(12, 12)
        dev = F.csr_to_dia(a)
        n = 144
        b = np.zeros(dev.n_rows_pad)
        b[:n] = np.random.default_rng(0).standard_normal(n)
        op = lambda x: S.spmv(dev, x)
        path = str(tmp_path / "cg.npz")
        res = checkpointed_solve(cg, op, jnp.asarray(b), path=path,
                                 cycle_iters=20, rtol=1e-9, maxiter=2000)
        assert bool(res.converged.all())
        assert os.path.exists(path)
        # resume from converged state: finishes immediately
        res2 = checkpointed_solve(cg, op, jnp.asarray(b), path=path,
                                  cycle_iters=20, rtol=1e-9, maxiter=2000)
        assert int(res2.iters) == 0


class TestIlut:
    def test_tighter_than_ilu0(self):
        from trilinos_tpu import precond

        a = recirc2d(12, 12, diff=1e-2)
        l0, u0 = precond.ilu0_factor(a)
        lt, ut = precond.ilut_factor(a, fill=3.0, droptol=1e-6)
        # more fill allowed -> product closer to A
        err0 = np.abs(l0.to_dense() @ u0.to_dense() - a.to_dense()).max()
        errt = np.abs(lt.to_dense() @ ut.to_dense() - a.to_dense()).max()
        assert errt <= err0 + 1e-12

    def test_accelerates_gmres(self):
        import trilinos_tpu.ops.matvec as S
        from trilinos_tpu.ops import formats as F
        from trilinos_tpu import precond
        from trilinos_tpu.solvers import gmres

        a = recirc2d(14, 14, diff=1e-2)
        dev = F.csr_to_dia(a)
        n = 196
        b = np.zeros(dev.n_rows_pad)
        b[:n] = np.random.default_rng(1).standard_normal(n)
        op = lambda x: S.spmv(dev, x)
        plain = gmres(op, jnp.asarray(b), restart=30, rtol=1e-8,
                      maxiter=2000)
        ilut = precond.create("ILUT", a, {"fact: sweeps": 10}).compute()
        accel = gmres(op, jnp.asarray(b), prec=ilut, restart=30, rtol=1e-8,
                      maxiter=2000)
        x = np.asarray(accel.x)[:n]
        rel = np.linalg.norm(b[:n] - a.to_dense() @ x) / np.linalg.norm(
            b[:n])
        assert rel <= 1e-6
        assert int(accel.iters) < int(plain.iters)


class TestGaleriFactoryNames:
    """create_matrix covers the reference's named problems
    (Galeri_CrsMatrices.cpp string factory + src-xpetra problems)."""

    def test_round2_names(self):
        from trilinos_tpu.galeri.stencils import create_matrix

        for name, params in [("Elasticity2D", dict(nx=4, ny=3)),
                             ("Helmholtz2D", dict(nx=6, ny=5, k=2.0)),
                             ("UniFlow2D", dict(nx=6, ny=5)),
                             ("Maxwell2D", dict(nx=4, ny=4))]:
            m = create_matrix(name, params)
            if name == "Maxwell2D":
                a, g = m
                assert a.shape[0] == a.shape[1] == g.shape[0]
            else:
                assert m.shape[0] == m.shape[1] > 0

    def test_unknown_raises(self):
        import pytest as _pytest

        from trilinos_tpu.galeri.stencils import create_matrix

        with _pytest.raises(ValueError):
            create_matrix("NotAProblem", dict(nx=2, ny=2))
