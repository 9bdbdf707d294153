"""I/O tests: MatrixMarket round trips, HB reading (incl. the reference's
own shipped test matrices when available), distributed read.

Mirrors the reference's in-tree HB-driven solver tests
(packages/belos/tpetra/test/BlockGmres/test_bl_gmres_hb.cpp:178-189).
"""
import io
import os

import numpy as np
import pytest

from trilinos_tpu.galeri import laplace2d
from trilinos_tpu.io import read_hb, read_dense, read_sparse, write_dense, write_sparse
from trilinos_tpu.ops.formats import CsrHost

REF = "/root/reference/packages"


def ref_path(rel):
    p = os.path.join(REF, rel)
    if not os.path.exists(p):
        pytest.skip(f"reference matrix {rel} not available")
    return p


class TestMatrixMarket:
    def test_round_trip(self, rng):
        a = laplace2d(7, 9)
        buf = io.StringIO()
        write_sparse(buf, a, comment="laplace2d 7x9")
        buf.seek(0)
        b = read_sparse(buf)
        np.testing.assert_allclose(b.to_dense(), a.to_dense())

    def test_dense_round_trip(self, rng):
        x = rng.standard_normal((5, 3))
        buf = io.StringIO()
        write_dense(buf, x)
        buf.seek(0)
        np.testing.assert_allclose(read_dense(buf), x)

    def test_symmetric_expansion(self):
        buf = io.StringIO(
            "%%MatrixMarket matrix coordinate real symmetric\n"
            "3 3 4\n1 1 2.0\n2 1 -1.0\n2 2 2.0\n3 3 5.0\n")
        a = read_sparse(buf)
        d = a.to_dense()
        np.testing.assert_allclose(d, d.T)
        assert d[0, 1] == -1.0 and d[1, 0] == -1.0

    def test_pattern(self):
        buf = io.StringIO(
            "%%MatrixMarket matrix coordinate pattern general\n"
            "2 2 2\n1 1\n2 2\n")
        a = read_sparse(buf)
        np.testing.assert_allclose(a.to_dense(), np.eye(2))

    def test_bad_header_raises(self):
        with pytest.raises(ValueError):
            read_sparse(io.StringIO("garbage\n1 1 1\n"))

    def test_reference_mtx_cross_check(self):
        p = ref_path("isorropia/test/mtx/west0067.mtx")
        a = read_sparse(p)
        import scipy.io as sio

        want = sio.mmread(p).toarray()
        np.testing.assert_allclose(a.to_dense(), want)


class TestHarwellBoeing:
    def test_cage4_scipy_cross_check(self):
        # the one reference HB file scipy's limited reader can also parse
        p = ref_path("belos/epetra/test/BiCGStab/cage4.hb")
        a = read_hb(p)
        import scipy.io as sio

        want = sio.hb_read(p).toarray()
        np.testing.assert_allclose(a.to_dense(), want, rtol=1e-12)

    @pytest.mark.parametrize("rel,shape,nnz_stored", [
        # scipy cannot read these (symmetric / RHS-bearing); validate
        # header-declared shape and numerics instead
        ("belos/epetra/test/RCG/gr_30_30.hb", (900, 900), 4322),
        ("belos/epetra/example/GCRODR/sherman5.hb", (3312, 3312), 20793),
        ("belos/epetra/example/BlockGmres/orsirr1.hb", (1030, 1030), 6858),
    ])
    def test_reference_hb_headers(self, rel, shape, nnz_stored):
        a = read_hb(ref_path(rel))
        assert a.shape == shape
        assert a.nnz >= nnz_stored  # symmetric files expand

    def test_gr_30_30_symmetric_and_spd(self):
        """gr_30_30 is RSA (symmetric storage): expansion must produce a
        symmetric SPD matrix that CG can solve — deep numeric validation."""
        import jax.numpy as jnp

        from trilinos_tpu.ops import formats as F
        import trilinos_tpu.ops.matvec as S
        from trilinos_tpu.solvers import cg

        a = read_hb(ref_path("belos/epetra/test/RCG/gr_30_30.hb"))
        d = a.to_dense()
        np.testing.assert_allclose(d, d.T, rtol=1e-12)
        dev = F.csr_to_ell(a)
        n, npad = a.shape[0], dev.n_rows_pad
        b = np.zeros(npad)
        b[:n] = np.random.default_rng(0).standard_normal(n)
        res = cg(lambda x: S.spmv(dev, x), jnp.asarray(b),
                 rtol=1e-10, maxiter=3000)
        x = np.asarray(res.x)[:n]
        rel_res = np.linalg.norm(b[:n] - d @ x) / np.linalg.norm(b[:n])
        assert rel_res <= 1e-9


class TestHbSolve:
    """End-to-end: read reference HB matrix, solve with GMRES+ILU(0) to the
    reference tolerance (BASELINE config #3 shape)."""

    def test_sherman5_gmres_ilu(self):
        import jax.numpy as jnp

        from trilinos_tpu.ops import formats as F
        import trilinos_tpu.ops.matvec as S
        from trilinos_tpu import precond
        from trilinos_tpu.solvers import gmres

        a = read_hb(ref_path("belos/epetra/example/GCRODR/sherman5.hb"))
        dev = F.csr_to_ell(a)
        n, npad = a.shape[0], dev.n_rows_pad
        rng = np.random.default_rng(0)
        b = np.zeros(npad)
        b[:n] = rng.standard_normal(n)
        op = lambda x: S.spmv(dev, x)
        ilu = precond.Ilu0(a, {"fact: sweeps": 20}).compute()
        res = gmres(op, jnp.asarray(b), prec=ilu, restart=50, rtol=1e-8,
                    maxiter=2000, ortho="DGKS")
        x = np.asarray(res.x)[:n]
        rel = (np.linalg.norm(b[:n] - a.to_dense() @ x)
               / np.linalg.norm(b[:n]))
        assert rel <= 1e-6

    def test_cage4_bicgstab(self):
        import jax.numpy as jnp

        from trilinos_tpu.ops import formats as F
        import trilinos_tpu.ops.matvec as S
        from trilinos_tpu.solvers import bicgstab

        a = read_hb(ref_path("belos/epetra/test/BiCGStab/cage4.hb"))
        dev = F.csr_to_ell(a)
        n, npad = a.shape[0], dev.n_rows_pad
        b = np.zeros(npad)
        b[:n] = np.random.default_rng(1).standard_normal(n)
        res = bicgstab(lambda x: S.spmv(dev, x), jnp.asarray(b),
                       rtol=1e-9, maxiter=2000)
        x = np.asarray(res.x)[:n]
        rel = (np.linalg.norm(b[:n] - a.to_dense() @ x)
               / np.linalg.norm(b[:n]))
        assert rel <= 1e-7


class TestDistributedRead:
    def test_read_sparse_distributed(self, tmp_path, rng):
        import jax.numpy as jnp

        from trilinos_tpu.io import read_sparse_distributed
        from trilinos_tpu.parallel import driver as drv

        a = laplace2d(10, 8)
        p = tmp_path / "m.mtx"
        write_sparse(str(p), a)
        dm = read_sparse_distributed(str(p), 4)
        mesh = drv.make_mesh(4)
        x = rng.standard_normal(80)
        y = drv.dist_spmv(dm, jnp.asarray(dm.row_map.to_padded(x)), mesh)
        np.testing.assert_allclose(dm.row_map.from_padded(np.asarray(y)),
                                   a.to_dense() @ x, rtol=1e-12)


class TestBinaryContainer:
    """TTBC binary container (EpetraExt_HDF5 analogue) + binary COO
    (Tpetra_Details_CooMatrix analogue)."""

    def test_round_trip(self, tmp_path, rng):
        from trilinos_tpu.io.container import BinaryContainer
        from trilinos_tpu.galeri import laplace2d

        a = laplace2d(13, 9)
        vec = rng.standard_normal(17)
        p = str(tmp_path / "c.ttbc")
        (BinaryContainer()
         .add_csr("A", a)
         .add_array("x", vec)
         .add_coo("B", [0, 1, 2], [2, 1, 0], [1.5, -2.0, 3.25], (3, 3))
         .add_meta("info", {"solver": "CG", "rtol": 1e-8})
         .write(p))
        c = BinaryContainer.open(p)
        assert c.names() == ["A", "B", "info", "x"]
        a2 = c.get_csr("A")
        np.testing.assert_array_equal(a2.row_ptr, a.row_ptr)
        np.testing.assert_array_equal(a2.cols, a.cols)
        np.testing.assert_array_equal(a2.vals, a.vals)
        np.testing.assert_array_equal(c.get_array("x"), vec)
        r, cc, v, shape = c.get_coo("B")
        np.testing.assert_array_equal(r, [0, 1, 2])
        np.testing.assert_array_equal(v, [1.5, -2.0, 3.25])
        assert shape == (3, 3)
        assert c.get_meta("info")["solver"] == "CG"

    def test_coo_file(self, tmp_path):
        from trilinos_tpu.io.container import read_coo, write_coo

        p = str(tmp_path / "m.coo")
        write_coo(p, np.array([0, 5]), np.array([1, 3]),
                  np.array([2.0, -4.0]), (6, 6))
        r, c, v, shape = read_coo(p)
        np.testing.assert_array_equal(r, [0, 5])
        assert shape == (6, 6)

    def test_bad_magic(self, tmp_path):
        from trilinos_tpu.io.container import BinaryContainer

        p = tmp_path / "junk.bin"
        p.write_bytes(b"NOTTTBC!xxxx")
        with pytest.raises(ValueError):
            BinaryContainer.open(str(p))


class TestVtk:
    """Legacy VTK mesh/field I/O (the SEACAS/Exodus results-file role)."""

    def test_roundtrip_quad_mesh(self, tmp_path):
        from trilinos_tpu.fem import structured_quad_mesh
        from trilinos_tpu.io import read_vtk, write_vtk

        mesh = structured_quad_mesh(3, 2)
        u = np.arange(mesh.coords.shape[0], dtype=np.float64)
        vel = np.stack([u, -u], axis=1)
        rho = np.arange(mesh.connect.shape[0], dtype=np.float64)
        p = str(tmp_path / "m.vtk")
        write_vtk(p, mesh, point_data={"u": u, "vel": vel},
                  cell_data={"rho": rho})
        name, coords, connect, pd, cd = read_vtk(p)
        assert name == "quad4"
        np.testing.assert_allclose(coords[:, :2], mesh.coords)
        np.testing.assert_array_equal(connect, mesh.connect)
        np.testing.assert_allclose(pd["u"], u)
        np.testing.assert_allclose(pd["vel"][:, :2], vel)
        np.testing.assert_allclose(cd["rho"], rho)

    def test_roundtrip_hex_and_tet(self, tmp_path):
        from trilinos_tpu.fem import (structured_hex_mesh,
                                      structured_tet_mesh)
        from trilinos_tpu.io import read_vtk, write_vtk

        for make, name in [(structured_hex_mesh, "hex8"),
                           (structured_tet_mesh, "tet4")]:
            mesh = make(2, 2, 2)
            p = str(tmp_path / f"{name}.vtk")
            write_vtk(p, mesh)
            got, coords, connect, _, _ = read_vtk(p)
            assert got == name
            np.testing.assert_allclose(coords, mesh.coords)
            np.testing.assert_array_equal(connect, mesh.connect)

    def test_series(self, tmp_path):
        import json

        from trilinos_tpu.fem import structured_tri_mesh
        from trilinos_tpu.io import read_vtk, write_vtk_series

        mesh = structured_tri_mesh(2, 2)
        n = mesh.coords.shape[0]
        steps = [({"u": np.full(n, float(i))}, None) for i in range(3)]
        base = str(tmp_path / "run")
        paths = write_vtk_series(base, mesh, steps, times=[0.0, 0.5, 1.0])
        assert len(paths) == 3
        _, _, _, pd, _ = read_vtk(paths[2])
        np.testing.assert_allclose(pd["u"], 2.0)
        idx = json.load(open(base + ".vtk.series"))
        assert idx["files"][1]["time"] == 0.5

    def test_field_length_mismatch(self, tmp_path):
        from trilinos_tpu.fem import structured_quad_mesh
        from trilinos_tpu.io import write_vtk

        mesh = structured_quad_mesh(2, 2)
        with pytest.raises(ValueError):
            write_vtk(str(tmp_path / "bad.vtk"), mesh,
                      point_data={"u": np.zeros(3)})

    def test_vtk_cell_orientation_valid(self, tmp_path):
        """Written quads/hexes must be in VTK CCW order (positive
        signed area / volume), not the fem lexicographic order."""
        from trilinos_tpu.fem import (structured_hex_mesh,
                                      structured_quad_mesh)
        from trilinos_tpu.io import read_vtk, write_vtk

        mesh = structured_quad_mesh(3, 3)
        p = str(tmp_path / "q.vtk")
        write_vtk(p, mesh)
        # read RAW file connectivity (VTK order)
        txt = open(p).read().split()
        i = txt.index("CELLS")
        ne = int(txt[i + 1])
        raw = np.array(txt[i + 3:i + 3 + ne * 5], dtype=int)
        conn_vtk = raw.reshape(ne, 5)[:, 1:]
        xy = mesh.coords
        for quad in conn_vtk:
            pts = xy[quad]
            area = 0.0
            for k in range(4):
                x0, y0 = pts[k]
                x1, y1 = pts[(k + 1) % 4]
                area += x0 * y1 - x1 * y0
            assert area > 0  # CCW, non-self-intersecting
        # and the read-back returns fem (lexicographic) order
        _, _, conn_back, _, _ = read_vtk(p)
        np.testing.assert_array_equal(conn_back, mesh.connect)

        hexm = structured_hex_mesh(2, 2, 2)
        ph = str(tmp_path / "h.vtk")
        write_vtk(ph, hexm)
        _, _, hconn, _, _ = read_vtk(ph)
        np.testing.assert_array_equal(hconn, hexm.connect)


class TestComplexMatrixMarket:
    """Complex / hermitian MatrixMarket files (the reference's templated
    reader supports complex Scalars; here they compose with ops.komplex
    equivalent-real solves)."""

    def _write(self, tmp_path, text, name="z.mtx"):
        p = tmp_path / name
        p.write_text(text)
        return str(p)

    def test_complex_coordinate_general(self, tmp_path):
        from trilinos_tpu.io.matrix_market import read_sparse

        path = self._write(tmp_path, """%%MatrixMarket matrix coordinate complex general
3 3 4
1 1 2.0 1.0
2 2 3.0 -0.5
3 3 4.0 0.0
1 3 0.5 0.25
""")
        a = read_sparse(path)
        dense = a.to_dense()
        assert dense.dtype.kind == "c"
        assert dense[0, 0] == 2.0 + 1.0j
        assert dense[0, 2] == 0.5 + 0.25j
        assert dense[2, 0] == 0.0

    def test_hermitian_coordinate(self, tmp_path):
        from trilinos_tpu.io.matrix_market import read_sparse

        path = self._write(tmp_path, """%%MatrixMarket matrix coordinate complex hermitian
2 2 3
1 1 2.0 0.0
2 2 3.0 0.0
2 1 1.0 0.5
""")
        a = read_sparse(path).to_dense()
        assert a[1, 0] == 1.0 + 0.5j
        assert a[0, 1] == 1.0 - 0.5j  # conjugate mirror

    def test_complex_read_then_solve(self, tmp_path):
        from trilinos_tpu.io.matrix_market import read_sparse
        from trilinos_tpu.ops import komplex

        rng = np.random.default_rng(9)
        n = 12
        az = (rng.standard_normal((n, n))
              + 1j * rng.standard_normal((n, n)) + 8 * np.eye(n))
        lines = [f"%%MatrixMarket matrix coordinate complex general",
                 f"{n} {n} {n * n}"]
        for i in range(n):
            for j in range(n):
                lines.append(
                    f"{i+1} {j+1} {az[i, j].real:.17g} {az[i, j].imag:.17g}")
        path = self._write(tmp_path, "\n".join(lines) + "\n")
        a = read_sparse(path)
        np.testing.assert_allclose(a.to_dense(), az, rtol=1e-14)
        bz = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        z, res = komplex.solve_complex(a, bz)
        np.testing.assert_allclose(z, np.linalg.solve(az, bz),
                                   rtol=1e-5, atol=1e-8)

    def test_complex_array_format(self, tmp_path):
        from trilinos_tpu.io.matrix_market import read_sparse

        path = self._write(tmp_path, """%%MatrixMarket matrix array complex general
2 2
1.0 0.5
2.0 0.0
3.0 -1.0
4.0 0.25
""")
        a = read_sparse(path).to_dense()
        # column-major: (1,1)=(1+0.5j) (2,1)=(2) (1,2)=(3-1j) (2,2)=(4+0.25j)
        assert a[0, 0] == 1.0 + 0.5j
        assert a[1, 0] == 2.0
        assert a[0, 1] == 3.0 - 1.0j
