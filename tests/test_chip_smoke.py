"""chip_smoke.py: its phases at tiny sizes on the CPU (the same code the
card runs at Laplace3D 256³), and its refusal to run without a GPU."""
import numpy as np
import pytest

import chip_smoke


@pytest.fixture
def lines():
    out = []

    def report(phase, **fields):
        out.append(dict(phase=phase, **fields))
        return out[-1]

    report.lines = out
    return report


def _errors_within_tolerance(lines):
    checked = [l for l in lines if "tol" in l]
    assert checked
    for l in checked:
        assert l["err"] <= l["tol"], l


def test_spmv_phase_tiny(lines):
    chip_smoke.phase_spmv(lines, n=8, el=(4, 4, 3))
    got = {(l["format"], l["dtype"], l["transpose"], l["nrhs"])
           for l in lines.lines}
    formats = {f for f, *_ in got}
    assert formats == {"stencil7", "stencil27", "dia", "ell", "bsr",
                       "bdia_b3"}
    assert ("dia", "bfloat16", True, 4) in got
    assert len(got) == 6 * 2 * 2 * 2 + 4
    _errors_within_tolerance(lines.lines)


def test_flagship_phase_tiny(lines):
    chip_smoke.phase_flagship(lines, n=16)
    solves = [l for l in lines.lines if l["phase"] == "b.amg_cg"]
    assert [l["dtype"] for l in solves] == ["float32", "float64"]
    assert all(l["converged"] for l in solves)
    _errors_within_tolerance(lines.lines)


def test_factory_phase_tiny(lines):
    chip_smoke.phase_factory(lines, n2=24, n3=12, m=8)
    assert [l["case"] for l in lines.lines] == [
        "recirc2d_riluk", "laplace3d_dia_chebyshev"]
    assert all(l["ortho_err"] <= l["ortho_tol"] for l in lines.lines)
    _errors_within_tolerance(lines.lines)


def test_former_kernel_phase_tiny(lines):
    chip_smoke.phase_former_kernels(lines, n=16, panel_rows=4096)
    assert {l["phase"] for l in lines.lines} == {
        "d.chebyshev", "d.krylov_amg_chebyshev", "d.cholqr2"}
    _errors_within_tolerance(lines.lines)


def test_distributed_phase_four_virtual_devices(lines):
    chip_smoke.phase_distributed(lines, n=16, n_dev=4)
    dist = [l for l in lines.lines if l["phase"] == "e.distributed"]
    assert [l["case"] for l in dist] == [
        "cg_pipeline_jacobi", "amg_structured_cg", "sstep_gmres_fused"]
    for l in dist:
        assert abs(l["iters"] - l["single_iters"]) <= 1
    assert all(l["devices"] == 4 for l in lines.lines
               if l["phase"] == "e.sharding")
    _errors_within_tolerance(lines.lines)


def test_rel_max_and_residual_helpers():
    want = np.array([1.0, -4.0, 2.0])
    assert chip_smoke.rel_max(want + [0.0, 0.0, 0.4], want) == \
        pytest.approx(0.1)
    import scipy.sparse as sp

    a = sp.identity(3, format="csr") * 2.0
    assert chip_smoke.true_rel_residual(a, want / 2.0, want) == 0.0


@pytest.mark.parametrize("argv", [[], ["--chips", "4"]])
def test_main_without_gpu_exits_nonzero_without_ok(argv, capsys):
    assert chip_smoke.main(argv) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU" in captured.err


def test_main_rejects_unknown_chip_count():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--chips", "2"])


@pytest.mark.gpu
def test_spmv_phase_on_gpu(gpu, lines):
    """The parity phase compiled for the card at a small grid."""
    chip_smoke.phase_spmv(lines, n=32, el=(8, 8, 6))
    _errors_within_tolerance(lines.lines)


@pytest.mark.gpu
def test_flagship_phase_on_gpu(gpu, lines):
    """The flagship solve compiled for the card at a small grid."""
    chip_smoke.phase_flagship(lines, n=32)
    _errors_within_tolerance(lines.lines)
