"""Harness-layer tests: CLI drivers, statistics, matrix specs, CSV schema."""

import csv
import os

import numpy as np
import pytest

from arnoldi_jax.harness import (
    EigensolverParameters,
    arnoldi_jax_eig,
    arpack_eig,
    find_best_matching,
    matrix_from_spec,
)
from arnoldi_jax.harness.suite import clement_matrix, deflation_eig, grcar_matrix


def test_matrix_specs():
    assert matrix_from_spec("mark:10").shape == (55, 55)
    assert matrix_from_spec("laplace:32").shape == (32, 32)
    assert matrix_from_spec("laplace2d:6").shape == (36, 36)
    assert matrix_from_spec("grcar:20").shape == (20, 20)
    assert matrix_from_spec("clement:20").shape == (20, 20)
    with pytest.raises(ValueError):
        matrix_from_spec("nosuch:5")


def test_clement_spectrum():
    # Clement matrix has eigenvalues ±(n-1), ±(n-3), ...
    n = 10
    A = clement_matrix(n)
    vals = np.sort(np.linalg.eigvals(A.todense()).real)
    want = np.sort(np.concatenate([np.arange(-n + 1, 0, 2),
                                   np.arange(1, n, 2)]))
    np.testing.assert_allclose(vals, want, atol=1e-8)


def test_drivers_agree():
    import jax

    A = matrix_from_spec("mark:10")
    params = EigensolverParameters(nev=3, ncv=12, tol=1e-9,
                                   max_restarts=5000, which="LR")
    r_vals, _, r_stats = arpack_eig(A, params)
    vals, vecs, stats = arnoldi_jax_eig(A, params, key=jax.random.key(0))
    d_vals, d_vecs, d_stats = deflation_eig(A, params, key=jax.random.key(0))

    a, b = find_best_matching(np.asarray(vals), r_vals)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    a, b = find_best_matching(np.asarray(d_vals), r_vals)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    assert stats.matvecs > 0 and stats.elapsed > 0
    # Krylov-Schur matvec counting must be solver-wide, not summed per-k
    assert stats.matvecs < 3 * r_stats.matvecs


def test_eigenvalues_match_boundary_ties():
    from arnoldi_jax.harness.suite import eigenvalues_match

    # Exact agreement passes.
    a = np.array([1.0, -1.0, 0.9977, 0.99, 0.98])
    assert eigenvalues_match(a, a.copy(), "LM")
    # LM boundary tie: 5th slot holds either member of the +/-0.9771
    # cluster — both answers correct (mark's symmetric spectrum).
    b = a.copy()
    b[2] = -0.9977           # other member of the tied boundary cluster?
    # ...not at the boundary (0.98 is the boundary key) -> must REJECT
    assert not eigenvalues_match(a, b, "LM")
    b = a.copy()
    b[4] = -0.98             # tie at the boundary key -> accept
    assert eigenvalues_match(a, b, "LM")
    # A genuinely different boundary value is still a mismatch.
    b = a.copy()
    b[4] = 0.90
    assert not eigenvalues_match(a, b, "LM")
    # Complex conjugate boundary tie under LR.
    a = np.array([2.0 + 0j, 1.0 + 1j])
    b = np.array([2.0 + 0j, 1.0 - 1j])
    assert eigenvalues_match(a, b, "LR")
    assert not eigenvalues_match(a, b, "LI")
    # Ghost duplicate: a repeats the +0.9977 member it already matched
    # instead of finding -0.9977 — a wrong set, not a tie pick.
    a = np.array([1.0, 0.9977, 0.9977])
    b = np.array([1.0, 0.9977, -0.9977])
    assert not eigenvalues_match(a, b, "LM")


def test_compare_arpack_cli(capsys):
    from arnoldi_jax.harness import compare_arpack

    rc = compare_arpack.main(["mark:20", "--nev", "3", "--which", "LR",
                              "--tol", "1e-8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "eigenvalues MATCH" in out
    assert "matvecs than ARPACK" in out


def test_stress_test_cli(tmp_path):
    from arnoldi_jax.harness import stress_test

    out = tmp_path / "stress.csv"
    rc = stress_test.main(["mark:12", "-o", str(out), "--quick"])
    assert rc == 0
    with open(out) as f:
        rows = list(csv.reader(f))
    header = rows[0]
    assert header == ["method", "dtype", "nev", "ncv", "tol", "max_restarts",
                      "p", "which", "elapsed", "matvecs", "restarts", "match"]
    assert len(rows) > 4


def test_bench_partial_schur_cli(capsys):
    from arnoldi_jax.harness import bench_partial_schur

    rc = bench_partial_schur.main(["mark:15", "--nev", "3", "--tol", "1e-8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ms/matvec" in out


def test_slepc_gracefully_unavailable():
    try:
        import slepc4py  # noqa: F401

        pytest.skip("slepc4py actually installed")
    except ImportError:
        pass
    from arnoldi_jax.harness import slepc

    with pytest.raises(ImportError, match="petsc4py/slepc4py"):
        slepc.slepc_eig(matrix_from_spec("mark:10"),
                        EigensolverParameters(nev=2))


def test_reference_implementation_method():
    """The reference implementation itself runs as a harness method
    (arnoldi-py-ref) from a shared v0 and agrees with ARPACK and with this
    framework's driver."""
    from arnoldi_jax.harness.suite import (_reference_package,
                                           arnoldi_py_ref_eig, arpack_eig,
                                           arnoldi_jax_eig,
                                           eigenvalues_match)
    from arnoldi_jax.utils.random import rand_normalized_vector
    import arnoldi_jax.harness.suite as suite_mod

    if _reference_package() is None:
        pytest.skip("reference package not importable")
    import jax

    A = matrix_from_spec("mark:20")
    params = EigensolverParameters(nev=4, ncv=16, tol=1e-8,
                                   max_restarts=10_000, which="LR")
    v0 = np.asarray(rand_normalized_vector(jax.random.key(0), A.shape[0],
                                           np.float64))
    vals_ref, vecs_ref, st = arnoldi_py_ref_eig(A, params, v0=v0)
    assert st.matvecs > 0 and st.elapsed > 0
    res = np.linalg.norm(A @ vecs_ref - vals_ref * vecs_ref, axis=0)
    assert res.max() < 1e-6
    vals_arp, _, _ = arpack_eig(A, params, v0=v0)
    assert eigenvalues_match(vals_ref, vals_arp, "LR")
    vals_ours, _, _ = arnoldi_jax_eig(A, params, key=jax.random.key(0))
    assert eigenvalues_match(vals_ours, vals_ref, "LR")
    # the monkeypatched start-vector hook must be restored
    import arnoldi.krylov_schur as ref_ks
    import arnoldi.utils as ref_utils

    assert ref_ks.rand_normalized_vector is ref_utils.rand_normalized_vector


def test_check_claims_reproduces_readme():
    """The drift guard itself: every quoted benchmark figure in the README
    must recompute from the committed artifacts (runs the real script)."""
    import subprocess
    import sys as _sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    script = repo / "scripts" / "check_claims.py"
    if not script.exists() or not list(
            (repo / "artifacts").glob("stress-mark100_r*.csv")):
        pytest.skip("artifacts not present")
    r = subprocess.run([_sys.executable, str(script)], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
