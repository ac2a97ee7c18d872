"""Native C++ dense-tier tests: the self-contained Schur/trexc/trevc
implementation must match SciPy/LAPACK to near machine precision, including
on pathological inputs (nilpotent shifts, graded matrices, denormal-scale
entries) that stress the QR iteration's deflation and rotation safety."""

import numpy as np
import pytest

from arnoldi_jax.native import dense_tier as nat

pytestmark = pytest.mark.skipif(
    not nat.available(), reason="native dense tier failed to build"
)


def matrices():
    rng = np.random.default_rng(42)
    out = {}
    out["random_complex"] = rng.standard_normal((30, 30)) + 1j * rng.standard_normal((30, 30))
    out["real_in_complex"] = rng.standard_normal((25, 25)).astype(complex)
    d = rng.integers(1, 4, size=20).astype(float)
    Q = np.linalg.qr(rng.standard_normal((20, 20)))[0]
    out["repeated_eigs"] = (Q * d) @ Q.T + 0j
    out["hessenberg"] = np.triu(rng.standard_normal((35, 35)), -1) + 0j
    n = 41
    J = np.diag(np.ones(n - 1), 1) + 0j
    J[n - 1, 0] = 1e-8
    out["nilpotent_shift"] = J
    out["graded"] = rng.standard_normal((30, 30)) * np.logspace(0, -12, 30)[:, None] + 0j
    return out


@pytest.mark.parametrize("name", list(matrices()))
def test_schur_matches_lapack_grade(name):
    A = matrices()[name]
    n = A.shape[0]
    T, Z = nat.schur_complex(A)
    scale = max(np.abs(A).max(), 1.0)
    assert np.abs(Z @ T @ Z.conj().T - A).max() / scale < 1e-12
    assert np.abs(Z.conj().T @ Z - np.eye(n)).max() < 1e-12
    assert np.abs(np.tril(T, -1)).max() == 0.0
    # spectrum agrees with numpy
    got = np.sort_complex(np.diag(T))
    want = np.sort_complex(np.linalg.eigvals(A))
    from common import find_best_matching

    a, b = find_best_matching(got, want)
    np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-7 * scale)


def test_ordered_schur_full_sort():
    rng = np.random.default_rng(3)
    n = 20
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    T, Z = nat.schur_complex(A)
    order = np.argsort(-np.abs(np.diag(T))).astype(np.int32)
    T2, Z2 = nat.ordered_schur(T, Z, order)
    assert np.abs(Z2 @ T2 @ Z2.conj().T - A).max() < 1e-12
    d = np.abs(np.diag(T2))
    assert np.all(np.diff(d) <= 1e-10)


def test_trexc_move():
    rng = np.random.default_rng(5)
    n = 10
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    T, Z = nat.schur_complex(A)
    tgt = T[6, 6]
    T2, Z2 = nat.trexc(T, Z, 6, 1)
    assert abs(T2[1, 1] - tgt) < 1e-10
    assert np.abs(Z2 @ T2 @ Z2.conj().T - A).max() < 1e-12


def test_eig_matches_numpy():
    rng = np.random.default_rng(7)
    n = 18
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    vals, vecs = nat.eig(A)
    res = np.linalg.norm(A @ vecs - vals * vecs, axis=0)
    np.testing.assert_allclose(res, 0, atol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=0), 1, atol=1e-12)


def test_complex64_dtype_contract():
    rng = np.random.default_rng(9)
    A = (rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))).astype(
        np.complex64
    )
    T, Z = nat.schur_complex(A)
    assert T.dtype == np.complex64
    assert Z.dtype == np.complex64
    assert np.abs(Z @ T @ Z.conj().T - A).max() < 1e-5


def test_dispatch_uses_native(monkeypatch):
    # The ops-layer dispatch must actually reach the native module when the
    # backend is 'auto'.
    import arnoldi_jax.ops.dense_tier as dt

    assert dt._native() is not None


class TestNativeRealSchur:
    """Real (quasi-triangular) tier: native Francis QR + dlaexc-style block
    swaps vs scipy/LAPACK goldens (tolerance provenance: the reference
    copies its ordered_schur tolerances from SciPy's ARPACK suite,
    /root/reference/tests/test_utils.py:8-19)."""

    def test_schur_real_factorization(self):
        rng = np.random.default_rng(3)
        for n in (2, 3, 7, 24, 60):
            A = rng.standard_normal((n, n))
            T, Q = nat.schur_real(A)
            assert np.abs(Q @ T @ Q.T - A).max() < 1e-11 * max(
                1, np.abs(A).max())
            assert np.abs(Q.T @ Q - np.eye(n)).max() < 1e-12
            vals = np.sort_complex(np.linalg.eigvals(A))
            import arnoldi_jax.ops.dense_tier as dt

            got = np.sort_complex(dt.real_schur_eigvals(T))
            np.testing.assert_allclose(got, vals, atol=1e-9, rtol=1e-9)

    def test_standardized_blocks(self):
        rng = np.random.default_rng(4)
        A = rng.standard_normal((40, 40))
        T, _ = nat.schur_real(A)
        i = 0
        while i < 39:
            if T[i + 1, i] != 0:
                assert abs(T[i, i] - T[i + 1, i + 1]) <= 1e-8 * max(
                    1, abs(T[i, i]))
                assert T[i, i + 1] * T[i + 1, i] < 0
                i += 2
            else:
                i += 1

    def test_reorder_blocks_conjugate_pairs(self):
        # Spectrum engineered with conjugate pairs straddling the sort
        # boundary; native reorder must match the scipy-trexc fallback.
        import scipy.linalg as sla

        import arnoldi_jax.ops.dense_tier as dt
        from arnoldi_jax.utils.sorting import arg_largest_real

        rng = np.random.default_rng(5)
        D = sla.block_diag(
            np.array([[0.9, 0.8], [-0.8, 0.9]]),
            np.diag([1.2, -0.3]),
            np.array([[1.0, 2.0], [-2.0, 1.0]]),
            np.array([[0.95, 0.1], [-0.1, 0.95]]),
        )
        Qo, _ = np.linalg.qr(rng.standard_normal(D.shape))
        A = Qo.T @ D @ Qo
        T, Z, vals = dt.ordered_schur_real(A, sort_function=arg_largest_real)
        assert np.abs(Z @ T @ Z.T - A).max() < 1e-11
        # wanted-first ordering by real part (pairs as units)
        starts, sizes = dt.real_schur_blocks(T)
        reps = np.array([vals[s].real for s in starts])
        assert np.all(np.diff(reps) < 1e-8), reps
        np.testing.assert_allclose(
            np.sort_complex(vals), np.sort_complex(np.linalg.eigvals(A)),
            atol=1e-9)

    def test_reorder_random_matches_scipy_path(self, monkeypatch):
        import arnoldi_jax.ops.dense_tier as dt
        from arnoldi_jax.utils.sorting import arg_largest_magnitude

        rng = np.random.default_rng(6)
        for trial in range(8):
            n = int(rng.integers(4, 30))
            A = rng.standard_normal((n, n))
            Tn, Zn, vn = dt.ordered_schur_real(
                A, sort_function=arg_largest_magnitude)
            # force the scipy path for the golden
            monkeypatch.setattr(dt, "_native", lambda: None)
            Ts, Zs, vs = dt.ordered_schur_real(
                A, sort_function=arg_largest_magnitude)
            monkeypatch.undo()
            np.testing.assert_allclose(np.abs(vn), np.abs(vs), atol=1e-9)
            assert np.abs(Zn @ Tn @ Zn.T - A).max() < 1e-11

    def test_degenerate_swap_rejected_native(self):
        # Two IDENTICAL complex pairs: the direct-swap Sylvester system is
        # singular and the rehearsed similarity cannot zero the sub-block.
        # The native tier must refuse (rc=1 -> RuntimeError) instead of
        # committing a corrupted T; the driver then falls back to LAPACK.
        from arnoldi_jax.native import dense_tier as nat
        import pytest

        if not nat.available():
            pytest.skip("native tier not built")

        def rot(a, b):
            return np.array([[a, b], [-b, a]])

        T = np.zeros((4, 4))
        T[:2, :2] = rot(1.0, 0.5)
        T[2:, 2:] = rot(1.0, 0.5)
        T[:2, 2:] = np.array([[1.0, 2.0], [3.0, 4.0]])
        with pytest.raises(RuntimeError, match="reorder_blocks_d"):
            nat.reorder_blocks_real(T, np.eye(4),
                                    np.array([1, 0], np.int32))
        # a well-separated swap of the same shape still goes through
        T2 = T.copy()
        T2[2:, 2:] = rot(-2.0, 0.3)
        Tn, Qn = nat.reorder_blocks_real(T2, np.eye(4),
                                         np.array([1, 0], np.int32))
        assert np.abs(Qn.T @ T2 @ Qn - Tn).max() < 1e-12

    def test_degenerate_pairs_full_driver(self):
        # ordered_schur_real on a matrix with a DOUBLE complex pair stays
        # a valid Schur form (similarity + orthogonality exact); the
        # eigenvalue split ~sqrt(eps) is the problem's own sensitivity.
        import arnoldi_jax.ops.dense_tier as dt
        from arnoldi_jax.utils.sorting import arg_largest_real

        def rot(a, b):
            return np.array([[a, b], [-b, a]])

        rng = np.random.default_rng(0)
        T0 = np.zeros((6, 6))
        T0[:2, :2] = rot(1.0, 0.5)
        T0[2:4, 2:4] = rot(-2.0, 0.3)
        T0[4:, 4:] = rot(1.0, 0.5)
        T0[:2, 2:] = rng.standard_normal((2, 4))
        T0[2:4, 4:] = rng.standard_normal((2, 2))
        Q0, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        A = Q0 @ T0 @ Q0.T
        T, Z, vals = dt.ordered_schur_real(A, sort_function=arg_largest_real)
        assert np.abs(Z.T @ A @ Z - T).max() < 1e-12
        assert np.abs(Z.T @ Z - np.eye(6)).max() < 1e-13
        # ordering: the double 1.0-pair leads, the -2 pair trails
        assert np.real(vals)[:4].min() > 0.9 and np.real(vals)[-1] < 0


class TestNativeRobustness:
    """Regressions from the native-tier review: dtype promotion, partial
    orders, and overflow in the triangular back-substitution."""

    def test_integer_input_promotes(self):
        # int64 in, float64 out — casting BACK to int returned a truncated
        # non-triangular "Schur factor" with wrong eigenvalues.
        import arnoldi_jax.ops.dense_tier as dt

        A = np.array([[0, 1, 0], [0, 0, 1], [5, 1, 2]])
        T, Q = dt.schur_real(A)
        assert np.issubdtype(T.dtype, np.floating)
        assert np.abs(Q @ T @ Q.T - A).max() < 1e-12
        np.testing.assert_allclose(
            np.sort(np.linalg.eigvals(T.astype(complex)).real),
            np.sort(np.linalg.eigvals(A.astype(float)).real), atol=1e-10)

    def test_topk_sort_order_safe(self):
        # A top-k (partial) sort order must route to the incremental
        # Python path — the native loop reads order[t] for every t < n
        # (heap over-read / UB before the length gate).
        import arnoldi_jax.ops.dense_tier as dt

        rng = np.random.default_rng(5)
        A = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
        T, Z = dt.ordered_schur(
            A, sort_function=lambda x: np.argsort(-np.abs(x))[:4])
        assert np.abs(Z @ T @ Z.conj().T - A).max() < 1e-12
        # leading 4 are the largest-magnitude eigenvalues
        d = np.abs(np.diag(T))
        assert d[:4].min() >= np.sort(np.abs(np.linalg.eigvals(A)))[-4] - 1e-9

    def test_defective_chain_eigvecs_finite(self):
        # Jordan-like chains multiply the back-substitution column by
        # ~1/(eps*scale) per level; without LAPACK-style rescaling the
        # column overflows and normalizes to NaN.
        from arnoldi_jax.native import dense_tier as nat
        import pytest

        if not nat.available():
            pytest.skip("native tier not built")
        J = np.diag(np.full(30, 2.0 + 0j)) + np.diag(np.ones(29), 1)
        vals, vecs = nat.eig(J)
        assert np.all(np.isfinite(vecs))
        S = nat.triangular_eigvecs(np.triu(np.ones((30, 30), complex)))
        assert np.all(np.isfinite(S))
        # unit columns
        np.testing.assert_allclose(np.linalg.norm(S, axis=0), 1.0,
                                   atol=1e-12)
