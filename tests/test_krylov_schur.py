"""Krylov-Schur driver tests: residual gates on Markov/projected-diagonal
matrices (reference ``tests/test_krylov_schur.py``), ARPACK eigenvalue
cross-validation, happy-breakdown support, and eigen post-processing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from arnoldi_jax import partial_schur
from arnoldi_jax.solvers.krylov_schur import eigenpairs_from_partial_schur
from arnoldi_jax.matrices import laplace, mark
from arnoldi_jax.utils.sorting import arg_largest_magnitude, arg_largest_real

from common import find_best_matching

norm = np.linalg.norm


def schur_residuals(A, Q, T):
    A = A.todense() if hasattr(A, "todense") else np.asarray(A)
    Q = np.asarray(Q)
    T = np.asarray(T)
    return norm(A @ Q - Q @ T, axis=1)


class TestPartialSchur:
    def test_mark10(self):
        A = mark(10)
        Q, T, history = partial_schur(
            A, 3, max_dim=5, sort_function=arg_largest_real,
            max_restarts=1000, key=jax.random.key(42),
        )
        np.testing.assert_allclose(
            schur_residuals(A, Q, T), 0, rtol=1e-4, atol=1e-8
        )
        assert history.total_matvecs > 0
        assert len(history.residual_trace) >= 1

    def test_simple_diagonal(self):
        rng = np.random.default_rng(5)
        D = np.diag([7, 7, 5, 4, 3, 2, 1]).astype(float)
        n = D.shape[0]
        M = rng.standard_normal((n, n))
        Qo, _ = np.linalg.qr(M)
        A = Qo.T @ D @ Qo

        Q, T, _ = partial_schur(
            A, 3, max_dim=n - 1, sort_function=arg_largest_real,
            max_restarts=1000, key=jax.random.key(1),
        )
        np.testing.assert_allclose(
            schur_residuals(A, Q, T), 0, rtol=1e-4, atol=1e-8
        )
        # The computed values must be true eigenvalues of A (a single-vector
        # Krylov space sees only one copy of the degenerate 7).
        got = np.sort(np.real(np.diag(np.asarray(T))))[::-1]
        for v in got:
            assert np.min(np.abs(np.diag(D) - v)) < 1e-6

    @pytest.mark.parametrize("which,sort_function", [
        ("LM", arg_largest_magnitude),
        ("LR", arg_largest_real),
    ])
    def test_matches_arpack(self, which, sort_function):
        A = mark(12)
        k = 4
        tol = 1e-9
        r_vals = sp.linalg.eigs(A, k, which=which)[0]

        Q, T, _ = partial_schur(
            A, k, stopping_criterion=tol, sort_function=sort_function,
            max_restarts=500, key=jax.random.key(3),
        )
        vals = np.linalg.eigvals(np.asarray(T))
        vals, r_vals = find_best_matching(vals, r_vals)
        np.testing.assert_allclose(vals, r_vals, rtol=1e-6, atol=1e-8)

    def test_schur_form_is_ordered_triangular(self):
        A = mark(10)
        Q, T, _ = partial_schur(
            A, 3, sort_function=arg_largest_real, max_restarts=500,
            key=jax.random.key(7),
        )
        T = np.asarray(T)
        np.testing.assert_allclose(T, np.triu(T), atol=1e-12)
        # Q orthonormal
        Qh = np.asarray(Q)
        np.testing.assert_allclose(
            Qh.conj().T @ Qh, np.eye(3), rtol=1e-8, atol=1e-8
        )

    def test_happy_breakdown_supported(self):
        # Start vector spanning an invariant subspace of dimension 4:
        # the reference raises here; we converge with exact residuals.
        D = np.diag(np.arange(1.0, 11.0))
        v0 = np.zeros(10)
        v0[:4] = [1, 1, 1, 1]

        Q, T, _ = partial_schur(
            D, 2, max_dim=8, sort_function=arg_largest_real,
            max_restarts=10, v0=v0,
        )
        np.testing.assert_allclose(
            schur_residuals(D, Q, T), 0, rtol=1e-6, atol=1e-7
        )
        # largest-real eigenvalues within the invariant subspace {1..4}
        np.testing.assert_allclose(
            np.sort(np.real(np.diag(np.asarray(T)))), [3, 4], atol=1e-7
        )

    def test_non_convergence_raises(self):
        A = mark(10)
        with pytest.raises(ValueError, match="Has not converged"):
            partial_schur(
                A, 3, max_dim=5, stopping_criterion=1e-14, max_restarts=2,
                key=jax.random.key(0),
            )

    def test_eigenpairs_postprocessing(self):
        A = mark(10)
        k = 3
        Q, T, _ = partial_schur(
            A, k, sort_function=arg_largest_real, max_restarts=500,
            key=jax.random.key(9),
        )
        vals, vecs = eigenpairs_from_partial_schur(Q, T)
        vecs = np.asarray(vecs)
        res = norm(A @ vecs - vals * vecs, axis=0)
        np.testing.assert_allclose(res, 0, rtol=1e-4, atol=1e-7)

    def test_float32_path(self):
        # The float32 path: complex64 basis with CGS2, relaxed tolerance.
        A = mark(10).astype(np.float32)
        Q, T, _ = partial_schur(
            A, 2, stopping_criterion=1e-4, sort_function=arg_largest_real,
            max_restarts=500, ortho="cgs2", dtype=np.complex64,
            key=jax.random.key(11),
        )
        assert np.asarray(Q).dtype == np.complex64
        res = schur_residuals(A.todense(), Q, T)
        np.testing.assert_allclose(res, 0, atol=5e-4)

    def test_laplace_largest(self):
        A = laplace(200)
        from arnoldi_jax.matrices import laplace_eigen

        Q, T, _ = partial_schur(
            A, 4, sort_function=arg_largest_real, max_restarts=2000,
            stopping_criterion=1e-9, key=jax.random.key(13),
        )
        vals = np.sort(np.real(np.diag(np.asarray(T))))[::-1]
        want = np.sort(laplace_eigen(200))[::-1][:4]
        np.testing.assert_allclose(vals, want, rtol=1e-6, atol=1e-7)


class TestHardLocking:
    def test_hard_matches_soft_on_separated_spectrum(self):
        """lock='hard' freezes converged pairs out of the rotation; on a
        well-separated-modulus spectrum it must agree with soft locking
        and return a globally sorted T (the exit reorder)."""
        import scipy.sparse as sp

        from arnoldi_jax.utils.sorting import sort_function_for

        n = 3000
        d = np.linspace(0.1, 1.0, n) ** 2
        off = 0.01 * np.ones(n - 1)
        A = sp.diags_array([off, d, -off], offsets=[-1, 0, 1]).tocsr()
        out = {}
        for lock in ("soft", "hard"):
            Q, T, h = partial_schur(
                A, 12, max_dim=40, stopping_criterion=1e-9,
                sort_function=sort_function_for("LM"), max_restarts=5000,
                key=jax.random.key(0), lock=lock)
            vals, vecs = eigenpairs_from_partial_schur(Q, T)
            vecs = np.asarray(vecs)
            res = np.linalg.norm(A @ vecs - vals * vecs, axis=0) / np.abs(vals)
            assert res.max() < 1e-8, (lock, res.max())
            assert np.all(np.diff(np.abs(vals)) <= 1e-12), (
                f"{lock}: output not sorted by |lambda|")
            out[lock] = np.sort_complex(vals)
        np.testing.assert_allclose(out["hard"], out["soft"], rtol=1e-8,
                                   atol=1e-10)

    def test_lock_validation(self):
        A = mark(10)
        with pytest.raises(ValueError, match="lock="):
            partial_schur(A, 2, lock="extra-firm")
