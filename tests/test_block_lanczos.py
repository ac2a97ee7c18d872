"""Block thick-restart Lanczos tests: degenerate-multiplicity recovery (the
capability single-vector Krylov provably lacks), block-CGS2/CholQR2 kernel
properties, and agreement with the scalar driver on simple spectra."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arnoldi_jax import partial_eigh
from arnoldi_jax.matrices import laplace, laplace_2d, laplace_2d_eigen, laplace_eigen
from arnoldi_jax.ops.ortho import block_cgs2

norm = np.linalg.norm


class TestBlockCGS2:
    def setup_method(self, method):
        rng = np.random.default_rng(3)
        self.n, self.mp, self.j, self.b = 400, 24, 10, 4
        Vt = np.zeros((self.mp, self.n))
        Vt[: self.j] = np.linalg.qr(rng.standard_normal((self.n, self.j)))[0].T
        self.Vt = jnp.asarray(Vt)
        self.W = jnp.asarray(rng.standard_normal((self.b, self.n)))

    def test_block_orthogonalization(self):
        C, Q, R, bd = block_cgs2(self.Vt, self.W, self.j, tol=1e-12)
        Qh = np.asarray(Q)
        # Q orthonormal rows
        np.testing.assert_allclose(Qh @ Qh.T, np.eye(self.b), atol=1e-12)
        # Q orthogonal to the active basis
        np.testing.assert_allclose(np.asarray(self.Vt)[: self.j] @ Qh.T, 0,
                                   atol=1e-12)
        # reconstruction: W = C^T Vt + R^T Q  (rows convention)
        recon = (np.asarray(C).T @ np.asarray(self.Vt)
                 + np.asarray(R).T @ Qh)
        np.testing.assert_allclose(recon, np.asarray(self.W), atol=1e-10)
        # R upper triangular
        np.testing.assert_allclose(np.asarray(R), np.triu(np.asarray(R)),
                                   atol=1e-12)
        assert not bool(bd)

    def test_rank_deficient_block_flags_breakdown(self):
        W = jnp.asarray(np.vstack([np.asarray(self.W[:1])] * self.b))
        C, Q, R, bd = block_cgs2(self.Vt, W, self.j, tol=1e-8)
        assert bool(bd)
        assert np.all(np.isfinite(np.asarray(Q)))  # regularized, no NaNs


class TestBlockPartialEigh:
    def test_degenerate_multiplicity_recovered(self):
        # Square-grid Laplacian: eigenvalues come in symmetric pairs that a
        # single-vector Krylov space cannot separate.
        A = laplace_2d(16)
        want = np.sort(laplace_2d_eigen(16))[:6]
        vals, vecs, h = partial_eigh(
            A, 6, which="SA", stopping_criterion=1e-9, max_restarts=3000,
            block_size=4, key=jax.random.key(0),
        )
        np.testing.assert_allclose(np.sort(vals), want, rtol=1e-8, atol=1e-8)
        vecs = np.asarray(vecs)
        res = norm(A @ vecs - vals * vecs, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-7)
        np.testing.assert_allclose(vecs.T @ vecs, np.eye(6), atol=1e-8)

    @pytest.mark.parametrize("b", [2, 3, 4])
    def test_matches_scalar_driver(self, b):
        A = laplace(150)
        want = np.sort(laplace_eigen(150))[::-1][:4]
        vals, vecs, _ = partial_eigh(
            A, 4, which="LA", stopping_criterion=1e-9, max_restarts=3000,
            block_size=b, key=jax.random.key(1),
        )
        np.testing.assert_allclose(np.sort(vals)[::-1], want, rtol=1e-7,
                                   atol=1e-8)

    def test_float32_block(self):
        A = laplace_2d(16).astype(np.float32)
        want = np.sort(laplace_2d_eigen(16))[:4]
        vals, vecs, _ = partial_eigh(
            A, 4, which="SA", stopping_criterion=3e-4, max_restarts=3000,
            block_size=4, dtype=np.float32, key=jax.random.key(2),
        )
        assert np.asarray(vecs).dtype == np.float32
        np.testing.assert_allclose(np.sort(vals), want, atol=5e-3)

    def test_eigsh_block_size(self):
        from arnoldi_jax import eigsh

        A = laplace_2d(12)
        want = np.sort(laplace_2d_eigen(12))[:4]
        vals, vecs = eigsh(A, 4, which="SA", tol=1e-9, block_size=2,
                           maxiter=3000, key=jax.random.key(3))
        np.testing.assert_allclose(np.sort(vals), want, rtol=1e-8, atol=1e-8)

    def test_sharded_block(self):
        from arnoldi_jax.parallel import make_mesh

        mesh = make_mesh(8)
        A = laplace_2d(16)  # n = 256
        vals, vecs, _ = partial_eigh(
            A, 4, which="SA", stopping_criterion=1e-9, max_restarts=3000,
            block_size=4, mesh=mesh, key=jax.random.key(4),
        )
        want = np.sort(laplace_2d_eigen(16))[:4]
        np.testing.assert_allclose(np.sort(vals), want, rtol=1e-8, atol=1e-8)


class TestBlockKrylovSchur:
    def test_degenerate_nonhermitian(self):
        # Non-Hermitian driver with a double eigenvalue: block_size=2
        # recovers both copies (the scalar driver sees only one).
        rng = np.random.default_rng(5)
        d = np.concatenate([[7.0, 7.0, 5.0], np.linspace(4, 0.1, 37)])
        n = len(d)
        Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = Qo.T @ np.diag(d) @ Qo

        from arnoldi_jax import partial_schur

        Q, T, h = partial_schur(
            A, 3, max_dim=20, sort_function="LR", max_restarts=1000,
            block_size=2, key=jax.random.key(1),
        )
        Th, Qh = np.asarray(T), np.asarray(Q)
        got = np.sort(np.real(np.linalg.eigvals(Th)))[::-1]
        np.testing.assert_allclose(got, [7, 7, 5], rtol=1e-7, atol=1e-7)
        res = norm(A @ Qh - Qh @ Th, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-7)

    def test_mark_block_matches_arpack(self):
        import scipy.sparse.linalg as spla
        from scipy.optimize import linear_sum_assignment

        from arnoldi_jax import partial_schur
        from arnoldi_jax.matrices import mark

        A = mark(10)
        Q, T, _ = partial_schur(
            A, 4, max_dim=16, sort_function="LM", max_restarts=2000,
            block_size=2, key=jax.random.key(3),
        )
        Qh, Th = np.asarray(Q), np.asarray(T)
        res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-7)
        rv = spla.eigs(A, Qh.shape[1], which="LM", maxiter=5000)[0]
        v = np.linalg.eigvals(Th)
        cost = np.abs(np.sort_complex(v)[:, None] - np.sort_complex(rv)[None, :])
        ri, ci = linear_sum_assignment(cost)
        assert np.abs(np.sort_complex(v)[ri] - np.sort_complex(rv)[ci]).max() < 1e-6

    def test_saturation_raises_not_garbage(self):
        # Tiny space where the block expansion saturates: must raise an
        # informative error, never return unconverged values silently.
        rng = np.random.default_rng(5)
        D = np.diag([7, 7, 5, 4, 3, 2, 1]).astype(float)
        n = D.shape[0]
        Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = Qo.T @ D @ Qo

        from arnoldi_jax import partial_schur

        with pytest.raises(ValueError, match="saturated|Has not converged"):
            partial_schur(A, 3, max_dim=6, sort_function="LR",
                          max_restarts=1000, block_size=2,
                          key=jax.random.key(1))
