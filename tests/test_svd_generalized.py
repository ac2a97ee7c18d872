"""Partial SVD (svds) and generalized eigenproblem (eigs/eigsh with M)
tests against dense LAPACK references."""

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp

from arnoldi_jax import eigs, svds
from arnoldi_jax.matrices import laplace


class TestSvds:
    def test_dense_rectangular(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((60, 40))
        U, s, Vh = svds(A, 5, tol=1e-10, maxiter=3000, key=jax.random.key(1))
        ref = np.linalg.svd(A, compute_uv=False)[:5]
        np.testing.assert_allclose(s[::-1], ref, rtol=1e-9)
        # shapes and the scipy (ascending) convention
        assert U.shape == (60, 5) and Vh.shape == (5, 40)
        assert np.all(np.diff(s) >= 0)
        # triplet consistency: A v = s u
        np.testing.assert_allclose(A @ Vh.conj().T, U * s, atol=1e-8)
        # orthonormality
        np.testing.assert_allclose(U.T @ U, np.eye(5), atol=1e-8)
        np.testing.assert_allclose(Vh @ Vh.conj().T, np.eye(5), atol=1e-8)

    def test_sparse_square(self):
        A = laplace(100).tocsr()
        s = svds(A, 3, return_singular_vectors=False, tol=1e-10,
                 maxiter=3000, key=jax.random.key(2))
        ref = np.sort(np.abs(np.linalg.eigvalsh(A.todense())))[-3:]
        np.testing.assert_allclose(np.asarray(s), ref, rtol=1e-8)

    def test_block_svds(self):
        rng = np.random.default_rng(3)
        A = rng.standard_normal((50, 30))
        _, s, _ = svds(A, 4, tol=1e-10, maxiter=3000, block_size=2,
                       key=jax.random.key(3))
        ref = np.linalg.svd(A, compute_uv=False)[:4]
        np.testing.assert_allclose(s[::-1], ref, rtol=1e-8)

    def test_wide_matrix_internal_transpose(self):
        # n_rows < n_cols: Lanczos must run on A A^H internally.
        rng = np.random.default_rng(4)
        A = rng.standard_normal((20, 35))
        U, s, Vh = svds(A, 4, tol=1e-10, maxiter=3000, key=jax.random.key(4))
        ref = np.linalg.svd(A, compute_uv=False)[:4]
        np.testing.assert_allclose(s[::-1], ref, rtol=1e-9)
        assert U.shape == (20, 4) and Vh.shape == (4, 35)
        np.testing.assert_allclose(A @ Vh.conj().T, U * s, atol=1e-8)
        np.testing.assert_allclose(Vh @ Vh.conj().T, np.eye(4), atol=1e-8)

    def test_smallest_singular_values(self):
        # which='SM' runs Lanczos for the smallest Gram eigenvalues.
        rng = np.random.default_rng(5)
        A = rng.standard_normal((40, 25)) + 3 * np.eye(40, 25)
        U, s, Vh = svds(A, 3, which="SM", tol=1e-10, maxiter=8000,
                        ncv=20, key=jax.random.key(5))
        ref = np.sort(np.linalg.svd(A, compute_uv=False))[:3]
        np.testing.assert_allclose(np.sort(s), ref, rtol=1e-7)
        np.testing.assert_allclose(A @ Vh.conj().T, U * s, atol=1e-7)

    def test_bsr_adjoint_matvec(self):
        # svds over an explicitly-BSR operator (the default format for
        # dense-tile scattered sparsity) exercises the block scatter-add
        # adjoint.
        from arnoldi_jax.linop import BsrOperator
        from arnoldi_jax.solvers.svd import _rmatvec

        rng = np.random.default_rng(6)
        S = sp.random(48, 30, density=0.2, random_state=np.random.RandomState(6)).tocsr()
        op = BsrOperator.from_scipy(S, blocksize=(8, 8))
        y = rng.standard_normal(48)
        np.testing.assert_allclose(np.asarray(_rmatvec(op, y)),
                                   S.T @ y, atol=1e-12)
        U, s, Vh = svds(op, 3, tol=1e-10, maxiter=3000, key=jax.random.key(6))
        ref = np.linalg.svd(S.todense(), compute_uv=False)[:3]
        np.testing.assert_allclose(s[::-1], ref, rtol=1e-8)

    def test_f32_dw_refinement_engages(self):
        # svds on the f32 work dtype with tol below the f32 floor: the
        # Gram CallableOperator must carry fn_dw (composed dw matvecs of
        # A and a materialized A^H) so partial_eigh's dw refinement
        # engages — without it the solver ground at an unreachable target
        # and returned unconverged triplets silently.
        rng = np.random.default_rng(9)
        A = rng.standard_normal((80, 50))
        U, s, Vh = svds(A, 4, tol=1e-9, dtype=np.float32, maxiter=3000,
                        key=jax.random.key(4))
        ref = np.linalg.svd(A, compute_uv=False)[:4]
        np.testing.assert_allclose(s[::-1], ref, rtol=1e-7)
        np.testing.assert_allclose(A @ Vh.conj().T, U * s, atol=2e-6)

    def test_f32_dw_refinement_sparse_wide(self):
        import scipy.sparse as sp

        rng = np.random.default_rng(10)
        A = sp.random(40, 90, density=0.2, random_state=3, format="csr")
        _, s, _ = svds(A, 3, tol=1e-9, dtype=np.float32, maxiter=3000,
                       key=jax.random.key(5))
        ref = np.linalg.svd(A.todense(), compute_uv=False)[:3]
        np.testing.assert_allclose(np.asarray(s)[::-1], np.asarray(ref),
                                   rtol=1e-6)

    def test_bad_which_raises(self):
        rng = np.random.default_rng(4)
        with pytest.raises(ValueError, match="which"):
            svds(rng.standard_normal((20, 20)), 2, which="XX")


class TestGeneralized:
    def test_largest_real(self):
        n = 80
        A = laplace(n).tocsr()
        B = sp.diags_array(np.linspace(1, 2, n)).tocsr()
        vals, vecs = eigs(A, 3, which="LR", M=B, tol=1e-9, maxiter=5000,
                          key=jax.random.key(0))
        ref = np.sort(sla.eigh(A.todense(), B.todense(),
                               eigvals_only=True))[::-1][:3]
        np.testing.assert_allclose(np.sort(np.real(vals))[::-1], ref,
                                   rtol=1e-7, atol=1e-9)
        # generalized residual: A v = lambda B v
        res = np.linalg.norm(A @ vecs - (B @ vecs) * vals, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-6)

    def test_shift_invert_generalized(self):
        n = 60
        A = laplace(n).tocsr()
        B = sp.diags_array(np.linspace(0.5, 1.5, n)).tocsr()
        sigma = -1.0
        vals, vecs = eigs(A, 3, sigma=sigma, M=B, tol=1e-9, maxiter=5000,
                          key=jax.random.key(5))
        full = np.sort(sla.eigh(A.todense(), B.todense(), eigvals_only=True))
        want = full[np.argsort(np.abs(full - sigma))[:3]]
        got = np.sort(np.real(vals))
        np.testing.assert_allclose(np.sort(got), np.sort(want), rtol=1e-7,
                                   atol=1e-8)

    def test_eigsh_generalized_la_sa(self):
        """eigsh(M=) — scipy's symmetric-definite pencil surface."""
        from arnoldi_jax import eigsh

        n = 80
        A = laplace(n).tocsr()
        B = sp.diags_array(np.linspace(1, 2, n)).tocsr()
        full = np.sort(sla.eigh(A.todense(), B.todense(), eigvals_only=True))
        for which, want in (("LA", full[-3:]), ("SA", full[:3])):
            vals, vecs = eigsh(A, 3, which=which, M=B, tol=1e-9,
                               maxiter=5000, key=jax.random.key(2))
            assert not np.iscomplexobj(vals) and not np.iscomplexobj(vecs)
            np.testing.assert_allclose(vals, want, rtol=1e-7, atol=1e-9)
            assert np.all(np.diff(vals) >= 0), "scipy ascending contract"
            # pencil residual + M-orthonormality (scipy contract)
            res = np.linalg.norm(A @ vecs - (B @ vecs) * vals, axis=0)
            np.testing.assert_allclose(res, 0, atol=1e-6)
            np.testing.assert_allclose(vecs.T @ (B @ vecs), np.eye(3),
                                       atol=1e-6)

    def test_eigsh_generalized_shift_invert(self):
        from arnoldi_jax import eigsh

        n = 60
        A = laplace(n).tocsr()
        B = sp.diags_array(np.linspace(0.5, 1.5, n)).tocsr()
        sigma = -1.0
        vals, vecs = eigsh(A, 3, sigma=sigma, M=B, tol=1e-9, maxiter=5000,
                           key=jax.random.key(7))
        full = np.sort(sla.eigh(A.todense(), B.todense(), eigvals_only=True))
        want = np.sort(full[np.argsort(np.abs(full - sigma))[:3]])
        np.testing.assert_allclose(vals, want, rtol=1e-7, atol=1e-8)
        res = np.linalg.norm(A @ vecs - (B @ vecs) * vals, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-6)

    def test_eigsh_be_standard_and_generalized(self):
        """which='BE' — k//2 low + (k - k//2) high ends, ascending."""
        from arnoldi_jax import eigsh

        n = 80
        A = laplace(n).tocsr()
        full = np.sort(np.linalg.eigvalsh(A.todense()))
        vals, vecs = eigsh(A, 5, which="BE", tol=1e-9, maxiter=5000,
                           key=jax.random.key(3))
        want = np.sort(np.concatenate([full[:2], full[-3:]]))
        np.testing.assert_allclose(vals, want, rtol=1e-7, atol=1e-9)
        res = np.linalg.norm(A @ vecs - vecs * vals, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-6)

        B = sp.diags_array(np.linspace(1, 2, n)).tocsr()
        gfull = np.sort(sla.eigh(A.todense(), B.todense(),
                                 eigvals_only=True))
        gvals, gvecs = eigsh(A, 4, which="BE", M=B, tol=1e-9, maxiter=5000,
                             key=jax.random.key(4))
        gwant = np.sort(np.concatenate([gfull[:2], gfull[-2:]]))
        np.testing.assert_allclose(gvals, gwant, rtol=1e-7, atol=1e-9)

    def test_minv_opinv_explicit_inverses(self):
        """scipy's Minv/OPinv surface: user-supplied inverses replace the
        inner Krylov solves on both eigs and eigsh."""
        from scipy.sparse.linalg import splu

        from arnoldi_jax import eigsh
        from arnoldi_jax.linop import CallableOperator

        n = 60
        A = laplace(n).tocsr()
        d = np.linspace(1, 2, n)
        B = sp.diags_array(d).tocsr()
        full = np.sort(sla.eigh(A.todense(), B.todense(), eigvals_only=True))

        # Minv: diagonal M inverted exactly, no inner solver involved
        Minv = sp.diags_array(1.0 / d).tocsr()
        vals, vecs = eigsh(A, 3, which="SA", M=B, Minv=Minv, tol=1e-9,
                           maxiter=5000, key=jax.random.key(1))
        np.testing.assert_allclose(vals, full[:3], rtol=1e-7, atol=1e-9)

        # OPinv: host-factorized (A - sigma B)^{-1} reached through
        # pure_callback so the closure stays jittable inside the solver
        sigma = -1.0
        lu = splu((A - sigma * B).tocsc().astype(np.float64))

        def _host_opinv(mat_lu):
            def mv(x):
                return jax.pure_callback(
                    lambda b: mat_lu.solve(np.asarray(b, np.float64))
                    .astype(b.dtype),
                    jax.ShapeDtypeStruct((n,), x.dtype), x,
                    vmap_method="sequential")
            return mv

        opinv = CallableOperator(_host_opinv(lu), (n, n), np.float64,
                                 nnz=A.nnz)
        gvals, gvecs = eigsh(A, 3, sigma=sigma, M=B, OPinv=opinv, tol=1e-9,
                             maxiter=5000, key=jax.random.key(2))
        want = np.sort(full[np.argsort(np.abs(full - sigma))[:3]])
        np.testing.assert_allclose(gvals, want, rtol=1e-7, atol=1e-8)
        res = np.linalg.norm(A @ gvecs - (B @ gvecs) * gvals, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-6)

        # standard shift-invert via OPinv only (M=None), on eigs
        lu2 = splu((A - sigma * sp.eye_array(n)).tocsc().astype(np.float64))
        opinv2 = CallableOperator(_host_opinv(lu2), (n, n), np.float64,
                                  nnz=A.nnz)
        evals, _ = eigs(A, 3, sigma=sigma, OPinv=opinv2, tol=1e-9,
                        maxiter=5000, key=jax.random.key(3))
        sfull = np.sort(np.linalg.eigvalsh(A.todense()))
        swant = np.sort(sfull[np.argsort(np.abs(sfull - sigma))[:3]])
        np.testing.assert_allclose(np.sort(np.real(evals)), swant,
                                   rtol=1e-7, atol=1e-8)

        # scipy-mirroring validation errors
        with pytest.raises(ValueError, match="OPinv"):
            eigs(A, 2, OPinv=opinv2)
        with pytest.raises(ValueError, match="Minv"):
            eigs(A, 2, sigma=sigma, M=B, Minv=Minv)
        with pytest.raises(ValueError, match="Minv"):
            eigsh(A, 2, Minv=Minv)

    def test_eigsh_mode_guard(self):
        # buckling/cayley are IMPLEMENTED (TestSpectralModes); only an
        # unknown mode string rejects now.
        from arnoldi_jax import eigsh

        A = laplace(20).tocsr()
        B = sp.eye_array(20).tocsr()
        with pytest.raises(ValueError, match="expected 'normal'"):
            eigsh(A, 2, M=B, sigma=1.0, mode="shift-and-pray")
        with pytest.raises(ValueError, match="not supported with M"):
            eigsh(A, 2, M=B, which="XX")


class TestReviewRegressions:
    """Regressions for the round-1 code-review findings."""

    def test_rectangular_sparse_svds(self):
        # EllOperator used to report rectangular matrices as square,
        # corrupting the Gram problem.
        A = sp.random(24, 12, density=0.4,
                      random_state=np.random.RandomState(1)).tocsr()
        U, s, Vh = svds(A, 3, tol=1e-10, maxiter=3000, key=jax.random.key(0))
        ref = np.linalg.svd(A.todense(), compute_uv=False)[:3]
        np.testing.assert_allclose(s[::-1], ref, rtol=1e-8)
        assert U.shape == (24, 3) and Vh.shape == (3, 12)

    def test_shift_invert_trim_keeps_nearest_sigma(self):
        # The k-trim used to re-sort by |lambda|, evicting the eigenvalue
        # nearest sigma when a conjugate pair straddled k.
        rng = np.random.default_rng(3)
        D = sla.block_diag(np.diag([0.05, 2.0, 3.0, 4.0, 5.0]),
                           np.array([[0.1, -0.1], [0.1, 0.1]]))
        Qo, _ = np.linalg.qr(rng.standard_normal(D.shape))
        A = Qo.T @ D @ Qo
        vals, _ = eigs(A, 2, sigma=0.0, tol=1e-9, maxiter=3000,
                       key=jax.random.key(1))
        assert np.min(np.abs(vals - 0.05)) < 1e-6, (
            "nearest-sigma eigenvalue 0.05 must survive the k-trim"
        )

    def test_eigsh_scipy_contracts(self):
        from arnoldi_jax import eigsh
        from arnoldi_jax.matrices import laplace_eigen

        A = laplace(64).tocsr()
        v, vecs = eigsh(A, 4, which="LA", tol=1e-9, maxiter=3000)
        # ascending order like scipy, values correct
        assert np.all(np.diff(v) >= 0)
        np.testing.assert_allclose(v, np.sort(laplace_eigen(64))[-4:],
                                   rtol=1e-8)

    def test_complex_sigma_accepted(self):
        rng = np.random.default_rng(7)
        A = (rng.standard_normal((30, 30))
             + 1j * rng.standard_normal((30, 30)))
        ref = np.linalg.eigvals(A)
        sigma = ref[5] + 0.01 + 0.01j  # near an eigenvalue, complex shift
        vals, _ = eigs(A, 1, sigma=sigma, tol=1e-9, maxiter=3000,
                       key=jax.random.key(2))
        assert np.min(np.abs(ref - vals[0])) < 1e-6


class TestRealified:
    """Complex eigenproblems in pure real arithmetic (the realified route)."""

    def test_dense_complex_matches_arpack(self):
        rng = np.random.default_rng(0)
        n = 60
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        from arnoldi_jax import eigs_realified

        vals, vecs = eigs_realified(A, 4, which="LM", tol=1e-9,
                                    maxiter=5000, key=jax.random.key(0))
        ref = np.linalg.eigvals(A)
        ref = ref[np.argsort(-np.abs(ref))][:4]
        np.testing.assert_allclose(np.sort_complex(vals),
                                   np.sort_complex(ref), rtol=1e-7,
                                   atol=1e-8)
        res = np.linalg.norm(A @ vecs - vals * vecs, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-7)

    def test_sparse_complex(self):
        import scipy.sparse.linalg as spla

        S = (sp.random(200, 200, density=0.05,
                       random_state=np.random.RandomState(1))
             + 1j * sp.random(200, 200, density=0.05,
                              random_state=np.random.RandomState(2))
             + sp.diags_array(np.ones(200))).tocsr()
        from arnoldi_jax import eigs_realified

        vals, vecs = eigs_realified(S, 3, which="LM", tol=1e-9,
                                    maxiter=5000, key=jax.random.key(1))
        rv = spla.eigs(S, 3, which="LM")[0]
        np.testing.assert_allclose(np.sort_complex(vals),
                                   np.sort_complex(rv), rtol=1e-6, atol=1e-8)
        res = np.linalg.norm(S @ vecs - vals * vecs, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-7)

    def test_realify_rejects_real(self):
        from arnoldi_jax import realify_operator

        with pytest.raises(TypeError):
            realify_operator(np.eye(5))

    def test_eigsh_sigma_which_la_scipy_semantics(self):
        import scipy.sparse.linalg as spla

        from arnoldi_jax import eigsh

        A = sp.diags_array(np.array([1.0, 2, 3, 4, 7, 9, 11])).tocsr()
        ours = eigsh(A, 2, sigma=5.0, which="LA", tol=1e-10, maxiter=2000)[0]
        ref = spla.eigsh(A.astype(float), 2, sigma=5.0, which="LA")[0]
        np.testing.assert_allclose(np.sort(ours), np.sort(ref), rtol=1e-8)

    def test_realified_li_raises(self):
        from arnoldi_jax import eigs_realified

        rng = np.random.default_rng(1)
        A = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
        with pytest.raises(NotImplementedError, match="conjugation"):
            eigs_realified(A, 2, which="LI")

    def test_realified_multiplicity_and_ncv(self):
        from arnoldi_jax import eigs_realified

        rng = np.random.default_rng(1)
        Z = np.diag([3 + 2j, 3 + 2j, 1 - 1j, 0.5 + 0.1j, -2 + 0j,
                     0.3 - 0.4j])
        Qc, _ = np.linalg.qr(rng.standard_normal((6, 6))
                             + 1j * rng.standard_normal((6, 6)))
        A = Qc @ Z @ Qc.conj().T
        vals, vecs = eigs_realified(A, 2, which="LM", tol=1e-10,
                                    maxiter=3000, key=jax.random.key(0))
        np.testing.assert_allclose(np.sort_complex(vals),
                                   [3 + 2j, 3 + 2j], rtol=1e-8)
        # scipy-legal ncv forwards without assertion crashes
        B = rng.standard_normal((20, 20)) + 1j * rng.standard_normal((20, 20))
        v = eigs_realified(B, 6, which="LM", ncv=10, tol=1e-8, maxiter=3000,
                           return_eigenvectors=False)
        assert len(v) == 6


class TestSpectralModes:
    """ARPACK generalized transforms (scipy eigsh mode=) and svds sigma."""

    def _pencil(self, n=60):
        from arnoldi_jax.matrices import laplace

        A = (-laplace(n)).tocsr()          # SPD
        M = sp.diags_array(np.linspace(1, 2, n)).tocsr()
        return A, M

    @pytest.mark.parametrize("mode", ["buckling", "cayley"])
    def test_mode_matches_scipy(self, mode):
        import scipy.sparse.linalg as ssla

        from arnoldi_jax import eigsh

        A, M = self._pencil()
        sigma = 1.5
        ref_vals, _ = ssla.eigsh(A, 4, M=M, sigma=sigma, mode=mode,
                                 which="LM")
        vals, vecs = eigsh(A, 4, M=M, sigma=sigma, mode=mode, which="LM",
                           tol=1e-9, maxiter=5000, key=jax.random.key(1),
                           inner_solver="gmres")
        np.testing.assert_allclose(np.sort(vals), np.sort(ref_vals),
                                   atol=1e-9)
        r = np.linalg.norm(A @ vecs - (M @ vecs) * vals[None, :], axis=0)
        assert r.max() < 1e-8
        # B-normalization: B = A for buckling, M for cayley (ARPACK's
        # dsaupd mode-4/5 inner products)
        B = A if mode == "buckling" else M
        np.testing.assert_allclose(
            np.einsum("ij,ij->j", vecs, B @ vecs), 1.0, atol=1e-8)

    @pytest.mark.parametrize("mode", ["buckling", "cayley"])
    def test_mode_opinv_explicit(self, mode):
        from scipy.sparse.linalg import LinearOperator, splu

        from arnoldi_jax import eigsh

        A, M = self._pencil()
        sigma = 1.5
        lu = splu((A - sigma * M).tocsc())

        def _solve(b):
            if np.iscomplexobj(b):   # complex128 CPU work dtype
                return (lu.solve(b.real.astype(np.float64))
                        + 1j * lu.solve(b.imag.astype(np.float64)))
            return lu.solve(np.asarray(b, np.float64))

        OPinv = LinearOperator(A.shape, matvec=_solve, dtype=np.float64)
        vals, vecs = eigsh(A, 3, M=M, sigma=sigma, mode=mode, which="LM",
                           tol=1e-9, maxiter=5000, key=jax.random.key(2),
                           OPinv=OPinv)
        r = np.linalg.norm(A @ vecs - (M @ vecs) * vals[None, :], axis=0)
        assert r.max() < 1e-8

    def test_mode_validation(self):
        from arnoldi_jax import eigsh

        A, M = self._pencil(30)
        with pytest.raises(ValueError, match="requires sigma"):
            eigsh(A, 2, M=M, mode="buckling")
        with pytest.raises(ValueError, match="requires M"):
            eigsh(A, 2, sigma=1.0, mode="cayley")
        with pytest.raises(ValueError, match="expected 'normal'"):
            eigsh(A, 2, M=M, sigma=1.0, mode="bogus")

    def test_svds_sigma_interior(self):
        rng = np.random.default_rng(5)
        A = rng.standard_normal((120, 80))
        sv = np.linalg.svd(A, compute_uv=False)
        target = float(np.median(sv))
        U, s, Vh = svds(A, 4, sigma=target, tol=1e-10, maxiter=3000,
                        key=jax.random.key(0))
        want = np.sort(sv[np.argsort(np.abs(sv - target))[:4]])
        np.testing.assert_allclose(np.sort(s), want, atol=1e-8)
        np.testing.assert_allclose(A @ Vh.conj().T, U * s[None, :],
                                   atol=1e-7)

    def test_svds_sigma_linear_vs_squared_domain(self):
        # |s - sigma| and |s^2 - sigma^2| orderings disagree here: for
        # sigma=1, 1.45 is linear-nearest (0.45 < 0.5) but 0.5 is
        # squared-nearest (0.75 < 1.1025).  The buffered selection must
        # return the LINEAR-nearest value.
        sv = np.array([0.5, 1.45, 2.1, 3.0, 4.2, 5.5])
        rng = np.random.default_rng(11)
        U0, _ = np.linalg.qr(rng.standard_normal((10, 6)))
        V0, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        A = (U0 * sv[None, :]) @ V0.T
        s = svds(A, 1, sigma=1.0, tol=1e-10, maxiter=3000,
                 key=jax.random.key(0), return_singular_vectors=False)
        np.testing.assert_allclose(np.asarray(s), [1.45], atol=1e-8)

    def test_svds_sigma_zero_is_smallest(self):
        rng = np.random.default_rng(6)
        A = rng.standard_normal((90, 60))
        sv = np.sort(np.linalg.svd(A, compute_uv=False))
        s = svds(A, 3, sigma=0.0, tol=1e-10, maxiter=3000,
                 key=jax.random.key(0), return_singular_vectors=False)
        np.testing.assert_allclose(np.sort(np.asarray(s)), sv[:3],
                                   atol=1e-8)


class TestSortSelectors:
    def test_si_selector(self):
        from arnoldi_jax.utils.sorting import sort_function_for

        x = np.array([1 + 2j, 1 - 3j, 0.5 + 0j, -2 - 1j])
        np.testing.assert_array_equal(sort_function_for("SI")(x),
                                      [1, 3, 2, 0])
        np.testing.assert_array_equal(sort_function_for("LI")(x),
                                      [0, 2, 3, 1])

    def test_si_end_to_end(self):
        # eigs(which='SI') on a rotation-like matrix with known imaginary
        # structure: smallest imaginary part = most negative frequencies.
        from arnoldi_jax import eigs

        rng = np.random.default_rng(7)
        n = 40
        S = rng.standard_normal((n, n))
        A = S - S.T + 0.1 * np.eye(n)  # skew + shift: pure-imag pairs
        vals = eigs(np.asarray(A), 4, which="SI", tol=1e-9, maxiter=2000,
                    key=jax.random.key(3), return_eigenvectors=False)
        full = np.linalg.eigvals(A)
        want = np.sort(full[np.argsort(np.imag(full))[:4]].imag)
        np.testing.assert_allclose(np.sort(np.imag(vals)), want, atol=1e-7)
