"""Thick-restart Lanczos (partial_eigh) tests: analytic Laplacian spectra,
ARPACK (eigsh) cross-validation, selective-orthogonalization kernel, f32,
and sharded execution."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.linalg import eigsh

from arnoldi_jax.matrices import laplace, laplace_2d, laplace_2d_eigen, laplace_eigen
from arnoldi_jax.solvers.lanczos import partial_eigh

norm = np.linalg.norm


def check(A, nev, which, tol=1e-9, **kw):
    vals, vecs, hist = partial_eigh(
        A, nev, which=which, stopping_criterion=tol, max_restarts=5000,
        key=jax.random.key(3), **kw,
    )
    vecs = np.asarray(vecs)
    Ad = A.todense() if sp.issparse(A) else np.asarray(A)
    res = norm(Ad @ vecs - vals * vecs, axis=0) / np.maximum(np.abs(vals), 1e-3)
    return vals, vecs, res, hist


class TestPartialEigh:
    @pytest.mark.parametrize("which", ["LA", "SA", "LM", "SM"])
    def test_laplace_all_modes(self, which):
        A = laplace(120)
        vals, vecs, res, _ = check(A, 4, which)
        assert res.max() < 1e-7
        full = np.sort(laplace_eigen(120))
        want = {
            "LA": full[-4:],
            "SA": full[:4],
            "LM": full[np.argsort(np.abs(full))[-4:]],
            "SM": full[np.argsort(np.abs(full))[:4]],
        }[which]
        np.testing.assert_allclose(np.sort(vals), np.sort(want),
                                   rtol=1e-7, atol=1e-8)

    def test_laplace_2d_vs_eigsh(self):
        A = laplace_2d(16)  # n = 256
        vals, vecs, res, hist = check(A, 6, "LA", tol=1e-9)
        assert res.max() < 1e-7
        want = eigsh(A.astype(float), 6, which="LA")[0]
        np.testing.assert_allclose(np.sort(vals), np.sort(want),
                                   rtol=1e-8, atol=1e-8)
        # Analytic check too
        full = np.sort(laplace_2d_eigen(16))[-6:]
        np.testing.assert_allclose(np.sort(vals), full, rtol=1e-7, atol=1e-7)

    def test_orthonormal_eigenvectors(self):
        A = laplace_2d(12)
        vals, vecs, res, _ = check(A, 5, "SA")
        G = vecs.T @ vecs
        np.testing.assert_allclose(G, np.eye(5), atol=1e-7)

    def test_selective_ortho(self):
        A = laplace(200)
        vals, vecs, res, hist = check(A, 4, "LA", ortho="selective")
        assert res.max() < 1e-7
        full = np.sort(laplace_eigen(200))
        np.testing.assert_allclose(np.sort(vals), full[-4:], rtol=1e-7,
                                   atol=1e-8)

    def test_float32(self):
        # Rectangular grid: nondegenerate spectrum (a square grid's
        # degenerate pairs are invisible to a single-vector Krylov space
        # until rounding noise reseeds them).
        A = laplace_2d(16, 13).astype(np.float32)
        vals, vecs, res, _ = check(A, 4, "SA", tol=3e-4, dtype=np.float32,
                                   ortho="cgs_dgks")
        assert np.asarray(vecs).dtype == np.float32
        assert res.max() < 5e-3
        full = np.sort(laplace_2d_eigen(16, 13))[:4]
        np.testing.assert_allclose(np.sort(vals), full, rtol=1e-3)

    def test_real_dtype_stays_real_on_cpu(self):
        A = laplace(64)
        vals, vecs, _, _ = check(A, 3, "LA")
        assert not np.iscomplexobj(np.asarray(vecs))
        assert vals.dtype.kind == "f"

    def test_sharded(self):
        from arnoldi_jax.parallel import make_mesh

        mesh = make_mesh(8)
        A = laplace_2d(16)  # n = 256, divisible by 8
        vals, vecs, hist = partial_eigh(
            A, 4, which="LA", stopping_criterion=1e-9, max_restarts=5000,
            mesh=mesh, key=jax.random.key(3),
        )
        vecs_np = np.asarray(vecs)
        res = norm(A.todense() @ vecs_np - vals * vecs_np, axis=0)
        assert res.max() < 1e-7

    def test_nonconvergence_raises(self):
        A = laplace_2d(24)
        with pytest.raises(ValueError, match="Has not converged"):
            partial_eigh(A, 3, which="SA", stopping_criterion=1e-14,
                         max_dim=6, max_restarts=2)


class TestDeviceLoop:
    def test_matches_host_loop(self):
        A = laplace_2d(16, 13)
        kw = dict(which="SA", stopping_criterion=1e-9, max_restarts=3000,
                  key=jax.random.key(3))
        v1, _, h1 = partial_eigh(A, 4, device_loop=True, **kw)
        v2, _, h2 = partial_eigh(A, 4, device_loop=False, **kw)
        np.testing.assert_allclose(np.sort(v1), np.sort(v2), rtol=1e-9,
                                   atol=1e-10)
        assert len(h1.residual_trace) >= 1

    def test_breakdown_falls_back_to_host(self):
        # Start vector = exact eigenvector: the fixed-shape device loop
        # cannot handle the resulting breakdown and must fall back to the
        # host-orchestrated path, which converges via happy breakdown.
        A = laplace(64)
        dense = np.asarray(A.todense())
        w, U = np.linalg.eigh(dense)
        vals, vecs, h = partial_eigh(
            A.tocsr(), 1, which="LA", stopping_criterion=1e-9,
            max_restarts=100, v0=U[:, -1],
        )
        np.testing.assert_allclose(vals[0], w[-1], rtol=1e-10)

    def test_device_loop_nonconvergence_raises(self):
        A = laplace_2d(24)
        with pytest.raises(ValueError, match="Has not converged"):
            partial_eigh(A, 3, which="SA", stopping_criterion=1e-14,
                         max_dim=8, max_restarts=3, device_loop=True)
