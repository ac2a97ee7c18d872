"""Chebyshev-filtered interior eigensolver tests (solvers/filtered.py).

The capability the reference reaches only through shift-invert (ARPACK
sigma mode, scripts/compare-against-arpack.py flags) — here via polynomial
filtering, the no-factorization route; validated against the analytic
Laplacian spectra and the shift-invert driver itself.
"""

import jax
import numpy as np
import pytest

from arnoldi_jax import eigsh, eigsh_filtered, eigsh_window
from arnoldi_jax.matrices import laplace, laplace_2d, laplace_eigen
from arnoldi_jax.solvers.filtered import (
    cheby_filter,
    estimate_window_count,
    jackson_cheby_coeffs,
    spectrum_bounds,
)


class TestPieces:
    def test_spectrum_bounds_enclose(self):
        n = 150
        L = laplace(n).tocsr()
        lmin, lmax = spectrum_bounds(L, 40, dtype=np.float64)
        full = laplace_eigen(n)
        assert lmin <= full.min() and lmax >= full.max()
        # ... and not absurdly loose (within 20% of the spread).
        spread = full.max() - full.min()
        assert lmin >= full.min() - 0.2 * spread
        assert lmax <= full.max() + 0.2 * spread

    def test_jackson_indicator_shape(self):
        # The damped expansion approximates the indicator: near 1 inside,
        # near 0 far outside, monotone-ish transition, no Gibbs overshoot
        # beyond a few percent.
        a, b, lmin, lmax = -2.2, -1.8, -4.0, 0.0
        coeffs = jackson_cheby_coeffs(a, b, lmin, lmax, 200)
        x = np.linspace(lmin, lmax, 2001)
        t = (x - 0.5 * (lmax + lmin)) / (0.5 * (lmax - lmin))
        # evaluate sum c_j T_j(t) by recurrence (host)
        T0, T1 = np.ones_like(t), t
        y = coeffs[0] * T0 + coeffs[1] * T1
        for j in range(2, len(coeffs)):
            T0, T1 = T1, 2 * t * T1 - T0
            y += coeffs[j] * T1
        inside = (x > a + 0.1) & (x < b - 0.1)
        far = (x < a - 0.4) | (x > b + 0.4)
        assert y[inside].min() > 0.5
        assert np.abs(y[far]).max() < 0.05
        assert y.max() < 1.05 and y.min() > -0.05  # Jackson: no Gibbs

    def test_filter_matches_dense_polynomial(self):
        # p(A) X from the recurrence == eigen-decomposition evaluation.
        rng = np.random.default_rng(3)
        n = 60
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.linspace(-1.5, 3.5, n)
        A = (Q * lam) @ Q.T
        lmin, lmax = -2.0, 4.0
        coeffs = jackson_cheby_coeffs(0.5, 1.5, lmin, lmax, 80)
        X = rng.standard_normal((4, n))
        got = np.asarray(cheby_filter(
            __import__("arnoldi_jax").linop.as_operator(A, dtype=np.float64),
            np.asarray(X), coeffs, lmin, lmax))
        # dense evaluation through the eigenbasis
        t = (lam - 0.5 * (lmax + lmin)) / (0.5 * (lmax - lmin))
        T0, T1 = np.ones_like(t), t
        p = coeffs[0] * T0 + coeffs[1] * T1
        for j in range(2, len(coeffs)):
            T0, T1 = T1, 2 * t * T1 - T0
            p += coeffs[j] * T1
        want = X @ (Q * p) @ Q.T
        np.testing.assert_allclose(got, want, atol=1e-10)

    def test_ghost_gain_discriminator(self):
        # _filter_gains separates a true in-window Ritz pair (flat-top
        # filter gain ~1) from a ghost — a mixture of OUTSIDE
        # eigendirections whose Rayleigh quotient lands inside the window
        # (gain << 0.5).  This is the deterministic completeness gate the
        # all-inside mode relies on when a stalled pending pair must be
        # classified.
        from arnoldi_jax.linop import as_operator
        from arnoldi_jax.solvers.filtered import _filter_gains

        rng = np.random.default_rng(11)
        n = 80
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.linspace(-2.0, 2.0, n)
        A = (Q * lam) @ Q.T
        lmin, lmax = -2.1, 2.1
        a, b = -0.1, 0.1  # covers lam indices around the middle
        degree = 400
        delta = 2.5 * (lmax - lmin) / degree
        coeffs = jackson_cheby_coeffs(a - delta, b + delta, lmin, lmax,
                                      degree)
        op = as_operator(A, dtype=np.float64)
        true_idx = int(np.argmin(np.abs(lam)))  # in-window eigenvector
        lo = int(np.searchsorted(lam, a - 6 * delta))  # far below capture
        hi = int(np.searchsorted(lam, b + 6 * delta)) + 1  # far above
        w = (lam[hi] - 0.0) / (lam[hi] - lam[lo])  # quotient lands at 0
        ghost = np.sqrt(w) * Q[:, lo] + np.sqrt(1 - w) * Q[:, hi]
        rq = ghost @ A @ ghost
        assert a < rq < b  # the ghost's Rayleigh quotient IS in-window
        V = np.stack([Q[:, true_idx], ghost])
        gains = np.asarray(_filter_gains(op, V, coeffs, lmin, lmax))
        assert gains[0] > 0.9, gains
        assert gains[1] < 0.3, gains

    def test_moments_price_any_window(self):
        # One moment pass prices every window: a truncated count from a
        # high-degree moment vector matches the direct lower-degree count
        # (same probes/key => identical recurrence prefix), and counts
        # derived from one mu are accurate across disjoint windows.
        from arnoldi_jax.solvers.filtered import (
            count_from_moments,
            spectral_moments,
        )
        from arnoldi_jax.linop import as_operator

        n = 300
        op = as_operator(laplace(n).tocsr(), dtype=np.float64)
        bounds = (-4.05, 0.05)
        key = jax.random.key(9)
        mu800 = spectral_moments(op, 800, bounds=bounds, key=key)
        mu300 = spectral_moments(op, 300, bounds=bounds, key=key)
        np.testing.assert_allclose(mu300, mu800[:301], rtol=1e-10)
        full = laplace_eigen(n)
        for win in [(-2.5, -1.5), (-3.5, -3.0), (-1.0, -0.2)]:
            true = int(((full >= win[0]) & (full <= win[1])).sum())
            est = count_from_moments(mu800, win, bounds)
            assert abs(est - true) < 0.3 * true + 3, (win, est, true)
        # the truncation branch RE-DAMPS (degree-specific Jackson
        # coefficients), it does not just slice mu — drivers rely on it
        # for their sizing counts
        win = (-2.5, -1.5)
        tr = count_from_moments(mu800, win, bounds, degree=300)
        direct = count_from_moments(mu300, win, bounds)
        np.testing.assert_allclose(tr, direct, rtol=1e-10)
        assert abs(tr - count_from_moments(mu800, win, bounds)) > 1e-6

    def test_active_rows_buckets(self):
        # soft-locking row selection: unconverged rows first, padded with
        # DISTINCT converged rows onto the halving count ladder
        # {s, s/2, s/4, ..., >=32} (each distinct count is a fresh remote
        # degree-N compile — r05), None for all-active / first sweep,
        # empty for everything locked.
        from arnoldi_jax.solvers.filtered import _active_rows

        assert _active_rows(None, 1e-8, 100) is None  # first sweep
        res = np.full(100, 1.0)
        assert _active_rows(res, 1e-8, 100) is None   # nothing converged
        res = np.full(100, 1e-12)
        assert _active_rows(res, 1e-8, 100).size == 0  # all locked
        res = np.full(100, 1e-12)
        res[[3, 50, 97]] = 1.0
        idx = _active_rows(res, 1e-8, 100)
        assert idx.size == 32                          # ladder floor
        assert set([3, 50, 97]) <= set(idx.tolist())
        assert np.unique(idx).size == idx.size         # distinct pad rows
        # more than half active -> just run the full sweep (one shape)
        res = np.full(40, 1e-12)
        res[:39] = 1.0
        assert _active_rows(res, 1e-8, 40) is None
        res = np.full(40, 1e-12)
        res[:30] = 1.0
        assert _active_rows(res, 1e-8, 40) is None     # 30 of 40 -> full
        # ladder rungs: 60 of 504 active -> ceil(504/8)=63 -> 64 rows
        res = np.full(504, 1e-12)
        res[:60] = 1.0
        assert _active_rows(res, 1e-8, 504).size == 64

    def test_window_count_estimator(self):
        n = 300
        L = laplace(n).tocsr()
        full = laplace_eigen(n)
        a, b = -2.5, -1.5
        true = int(((full >= a) & (full <= b)).sum())
        est = estimate_window_count(L, (a, b), dtype=np.float64,
                                    key=jax.random.key(7))
        assert abs(est - true) < 0.3 * true + 3, (est, true)


class TestEigshFiltered:
    def test_laplace_interior(self):
        n = 200
        L = laplace(n).tocsr()
        a, b = -2.2, -1.8
        vals, vecs, hist = eigsh_filtered(
            L, 4, (a, b), tol=1e-10, dtype=np.float64,
            key=jax.random.key(0))
        full = np.sort(laplace_eigen(n))
        want = full[(full >= a) & (full <= b)]
        c = 0.5 * (a + b)
        want4 = np.sort(want[np.argsort(np.abs(want - c))[:4]])
        np.testing.assert_allclose(vals, want4, atol=1e-9)
        res = np.linalg.norm(L @ vecs - vals * vecs, axis=0)
        assert res.max() < 1e-8
        # orthonormal output
        np.testing.assert_allclose(vecs.T @ vecs, np.eye(4), atol=1e-9)
        assert hist.total_matvecs > 0
        assert len(hist.residual_trace) == hist.restarts[0]

    def test_laplace_2d_window(self):
        from arnoldi_jax.matrices import laplace_2d_eigen

        L = laplace_2d(24)
        full = np.sort(laplace_2d_eigen(24))
        a, b = -5.0, -4.5
        k = 3
        vals, vecs, _ = eigsh_filtered(
            L, k, (a, b), tol=1e-10, dtype=np.float64,
            key=jax.random.key(2))
        want = full[(full >= a) & (full <= b)]
        c = 0.5 * (a + b)
        wantk = np.sort(want[np.argsort(np.abs(want - c))[:k]])
        np.testing.assert_allclose(vals, wantk, atol=1e-8)

    def test_matches_shift_invert(self):
        n = 120
        L = laplace(n).tocsr()
        sigma = -1.3
        si_vals, _ = eigsh(L, 3, sigma=sigma, tol=1e-10, dtype=np.float64,
                           key=jax.random.key(4), inner_solver="splu")
        f_vals, _, _ = eigsh_filtered(
            L, 3, (sigma - 0.25, sigma + 0.25), tol=1e-10,
            dtype=np.float64, key=jax.random.key(4))
        np.testing.assert_allclose(np.sort(f_vals), np.sort(si_vals),
                                   atol=1e-8)

    def test_f32_path(self):
        # The on-device dtype: residuals to ~1e-5 relative.
        n = 160
        L = laplace(n).tocsr()
        vals, vecs, _ = eigsh_filtered(
            L, 3, (-2.1, -1.9), tol=3e-5, dtype=np.float32,
            key=jax.random.key(5))
        res = np.linalg.norm(L @ vecs - vals * vecs, axis=0)
        assert res.max() < 4.0 * 3e-5
        # every returned value is a true in-window eigenvalue (the
        # center-distance pick is tie-ambiguous: the spectrum is symmetric
        # about -2, so match against the whole window instead).
        full = np.sort(laplace_eigen(n))
        want = full[(full >= -2.1) & (full <= -1.9)]
        dist = np.abs(vals[:, None] - want[None, :]).min(axis=1)
        assert dist.max() < 1e-4, (vals, want)
        assert np.unique(np.round(vals, 3)).size == 3  # distinct pairs

    def test_not_converged_raises(self):
        # subspace pinned far below the cluster: a degree-8 filter cannot
        # resolve the window in one sweep (the auto-sized subspace would
        # cover the whole n=100 space and legitimately converge by exact
        # Rayleigh-Ritz).
        L = laplace(100).tocsr()
        with pytest.raises(RuntimeError, match="Has not converged !"):
            eigsh_filtered(L, 3, (-2.1, -1.9), tol=1e-12, max_iters=1,
                           degree=8, subspace=6, dtype=np.float64)

    def test_bad_window_raises(self):
        L = laplace(50).tocsr()
        with pytest.raises(AssertionError):
            eigsh_filtered(L, 2, (10.0, 12.0), dtype=np.float64)  # outside
        with pytest.raises(AssertionError):
            eigsh_filtered(L, 2, (-1.0, -1.0), dtype=np.float64)  # empty


class TestFilteredDwRefine:
    """Double-word continuation of the filtered solver (the interior analog
    of solvers/refine.py): 1e-8-grade residuals against the TRUE f64
    matrix from the f32 work dtype."""

    def test_laplace_f32_to_1e9(self):
        n = 200
        L = laplace(n).tocsr()
        vals, vecs, hist = eigsh_filtered(
            L, 4, (-2.2, -1.8), tol=1e-9, dtype=np.float32,
            key=jax.random.key(0))
        assert vecs.dtype == np.float64
        res = np.linalg.norm(L @ vecs - vals * vecs, axis=0)
        assert res.max() < 4.0 * 1e-9, res.max()
        full = np.sort(laplace_eigen(n))
        w = full[(full >= -2.2) & (full <= -1.8)]
        dist = np.abs(vals[:, None] - w[None, :]).min(axis=1)
        assert dist.max() < 1e-12, dist.max()

    def test_dense_operator_refine(self):
        # dense format exercises dense_matvec_dw + the cast-residual path
        rng = np.random.default_rng(8)
        n = 96
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.linspace(-3.0, 3.0, n)
        A = ((Q * lam) @ Q.T).astype(np.float64)
        vals, vecs, _ = eigsh_filtered(
            A, 3, (-0.3, 0.3), tol=1e-9, dtype=np.float32,
            key=jax.random.key(1))
        res = np.linalg.norm(A @ vecs - vals * vecs, axis=0)
        assert res.max() < 3.0 * 3e-9, res.max()
        dist = np.abs(vals[:, None] - lam[None, :]).min(axis=1)
        assert dist.max() < 1e-11

    def test_refine_none_stays_f32(self):
        L = laplace(128).tocsr()
        vals, vecs, _ = eigsh_filtered(
            L, 3, (-2.2, -1.8), tol=3e-5, dtype=np.float32, refine=None,
            key=jax.random.key(2))
        # f32 phase only: residual floor well above the dw tier's
        res = np.linalg.norm(L @ vecs - vals * vecs, axis=0)
        assert res.max() < 4 * 3e-5

    def test_bad_refine_raises(self):
        L = laplace(64).tocsr()
        with pytest.raises(ValueError, match="refine"):
            eigsh_filtered(L, 2, (-2.2, -1.8), refine="bogus")


class TestEigshWindow:
    """Spectrum slicing: ALL eigenpairs inside a window (eigsh_window),
    and eigsh_filtered's all-inside (nev=None) slice mode it builds on."""

    def test_all_inside_mode(self):
        n = 250
        L = laplace(n).tocsr()
        a, b = -2.2, -1.8
        vals, vecs, hist = eigsh_filtered(
            L, None, (a, b), tol=1e-10, dtype=np.float64,
            key=jax.random.key(1))
        full = np.sort(laplace_eigen(n))
        want = full[(full >= a) & (full <= b)]
        assert len(vals) == want.size
        np.testing.assert_allclose(vals, want, atol=1e-9)
        assert hist.matvecs.shape == (len(vals),)

    def test_window_complete(self):
        n = 400
        L = laplace(n).tocsr()
        a, b = -2.6, -1.4
        full = np.sort(laplace_eigen(n))
        want = full[(full >= a) & (full <= b)]  # 78 pairs -> 2 slices
        vals, vecs, hist = eigsh_window(L, (a, b), tol=1e-10,
                                        dtype=np.float64,
                                        key=jax.random.key(0))
        assert len(vals) == want.size, (len(vals), want.size)
        np.testing.assert_allclose(vals, want, atol=1e-9)
        res = np.linalg.norm(L @ vecs - vals * vecs, axis=0)
        assert res.max() < 1e-9
        assert hist.total_matvecs > 0

    def test_window_empty(self):
        L = laplace(100).tocsr()  # spectrum min is -3.999033
        # enclosure covers the window but no eigenvalues live there
        vals, vecs, _ = eigsh_window(L, (-4.04, -3.9995),
                                     bounds=(-4.05, 0.05), tol=1e-9,
                                     dtype=np.float64,
                                     key=jax.random.key(2))
        assert len(vals) == 0 and vecs.shape == (100, 0)

    def test_window_f32_refined(self):
        n = 200
        L = laplace(n).tocsr()
        a, b = -2.15, -1.95
        full = np.sort(laplace_eigen(n))
        want = full[(full >= a) & (full <= b)]
        vals, vecs, _ = eigsh_window(L, (a, b), tol=1e-9,
                                     dtype=np.float32,
                                     key=jax.random.key(3))
        assert len(vals) == want.size, (len(vals), want.size)
        np.testing.assert_allclose(vals, want, atol=1e-8)
        res = np.linalg.norm(L @ vecs - vals * vecs, axis=0)
        assert res.max() < 4 * 1e-8

    def test_3d_interior(self):
        # the target workload: 3-D stencil where shift-invert fill-in
        # explodes; polynomial filtering needs only matvecs.
        from arnoldi_jax.matrices import laplace_3d, laplace_3d_eigen

        L = laplace_3d(16)  # n = 4096
        full = np.sort(laplace_3d_eigen(16))
        a, b = -11.0, -10.7
        want = full[(full >= a) & (full <= b)]
        assert want.size > 5
        vals, vecs, _ = eigsh_window(L, (a, b), tol=1e-10,
                                     dtype=np.float64,
                                     key=jax.random.key(6))
        assert len(vals) == want.size, (len(vals), want.size)
        np.testing.assert_allclose(vals, want, atol=1e-9)


class TestFilteredMesh:
    """GSPMD-distributed filtered solve: rows of the operator and subspace
    partitioned over a device mesh (coarse and dw sweeps both)."""

    @pytest.fixture(scope="class")
    def mesh(self):
        from arnoldi_jax.parallel import make_mesh

        assert len(jax.devices()) >= 8
        return make_mesh(8)

    def test_matches_single_device(self, mesh):
        n = 256
        L = laplace(n).tocsr()
        a, b = -2.2, -1.8
        ref, _, _ = eigsh_filtered(L, 4, (a, b), tol=1e-10,
                                   dtype=np.float64, key=jax.random.key(0))
        vals, vecs, _ = eigsh_filtered(L, 4, (a, b), tol=1e-10,
                                       dtype=np.float64,
                                       key=jax.random.key(0), mesh=mesh)
        np.testing.assert_allclose(vals, ref, atol=1e-9)
        res = np.linalg.norm(L @ vecs - vals * vecs, axis=0)
        assert res.max() < 1e-9

    def test_mesh_f32_dw_refine(self, mesh):
        n = 256
        L = laplace(n).tocsr()
        vals, vecs, _ = eigsh_filtered(L, 3, (-2.2, -1.8), tol=1e-9,
                                       dtype=np.float32,
                                       key=jax.random.key(1), mesh=mesh)
        res = np.linalg.norm(L @ vecs - vals * vecs, axis=0)
        assert res.max() < 4e-9, res.max()

    def test_mesh_window(self, mesh):
        n = 256
        L = laplace(n).tocsr()
        a, b = -2.15, -1.95
        full = np.sort(laplace_eigen(n))
        want = full[(full >= a) & (full <= b)]
        vals, vecs, _ = eigsh_window(L, (a, b), tol=1e-10,
                                     dtype=np.float64,
                                     key=jax.random.key(2), mesh=mesh)
        assert len(vals) == want.size
        np.testing.assert_allclose(vals, want, atol=1e-9)
