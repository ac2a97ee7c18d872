"""Real-arithmetic Krylov-Schur path tests (the device hot loop stays real
— half the traffic and a quarter of the flops of complex; the dense tier
uses the real Schur form with 2x2 blocks for conjugate pairs,
which the reference leaves unimplemented)."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp

from arnoldi_jax import partial_schur
from arnoldi_jax.solvers.krylov_schur import eigenpairs_from_partial_schur
from arnoldi_jax.matrices import laplace, mark
from arnoldi_jax.ops.dense_tier import (
    ordered_schur_real,
    real_schur_blocks,
    real_schur_eigvals,
)
from arnoldi_jax.utils.sorting import arg_largest_magnitude, arg_largest_real

from common import find_best_matching

norm = np.linalg.norm


class TestOrderedSchurReal:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    @pytest.mark.parametrize("which", ["LM", "LR"])
    def test_random_real(self, seed, which):
        rng = np.random.default_rng(seed)
        n = 12
        A = rng.standard_normal((n, n))
        sf = arg_largest_magnitude if which == "LM" else arg_largest_real

        T, Z, vals = ordered_schur_real(A, sort_function=sf)

        # similarity: A = Z T Z^T
        np.testing.assert_allclose(Z @ T @ Z.T, A, rtol=1e-9, atol=1e-9)
        # Z orthogonal
        np.testing.assert_allclose(Z.T @ Z, np.eye(n), atol=1e-10)
        # same spectrum
        ref = np.linalg.eigvals(A)
        a, b = find_best_matching(np.sort_complex(vals), np.sort_complex(ref))
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-9)
        # block order follows the sort function (block representatives are
        # non-increasing under the sort key)
        starts, sizes = real_schur_blocks(T)
        reps = np.array([vals[s] for s in starts])
        key = np.abs(reps) if which == "LM" else np.real(reps)
        assert np.all(np.diff(key) <= 1e-9)

    def test_eigvals_positional_pairs(self):
        rng = np.random.default_rng(7)
        A = rng.standard_normal((8, 8))
        T, Z, vals = ordered_schur_real(A)
        starts, sizes = real_schur_blocks(T)
        for s, sz in zip(starts, sizes):
            if sz == 2:
                assert vals[s].imag > 0
                np.testing.assert_allclose(vals[s + 1], np.conj(vals[s]))


class TestRealPartialSchur:
    def check(self, A, k, which, tol=1e-9, max_dim=None, dtype=np.float64,
              seed=3, res_atol=1e-8):
        sf = arg_largest_real if which == "LR" else arg_largest_magnitude
        Q, T, hist = partial_schur(
            A, k, max_dim=max_dim, stopping_criterion=tol, sort_function=sf,
            max_restarts=3000, dtype=dtype, key=jax.random.key(seed),
        )
        Qh = np.asarray(Q)
        Th = np.asarray(T)
        assert not np.iscomplexobj(Qh) and not np.iscomplexobj(Th)
        assert Qh.shape[1] in (k, k + 1)  # pair-straddle contract
        Ad = A.todense() if sp.issparse(A) else A
        res = norm(Ad @ Qh - Qh @ Th, axis=0)
        np.testing.assert_allclose(res, 0, atol=res_atol)
        return Qh, Th, hist

    def test_mark10_lr(self):
        A = mark(10)
        Qh, Th, _ = self.check(A, 3, "LR")
        vals, vecs = eigenpairs_from_partial_schur(Qh, Th)
        r_vals = sp.linalg.eigs(A, 3, which="LR")[0]
        got = np.asarray(sorted(vals, key=lambda v: -v.real))[:3]
        want = np.asarray(sorted(r_vals, key=lambda v: -v.real))
        a, b = find_best_matching(got, want)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)

    def test_mark10_lm_complex_pairs(self):
        # LM on mark(10) pulls in +1, -1 and complex pairs: exercises 2x2
        # block handling in truncation and convergence.
        A = mark(10)
        Qh, Th, _ = self.check(A, 4, "LM", max_dim=20)
        vals = np.linalg.eigvals(Th)
        assert np.any(np.iscomplex(vals)) or np.allclose(vals.imag, 0)
        r_vals = sp.linalg.eigs(A, Qh.shape[1], which="LM", maxiter=5000)[0]
        a, b = find_best_matching(np.sort_complex(vals),
                                  np.sort_complex(r_vals))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)

    def test_rotating_matrix_pairs_straddle(self):
        # Block-diagonal rotation-scaled matrix: spectrum is all conjugate
        # pairs with distinct moduli; odd nev forces a straddling block.
        rng = np.random.default_rng(11)
        n = 40
        blocks = []
        for i in range(n // 2):
            r = 2.0 - i * 0.04
            th = 0.3 + 0.1 * (i % 7)
            blocks.append(r * np.array([[np.cos(th), -np.sin(th)],
                                        [np.sin(th), np.cos(th)]]))
        D = sp.block_diag(blocks).toarray()
        Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = Qo.T @ D @ Qo

        Qh, Th, _ = self.check(A, 3, "LM", max_dim=16, res_atol=1e-7)
        # nev=3 cuts a pair: must return 4 columns
        assert Qh.shape[1] == 4
        vals = np.linalg.eigvals(Th)
        want = np.linalg.eigvals(D)
        want = want[np.argsort(-np.abs(want))][:4]
        a, b = find_best_matching(np.sort_complex(vals), np.sort_complex(want))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)

    def test_laplace_real(self):
        from arnoldi_jax.matrices import laplace_eigen

        A = laplace(150)
        Qh, Th, _ = self.check(A, 4, "LR", tol=1e-9)
        vals = np.sort(np.linalg.eigvals(Th).real)[::-1][:4]
        want = np.sort(laplace_eigen(150))[::-1][:4]
        np.testing.assert_allclose(vals, want, rtol=1e-6, atol=1e-7)

    def test_float32(self):
        A = mark(10).astype(np.float32)
        Q, T, _ = partial_schur(
            A, 2, stopping_criterion=3e-4, sort_function=arg_largest_real,
            max_restarts=2000, dtype=np.float32, ortho="cgs2",
            key=jax.random.key(5),
        )
        Qh, Th = np.asarray(Q), np.asarray(T)
        assert Qh.dtype == np.float32
        res = norm(A.todense() @ Qh - Qh @ Th, axis=0)
        np.testing.assert_allclose(res, 0, atol=2e-3)

    def test_eigenpairs_from_real_schur(self):
        A = mark(10)
        Qh, Th, _ = self.check(A, 4, "LM", max_dim=20)
        vals, vecs = eigenpairs_from_partial_schur(Qh, Th)
        vecs = np.asarray(vecs)
        res = norm(A @ vecs - vals * vecs, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-6)


class TestComplexPairsGenerator:
    """random_scattered_complex_pairs: the at-scale complex-pair workload
    (bench.py complexpairs) in miniature — the dominant spectrum must be
    genuinely complex and the real-Schur path must recover it."""

    def test_dominant_spectrum_is_complex_pairs(self):
        from arnoldi_jax.matrices import random_scattered_complex_pairs

        n = 600
        A = random_scattered_complex_pairs(n, 8, coupling=0.02, omega=0.3,
                                           seed=3, bandwidth=64)
        assert not np.iscomplexobj(A.data)
        vals = np.linalg.eigvals(A.toarray())
        top = vals[np.argsort(-vals.real)[:6]]
        # the three LARGEST-real conjugate pairs: d_j +/- i w_j for
        # j = 4, 3, 2 (d_j = 1.2 + 0.06j ascending), up to O(coupling)
        want = np.array([1.44 + 0.60j, 1.44 - 0.60j, 1.38 + 0.525j,
                         1.38 - 0.525j, 1.32 + 0.45j, 1.32 - 0.45j])
        a, b = find_best_matching(np.sort_complex(top),
                                  np.sort_complex(want))
        np.testing.assert_allclose(a, b, atol=0.05)
        assert np.abs(top.imag).min() > 0.25

    def test_partial_schur_real_path_recovers_pairs(self):
        from arnoldi_jax.matrices import random_scattered_complex_pairs

        n = 600
        A = random_scattered_complex_pairs(n, 8, coupling=0.02, omega=0.3,
                                           seed=3, bandwidth=64)
        Q, T, hist = partial_schur(
            A, 6, max_dim=30, stopping_criterion=1e-9,
            sort_function=arg_largest_real, max_restarts=2000,
            dtype=np.float64, key=jax.random.key(0))
        Qh, Th = np.asarray(Q), np.asarray(T)
        assert not np.iscomplexobj(Th)      # real Schur form, 2x2 blocks
        res = np.linalg.norm(A @ Qh - Qh @ Th, axis=0)
        assert res.max() < 1e-7
        vals = np.linalg.eigvals(Th)
        assert np.abs(vals.imag).min() > 0.25   # every returned value complex
        ref = np.linalg.eigvals(A.toarray())
        ref_top = ref[np.argsort(-ref.real)[:len(vals)]]
        a, b = find_best_matching(np.sort_complex(vals),
                                  np.sort_complex(ref_top))
        np.testing.assert_allclose(a, b, atol=1e-7)
