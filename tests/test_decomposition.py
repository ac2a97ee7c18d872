"""Arnoldi core tests: the invariant oracle (Saad eqs. 6.8/6.9), truncation,
breakdown on an eigenvector start, the Saad table 6.1 convergence anchors,
Ritz residual identities, and the noise-injection max_dim check — the same
oracle set as the reference's ``tests/test_decomposition.py``, run against
the static-shape jitted expansion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from arnoldi_jax.solvers.decomposition import (
    RitzDecomposition,
    arnoldi_decomposition,
    arnoldi_expand,
)
from arnoldi_jax.matrices import laplace, mark
from arnoldi_jax.utils.random import rand_normalized_vector

from common import ATOL, RTOL, assert_invariants

norm = np.linalg.norm


def random_spd_ish(n, dtype=np.complex128):
    A = sp.random(n, n, density=5 / n, dtype=dtype,
                  random_state=np.random.RandomState(7))
    A = A + sp.diags_array(np.ones(n))
    return A.tocsr()


def fresh_workspace(n, m, dtype=np.complex128, seed=0):
    V = jnp.zeros((n, m + 1), dtype=dtype)
    H = jnp.zeros((m + 1, m), dtype=dtype)
    v0 = rand_normalized_vector(jax.random.key(seed), n, dtype)
    return V.at[:, 0].set(v0), H


class TestArnoldiExpand:
    def test_invariant_simple(self):
        n, m = 10, 6
        A = random_spd_ish(n)
        V, H = fresh_workspace(n, m)

        Va, Ha, n_iter = arnoldi_decomposition(A, V, H, ATOL)

        assert n_iter == m
        assert_invariants(A, Va, Ha, n_iter)

    def test_max_dim_support(self):
        n, m, max_dim = 10, 6, 3
        A = random_spd_ish(n)
        V, H = fresh_workspace(n, m)

        Va, Ha, n_iter = arnoldi_decomposition(A, V, H, ATOL, max_dim=max_dim)

        assert Va.shape == (n, max_dim + 1)
        assert Ha.shape == (max_dim + 1, max_dim)
        assert_invariants(A, Va, Ha, n_iter)

    def test_converge_first_iteration(self):
        # Seeding with an eigenvector must break down after one step.
        n, m = 10, 6
        A = random_spd_ish(n)
        _, r_vecs = sp.linalg.eigs(A)

        V = jnp.zeros((n, m + 1), dtype=jnp.complex128)
        H = jnp.zeros((m + 1, m), dtype=jnp.complex128)
        v0 = r_vecs[:, 0] / norm(r_vecs[:, 0])
        V = V.at[:, 0].set(jnp.asarray(v0))

        Vm, Hm, n_iter = arnoldi_decomposition(A, V, H, ATOL)

        assert n_iter == 1
        assert Vm.shape == (n, n_iter + 1)
        assert Hm.shape == (n_iter + 1, n_iter)
        assert_invariants(A, Vm, Hm, n_iter)

    def test_resume_matches_single_run(self):
        # The restart primitive: expanding 0->m must equal 0->k then k->m.
        n, m, k = 30, 12, 5
        A = random_spd_ish(n)
        V0, H0 = fresh_workspace(n, m, seed=3)
        V0 = V0.T  # arnoldi_expand uses the transposed layout

        V_full, H_full, it_full = arnoldi_expand(A, V0, H0, ATOL)
        V_a, H_a, it_a = arnoldi_expand(A, V0, H0, ATOL, max_dim=k)
        V_b, H_b, it_b = arnoldi_expand(A, V_a, H_a, ATOL, start_dim=k)

        assert int(it_full) == int(it_b) == m
        np.testing.assert_allclose(np.asarray(V_b), np.asarray(V_full),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(H_b), np.asarray(H_full),
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("ortho", ["cgs_dgks", "mgs_dgks", "cgs2"])
    def test_ortho_kernels_agree_on_invariants(self, ortho):
        n, m = 24, 10
        A = random_spd_ish(n)
        V, H = fresh_workspace(n, m, seed=5)
        Va, Ha, n_iter = arnoldi_decomposition(A, V, H, ATOL, ortho=ortho)
        assert_invariants(A, Va, Ha, n_iter)


class TestEigenValues:
    @pytest.mark.parametrize(
        "m,d", [(5, 0), (10, 1), (15, 2), (20, 3), (25, 5), (30, 7)]
    )
    def test_mark10(self, m, d):
        # Convergence-rate anchors from Saad table 6.1 (same as the
        # reference's test, deterministic via seeded start vectors).
        A = mark(10)
        n = A.shape[0]
        k = 2

        V, H = fresh_workspace(n, m, seed=2)
        V, H, n_iter = arnoldi_expand(A, V.T, H)

        ritz = RitzDecomposition.from_vt_and_h(V, H, k, max_dim=int(n_iter))

        val = ritz.values[0]
        vec = np.asarray(ritz.vectors[:, 0])
        residual = norm(A @ vec - val * vec)
        assert residual <= 2 * 10 ** (-d)


class TestRitzDecomposition:
    def compute_ritz(self, A, m, k, sort_function=None, seed=11):
        n = A.shape[0]
        V, H = fresh_workspace(n, m, seed=seed)
        Vt, H, n_iter = arnoldi_expand(A, V.T, H)
        return RitzDecomposition.from_vt_and_h(
            Vt, H, k, max_dim=int(n_iter), sort_function=sort_function
        )

    @pytest.mark.parametrize(
        "which, sort_function",
        [
            ("LM", lambda x: np.argsort(-np.abs(x))),
            ("LR", lambda x: np.argsort(-np.real(x))),
        ],
    )
    def test_simple(self, which, sort_function):
        A = mark(10)
        m, k, precision = 30, 2, 3

        r_vecs = sp.linalg.eigs(A, k, which=which)[1]
        ritz = self.compute_ritz(A, m, k, sort_function=sort_function)

        overlap = norm(np.asarray(ritz.vectors).T @ r_vecs) / np.sqrt(k)
        np.testing.assert_allclose(overlap, 1, rtol=1e-4, atol=ATOL)

        vecs = np.asarray(ritz.vectors)
        residuals = norm(A @ vecs - ritz.values * vecs)
        assert residuals <= 2 * 10 ** (-precision)

    @pytest.mark.parametrize("A,m", [(mark(10), 20), (laplace(100), 10)])
    def test_residual_computation(self, A, m):
        k = 2
        ritz = self.compute_ritz(A, m, k)
        vecs = np.asarray(ritz.vectors)
        residuals = norm(A @ vecs - ritz.values * vecs, axis=0)
        np.testing.assert_allclose(
            ritz.compute_true_residuals(A), residuals, rtol=RTOL, atol=ATOL
        )
        np.testing.assert_allclose(
            ritz.approximate_residuals, residuals, rtol=RTOL, atol=ATOL
        )

    def test_max_dim_ignores_stale_columns(self):
        # Inject noise beyond max_dim; the truncated extraction must not see
        # it (reference's inject_noise test).
        A = mark(10)
        n = A.shape[0]
        m, k = 20, 2
        max_dim = m - 5

        V, H = fresh_workspace(n, m, seed=4)
        Vt, H, n_iter = arnoldi_expand(A, V.T, H)

        rng = np.random.default_rng(0)
        V_noisy = np.array(Vt).T  # back to reference orientation
        H_noisy = np.array(H)
        V_noisy[:, max_dim:] = rng.standard_normal(V_noisy[:, max_dim:].shape)
        H_noisy[max_dim + 1 :, max_dim:] = rng.standard_normal(
            H_noisy[max_dim + 1 :, max_dim:].shape
        )

        broken = RitzDecomposition.from_v_and_h(V_noisy, H_noisy, k)
        good = RitzDecomposition.from_v_and_h(V_noisy, H_noisy, k, max_dim=max_dim)

        with pytest.raises(AssertionError):
            np.testing.assert_allclose(
                broken.compute_true_residuals(A),
                broken.approximate_residuals,
                rtol=RTOL,
                atol=ATOL,
            )
        np.testing.assert_allclose(
            good.compute_true_residuals(A),
            good.approximate_residuals,
            rtol=RTOL,
            atol=ATOL,
        )


class TestSegmentedExpansion:
    """Piecewise-static expansion must reproduce the plain expansion
    (identical masking/breakdown contract; rounding-level differences only
    from the smaller reduction shapes)."""

    def test_matches_plain(self):
        import jax
        import jax.numpy as jnp

        from arnoldi_jax.linop import as_operator
        from arnoldi_jax.matrices import mark
        from arnoldi_jax.solvers.decomposition import (_expand_jit,
                                                       _expand_segmented_jit)
        from arnoldi_jax.utils.random import rand_normalized_vector

        op = as_operator(mark(40))  # n=820
        n = op.shape[0]
        m = 40
        v0 = rand_normalized_vector(jax.random.key(3), n, jnp.float64)
        Vt0 = jnp.zeros((m + 1, n)).at[0].set(v0)
        H0 = jnp.zeros((m + 1, m))
        tol = jnp.asarray(1e-12)
        Vp, Hp, itp = _expand_jit(op, Vt0, H0, tol, start_dim=0, max_dim=m,
                                  ortho="cgs2")
        Vs, Hs, its = _expand_segmented_jit(op, Vt0, H0, tol, start_dim=0,
                                            max_dim=m, ortho="cgs2")
        assert int(itp) == int(its) == m
        np.testing.assert_allclose(np.asarray(Vs), np.asarray(Vp),
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(Hs), np.asarray(Hp),
                                   atol=1e-10)
        # restart-style start_dim > 0 (not segment-aligned)
        Vp2, Hp2, _ = _expand_jit(op, Vp, Hp, tol, start_dim=13, max_dim=m,
                                  ortho="cgs2")
        Vs2, Hs2, _ = _expand_segmented_jit(op, Vp, Hp, tol, start_dim=13,
                                            max_dim=m, ortho="cgs2")
        np.testing.assert_allclose(np.asarray(Vs2), np.asarray(Vp2),
                                   atol=1e-10)

    def test_breakdown_crosses_segments(self):
        import jax.numpy as jnp

        from arnoldi_jax.linop import as_operator
        from arnoldi_jax.solvers.decomposition import _expand_segmented_jit

        # rank-2 operator: breakdown at iteration 2, segments keep running
        # dead and n_iter reports the breakdown point.
        rng = np.random.default_rng(0)
        u = rng.standard_normal((64, 2))
        A = u @ u.T
        op = as_operator(A)
        m = 40
        v0 = rng.standard_normal(64)
        v0 /= np.linalg.norm(v0)
        Vt0 = jnp.zeros((m + 1, 64)).at[0].set(jnp.asarray(v0))
        H0 = jnp.zeros((m + 1, m))
        _, _, it = _expand_segmented_jit(op, Vt0, H0, jnp.asarray(1e-10),
                                         start_dim=0, max_dim=m,
                                         ortho="cgs2")
        assert int(it) <= 3
