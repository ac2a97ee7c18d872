"""Native host-tier engine vs the NumPy host path (its correctness oracle).

The engine (``native/host_engine.cpp``) mirrors
``decomposition.host_arnoldi_expand`` exactly — same CGS/DGKS/CGS2/MGS
semantics, same breakdown contract — reached through one C call per
restart.  These tests pin the equivalence and the full-solve parity.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from arnoldi_jax.matrices import mark
from arnoldi_jax.native import host_engine
from arnoldi_jax.solvers.decomposition import host_arnoldi_expand

pytestmark = pytest.mark.skipif(
    not host_engine.available(), reason="native host engine not built")


def _workspaces(n, max_dim, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n)
    v0 /= np.linalg.norm(v0)
    Vt = np.zeros((max_dim + 1, n))
    H = np.zeros((max_dim + 1, max_dim))
    Vt[0] = v0
    return Vt, H


@pytest.mark.parametrize("ortho", ["cgs_dgks", "cgs2", "mgs_dgks"])
def test_expand_matches_numpy_path(ortho):
    A = mark(30)
    n = A.shape[0]
    max_dim = 25
    Vt_e, H_e = _workspaces(n, max_dim)
    Vt_p, H_p = _workspaces(n, max_dim)

    eng = host_engine.engine_for(A, np.float64, max_dim, ortho)
    assert eng is not None
    _, _, it_e = eng.expand(Vt_e, H_e, 1e-12, start_dim=0, max_dim=max_dim,
                            ortho=ortho)
    mv = lambda v: A @ v  # noqa: E731
    _, _, it_p = host_arnoldi_expand(mv, Vt_p, H_p, 1e-12, start_dim=0,
                                     max_dim=max_dim, ortho=ortho)
    assert it_e == it_p == max_dim
    np.testing.assert_allclose(Vt_e, Vt_p, rtol=0, atol=1e-12)
    np.testing.assert_allclose(H_e, H_p, rtol=0, atol=1e-12)
    # Arnoldi invariants independently of the oracle
    Vm = Vt_e[:max_dim].T
    np.testing.assert_allclose(Vm.T @ Vm, np.eye(max_dim), atol=1e-10)
    lhs = A @ Vm
    rhs = Vt_e[: max_dim + 1].T @ H_e[:, :max_dim]
    np.testing.assert_allclose(lhs, rhs, atol=1e-10)


def test_cycle_matches_truncate_plus_expand():
    A = mark(30)
    n = A.shape[0]
    max_dim = 20
    pa = 8
    Vt, H = _workspaces(n, max_dim, seed=1)
    eng = host_engine.engine_for(A, np.float64, max_dim, "cgs_dgks")
    eng.expand(Vt, H, 1e-12, start_dim=0, max_dim=max_dim)

    rng = np.random.default_rng(2)
    Qp = np.linalg.qr(rng.standard_normal((max_dim, max_dim)))[0][:, :pa]
    H_new = np.zeros_like(H)
    H_new[:pa, :pa] = Qp.T @ H[:max_dim, :max_dim] @ Qp
    H_new[pa, :pa] = H[max_dim, max_dim - 1] * Qp[max_dim - 1, :]

    # oracle: python truncate + numpy expand
    out_p = np.zeros_like(Vt)
    out_p[:pa] = Qp.T @ Vt[:max_dim]
    out_p[pa] = Vt[max_dim]
    H_p = H_new.copy()
    mv = lambda v: A @ v  # noqa: E731
    _, _, it_p = host_arnoldi_expand(mv, out_p, H_p, 1e-12, start_dim=pa,
                                     max_dim=max_dim)

    out_e = np.empty_like(Vt)
    H_e = H_new.copy()
    _, _, it_e = eng.cycle(Vt, out_e, H_e, Qp, m=max_dim, pa=pa, carry=1,
                           max_dim=max_dim, tol=1e-12)
    assert it_e == it_p
    np.testing.assert_allclose(out_e[: max_dim + 1], out_p[: max_dim + 1],
                               atol=1e-12)
    np.testing.assert_allclose(H_e, H_p, atol=1e-12)


def test_breakdown_contract():
    # start vector inside a 2-dimensional invariant subspace -> breakdown
    # at j == 2 with a zero coupling coefficient and the raw vector stored.
    D = sp.diags_array([3.0, 1.0, 0.5, 0.25], offsets=0,
                       format="csr")
    n = 4
    max_dim = 4
    v0 = np.zeros(n)
    v0[:2] = [1.0, 1.0]
    v0 /= np.linalg.norm(v0)
    Vt = np.zeros((max_dim + 1, n))
    H = np.zeros((max_dim + 1, max_dim))
    Vt[0] = v0
    eng = host_engine.engine_for(D, np.float64, max_dim, "cgs_dgks")
    _, _, it = eng.expand(Vt, H, 1e-10, start_dim=0, max_dim=max_dim)
    assert it == 2
    assert H[2, 1] == 0.0


def test_full_solve_parity_engine_vs_numpy(monkeypatch):
    import jax

    from arnoldi_jax.solvers.krylov_schur import (
        eigenpairs_from_partial_schur, partial_schur)

    A = mark(40)
    kwargs = dict(max_dim=24, stopping_criterion=1e-8, max_restarts=5000,
                  sort_function="LM", key=jax.random.key(3))
    Q1, T1, h1 = partial_schur(A, 5, **kwargs)
    v1, _ = eigenpairs_from_partial_schur(Q1, T1)

    monkeypatch.setattr(host_engine, "engine_for",
                        lambda *a, **k: None)
    Q2, T2, h2 = partial_schur(A, 5, **kwargs)
    v2, _ = eigenpairs_from_partial_schur(Q2, T2)
    np.testing.assert_allclose(np.sort_complex(v1), np.sort_complex(v2),
                               rtol=1e-8)
    assert h1.total == h2.total  # identical arithmetic path
