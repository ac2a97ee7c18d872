"""Double-word refinement: 1e-8-grade residuals from the float32 device
path (requested here by dtype=float32).

The reference gets 1e-8 from complex128
(/root/reference/src/arnoldi/krylov_schur.py:16-19, tol=sqrt(eps)); these
tests prove the compensated-f32 path reaches the same targets, including
the Saad-table anchor at 1e-8 (the reference anchors the deflated driver at
tol=1e-8 in /root/reference/tests/test_explicit_restarts.py:113-125).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from arnoldi_jax import partial_eigh, partial_schur
from arnoldi_jax.linop import as_operator
from arnoldi_jax.matrices import laplace_2d, laplace_2d_eigen, mark
from arnoldi_jax.ops.df32 import dw_from_f64, dw_to_f64
from arnoldi_jax.ops.df32_linop import dw_matvec
from arnoldi_jax.solvers.refine import (build_cast_residual_operator,
                                        dw_cgs2, refine_schur_dw)
from arnoldi_jax.utils.sorting import arg_largest_real


class TestDwMatvec:
    @pytest.mark.parametrize("fmt", ["banded", "ell", "bsr", "dense"])
    def test_accuracy_vs_f64(self, rng, fmt):
        A = mark(20)  # n=210, entries not f32-representable
        if fmt == "dense":
            op = as_operator(np.asarray(A.todense(), np.float32))
        elif fmt == "bsr":
            op = as_operator(A.astype(np.float32), format=("bsr", (8, 8)))
        else:
            op = as_operator(A.astype(np.float32), format=fmt)
        op_lo = build_cast_residual_operator(A.astype(np.float64), op)
        x = rng.standard_normal(A.shape[0])
        xh, xl = dw_from_f64(x)
        yh, yl = jax.jit(lambda *a: dw_matvec(op, a[0], a[1], op_lo=op_lo))(
            xh, xl)
        want = A @ x
        err = np.abs(dw_to_f64(yh, yl) - want).max()
        assert err < 1e-13 * np.abs(want).max(), (fmt, err)

    def test_cast_residual_none_for_exact_data(self):
        A = laplace_2d(8)  # integer entries: exact in f32
        op = as_operator(A.astype(np.float32), format="banded")
        assert build_cast_residual_operator(A.astype(np.float64), op) is None


class TestDwCgs2:
    def test_orthogonality_u2(self, rng):
        m, n = 12, 400
        V = np.linalg.qr(rng.standard_normal((n, m)))[0].T  # (m, n) rows
        Vh, Vl = dw_from_f64(V)
        pad = jnp.zeros((3, n), jnp.float32)
        Vh = jnp.concatenate([Vh, pad]); Vl = jnp.concatenate([Vl, pad])
        w = rng.standard_normal(n)
        wh, wl = dw_from_f64(w)
        (hh, hl), (wh2, wl2), (bh, bl), brk = jax.jit(
            lambda *a: dw_cgs2(*a))(Vh, Vl, wh, wl, m)
        w2 = dw_to_f64(wh2, wl2)
        # orthogonal against every basis row to ~u^2 of the vector scale
        proj = np.abs(V @ w2).max()
        assert proj < 1e-12 * np.linalg.norm(w2)
        assert not bool(brk)
        # h + w2 reconstructs w
        h = dw_to_f64(hh, hl)[:m]
        np.testing.assert_allclose(V.T @ h + w2, w, atol=1e-12)


    def test_orthogonality_u2_chunked_reduce(self, rng):
        # n large enough to engage dw_sum's chunked lax.reduce path
        # (>= 2 * _REDUCE_CHUNK), including the non-divisible padding.
        m, n = 9, 5003
        V = np.linalg.qr(rng.standard_normal((n, m)))[0].T
        Vh, Vl = dw_from_f64(V)
        pad = jnp.zeros((2, n), jnp.float32)
        Vh = jnp.concatenate([Vh, pad]); Vl = jnp.concatenate([Vl, pad])
        w = rng.standard_normal(n)
        wh, wl = dw_from_f64(w)
        (hh, hl), (wh2, wl2), (bh, bl), brk = jax.jit(
            lambda *a: dw_cgs2(*a))(Vh, Vl, wh, wl, m)
        w2 = dw_to_f64(wh2, wl2)
        assert np.abs(V @ w2).max() < 1e-11 * np.linalg.norm(w2)
        h = dw_to_f64(hh, hl)[:m]
        np.testing.assert_allclose(V.T @ h + w2, w, atol=1e-11)


class TestDwMatvecFusion:
    def test_fused_matches_separate(self, rng):
        # The cast-residual fusion (shared gathers) must agree with the
        # fallback separate-matvec path to double-word accuracy.
        from arnoldi_jax.ops.df32 import dw_add_fl

        A = (mark(20) * np.pi).tocsr()  # entries needing the lo operator
        for fmt in ("banded", "ell", ("bsr", (8, 8))):
            op = as_operator(A.astype(np.float32), format=fmt)
            op_lo = build_cast_residual_operator(A.astype(np.float64), op)
            assert op_lo is not None
            x = rng.standard_normal(A.shape[0])
            xh, xl = dw_from_f64(x)
            yh, yl = jax.jit(
                lambda *a: dw_matvec(op, a[0], a[1], op_lo=op_lo))(xh, xl)
            # fallback: plain matvec of the lo part added afterwards
            yh2, yl2 = jax.jit(
                lambda *a: dw_add_fl(
                    *dw_matvec(op, a[0], a[1]),
                    op_lo.matvec(a[0]).astype(jnp.float32)))(xh, xl)
            got = dw_to_f64(yh, yl)
            want = dw_to_f64(yh2, yl2)
            np.testing.assert_allclose(got, want, atol=2e-13 * np.abs(
                A @ x).max(), err_msg=str(fmt))
            # and both match the true f64 product
            np.testing.assert_allclose(got, A @ x, atol=1e-12 * np.abs(
                A @ x).max(), err_msg=str(fmt))


class TestRefinedSolvers:
    def test_partial_schur_f32_reaches_1e8(self):
        A = mark(30)
        Q, T, hist = partial_schur(
            A, 4, max_dim=20, stopping_criterion=1e-8,
            sort_function=arg_largest_real, max_restarts=2000,
            dtype=np.float32, ortho="cgs2", key=jax.random.key(0))
        assert isinstance(Q, np.ndarray) and Q.dtype == np.float64
        res = np.linalg.norm(A.todense() @ Q - Q @ T, axis=0)
        assert res.max() < 1e-8, res.max()

    def test_partial_eigh_f32_gate_at_1e8(self):
        # The bench.py correctness gate shape, at the BASELINE tolerance.
        nx, ny = 40, 39
        A = laplace_2d(nx, ny)
        vals, vecs, hist = partial_eigh(
            A.astype(np.float32), 4, which="LA", stopping_criterion=1e-8,
            max_restarts=3000, dtype=np.float32, key=jax.random.key(0))
        want = np.sort(laplace_2d_eigen(nx, ny))[-4:][::-1]
        assert np.abs(np.sort(vals) - np.sort(want)).max() < 1e-8
        res = np.linalg.norm(A @ vecs - vecs * vals[None, :], axis=0)
        assert res.max() < 1e-7

    def test_saad_table_anchor_at_1e8_f32(self):
        # Saad's mark(10) deflation anchor, run at tol=1e-8 on the f32
        # path (reference test_explicit_restarts.py:113-125 does this at
        # complex128; here float32 + dw refinement).
        A = mark(10)
        Q, T, hist = partial_schur(
            A, 3, max_dim=10, stopping_criterion=1e-8,
            sort_function=arg_largest_real, max_restarts=5000,
            dtype=np.float32, ortho="cgs2", key=jax.random.key(1))
        res = np.linalg.norm(A.todense() @ Q - Q @ T, axis=0)
        assert res.max() < 1e-8
        from scipy.sparse.linalg import eigs

        ref = np.sort(np.real(eigs(mark(10).astype(float), 3,
                                   which="LR")[0]))
        vals = np.sort(np.real(np.linalg.eigvals(T)))
        np.testing.assert_allclose(vals, ref, atol=1e-7)

    def test_refine_none_keeps_f32_contract(self):
        A = mark(20)
        Q, T, _ = partial_schur(
            A, 3, stopping_criterion=2e-4, sort_function=arg_largest_real,
            max_restarts=2000, dtype=np.float32, ortho="cgs2",
            refine=None, key=jax.random.key(0))
        assert jnp.asarray(Q).dtype == jnp.float32

    def test_explicit_dw_with_unsupported_refine_value(self):
        with pytest.raises(ValueError, match="refine"):
            partial_schur(mark(10), 2, stopping_criterion=1e-8,
                          refine="bogus", dtype=np.float32)

    def test_standalone_refine_from_random_start(self, rng):
        A = mark(30)
        op = as_operator(A.astype(np.float32))
        op_lo = build_cast_residual_operator(A.astype(np.float64), op)
        v0 = rng.standard_normal(A.shape[0])
        Q, T, nr, nmv = refine_schur_dw(
            op, v0, 4, max_dim=20, p=9, tol=1e-9,
            sort_function=arg_largest_real, max_restarts=300, op_lo=op_lo)
        res = np.linalg.norm(A.todense() @ Q - Q @ T, axis=0)
        assert res.max() < 1e-8


class TestRefineBsr:
    def test_partial_schur_bsr_refine(self):
        # BSR (the default for dense-tile scattered sparsity) must refine.
        from arnoldi_jax.linop import as_operator

        A = mark(25)
        op = as_operator(A.astype(np.float32), format=("bsr", (8, 8)))
        Q, T, hist = partial_schur(
            op, 3, max_dim=18, stopping_criterion=1e-8,
            sort_function=arg_largest_real, max_restarts=2000,
            dtype=np.float32, ortho="cgs2", key=jax.random.key(2))
        # NOTE op was built from the f32 cast, so the refinement target IS
        # the f32 matrix here (op_lo None: A not threaded through op).
        A32 = A.astype(np.float32).astype(np.float64)
        res = np.linalg.norm(A32 @ Q - Q @ T, axis=0)
        assert res.max() < 1e-8, res.max()


class TestHostTrafficPaths:
    """The host-traffic levers: device-side start vector, bf16 low-limb
    output, and the ARNOLDI_PHASES stopwatch that found them."""

    def test_start_vector_device_matches_host(self):
        from arnoldi_jax.solvers.refine import refinement_start_vector

        rng = np.random.default_rng(3)
        Vt = rng.standard_normal((8, 40)).astype(np.float32)
        host = refinement_start_vector(Vt, 5)
        dev = refinement_start_vector(jnp.asarray(Vt), 5)
        assert isinstance(dev, jax.Array)
        np.testing.assert_allclose(np.asarray(dev, np.float64), host,
                                   atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(np.asarray(dev)), 1.0,
                                   atol=1e-6)

    def test_refine_accepts_device_f32_start(self):
        A = mark(25)
        op = as_operator(A.astype(np.float32))
        op_lo = build_cast_residual_operator(A.astype(np.float64), op)
        v0 = jnp.asarray(np.random.default_rng(0).standard_normal(
            A.shape[0]), jnp.float32)
        Q, T, nr, nmv = refine_schur_dw(
            op, v0, 3, max_dim=16, p=8, tol=1e-9,
            sort_function=arg_largest_real, max_restarts=300, op_lo=op_lo)
        res = np.linalg.norm(A.todense() @ Q - Q @ T, axis=0)
        assert res.max() < 1e-8

    def test_tight_tol_keeps_f32_low_limb(self):
        # tol < 1e-9 must NOT take the bf16 output shortcut: the returned
        # Q carries the full double-word accuracy.
        A = mark(20)
        op = as_operator(A.astype(np.float32))
        op_lo = build_cast_residual_operator(A.astype(np.float64), op)
        v0 = np.random.default_rng(1).standard_normal(A.shape[0])
        Q, T, nr, nmv = refine_schur_dw(
            op, v0, 3, max_dim=16, p=8, tol=1e-12,
            sort_function=arg_largest_real, max_restarts=500, op_lo=op_lo)
        res = np.linalg.norm(A.todense() @ Q - Q @ T, axis=0)
        assert res.max() < 1e-11, res.max()

    def test_phase_clock_on_history(self, monkeypatch):
        monkeypatch.setenv("ARNOLDI_PHASES", "1")
        A = mark(20)
        Q, T, hist = partial_schur(
            A, 3, max_dim=12, stopping_criterion=1e-8,
            sort_function=arg_largest_real, max_restarts=2000,
            dtype=np.float32, ortho="cgs2", key=jax.random.key(0))
        assert "f32.initial_expand" in hist.phases
        assert any(k.startswith("dw.") for k in hist.phases)
        assert all(v["seconds"] >= 0 and v["calls"] >= 1
                   for v in hist.phases.values())
        monkeypatch.delenv("ARNOLDI_PHASES")
        _, _, h2 = partial_schur(
            A, 3, max_dim=12, stopping_criterion=1e-8,
            sort_function=arg_largest_real, max_restarts=2000,
            dtype=np.float32, ortho="cgs2", key=jax.random.key(0))
        assert h2.phases == {}
