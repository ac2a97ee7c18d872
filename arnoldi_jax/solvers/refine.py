"""Double-word Krylov-Schur refinement: 1e-8-grade residuals from a
float32 solve.

The reference reaches tol = sqrt(eps) ~ 1.5e-8 trivially by working in
complex128 (reference ``src/arnoldi/krylov_schur.py:16-19``); a
solve that runs in float32 (64-bit types off, or float32 chosen for its
bandwidth) cannot, and a plain f32 Krylov
process bottoms out at ~1e-6 relative residual (eps_f32 * ||A||, from the
matvec and projection roundoff alone).  This module runs the SAME
Krylov-Schur restart loop with every n-sized quantity carried as a
double-word f32 pair (``ops/df32.py``, unit roundoff ~2^-49): compensated
matvec (``ops/df32_linop.py``), compensated CGS2 orthogonalization, and a
compensated basis rotation, with the tiny projected matrix reconstructed
EXACTLY into float64 on the host (hi + lo is exact).  Attainable residual:
~1e-13 relative — comfortably past the 1e-8 BASELINE target.

Intended use: warm-started refinement.  The cheap f32 phase (plain
``partial_schur``) converges to ~1e-5; its Schur basis seeds a start vector
whose unwanted components are already ~1e-5, so the dw phase — each
iteration a few times the cost of an f32 one — typically needs only a
couple of restarts.  Wired in as ``partial_schur(..., refine=...)`` /
``partial_eigh(..., refine=...)``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops import dense_tier
from ..ops.df32 import (dw_add, dw_add_fl, dw_div, dw_dot, dw_mul,
                        dw_mul_fl, dw_norm, dw_sub, dw_sum)
from ..ops.df32_linop import dw_matvec

__all__ = ["dw_cgs2", "refine_schur_dw", "DW_INVARIANT_TOL"]

#: Breakdown threshold for the dw expansion: sqrt of the double-word unit
#: roundoff (the dw analog of the reference's sqrt(eps) default,
#: decomposition.py:41-42).
DW_INVARIANT_TOL = float(np.sqrt(2.0 ** -49))

_f32 = jnp.float32


def dw_cgs2(Vh, Vl, wh, wl, n_active, *, tol=DW_INVARIANT_TOL):
    """Twice-is-enough classical Gram-Schmidt in double-word arithmetic.

    Same contract as :func:`arnoldi_jax.ops.ortho.cgs2`, with every array a
    double-word pair: orthogonalizes ``w`` against the first ``n_active``
    rows of the transposed basis, returning ``(h, w, beta, breakdown)``
    where ``h`` and ``beta`` are dw pairs.

    Mixed-precision structure (one compensated pass instead of two, same
    accuracy): the FIRST projection is a plain
    f32 matvec — its coefficient rounding (~u_f32 relative) survives
    into w1 only as basis components that the SECOND, fully compensated
    pass measures to O(u^2) and removes.  Both UPDATES are compensated
    (error-free products + dw accumulation), so no u_f32-level error ever
    enters the Arnoldi relation: ``w_out = w_in - V h`` and the
    orthogonality of ``w_out`` against the basis both hold to O(u^2) —
    the property the plain f32 path cannot deliver.
    """
    import jax

    mp1 = Vh.shape[0]
    mask = jnp.arange(mp1) < n_active

    # Pass 1: f32 coefficients (one matvec), compensated update.
    c1 = jnp.matmul(Vh, wh, precision=jax.lax.Precision.HIGHEST)
    c1 = jnp.where(mask, c1, 0.0)
    uh, ul = dw_mul_fl(Vh, Vl, c1[:, None])                 # (m+1, n)
    sh, sl = dw_sum(uh, ul, axis=0)                         # (n,)
    wh, wl = dw_sub(wh, wl, sh, sl)

    # Pass 2: fully compensated projection of the (small) remainder.
    c2h, c2l = dw_dot(Vh, Vl, wh[None, :], wl[None, :], axis=1)  # (m+1,)
    c2h = jnp.where(mask, c2h, 0.0)
    c2l = jnp.where(mask, c2l, 0.0)
    uh, ul = dw_mul(c2h[:, None], c2l[:, None], Vh, Vl)     # (m+1, n)
    sh, sl = dw_sum(uh, ul, axis=0)                         # (n,)
    wh, wl = dw_sub(wh, wl, sh, sl)

    hh, hl = dw_add_fl(c2h, c2l, c1)
    bh, bl = dw_norm(wh, wl)
    return (hh, hl), (wh, wl), (bh, bl), bh < tol


def _dw_expand_window(op, Vh, Vl, Hh, Hl, invariant_tol, bj0, *, start, end,
                      op_lo=None):
    """Double-word expansion steps ``start..end`` on a (possibly
    row-sliced) workspace — the dw mirror of
    ``decomposition._expand_window`` (static-trip-count ``fori_loop``,
    dead-step masking after a breakdown, breakdown index threaded so
    segments compose)."""
    mp1 = Vh.shape[0]

    def body_fn(j, state):
        Vh, Vl, Hh, Hl, bj = state
        dead = j >= bj
        vh = lax.dynamic_slice_in_dim(Vh, j, 1, axis=0)[0]
        vl = lax.dynamic_slice_in_dim(Vl, j, 1, axis=0)[0]
        wh, wl = dw_matvec(op, vh, vl, op_lo=op_lo)
        (hh, hl), (wh, wl), (bh, bl), breakdown = dw_cgs2(
            Vh, Vl, wh, wl, j + 1, tol=invariant_tol)
        dead_or_break = breakdown | dead
        beta_h = jnp.where(dead_or_break, 0.0, bh).astype(_f32)
        beta_l = jnp.where(dead_or_break, 0.0, bl).astype(_f32)
        is_beta_row = jnp.arange(mp1) == j + 1
        col_h = jnp.where(is_beta_row, beta_h,
                          jnp.where(dead, 0.0, hh)).astype(_f32)
        col_l = jnp.where(is_beta_row, beta_l,
                          jnp.where(dead, 0.0, hl)).astype(_f32)
        Hh = lax.dynamic_update_slice(Hh, col_h[:, None], (0, j))
        Hl = lax.dynamic_update_slice(Hl, col_l[:, None], (0, j))
        safe_bh = jnp.where(bh > 0, bh, 1.0)
        safe_bl = jnp.where(bh > 0, bl, 0.0)
        nh, nl = dw_div(wh, wl, safe_bh, safe_bl)
        vnh = jnp.where(dead, 0.0, jnp.where(breakdown, wh, nh))
        vnl = jnp.where(dead, 0.0, jnp.where(breakdown, wl, nl))
        Vh = lax.dynamic_update_slice(Vh, vnh[None, :], (j + 1, 0))
        Vl = lax.dynamic_update_slice(Vl, vnl[None, :], (j + 1, 0))
        bj = jnp.where(breakdown & jnp.logical_not(dead), j + 1, bj)
        return Vh, Vl, Hh, Hl, bj

    return lax.fori_loop(start, end, body_fn, (Vh, Vl, Hh, Hl, bj0))


def _dw_expand_impl(op, Vh, Vl, Hh, Hl, invariant_tol, *, start_dim, max_dim,
                    op_lo=None):
    """Double-word Arnoldi expansion; auto-segments on large problems
    (same traffic argument as ``decomposition._expand_segmented_jit`` —
    the dw CGS2 reads BOTH limb arrays of the full workspace every
    iteration, so row-slicing at static boundaries nearly halves the
    dominant HBM traffic)."""
    from .decomposition import _EXPAND_SEG, _SEG_MIN_N

    if (Vh.shape[1] >= _SEG_MIN_N and max_dim - start_dim > _EXPAND_SEG
            and max_dim > 2 * _EXPAND_SEG):
        bj = jnp.asarray(max_dim + 1)
        a = start_dim
        while a < max_dim:
            b_end = min((a // _EXPAND_SEG + 1) * _EXPAND_SEG, max_dim)
            rows = b_end + 1
            Vhs, Vls, Hhs, Hls, bj = _dw_expand_window(
                op, Vh[:rows], Vl[:rows], Hh[:rows], Hl[:rows],
                invariant_tol, bj, start=a, end=b_end, op_lo=op_lo)
            Vh = Vh.at[:rows].set(Vhs)
            Vl = Vl.at[:rows].set(Vls)
            Hh = Hh.at[:rows].set(Hhs)
            Hl = Hl.at[:rows].set(Hls)
            a = b_end
        return Vh, Vl, Hh, Hl, jnp.minimum(bj, max_dim)
    Vh, Vl, Hh, Hl, bj = _dw_expand_window(
        op, Vh, Vl, Hh, Hl, invariant_tol, jnp.asarray(max_dim + 1),
        start=start_dim, end=max_dim, op_lo=op_lo)
    return Vh, Vl, Hh, Hl, jnp.minimum(bj, max_dim)


_dw_expand_jit = jax.jit(_dw_expand_impl,
                         static_argnames=("start_dim", "max_dim"))


@partial(jax.jit, static_argnames=("p", "m", "max_dim"))
def _dw_truncate_and_expand(op, Vh, Vl, Qh, Ql, Hh, Hl, invariant_tol, *,
                            p, m, max_dim, op_lo=None):
    """One-dispatch restart step for the dw phase: rotate/truncate the
    double-word basis by the host-computed ``Qp`` and immediately re-expand
    to ``max_dim`` — the dw mirror of the f32 path's fused
    ``_truncate_and_expand`` (one device round trip per restart instead of
    two)."""
    Vh, Vl = _dw_truncate_impl(Vh, Vl, Qh, Ql, p=p, m=m)
    Vh, Vl, Hh, Hl, bj = _dw_expand_impl(
        op, Vh, Vl, Hh, Hl, invariant_tol, start_dim=p, max_dim=max_dim,
        op_lo=op_lo)
    return Vh, Vl, jnp.stack([Hh, Hl]), bj


def _dw_truncate_impl(Vh, Vl, Qh, Ql, *, p, m):
    """Double-word basis truncation ``V[:p] = Qp^T V[:m]`` (+ carry row),
    accumulated over the small m axis with dw products so the rotated
    basis keeps its compensation limbs."""
    mpb, n = Vh.shape

    def body(j, acc):
        ah, al = acc
        vh = lax.dynamic_slice_in_dim(Vh, j, 1, axis=0)[0]
        vl = lax.dynamic_slice_in_dim(Vl, j, 1, axis=0)[0]
        qh = lax.dynamic_slice_in_dim(Qh, j, 1, axis=0)[0]  # (p,)
        ql = lax.dynamic_slice_in_dim(Ql, j, 1, axis=0)[0]
        ph, pl = dw_mul(qh[:, None], ql[:, None], vh[None, :], vl[None, :])
        return dw_add(ah, al, ph, pl)

    ah, al = lax.fori_loop(
        0, m, body, (jnp.zeros((p, n), _f32), jnp.zeros((p, n), _f32)))
    tail = jnp.zeros((mpb - p - 1, n), _f32)
    Vh2 = jnp.concatenate([ah, Vh[m : m + 1], tail], axis=0)
    Vl2 = jnp.concatenate([al, Vl[m : m + 1], tail], axis=0)
    return Vh2, Vl2


_dw_truncate = jax.jit(_dw_truncate_impl, static_argnames=("p", "m"))


def _combine_limbs_transposed(hi, lo, chunk=1 << 19):
    """Host-side double-word output assembly: ``(hi + lo).T`` as float64.

    The naive ``hi.astype(f64) + lo.astype(f64)`` costs SECONDS at
    n=4M x 5 on this host (measured 6.6 s — the shared VM sustains only
    ~100 MB/s per core on fresh-allocation dtype conversions, and the
    trailing ``.T`` view makes the downstream residual checks stride):
    converting in column chunks straight into the transposed output on a
    thread pool (``astype`` releases the GIL) is bit-identical and 19x
    faster, and returns a C-contiguous (n, k) array.  The low limb may
    arrive as bfloat16 (the compact output encoding): bf16 -> f32 is exact,
    and the add runs in float64 either way.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    k, n = hi.shape
    out = np.empty((n, k), np.float64)
    workers = min(8, os.cpu_count() or 1)
    # keep every worker busy even when n is below the default chunk
    chunk = max(min(chunk, -(-n // workers)), 1 << 14)

    def work(c0):
        c1 = min(c0 + chunk, n)
        seg = hi[:, c0:c1].astype(np.float64)
        seg += lo[:, c0:c1].astype(np.float32)
        out[c0:c1, :] = seg.T

    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(work, range(0, n, chunk)))
    return out


def refine_schur_dw(op, v0, nev, *, max_dim, p, tol, sort_function,
                    max_restarts=100, invariant_tol=DW_INVARIANT_TOL,
                    op_lo=None, clock=None, mesh=None):
    """Krylov-Schur in double-word f32 arithmetic (real path).

    Runs the standard restart loop — dw expansion on device, ordered real
    Schur + truncation geometry on the host in exact float64 (``Hh + Hl``
    reconstructs H exactly) — from start vector ``v0`` until the wanted
    ``nev`` pairs reach relative residual ``tol``.  ``op_lo`` carries the
    f64-to-f32 cast residual of the operator (see
    :func:`arnoldi_jax.ops.df32_linop.dw_matvec`) so the refinement targets
    the ORIGINAL matrix, not its f32 cast.

    Returns ``(Q, T, n_restarts, n_matvecs)`` with ``Q (n, nev_ret)`` and
    ``T (nev_ret, nev_ret)`` float64 HOST arrays (nev_ret = nev + 1 when a
    conjugate-pair block straddles the boundary, as in ``partial_schur``).
    """
    from ..utils.profiling import NULL_CLOCK

    clock = clock if clock is not None else NULL_CLOCK
    n = op.shape[0]
    max_dim = int(max_dim)
    p = int(p)
    assert nev <= p < max_dim <= n

    with clock("dw.setup"):
        Vh = jnp.zeros((max_dim + 1, n), _f32)
        Vl = jnp.zeros((max_dim + 1, n), _f32)
        Hh = jnp.zeros((max_dim + 1, max_dim), _f32)
        Hl = jnp.zeros((max_dim + 1, max_dim), _f32)
        if mesh is not None:
            # Same placement as the f32 phase: limb workspaces row-sharded
            # (axis 1 of the transposed basis), projected matrix
            # replicated.  The dw kernels are sharding-transparent jnp
            # code, so GSPMD partitions them (psum'd first-pass
            # projections; the compensated reductions partition with the
            # same combiner, so the O(u^2) error bound is preserved).
            from ..parallel.sharded import shard_workspace

            Vh, Hh = shard_workspace(Vh, Hh, mesh)
            Vl, Hl = shard_workspace(Vl, Hl, mesh)

        from ..ops.df32 import dw_from_f64

        if isinstance(v0, jax.Array) and v0.dtype == _f32:
            # Device start vector (the warm-start path): normalize on
            # device, zero low limb — no host round trip.  An f32-accurate
            # direction is all a start vector is.
            v0 = v0 / jnp.linalg.norm(v0)
            Vh = Vh.at[0, :].set(v0)
        else:
            v0 = np.asarray(v0, np.float64)
            v0 = v0 / np.linalg.norm(v0)
            v0h, v0l = dw_from_f64(v0)
            if mesh is not None:
                from ..parallel.mesh import row_sharding

                v0h = jax.device_put(jnp.asarray(v0h), row_sharding(mesh, 1))
                v0l = jax.device_put(jnp.asarray(v0l), row_sharding(mesh, 1))
            Vh = Vh.at[0, :].set(v0h)
            Vl = Vl.at[0, :].set(v0l)

    tolj = jnp.asarray(invariant_tol, _f32)
    with clock("dw.initial_expand"):
        Vh, Vl, Hh, Hl, n_iter = _dw_expand_jit(
            op, Vh, Vl, Hh, Hl, tolj, start_dim=0, max_dim=max_dim,
            op_lo=op_lo)
        m = int(n_iter)
    total_matvecs = m
    with clock("dw.h_pull"):
        # one batched pull (both limbs in flight together)
        Hh_host, Hl_host = jax.device_get((Hh, Hl))
        H_pair = (np.asarray(Hh_host, np.float64),
                  np.asarray(Hl_host, np.float64))

    H_trunc = None
    prev_pa = 0
    nev_ret = nev
    for restart in range(max_restarts):
        happy_breakdown = m != max_dim
        if happy_breakdown and m < nev:
            raise ValueError(
                f"Invariant subspace of dimension {m} < nev={nev} in dw "
                "refinement")

        # Exact f64 reconstruction of the projected matrix.
        with clock("dw.host_schur"):
            H_host = H_pair[0] + H_pair[1]
            if H_trunc is not None:
                H_host[: prev_pa + 1, :prev_pa] = H_trunc
            H_active = H_host[:m, :m]

            T2, Q, eigs_pos = dense_tier.ordered_schur_real(
                H_active, sort_function=sort_function)
            b_starts, b_sizes = dense_tier.real_schur_blocks(T2)
            in_block = np.zeros(m + 1, dtype=bool)
            for s, sz in zip(b_starts, b_sizes):
                if sz == 2:
                    in_block[s + 1] = True

        pa = min(p, m) if happy_breakdown else p
        if in_block[pa]:
            # Relocate a 1x1 block across the cut instead of moving pa
            # (pa is a STATIC shape downstream; drift = fresh compiles).
            try:
                T2, Q = dense_tier.resolve_straddle(T2, Q, pa,
                                                    min_keep=nev)
                b_starts, b_sizes = dense_tier.real_schur_blocks(T2)
                eigs_pos = dense_tier.real_schur_eigvals(T2)
                in_block = np.zeros(m + 1, dtype=bool)
                for s_, sz_ in zip(b_starts, b_sizes):
                    if sz_ == 2:
                        in_block[s_ + 1] = True
            except RuntimeError:
                # No prefix-safe relocation: step the cut (up first, then
                # down with the >= nev floor — pa below nev would truncate
                # wanted rows; mirrors the f32 path's stepping)
                limit = m if happy_breakdown else m - 1
                if pa + 1 <= limit and not in_block[pa + 1]:
                    pa += 1
                elif pa - 1 >= nev and not in_block[pa - 1]:
                    pa -= 1
                else:
                    raise ValueError(
                        "Cannot truncate without splitting a conjugate "
                        "pair; increase max_dim or p")
        Qp = Q[:, :pa]

        H_new = np.zeros((max_dim + 1, max_dim))
        H_new[:pa, :pa] = T2[:pa, :pa]
        H_new[pa, :pa] = H_host[m, :m] @ Qp
        H_trunc = H_new[: pa + 1, :pa].copy()
        prev_pa = pa

        coupling = np.abs(H_host[m, m - 1])
        last_row = np.abs(Q[m - 1, :])
        for s, sz in zip(b_starts, b_sizes):
            if sz == 2:
                pr = np.hypot(Q[m - 1, s], Q[m - 1, s + 1])
                last_row[s] = last_row[s + 1] = pr
        denom = np.abs(eigs_pos)
        denom = np.where(denom == 0, 1.0, denom)
        rel = coupling * last_row / denom

        converged = bool(np.all(rel[:nev] < tol))
        if (not converged) and happy_breakdown and pa >= m:
            raise ValueError(
                f"dw refinement saturated at dimension {m} without "
                "convergence")
        Qh, Ql_ = dw_from_f64(Qp)
        if converged:
            with clock("dw.final_truncate"):
                Vh, Vl = _dw_truncate(Vh, Vl, Qh, Ql_, p=pa, m=m)
            nev_ret = nev + 1 if in_block[nev] else nev
            with clock("dw.q_out_pull"):
                # ONE batched device_get (both limb slices in flight
                # together) instead of two sequential blocking pulls.
                # When the requested tolerance leaves headroom,
                # ship the LOW limb as bfloat16 — its rounding is
                # 2^-9|lo| <= 2^-34|hi| (~6e-11 relative on Q), invisible
                # above 1e-9 tolerances, and it cuts the pull by 25%.
                lo = Vl[:nev_ret]
                if tol >= 1e-9:
                    lo = lo.astype(jnp.bfloat16)
                Qh_out, Ql_out = jax.device_get((Vh[:nev_ret], lo))
            with clock("dw.q_combine"):
                Qout = _combine_limbs_transposed(Qh_out, Ql_out)
            T = H_new[:nev_ret, :nev_ret]
            return Qout, T, restart + 1, total_matvecs

        # Fused truncate+re-expand: one dispatch per restart, and one
        # batched device_get for the (tiny) projected matrix + count.
        Hh2, Hl2 = dw_from_f64(H_new[:, :max_dim])
        with clock("dw.restart_dispatch"):
            Vh, Vl, Hs, bj = _dw_truncate_and_expand(
                op, Vh, Vl, Qh, Ql_, Hh2, Hl2, tolj, p=pa, m=m,
                max_dim=max_dim, op_lo=op_lo)
            Hs_host, m_new = jax.device_get((Hs, bj))
        H_pair = (Hs_host[0].astype(np.float64), Hs_host[1].astype(np.float64))
        m_new = int(m_new)
        total_matvecs += m_new - pa
        m = m_new

    raise ValueError("Has not converged !")  # dw refinement budget exhausted


def cast_operator_f32(op):
    """Cast an operator's stored arrays to float32 (identity if already
    f32).  The dropped bits are exactly what
    :func:`build_cast_residual_operator` recovers."""
    import dataclasses

    from ..linop import (BandedOperator, BsrOperator, DenseOperator,
                         EllOperator)

    if jnp.dtype(op.dtype) == jnp.float32:
        return op
    if isinstance(op, BandedOperator):
        return dataclasses.replace(op, bands=op.bands.astype(jnp.float32))
    if isinstance(op, EllOperator):
        return dataclasses.replace(op, data=op.data.astype(jnp.float32))
    if isinstance(op, BsrOperator):
        return dataclasses.replace(op, blocks=op.blocks.astype(jnp.float32))
    if isinstance(op, DenseOperator):
        return DenseOperator(op.A.astype(jnp.float32))
    raise TypeError(
        f"dw refinement not supported for {type(op).__name__}")


def build_cast_residual_operator(A, op):
    """Operator holding ``A - f32(A)`` in the same device format as ``op``
    (the ``op_lo`` input of :func:`arnoldi_jax.ops.df32_linop.dw_matvec`).

    Returns None when ``A`` carries no precision beyond f32 (already-f32
    data, exact small-integer stencils, or an unsupported input type) —
    in that case the f32 operator IS the exact matrix.
    """
    import numpy as np
    import scipy.sparse as sp

    from ..linop import (BandedOperator, BsrOperator, DenseOperator,
                         EllOperator, as_operator)

    if sp.issparse(A) and A.dtype == np.float64:
        # Same sparsity pattern: subtract on the data array only (a full
        # sparse subtract re-sorts/merges — measured ~4x slower).
        A_c = sp.csr_matrix(A)
        lo = (A_c.data
              - A_c.data.astype(np.float32).astype(np.float64)
              ).astype(np.float32)
        if not lo.any():
            return None
        Alo = sp.csr_matrix((lo, A_c.indices.copy(), A_c.indptr.copy()),
                            shape=A_c.shape)
    elif isinstance(A, np.ndarray) and A.dtype == np.float64:
        A32 = A.astype(np.float32)
        Alo = (A - A32.astype(np.float64)).astype(np.float32)
        if not Alo.any():
            return None
    else:
        return None
    if isinstance(op, BandedOperator):
        return as_operator(sp.csr_matrix(Alo), format="banded")
    if isinstance(op, EllOperator):
        return as_operator(sp.csr_matrix(Alo), format="ell")
    if isinstance(op, BsrOperator):
        return as_operator(sp.csr_matrix(Alo) if not sp.issparse(Alo)
                           else Alo, format=("bsr", op.blockshape))
    if isinstance(op, DenseOperator):
        dense = Alo.todense() if sp.issparse(Alo) else Alo
        return as_operator(np.asarray(dense, np.float32))
    return None


def build_padded_cast_residual(A, op32, n_solve, mesh=None):
    """:func:`build_cast_residual_operator` for a possibly PADDED solve
    size (shared by the Krylov-Schur and Lanczos refine paths): pad the
    exact source to ``n_solve`` so the residual shares the f32 operator's
    layout, build the residual operator, and shard it under ``mesh``.
    Returns None when ``A``'s type carries no exact f64 source."""
    import scipy.sparse as sp

    n = A.shape[0] if hasattr(A, "shape") else None
    src = A
    if n is not None and n_solve != n:
        if sp.issparse(A):
            src = sp.csr_matrix(A).copy()
            src.resize(n_solve, n_solve)
        elif isinstance(A, np.ndarray):
            src = np.zeros((n_solve, n_solve), A.dtype)
            src[:n, :n] = A
        else:
            src = None
    op_lo = (build_cast_residual_operator(src, op32)
             if src is not None else None)
    if op_lo is not None and mesh is not None:
        from ..parallel.sharded import shard_operator

        op_lo = shard_operator(op_lo, mesh)
    return op_lo


def refinement_start_vector(Vt, nev_ret):
    """Deterministic start vector for the dw phase: a fixed-weight mix of
    the converged f32 Schur basis rows (weights 1/(i+1) prevent accidental
    cancellation between symmetric components).

    Accepts the DEVICE workspace directly and stays on device (returns a
    jax f32 vector): pulling the full (max_dim+1, n) workspace to the host
    just to mix a handful of rows would move (max_dim+1) * n values.
    The start vector's own rounding is irrelevant — any f32-accurate
    vector in the converged subspace seeds the warm start equally well.
    """
    if isinstance(Vt, jax.Array):
        rows = Vt[:nev_ret]
        w = jnp.asarray(1.0 / (1.0 + np.arange(rows.shape[0])), rows.dtype)
        v0 = (w[:, None] * rows).sum(axis=0)
        nrm = jnp.linalg.norm(v0)
        fallback = rows[0] / jnp.maximum(jnp.linalg.norm(rows[0]),
                                         jnp.finfo(rows.dtype).tiny)
        return jnp.where(nrm > 0, v0 / jnp.where(nrm > 0, nrm, 1.0),
                         fallback)
    rows = np.asarray(Vt[:nev_ret], np.float64)
    w = 1.0 / (1.0 + np.arange(rows.shape[0]))
    v0 = (w[:, None] * rows).sum(axis=0)
    nrm = np.linalg.norm(v0)
    if nrm == 0:
        v0 = rows[0]
        nrm = np.linalg.norm(v0)
    return v0 / nrm
