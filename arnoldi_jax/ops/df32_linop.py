"""Double-word (df32) sparse matvecs: ``y = A x`` with f32 operator
storage and double-word vectors, accurate to ~1e-15 relative.

The operator entries stay plain float32 (they are EXACT data — the f32
cast of the matrix happened once at load time); only the Krylov vectors
carry a compensation limb.  Each elementwise product ``a_ij * x_j`` is
computed error-free (``two_prod`` on the hi limb + f32 product with the lo
limb) and accumulated with a compensated cascade (error-free TwoSum on the
hi limbs, O(u^2)-rounding plain adds on the lo limbs), so the matvec error
is O(u^2 * row_nnz) instead of O(u sqrt(n)) — the piece that makes 1e-8
residuals attainable on a device with no float64 (see ops/df32.py).

Formats mirror ``arnoldi_jax.linop``: banded/DIA (shift-and-add), ELL
(gather + row reduction), BSR (block gather, loop over the small static
block-slot axis to bound temporaries), dense (row-chunked).

Cast-residual fusion: when the caller supplies ``op_lo`` (holding
``A - f32(A)``, built by
:func:`arnoldi_jax.solvers.refine.build_cast_residual_operator` from the
SAME sparsity pattern), its contribution ``A_lo @ x_hi`` is folded into
the main gather loop — the gathered ``x`` blocks are reused and no second
matvec is dispatched.  The fusion requires op_lo to share op's packed
layout; ``build_cast_residual_operator`` guarantees this (explicit zeros
are preserved through the CSR -> device-format packing, which is a pure
function of the sparsity pattern).  A shape mismatch falls back to a
separate ``op_lo.matvec`` dispatch.
"""

import jax
import jax.numpy as jnp

from .df32 import dw_sum, fast_two_sum, two_prod, two_sum

__all__ = ["dw_matvec"]


def _shift(x, off):
    if off == 0:
        return x
    if off > 0:
        return jnp.concatenate([x[off:], jnp.zeros(off, x.dtype)])
    return jnp.concatenate([jnp.zeros(-off, x.dtype), x[:off]])


def _acc(acc_h, acc_l, ph, pl):
    """Fold the compensated product pair ``(ph, pl)`` into the running
    accumulator: TwoSum keeps the hi path error-free; the lo adds round at
    O(u^2) of the hi magnitude."""
    s, e = two_sum(acc_h, ph)
    return s, acc_l + pl + e


def banded_matvec_dw(bands, offsets, xh, xl, bands_lo=None):
    n = xh.shape[0]
    yh = jnp.zeros(n, jnp.float32)
    yl = jnp.zeros(n, jnp.float32)
    for d, off in enumerate(offsets):
        b = bands[d]
        sh = _shift(xh, off)
        ph, pl = two_prod(b, sh)
        pl = pl + b * _shift(xl, off)
        if bands_lo is not None:
            pl = pl + bands_lo[d] * sh
        yh, yl = _acc(yh, yl, ph, pl)
    return fast_two_sum(yh, yl)


def ell_matvec_dw(data, cols, xh, xl, data_lo=None):
    gh = jnp.take(xh, cols, axis=0)  # (n, L)
    gl = jnp.take(xl, cols, axis=0)
    ph, pl = two_prod(data, gh)
    pl = pl + data * gl
    if data_lo is not None:
        pl = pl + data_lo * gh
    return dw_sum(ph, pl, axis=1)


def bsr_matvec_dw(blocks, block_cols, n_rows, n_cols, xh, xl,
                  blocks_lo=None):
    nb, L, r, c = blocks.shape
    n_bcol_pad = -(-n_cols // c) * c
    xph = jnp.zeros(n_bcol_pad, jnp.float32).at[:n_cols].set(xh)
    xpl = jnp.zeros(n_bcol_pad, jnp.float32).at[:n_cols].set(xl)
    xbh = xph.reshape(-1, c)
    xbl = xpl.reshape(-1, c)
    yh = jnp.zeros((nb, r), jnp.float32)
    yl = jnp.zeros((nb, r), jnp.float32)
    # Static loop over the (small) block-slot axis keeps the per-step
    # temporary at (nb, r, c) instead of (nb, L, r, c).
    for l in range(L):
        gh = jnp.take(xbh, block_cols[:, l], axis=0)  # (nb, c)
        gl = jnp.take(xbl, block_cols[:, l], axis=0)
        B = blocks[:, l]                               # (nb, r, c)
        ph, pl = two_prod(B, gh[:, None, :])
        pl = pl + B * gl[:, None, :]
        if blocks_lo is not None:
            pl = pl + blocks_lo[:, l] * gh[:, None, :]
        sh, sl = dw_sum(ph, pl, axis=-1)               # (nb, r)
        yh, yl = _acc(yh, yl, sh, sl)
    yh, yl = fast_two_sum(yh, yl)
    return yh.reshape(-1)[:n_rows], yl.reshape(-1)[:n_rows]


def dense_matvec_dw(A, xh, xl, row_chunk=256, A_lo=None):
    n, m = A.shape
    pad = (-n) % row_chunk
    Ap = jnp.pad(A, ((0, pad), (0, 0))).reshape(-1, row_chunk, m)
    Alp = (jnp.pad(A_lo, ((0, pad), (0, 0))).reshape(-1, row_chunk, m)
           if A_lo is not None else None)

    def chunk(args):
        Ac, Alc = args
        ph, pl = two_prod(Ac, xh[None, :])
        pl = pl + Ac * xl[None, :]
        if Alc is not None:
            pl = pl + Alc * xh[None, :]
        return dw_sum(ph, pl, axis=-1)

    if Alp is None:
        yh, yl = jax.lax.map(lambda Ac: chunk((Ac, None)), Ap)
    else:
        yh, yl = jax.lax.map(chunk, (Ap, Alp))
    return yh.reshape(-1)[:n], yl.reshape(-1)[:n]


def dw_matvec(op, xh, xl, op_lo=None):
    """``A @ x`` with a double-word vector; dispatches on operator type.

    ``op`` holds the float32 cast of the matrix (the f32 work format);
    ``op_lo``, when given, holds the CAST RESIDUAL ``A - f32(A)`` (same
    format, f32 storage).  Its contribution is ~eps * ||A|| * ||x||, so a
    PLAIN f32 product with the hi limb suffices (its own rounding is
    O(eps^2)) — one cheap fused term recovers the original f64 matrix
    exactly to double-word accuracy.  When op_lo shares op's packed layout
    (the :func:`build_cast_residual_operator` contract) the term rides the
    main kernel's gathers; otherwise it falls back to a separate matvec.
    """
    from ..linop import (BandedOperator, BsrOperator, CallableOperator,
                         DenseOperator, EllOperator)

    if not isinstance(op, (BandedOperator, BsrOperator, DenseOperator,
                           EllOperator)) and hasattr(op, "matvec_dw"):
        # Composite/closure operators carrying their own dw action: the
        # halo-exchange closure (parallel/halo_spmv.py, a
        # CallableOperator) and GramOperator (linop.py).  Any
        # cast-residual correction is folded inside, so a
        # separately-supplied op_lo is not meaningful here.
        assert op_lo is None, (
            f"{type(op).__name__} dw matvec folds its own op_lo")
        return op.matvec_dw(xh, xl)

    fused = False
    if isinstance(op, BandedOperator):
        lo = (op_lo.bands
              if isinstance(op_lo, BandedOperator)
              and op_lo.offsets == op.offsets
              and op_lo.bands.shape == op.bands.shape else None)
        fused = lo is not None
        yh, yl = banded_matvec_dw(op.bands, op.offsets, xh, xl, bands_lo=lo)
    elif isinstance(op, EllOperator):
        lo = (op_lo.data
              if isinstance(op_lo, EllOperator)
              and op_lo.data.shape == op.data.shape else None)
        fused = lo is not None
        yh, yl = ell_matvec_dw(op.data, op.cols, xh, xl, data_lo=lo)
    elif isinstance(op, BsrOperator):
        lo = (op_lo.blocks
              if isinstance(op_lo, BsrOperator)
              and op_lo.blocks.shape == op.blocks.shape else None)
        fused = lo is not None
        yh, yl = bsr_matvec_dw(op.blocks, op.block_cols, op.shape[0],
                               op.shape[1], xh, xl, blocks_lo=lo)
    elif isinstance(op, DenseOperator):
        lo = (op_lo.A if isinstance(op_lo, DenseOperator)
              and op_lo.A.shape == op.A.shape else None)
        fused = lo is not None
        yh, yl = dense_matvec_dw(op.A, xh, xl, A_lo=lo)
    else:
        raise TypeError(
            f"double-word matvec not implemented for {type(op).__name__}; "
            "supply a Banded/Ell/Bsr/Dense operator")
    if op_lo is not None and not fused:
        from .df32 import dw_add_fl

        yh, yl = dw_add_fl(yh, yl, op_lo.matvec(xh).astype(jnp.float32))
    return yh, yl
