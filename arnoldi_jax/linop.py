"""Device-side linear operators.

The reference reaches sparse matvec through SciPy CSR's C kernel
(``A @ V[:, j]``, ``src/arnoldi/decomposition.py:58``).  The framework's
operator layer re-encodes sparsity in static-shape formats that XLA compiles
without data-dependent loop bounds:

* :class:`DenseOperator` — plain matmul (small/medium n).
* :class:`EllOperator` — ELLPACK: rows padded to a fixed nnz-per-row budget,
  giving a static-shape gather + row reduction.
* :class:`BandedOperator` — diagonal (DIA) storage for stencil matrices
  (``laplace``/``laplace_2d``): shift-and-add, no gather at all.
* :class:`BsrOperator` — block-sparse rows: dense ``r x c`` blocks.
* :class:`CallableOperator` — escape hatch wrapping an arbitrary jittable
  matvec closure.

All operators are pytrees, so they pass straight through ``jax.jit`` /
``shard_map`` as arguments, and expose ``matvec`` (n,)->(n,), ``matmat``
(n,k)->(n,k), ``shape``, ``dtype``, and ``nnz`` (for throughput metrics).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _check_padded_layout(kind, padded_elems, stored_elems, L, degrees):
    """Refuse to build a padded static-shape layout whose zero-fill would
    dwarf the data.  ELL/BSR pad every row to the MAX row degree; a matrix
    with a few super-dense rows (e.g. the transpose of a generator that
    clips columns onto a boundary, or a graph with hub nodes) makes the
    padded array orders of magnitude larger than nnz — observed 34.8 GiB
    for a 105 MB matrix (r05: ``random_scattered(edge='clip')``'s adjoint,
    max block-row degree 1113 vs mean 3).  Raising here turns a host OOM
    kill into an actionable error; callers that can proceed without the
    device format (e.g. the svds Gram refinement companion) catch it.
    """
    # generous: padding below 8x the data, or small in absolute terms,
    # is always accepted
    if padded_elems <= max(8 * max(stored_elems, 1), 1 << 24):
        return
    mean_deg = float(np.mean(degrees)) if len(degrees) else 0.0
    raise ValueError(
        f"{kind} layout would allocate {padded_elems:,} elements "
        f"({padded_elems * 4 / 1e9:.1f}+ GB) for {stored_elems:,} stored — "
        f"max row degree {L} vs mean {mean_deg:.1f}.  The padded "
        f"static-shape layout is built for bounded-degree sparsity; "
        "rebalance the matrix (e.g. random_scattered(edge='reflect')) or "
        "use a host/CSR path for this operator")


def _result_dtype(op_dtype, x_dtype):
    return jnp.result_type(op_dtype, x_dtype)


#: Matvec accuracy matters more than matrix-unit throughput for Krylov
#: residuals: a default-precision float32 product may run in TF32 (GPU) or
#: bfloat16 passes, keeping only ~3 decimal digits.
_PREC = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DenseOperator:
    """Dense matrix operator; matvec is a single gemv/gemm."""

    A: jax.Array

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def nnz(self):
        return self.A.shape[0] * self.A.shape[1]

    def matvec(self, x):
        return jnp.matmul(self.A, x, precision=_PREC)

    def matmat(self, X):
        return jnp.matmul(self.A, X, precision=_PREC)

    def tree_flatten(self):
        return (self.A,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class EllOperator:
    """ELLPACK sparse operator: ``y[r] = sum_l data[r, l] * x[cols[r, l]]``.

    Rows are padded to the max row-degree with zero weights (pointing at
    column 0), so every shape is static — the XLA-friendly replacement for
    CSR's variable-length rows.  ``nnz_stored`` counts true nonzeros for
    throughput accounting.
    """

    data: jax.Array  # (n_rows, L)
    cols: jax.Array  # (n_rows, L) int32
    nnz_stored: int = dataclasses.field(metadata={"static": True})
    #: column count; 0 means square (n_rows x n_rows)
    n_cols: int = 0

    @property
    def shape(self):
        n = self.data.shape[0]
        return (n, self.n_cols or n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):
        return self.nnz_stored

    def matvec(self, x):
        gathered = jnp.take(x, self.cols, axis=0)  # (n, L)
        return jnp.sum(self.data * gathered, axis=1)

    def matmat(self, X):
        gathered = jnp.take(X, self.cols, axis=0)  # (n, L, k)
        return jnp.einsum("nl,nlk->nk", self.data, gathered, precision=_PREC)

    @classmethod
    def from_scipy(cls, A, dtype=None):
        """Build from any SciPy sparse matrix."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        if dtype is not None:
            A = A.astype(dtype)
        A.sum_duplicates()
        n = A.shape[0]
        degrees = np.diff(A.indptr)
        L = max(int(degrees.max(initial=0)), 1)
        _check_padded_layout("ELL", n * L, A.nnz, L, degrees)
        data = np.zeros((n, L), dtype=A.dtype)
        cols = np.zeros((n, L), dtype=np.int32)
        # Scatter each row's nonzeros into its padded slot.
        row_ids = np.repeat(np.arange(n), degrees)
        slot_ids = np.arange(A.nnz) - np.repeat(A.indptr[:-1], degrees)
        data[row_ids, slot_ids] = A.data
        cols[row_ids, slot_ids] = A.indices
        n_cols = 0 if A.shape[1] == n else int(A.shape[1])
        return cls(jnp.asarray(data), jnp.asarray(cols), int(A.nnz),
                   n_cols=n_cols)

    def tree_flatten(self):
        return (self.data, self.cols), (self.nnz_stored, self.n_cols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BandedOperator:
    """DIA-format operator for banded/stencil matrices.

    ``bands[d]`` holds the diagonal at ``offsets[d]`` stored full-length and
    aligned so that ``y += bands[d] * shift(x, offsets[d])`` — matvec is a
    handful of shifted elementwise multiply-adds that XLA fuses into one
    streaming pass: the cheapest encoding of the reference's tridiagonal
    ``laplace`` family.

    Convention: ``y[i] += bands[d][i] * x[i + offsets[d]]`` where out-of-range
    positions contribute zero (``bands`` is zero-padded there).
    """

    bands: jax.Array  # (k, n)
    offsets: tuple = dataclasses.field(metadata={"static": True})
    nnz_stored: int = dataclasses.field(metadata={"static": True})

    @property
    def shape(self):
        n = self.bands.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def nnz(self):
        return self.nnz_stored

    def matvec(self, x):
        n = x.shape[0]
        y = jnp.zeros(n, dtype=_result_dtype(self.dtype, x.dtype))
        for d, off in enumerate(self.offsets):
            if off == 0:
                y = y + self.bands[d] * x
            elif off > 0:
                shifted = jnp.concatenate([x[off:], jnp.zeros(off, x.dtype)])
                y = y + self.bands[d] * shifted
            else:
                shifted = jnp.concatenate([jnp.zeros(-off, x.dtype), x[:off]])
                y = y + self.bands[d] * shifted
        return y

    def matmat(self, X):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    @classmethod
    def from_scipy(cls, A, dtype=None):
        import scipy.sparse as sp

        assert A.shape[0] == A.shape[1], (
            "BandedOperator requires a square matrix; use the ELL format "
            "for rectangular sparse inputs")
        d = sp.dia_matrix(A)
        if dtype is not None:
            d = d.astype(dtype)
        n = d.shape[0]
        offsets = tuple(int(o) for o in d.offsets)
        bands = np.zeros((len(offsets), n), dtype=d.data.dtype)
        for k, off in enumerate(offsets):
            # scipy DIA stores data[k, i] as the entry at column i on that
            # diagonal, i.e. A[i - off, i]; our convention wants
            # bands[k][r] = A[r, r + off].
            diag = np.zeros(n, dtype=d.data.dtype)
            # scipy may store data narrower than n (trailing all-zero
            # columns trimmed) — clamp the copy to the stored width.
            W = d.data.shape[1]
            if off >= 0:
                m = min(n - off, max(W - off, 0))
                diag[:m] = d.data[k, off : off + m]
            else:
                m = min(n + off, W)
                diag[-off : -off + m] = d.data[k, : m]
            bands[k] = diag
        # count from the bands already built — a CSR conversion just for
        # nnz is an O(nnz) copy on every construction
        nnz = int(np.count_nonzero(bands))
        return cls(jnp.asarray(bands), offsets, nnz)

    def tree_flatten(self):
        return (self.bands,), (self.offsets, self.nnz_stored)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BsrOperator:
    """Block-sparse-row operator: dense ``r x c`` blocks at sparse block
    positions — the encoding for FE/mesh matrices whose natural nonzero
    pattern is small dense blocks.

    ``y_block[i] = sum_k blocks[k] @ x_block[block_cols[k]]`` for the blocks
    ``k`` in block-row ``i``; stored ELL-style with a fixed block budget per
    block-row, so every shape is static and the per-block work is a dense
    einsum (one gathered index per ``c`` columns instead of one per
    nonzero, as scalar ELL needs).
    """

    blocks: jax.Array      # (n_brow, L, r, c) dense blocks, zero-padded
    block_cols: jax.Array  # (n_brow, L) int32 block-column ids
    nnz_stored: int = dataclasses.field(metadata={"static": True})
    n_cols: int = 0        # true column count (pre block padding)
    n_rows: int = 0        # true row count

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def nnz(self):
        return self.nnz_stored

    @property
    def blockshape(self):
        return self.blocks.shape[2], self.blocks.shape[3]

    @property
    def row_granularity(self):
        # Mesh padding must keep whole block rows per shard.
        return self.blocks.shape[2]

    def matvec(self, x):
        r, c = self.blockshape
        n_bcol_pad = -(-self.n_cols // c) * c
        xp = jnp.zeros(n_bcol_pad, x.dtype).at[: self.n_cols].set(x)
        xb = xp.reshape(-1, c)                       # (n_bcol, c)
        gathered = jnp.take(xb, self.block_cols, axis=0)  # (n_brow, L, c)
        yb = jnp.einsum("blrc,blc->br", self.blocks, gathered,
                        precision=_PREC)             # (n_brow, r)
        return yb.reshape(-1)[: self.n_rows]

    def matmat(self, X):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    @classmethod
    def from_scipy(cls, A, blocksize=(8, 8), dtype=None):
        import scipy.sparse as sp

        r, c = blocksize
        n_rows, n_cols_true = A.shape
        pad_r = -(-n_rows // r) * r
        pad_c = -(-n_cols_true // c) * c
        coo = sp.coo_matrix(A)
        B = sp.coo_matrix(
            (coo.data, (coo.row, coo.col)), shape=(pad_r, pad_c)
        ).tobsr(blocksize=(r, c))
        if dtype is not None:
            B = B.astype(dtype)
        B.sum_duplicates()
        n_brow = B.indptr.shape[0] - 1
        degrees = np.diff(B.indptr)
        L = max(int(degrees.max(initial=0)), 1)
        _check_padded_layout("BSR", n_brow * L * r * c,
                             B.data.size, L, degrees)
        blocks = np.zeros((n_brow, L, r, c), dtype=B.data.dtype)
        cols = np.zeros((n_brow, L), dtype=np.int32)
        row_ids = np.repeat(np.arange(n_brow), degrees)
        slot_ids = np.arange(B.indices.shape[0]) - np.repeat(
            B.indptr[:-1], degrees)
        blocks[row_ids, slot_ids] = B.data
        cols[row_ids, slot_ids] = B.indices
        nnz_true = int(np.count_nonzero(coo.data))
        return cls(jnp.asarray(blocks), jnp.asarray(cols), nnz_true,
                   n_cols=int(A.shape[1]), n_rows=int(A.shape[0]))

    def tree_flatten(self):
        return (self.blocks, self.block_cols), (
            self.nnz_stored, self.n_cols, self.n_rows)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1], aux[2])


@jax.tree_util.register_pytree_node_class
class CallableOperator:
    """Wrap an arbitrary jittable matvec closure as an operator.

    ``fn_dw``, when given, is the double-word companion
    ``(xh, xl) -> (yh, yl)`` (float32 limb pairs) used by the dw
    refinement tier (``solvers/refine.py``) — e.g. the halo-exchange dw
    matvec from :func:`arnoldi_jax.parallel.halo_matvec_closure`.  Any
    cast-residual ("lo") correction must be folded inside the closure.
    """

    def __init__(self, fn, shape, dtype, nnz=None, fn_dw=None):
        self.fn = fn
        self.fn_dw = fn_dw
        self._shape = tuple(shape)
        self._dtype = jnp.dtype(dtype)
        self._nnz = nnz if nnz is not None else shape[0] * shape[1]

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def nnz(self):
        return self._nnz

    def matvec(self, x):
        return self.fn(x)

    def matvec_dw(self, xh, xl):
        if self.fn_dw is None:
            raise TypeError(
                "this CallableOperator has no double-word matvec (fn_dw); "
                "build it via halo_matvec_closure(..., op_lo=...) or use a "
                "format operator")
        return self.fn_dw(xh, xl)

    def matmat(self, X):
        return jax.vmap(self.fn, in_axes=1, out_axes=1)(X)

    def tree_flatten(self):
        return (), (self.fn, self._shape, self._dtype, self._nnz,
                    self.fn_dw)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], aux[2], aux[3], fn_dw=aux[4])


#: Union type for documentation purposes.  GramOperator is appended after
#: its definition below (it composes the format operators).
LinearOperator = (DenseOperator, EllOperator, BandedOperator, BsrOperator,
                  CallableOperator)


def rmatvec(op, y):
    """``A^H y`` for the format operators (dense/ELL/BSR/banded)."""
    if isinstance(op, DenseOperator):
        return jnp.matmul(op.A.conj().T, y, precision=_PREC)
    if isinstance(op, EllOperator):
        # scatter-add of y[r] * conj(data[r, l]) into cols[r, l]
        n = op.shape[1]
        contrib = (op.data.conj() * y[:, None]).reshape(-1)
        idx = op.cols.reshape(-1)
        return jnp.zeros(n, contrib.dtype).at[idx].add(contrib)
    if isinstance(op, BsrOperator):
        # Block scatter-add: x_block[cols[i,l]] += blocks[i,l]^H @ y_block[i]
        r, c = op.blockshape
        n_row_pad = op.blocks.shape[0] * r
        yp = jnp.zeros(n_row_pad, y.dtype).at[: op.shape[0]].set(y)
        yb = yp.reshape(-1, r)                       # (n_brow, r)
        contrib = jnp.einsum("blrc,br->blc", op.blocks.conj(), yb,
                             precision=_PREC)        # (n_brow, L, c)
        n_bcol = -(-op.shape[1] // c)
        out = jnp.zeros((n_bcol, c), contrib.dtype)
        out = out.at[op.block_cols.reshape(-1)].add(contrib.reshape(-1, c))
        return out.reshape(-1)[: op.shape[1]]
    if isinstance(op, BandedOperator):
        # (A^H y)[j] = sum_d conj(bands[d][j - off]) * y[j - off]
        n = op.shape[0]
        out = jnp.zeros(n, jnp.result_type(op.dtype, y.dtype))
        for d, off in enumerate(op.offsets):
            prod = op.bands[d].conj() * y
            if off == 0:
                out = out + prod
            elif off > 0:
                out = out.at[off:].add(prod[:-off])
            else:
                out = out.at[:off].add(prod[-off:])
        return out
    raise TypeError(
        f"adjoint matvec not implemented for {type(op).__name__}; "
        "wrap A with a CallableOperator providing the Gram matvec directly")


def rmatmat(op, Y):
    """``A^H Y`` column-wise."""
    if isinstance(op, DenseOperator):
        return jnp.matmul(op.A.conj().T, Y, precision=_PREC)
    return jax.vmap(lambda y: rmatvec(op, y), in_axes=1, out_axes=1)(Y)


@jax.tree_util.register_pytree_node_class
class GramOperator:
    """``A^H A`` (or ``A A^H`` when ``transposed``) as a FIRST-CLASS
    pytree operator over a format operator.

    The factor operators are pytree CHILDREN, so under ``jit`` their
    arrays are traced ARGUMENTS.  The previous closure-based Gram
    (``CallableOperator`` capturing the factors) embedded every captured
    array as an HLO CONSTANT — at 1M rows x 24 nnz that is ~400 MB of
    literals in the f32 program and ~4x that in the double-word one, which
    makes compilation slow and memory-hungry (constant folding).

    ``opT``/``lo``/``loT`` (optional) enable the double-word companion:
    the materialized adjoint operator and the two cast-residual
    operators (see ``solvers/svd.py::_gram_companions``).
    """

    def __init__(self, op, opT=None, lo=None, loT=None, *,
                 transposed=False, nnz=None):
        self.op = op
        self.opT = opT
        self.lo = lo
        self.loT = loT
        self.transposed = bool(transposed)
        self._nnz = nnz if nnz is not None else op.nnz

    @property
    def shape(self):
        d = self.op.shape[0] if self.transposed else self.op.shape[1]
        return (d, d)

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def nnz(self):
        return self._nnz

    @property
    def has_dw(self):
        """True when the double-word companion legs are present."""
        return self.opT is not None

    def matvec(self, x):
        # The adjoint leg prefers the MATERIALIZED transpose operator
        # when present: ``rmatvec`` is a scatter-add (conflicting writes),
        # while ``opT.matvec`` is the same gather kernel as the forward
        # leg.
        if self.transposed:      # A A^H
            z = (self.opT.matvec(x) if self.opT is not None
                 else rmatvec(self.op, x))
            return self.op.matvec(z)
        z = self.op.matvec(x)
        return (self.opT.matvec(z) if self.opT is not None
                else rmatvec(self.op, z))

    def matmat(self, X):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def matvec_dw(self, xh, xl):
        if self.opT is None:
            raise TypeError(
                "this GramOperator has no double-word companion (opT); "
                "build it with the adjoint + cast-residual operators")
        from .ops.df32_linop import dw_matvec

        if self.transposed:      # A A^H
            zh, zl = dw_matvec(self.opT, xh, xl, self.loT)
            return dw_matvec(self.op, zh, zl, self.lo)
        zh, zl = dw_matvec(self.op, xh, xl, self.lo)
        return dw_matvec(self.opT, zh, zl, self.loT)

    def tree_flatten(self):
        return ((self.op, self.opT, self.lo, self.loT),
                (self.transposed, self._nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        op, opT, lo, loT = children
        return cls(op, opT, lo, loT, transposed=aux[0], nnz=aux[1])


LinearOperator = LinearOperator + (GramOperator,)


def pad_operator(op, n_pad):
    """Zero-pad an operator to ``n_pad`` rows/columns.

    The padded operator acts as ``diag(A, 0)``: padding rows and columns are
    exactly zero, so a Krylov process started from a vector with zero padding
    keeps the padding identically zero and produces the same H as the
    unpadded problem.  Used to meet the mesh divisibility requirement
    (shard sizes must tile the row dimension exactly).
    """
    n = op.shape[0]
    if n_pad == n:
        return op
    assert n_pad > n
    extra = n_pad - n
    if isinstance(op, EllOperator):
        assert op.shape[0] == op.shape[1], "pad_operator expects square"
        data = jnp.vstack([op.data, jnp.zeros((extra, op.data.shape[1]), op.data.dtype)])
        cols = jnp.vstack([op.cols, jnp.zeros((extra, op.cols.shape[1]), op.cols.dtype)])
        return EllOperator(data, cols, op.nnz_stored)
    if isinstance(op, DenseOperator):
        A = op.A
        A = jnp.pad(A, ((0, extra), (0, extra)))
        return DenseOperator(A)
    if isinstance(op, BandedOperator):
        bands = jnp.pad(op.bands, ((0, 0), (0, extra)))
        return BandedOperator(bands, op.offsets, op.nnz_stored)
    if isinstance(op, BsrOperator):
        r, c = op.blockshape
        assert n_pad % r == 0, "pad to a multiple of the block size"
        new_brow = n_pad // r
        cur = op.blocks.shape[0]
        blocks = jnp.pad(op.blocks, ((0, new_brow - cur), (0, 0), (0, 0),
                                     (0, 0)))
        cols = jnp.pad(op.block_cols, ((0, new_brow - cur), (0, 0)))
        return BsrOperator(blocks, cols, op.nnz_stored, n_cols=n_pad,
                           n_rows=n_pad)
    raise TypeError(f"Cannot pad operator of type {type(op)}")


def cast_operator(op, dtype):
    """Cast an operator's stored VALUE arrays to ``dtype`` (identity when
    already there).  Sharding-preserving: ``astype`` keeps each array's
    placement.  A :class:`CallableOperator` cannot be cast — its closure
    owns the dtype — so that raises."""
    dt = jnp.dtype(dtype)
    if jnp.dtype(op.dtype) == dt:
        return op
    if isinstance(op, BandedOperator):
        return dataclasses.replace(op, bands=op.bands.astype(dt))
    if isinstance(op, EllOperator):
        return dataclasses.replace(op, data=op.data.astype(dt))
    if isinstance(op, BsrOperator):
        return dataclasses.replace(op, blocks=op.blocks.astype(dt))
    if isinstance(op, DenseOperator):
        return dataclasses.replace(op, A=op.A.astype(dt))
    raise TypeError(
        f"cannot cast a {type(op).__name__} (dtype {op.dtype}) to {dtype}; "
        "wrap a new closure at the wanted dtype instead")


#: Scattered sparsity goes to BSR-8 when its 8x8 blocks are this dense
#: (stored block entries per nonzero): on the H100, a 4M-row matrix of
#: dense 8x8 tiles (fill 1.28) ran its matvec 3.4x faster as BSR-8 than as
#: ELL in float64 and 11x faster in float32.  Scalar-scattered matrices
#: (fill >> 2) stay on ELL.
_BSR_MAX_FILL = 2.0


def _bsr8_fill(coo):
    """Stored entries of an 8x8 BSR layout per nonzero of ``coo``."""
    r = 8
    blocks = np.unique((coo.row // r).astype(np.int64)
                       * ((coo.shape[1] // r) + 2) + (coo.col // r)).size
    return blocks * r * r / max(coo.nnz, 1)


def as_operator(A, dtype=None, format=None):
    """Coerce ``A`` to a device operator.

    Accepts an existing operator, a NumPy/JAX dense array, any SciPy
    sparse matrix, or a SciPy ``LinearOperator``.  ``format`` forces
    'dense', 'ell', 'banded' or 'bsr' (``("bsr", (r, c))`` for another
    block shape); by default sparse inputs go to DIA when they are
    recognisably banded with few diagonals, to BSR-8 when their nonzeros
    come in dense 8x8 tiles, and to ELL otherwise.

    Every argument is HONOURED for every input kind: an existing operator
    is dtype-cast when ``dtype`` differs (see :func:`cast_operator`), and a
    ``format`` that contradicts the input raises rather than being
    silently ignored.
    """
    import scipy.sparse as sp

    if isinstance(A, LinearOperator):
        if format is not None:
            fmt = format[0] if isinstance(format, tuple) else format
            have = {DenseOperator: "dense", BandedOperator: "banded",
                    EllOperator: "ell", BsrOperator: "bsr"}.get(type(A))
            if have != fmt:
                raise ValueError(
                    f"as_operator(format={format!r}) on an existing "
                    f"{type(A).__name__}: operators are not re-formatted — "
                    "build from the scipy/dense source instead")
        if dtype is not None:
            A = cast_operator(A, dtype)
        return A
    if isinstance(A, (np.ndarray, jax.Array)):
        if format not in (None, "dense"):
            raise ValueError(
                f"format={format!r} is not available for dense array "
                "input; convert to scipy.sparse first")
        arr = jnp.asarray(A, dtype=dtype)
        return DenseOperator(arr)
    if sp.issparse(A):
        if format == "dense":
            return DenseOperator(jnp.asarray(A.todense(), dtype=dtype))
        if format == "banded":
            return BandedOperator.from_scipy(A, dtype=dtype)
        if format == "ell":
            return EllOperator.from_scipy(A, dtype=dtype)
        if format == "bsr" or (isinstance(format, tuple) and format[0] == "bsr"):
            bs = format[1] if isinstance(format, tuple) else (8, 8)
            return BsrOperator.from_scipy(A, blocksize=bs, dtype=dtype)
        if format is None:
            if A.shape[0] != A.shape[1]:
                # Rectangular: ELL only (the gather reads the full x by
                # stored column index, so any x length works)
                return EllOperator.from_scipy(A, dtype=dtype)
            # Heuristic: DIA when the matrix is a stencil (few distinct
            # diagonals). Probe via COO offsets without building DIA.
            coo = A.tocoo()
            n_diags = np.unique(coo.col.astype(np.int64) - coo.row).size
            if n_diags <= 16:
                return BandedOperator.from_scipy(A, dtype=dtype)
            if _bsr8_fill(coo) <= _BSR_MAX_FILL:
                return BsrOperator.from_scipy(A, blocksize=(8, 8),
                                              dtype=dtype)
            return EllOperator.from_scipy(A, dtype=dtype)
        raise ValueError(f"Unknown operator format {format!r}")
    from scipy.sparse.linalg import LinearOperator as _ScipyLinOp

    if isinstance(A, _ScipyLinOp):
        # scipy-parity surface: Minv/OPinv/operators are frequently scipy
        # LinearOperators.  The matvec is host code, reached through
        # pure_callback so the jitted expansion can call it; every matvec
        # then round-trips through host memory.
        n_out, n_in = A.shape
        op_dtype = jax.dtypes.canonicalize_dtype(
            np.dtype(dtype) if dtype is not None
            else (A.dtype if A.dtype is not None else np.float64))

        def _host_mv(x):
            return np.asarray(A.matvec(np.asarray(x))).astype(x.dtype)

        def _mv(x):
            return jax.pure_callback(
                _host_mv, jax.ShapeDtypeStruct((n_out,), x.dtype), x,
                vmap_method="sequential")

        return CallableOperator(_mv, (n_out, n_in), op_dtype)
    raise TypeError(f"Cannot convert {type(A)} to a linear operator")
