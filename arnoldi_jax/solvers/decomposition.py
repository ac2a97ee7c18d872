"""Arnoldi decomposition core (the hot loop) and Ritz extraction.

Semantics parity with the reference's ``src/arnoldi/decomposition.py``:

* :func:`arnoldi_expand` — extend an Arnoldi factorization ``(V, H)`` from
  ``start_dim`` to ``max_dim`` columns, maintaining the invariant
  ``A V_m = V_m H_m + h_{m+1,m} v_{m+1} e_m^H`` (reference
  ``decomposition.py:13-68``), with breakdown (invariant subspace) detection.
* :class:`RitzDecomposition` — Ritz values/vectors + approximate residuals
  ``|h_{m+1,m} * s_i[-1]|`` from the small projected eigenproblem
  (reference ``decomposition.py:71-146``).

Design (deliberately NOT the reference's mutable in-place API):

* The factorization state is an immutable pytree of fixed-shape arrays
  ``Vt: (m+1, n)`` (TRANSPOSED: basis vectors are contiguous rows — the
  reference's F-order observation, krylov_schur.py:40-42: contiguous,
  coalesced row streams) and
  ``H: (m+1, m)``; "length" is data, not shape.  The reference's
  early-return truncation on breakdown (``decomposition.py:61-63``) becomes
  a ``lax.while_loop`` exit with the reached dimension ``n_iter`` returned
  as a traced scalar.
* The whole expansion — matvec, masked Gram-Schmidt projection (two
  matmuls), Hessenberg column writes — is one jitted function; nothing
  round-trips to the host inside the loop.
* The projected ``m x m`` eigenproblem is solved on the host (it is tiny and
  LAPACK-shaped); only ``V_m @ S`` (tall matmul) runs on device.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..linop import as_operator
from ..ops.ortho import resolve_ortho
from ..utils.sorting import arg_largest_magnitude


def default_invariant_tol(dtype):
    """sqrt(eps) of the operator dtype — reference ``decomposition.py:41-42``
    (logic credited there to ArnoldiMethod.jl)."""
    return float(np.sqrt(np.finfo(np.dtype(dtype)).eps))


def _expand_window(op, Vt, H, invariant_tol, bj0, *, start, end, ortho_fn):
    """Expansion steps ``start..end`` on a (possibly row-sliced) workspace,
    threading the breakdown index ``bj0`` so segments compose.

    fori_loop with a STATIC trip count, not while_loop: XLA pipelines the
    fixed-count loop but cannot for a dynamic-exit loop (same results
    bit for bit).  Breakdown cannot exit early, so steps past the
    first breakdown run "dead": they write zeros and are excluded by the
    returned n_iter (breakdown is rare; the waste is bounded and only on
    that rare path).
    """
    mp1 = Vt.shape[0]
    rdtype = jnp.finfo(Vt.dtype).dtype

    def body_fn(j, state):
        Vt, H, bj = state
        dead = j >= bj
        v_j = lax.dynamic_slice_in_dim(Vt, j, 1, axis=0)[0]
        w = op.matvec(v_j).astype(Vt.dtype)
        h, w, beta, breakdown = ortho_fn(Vt, w, j + 1, tol=invariant_tol)
        # Column j of H: projection coefficients in rows 0..j, the coupling
        # coefficient beta at row j+1 (left at zero on breakdown, matching
        # the reference's truncated return where H[j+1, j] is never written).
        beta_entry = jnp.where(
            breakdown | dead, jnp.zeros((), rdtype), beta).astype(Vt.dtype)
        col = jnp.where(jnp.arange(mp1) == j + 1, beta_entry,
                        jnp.where(dead, jnp.zeros((), Vt.dtype), h))
        H = lax.dynamic_update_slice(H, col[:, None], (0, j))
        # Next basis vector: w / beta; the raw (near-zero) w on breakdown
        # (its coupling coefficient is zero so it never enters the
        # invariant); zeros on dead steps.
        safe_beta = jnp.where(beta > 0, beta, jnp.ones((), rdtype))
        v_next = jnp.where(dead, jnp.zeros_like(w),
                           jnp.where(breakdown, w, w / safe_beta))
        Vt = lax.dynamic_update_slice(Vt, v_next[None, :], (j + 1, 0))
        bj = jnp.where(breakdown & jnp.logical_not(dead), j + 1, bj)
        return Vt, H, bj

    return lax.fori_loop(start, end, body_fn, (Vt, H, bj0))


#: Segment width for the piecewise-static expansion (multiples of the f32
#: sublane tile).  Chosen so each segment's workspace slice stays
#: tile-aligned; the win is traffic: the masked CGS projections read the
#: whole sliced workspace, so slicing at segment boundaries makes the cost
#: of iteration j scale with ~roundup(j, SEG) instead of max_dim — close to
#: halving hot-loop HBM traffic over a full expansion.
_EXPAND_SEG = 16

#: Auto-segmentation threshold: below this row count the extra compiled
#: segments are not worth it.
_SEG_MIN_N = 32768


@partial(jax.jit, static_argnames=("start_dim", "max_dim", "ortho"))
def _expand_jit(op, Vt, H, invariant_tol, *, start_dim, max_dim, ortho):
    ortho_fn = resolve_ortho(ortho)
    Vt, H, bj = _expand_window(
        op, Vt, H, invariant_tol, jnp.asarray(max_dim + 1),
        start=start_dim, end=max_dim, ortho_fn=ortho_fn)
    return Vt, H, jnp.minimum(bj, max_dim)


@partial(jax.jit, static_argnames=("start_dim", "max_dim", "ortho", "seg"))
def _expand_segmented_jit(op, Vt, H, invariant_tol, *, start_dim, max_dim,
                          ortho, seg=_EXPAND_SEG):
    """Piecewise-static expansion: run the window in segments, each on a
    row-SLICED workspace, so the projection matmuls touch only the rows
    that can be active — one dispatch, several fori_loops in one program.
    Identical semantics to :func:`_expand_jit` (same masking and breakdown
    contract; results differ only at rounding level from the smaller
    reduction shapes)."""
    ortho_fn = resolve_ortho(ortho)
    bj = jnp.asarray(max_dim + 1)
    a = start_dim
    while a < max_dim:
        b_end = min((a // seg + 1) * seg, max_dim)
        rows = b_end + 1
        Vs, Hs, bj = _expand_window(
            op, Vt[:rows], H[:rows], invariant_tol, bj,
            start=a, end=b_end, ortho_fn=ortho_fn)
        Vt = Vt.at[:rows].set(Vs)
        H = H.at[:rows].set(Hs)
        a = b_end
    return Vt, H, jnp.minimum(bj, max_dim)


def _expand_auto(op, Vt, H, invariant_tol, *, start_dim, max_dim, ortho):
    """Dispatch to the segmented expansion when the problem is large enough
    for the traffic saving to dominate the extra compile cost."""
    if (Vt.shape[1] >= _SEG_MIN_N
            and max_dim - start_dim > _EXPAND_SEG
            and max_dim > 2 * _EXPAND_SEG):
        return _expand_segmented_jit(
            op, Vt, H, invariant_tol, start_dim=start_dim, max_dim=max_dim,
            ortho=ortho)
    return _expand_jit(op, Vt, H, invariant_tol, start_dim=start_dim,
                       max_dim=max_dim, ortho=ortho)


def _block_expand_window(op, Vt, H, invariant_tol, bj0, *, start_block,
                         end_block, b):
    """Block expansion steps ``start_block..end_block`` on a (possibly
    row-sliced) workspace, threading the breakdown block index."""
    from ..ops.ortho import block_cgs2

    mpb = Vt.shape[0]

    # Static-trip-count fori_loop (see _expand_window): steps at or past a
    # rank-deficient block run dead and leave the workspace untouched; the
    # factorization stays valid up to bj blocks.
    def body_fn(j, state):
        Vt, H, bj = state
        dead = j >= bj
        V_block = lax.dynamic_slice_in_dim(Vt, j * b, b, axis=0)  # (b, n)
        W = op.matmat(V_block.T).T.astype(Vt.dtype)
        C, Q, R, breakdown = block_cgs2(Vt, W, (j + 1) * b,
                                        tol=invariant_tol)
        skip = breakdown | dead
        row_ids = jnp.arange(mpb)[:, None]
        R_embedded = jnp.zeros((mpb, b), Vt.dtype)
        R_embedded = lax.dynamic_update_slice(R_embedded, R, ((j + 1) * b, 0))
        in_R = (row_ids >= (j + 1) * b) & (row_ids < (j + 2) * b)
        col_block = jnp.where(in_R, R_embedded, C)
        old_cols = lax.dynamic_slice(H, (0, j * b), (mpb, b))
        H = lax.dynamic_update_slice(
            H, jnp.where(skip, old_cols, col_block), (0, j * b))
        old_rows = lax.dynamic_slice(Vt, ((j + 1) * b, 0), (b, Vt.shape[1]))
        Vt = lax.dynamic_update_slice(
            Vt, jnp.where(skip, old_rows, Q), ((j + 1) * b, 0))
        bj = jnp.where(breakdown & jnp.logical_not(dead), j, bj)
        return Vt, H, bj

    return lax.fori_loop(start_block, end_block, body_fn, (Vt, H, bj0))


@partial(jax.jit, static_argnames=("start_block", "n_blocks", "b"))
def _block_expand_jit(op, Vt, H, invariant_tol, *, start_block, n_blocks, b):
    """Block Arnoldi expansion: process ``b`` vectors per step with one
    operator matmat + one :func:`arnoldi_jax.ops.ortho.block_cgs2` (two gemm
    projections + CholQR2).  Workspace ``Vt: (n_blocks*b + b, n)``,
    ``H: (n_blocks*b + b, n_blocks*b)``.  Block ``j`` occupies rows
    ``j*b..(j+1)*b``; on entry the block at ``start_block`` must hold
    orthonormal start vectors.  Returns ``(Vt, H, n_done_blocks)``.

    Auto-segments on large problems (see :func:`_expand_segmented_jit` —
    the block projections otherwise read the full workspace every step).
    """
    seg_blocks = max(_EXPAND_SEG // b, 2)
    if (Vt.shape[1] >= _SEG_MIN_N
            and n_blocks - start_block > seg_blocks
            and n_blocks > 2 * seg_blocks):
        bj = jnp.asarray(n_blocks + 1)
        a = start_block
        while a < n_blocks:
            e = min((a // seg_blocks + 1) * seg_blocks, n_blocks)
            rows = (e + 1) * b
            Vs, Hs, bj = _block_expand_window(
                op, Vt[:rows], H[:rows], invariant_tol, bj,
                start_block=a, end_block=e, b=b)
            Vt = Vt.at[:rows].set(Vs)
            H = H.at[:rows].set(Hs)
            a = e
        return Vt, H, jnp.minimum(bj, n_blocks)
    Vt, H, bj = _block_expand_window(
        op, Vt, H, invariant_tol, jnp.asarray(n_blocks + 1),
        start_block=start_block, end_block=n_blocks, b=b)
    return Vt, H, jnp.minimum(bj, n_blocks)


#: Ortho kernels the host tier mirrors (names shared with ops/ortho.py).
HOST_ORTHO = ("cgs_dgks", "cgs2", "mgs_dgks")


def host_arnoldi_expand(matvec, Vt, H, invariant_tol, *, start_dim, max_dim,
                        ortho="cgs_dgks"):
    """Host (NumPy/BLAS) Arnoldi expansion — same contract as
    :func:`arnoldi_expand` but on plain float64/complex128 ndarrays,
    mutating ``Vt``/``H`` in place and returning ``(Vt, H, n_iter)``.

    Below a few 10^4 rows the per-restart XLA dispatch overhead dominates
    the arithmetic (the reference's regime: mark(100) is n=5050, where
    ARPACK runs the whole solve in under 0.1 s), so the driver routes
    small problems here: two BLAS gemvs per iteration, no compilation, no
    device transfers.  Semantics match the device kernels: CGS with the
    DGKS criterion (eta = sqrt(1/2), one re-orthogonalization pass — or an
    unconditional second pass for ``cgs2``), breakdown when the
    post-orthogonalization norm drops below ``invariant_tol`` (the raw
    near-zero vector is stored with a zero coupling coefficient, as the
    masked device loop does).
    """
    from ..ops.ortho import M_SQRT1_2

    for j in range(start_dim, max_dim):
        w = matvec(Vt[j])
        Vj = Vt[: j + 1]
        if ortho == "mgs_dgks":
            beta_before = np.linalg.norm(w)
            c = np.zeros(j + 1, dtype=Vt.dtype)
            for i in range(j + 1):
                ci = np.vdot(Vj[i], w)
                w = w - ci * Vj[i]
                c[i] = ci
            beta = np.linalg.norm(w)
            if beta < M_SQRT1_2 * beta_before:
                for i in range(j + 1):
                    ci = np.vdot(Vj[i], w)
                    w = w - ci * Vj[i]
                    c[i] += ci
                beta = np.linalg.norm(w)
        else:
            # h_i = <v_i, w>: computed as conj(Vj @ conj(w)) so only the
            # (n,) vector is conjugated, never the (j+1, n) basis slab
            # (Vj.conj() materializes a copy every iteration — measured
            # ~35% of the whole host solve).
            cplx = np.iscomplexobj(Vt)
            beta_before = np.linalg.norm(w)
            c = np.conj(Vj @ np.conj(w)) if cplx else Vj @ w
            w = w - c @ Vj
            beta = np.linalg.norm(w)
            if ortho == "cgs2" or beta < M_SQRT1_2 * beta_before:
                c2 = np.conj(Vj @ np.conj(w)) if cplx else Vj @ w
                w = w - c2 @ Vj
                c = c + c2
                beta = np.linalg.norm(w)
        H[: j + 1, j] = c
        if beta < invariant_tol:
            H[j + 1, j] = 0.0
            Vt[j + 1] = w
            return Vt, H, j + 1
        H[j + 1, j] = beta
        Vt[j + 1] = w / beta
    return Vt, H, max_dim


def arnoldi_expand(A, Vt, H, invariant_tol=None, *, start_dim=0, max_dim=None,
                   ortho="cgs_dgks"):
    """Extend the Arnoldi factorization ``(Vt, H)`` of ``A``.

    Parameters
    ----------
    A : operator-like (see :func:`arnoldi_jax.linop.as_operator`).
    Vt : (m+1, n) TRANSPOSED basis workspace: row ``j`` is the j-th Krylov
        vector.  Rows ``0..start_dim`` valid (row ``start_dim`` is the next
        start vector, unit norm); the rest zero or stale (they are masked).
    H : (m+1, m) array, valid in the leading ``start_dim`` columns.
    invariant_tol : breakdown threshold; default ``sqrt(eps(A.dtype))``.
    start_dim, max_dim : static ints — extend rows ``start_dim..max_dim``.
    ortho : orthogonalization kernel name or callable
        (see ``arnoldi_jax.ops.ortho.ORTHO_KERNELS``).

    Returns
    -------
    Vt, H : updated arrays (same fixed shapes).
    n_iter : traced int scalar — reached dimension; ``< max_dim`` iff the
        expansion hit an invariant subspace ("happy breakdown").
    """
    op = as_operator(A)
    m = Vt.shape[0] - 1
    n = op.shape[0]
    assert op.shape[1] == n, "A is expected to be a square operator"
    assert Vt.shape == (m + 1, n), "Vt must be (m+1, n) transposed layout"
    assert H.shape == (m + 1, m), f"H must be {(m + 1, m)}, is {H.shape}"
    if max_dim is None:
        max_dim = m
    assert max_dim <= m, "max_dim > m violated"
    assert 0 <= start_dim <= max_dim

    if invariant_tol is None:
        invariant_tol = default_invariant_tol(op.dtype)

    rdtype = jnp.finfo(jnp.asarray(Vt).dtype).dtype
    return _expand_auto(
        op, jnp.asarray(Vt), jnp.asarray(H), jnp.asarray(invariant_tol, rdtype),
        start_dim=int(start_dim), max_dim=int(max_dim), ortho=ortho,
    )


def arnoldi_decomposition(A, V, H, invariant_tol=None, *, start_dim=0,
                          max_dim=None, ortho="cgs_dgks"):
    """Reference-signature driver (``decomposition.py:13-68``): takes and
    returns the reference's ``V: (n, m+1)`` orientation (transposing to the
    internal row layout), with host-truncated views
    ``(V[:, :n_iter+1], H[:n_iter+1, :n_iter], n_iter)`` so downstream
    host-tier code sees the same shapes as the reference API.
    """
    Vt = jnp.asarray(V).T
    Vt, H, n_iter_dev = arnoldi_expand(
        A, Vt, H, invariant_tol, start_dim=start_dim, max_dim=max_dim,
        ortho=ortho,
    )
    n_iter = int(n_iter_dev)
    return Vt[: n_iter + 1, :].T, H[: n_iter + 1, :n_iter], n_iter


@dataclasses.dataclass
class RitzDecomposition:
    """Ritz eigenpair approximations extracted from an Arnoldi factorization.

    Parity with reference ``decomposition.py:71-146``: ``values`` (host),
    ``vectors`` (device, (n, n_ritz)), and ``approximate_residuals``
    ``|h_{m+1,m} * s_i[-1]|`` — the residual identity
    ``||A u_i - lambda_i u_i|| = |h_{m+1,m}| |<e_m, s_i>|``.
    """

    values: np.ndarray
    vectors: jax.Array
    approximate_residuals: np.ndarray

    @classmethod
    def from_v_and_h(cls, V, H, n_ritz, *, max_dim=None, sort_function=None):
        """Extract ``n_ritz`` Ritz pairs from ``(V, H)``.

        ``V``/``H`` may be the full fixed-shape workspace with ``max_dim``
        giving the active length, or reference-style truncated arrays.
        """
        if max_dim is None:
            max_dim = V.shape[1] - 1
        return cls.from_vt_and_h(jnp.asarray(V).T, H, n_ritz,
                                 max_dim=max_dim,
                                 sort_function=sort_function)

    @classmethod
    def from_vt_and_h(cls, Vt, H, n_ritz, *, max_dim=None, sort_function=None):
        """Like :meth:`from_v_and_h` but taking the internal TRANSPOSED
        basis layout ``Vt: (m+1, n)`` (rows are Krylov vectors); the Ritz
        vectors are still returned column-oriented ``(n, n_ritz)``."""
        if max_dim is None:
            max_dim = Vt.shape[0] - 1
        assert H.shape[0] > max_dim
        assert H.shape[1] >= max_dim
        assert Vt.shape[0] > max_dim
        assert n_ritz <= max_dim
        if sort_function is None:
            sort_function = arg_largest_magnitude

        # Host dense tier always float64 (CLAUDE.md invariant): an f32
        # sgeev puts ~1e-6-relative noise on Ritz values AND the
        # approximate residuals, which poisons any convergence gate
        # tighter than ~1e-5.
        H_host = np.asarray(H)
        H_host = H_host.astype(
            np.complex128 if np.iscomplexobj(H_host) else np.float64)
        H_m = H_host[:max_dim, :max_dim]
        eigvals, eigvecs = np.linalg.eig(H_m)
        ind = np.asarray(sort_function(eigvals))[:n_ritz]
        S = eigvecs[:, ind]

        ritz_values = eigvals[ind]
        Vt_m = jnp.asarray(Vt)[:max_dim, :]
        if np.iscomplexobj(S) and not jnp.issubdtype(
            Vt_m.dtype, jnp.complexfloating
        ):
            vr = np.asarray(jnp.matmul(jnp.asarray(S.real.T, Vt_m.dtype),
                                       Vt_m,
                                       precision=jax.lax.Precision.HIGHEST))
            vi = np.asarray(jnp.matmul(jnp.asarray(S.imag.T, Vt_m.dtype),
                                       Vt_m,
                                       precision=jax.lax.Precision.HIGHEST))
            ritz_vectors = (vr + 1j * vi).T  # host (no complex basis copy)
        else:
            ritz_vectors = jnp.matmul(
                jnp.asarray(S.T, dtype=Vt_m.dtype), Vt_m,
                precision=jax.lax.Precision.HIGHEST,
            ).T

        approximate_residuals = np.abs(H_host[max_dim, max_dim - 1] * S[-1])
        return cls(ritz_values, ritz_vectors, approximate_residuals)

    def compute_true_residuals(self, A):
        """``res[i] = ||A v_i - lambda_i v_i||`` — requires matvecs with A
        (reference ``decomposition.py:134-146``)."""
        op = as_operator(A)
        vecs = self.vectors
        if np.iscomplexobj(vecs) and not np.issubdtype(
                np.dtype(op.dtype), np.complexfloating):
            # Host complex Ritz vectors over a REAL operator (the
            # real-basis path in from_vt_and_h): apply the real operator
            # to the real and imaginary parts separately (no complex
            # promotion of the operator) and recombine on the host.
            vecs = np.asarray(vecs)
            vr = np.asarray(op.matmat(jnp.asarray(vecs.real, op.dtype)))
            vi = np.asarray(op.matmat(jnp.asarray(vecs.imag, op.dtype)))
            AV = vr + 1j * vi
            return np.linalg.norm(AV - vecs * self.values[None, :], axis=0)
        AV = op.matmat(vecs)
        lam = jnp.asarray(self.values, dtype=AV.dtype)
        return np.asarray(jnp.linalg.norm(AV - self.vectors * lam[None, :], axis=0))
