"""Orthogonalization kernels (functional, jit/shard-friendly).

Semantics parity with the reference's ``src/arnoldi/ortho.py``:

* :func:`cgs_dgks` — classical Gram-Schmidt as two tall-skinny matmuls with
  the DGKS criterion (``beta < eta * beta_before`` with ``eta = sqrt(1/2)``)
  triggering exactly one re-orthogonalization pass (reference ``ortho.py:56-107``).
  The reference rationale holds even more strongly on an accelerator: CGS
  turns the projection into two matmuls against the whole basis, where MGS
  is an inherently sequential chain of m vector ops (Giraud/Langou/Rozložník
  2005).
* :func:`mgs_dgks` — modified Gram-Schmidt variant with the same DGKS-driven
  second pass (reference ``ortho.py:9-53``), kept for capability parity and
  for numerical cross-checks.

Design differences from the reference:

* No in-place mutation; kernels are pure functions returning
  ``(h, w_ortho, beta, breakdown)``.
* **Transposed basis layout**: the workspace is ``Vt: (m+1, n)`` — each
  basis vector is a CONTIGUOUS ROW.  This is the reference's own F-order
  observation (``krylov_schur.py:40-42``, "~3x performance increase"):
  row reads/writes of V are contiguous, coalesced streams.
* Static shapes: the number of *active* rows ``n_active`` is a traced
  integer and inactive rows are masked out of the projection, which lets
  the Arnoldi hot loop live inside ``lax.while_loop``.
* Projection matmuls request ``Precision.HIGHEST`` (a default-precision
  float32 product may run in TF32, which destroys orthogonality long
  before f32 eps).
"""

import math
from functools import partial

import jax.numpy as jnp
from jax import lax

#: DGKS re-orthogonalization threshold, eta = sqrt(1/2) (reference ortho.py:6).
M_SQRT1_2 = math.sqrt(0.5)

#: All projection matmuls run at HIGHEST precision.
_PREC = lax.Precision.HIGHEST


def _row_mask(mp1, n_active, dtype):
    return (jnp.arange(mp1) < n_active).astype(dtype)


def _norm(w):
    return jnp.linalg.norm(w)


def cgs_dgks(Vt, w, n_active, *, tol=1e-8, eta=M_SQRT1_2):
    """Classical Gram-Schmidt with DGKS-controlled re-orthogonalization.

    Orthogonalizes ``w`` against the first ``n_active`` ROWS of ``Vt``.

    Parameters
    ----------
    Vt : (m+1, n) array — transposed basis workspace; inactive rows masked.
    w : (n,) array — vector to orthogonalize.
    n_active : traced int — number of valid leading rows of ``Vt``.
    tol : breakdown threshold on the post-orthogonalization norm.
    eta : DGKS threshold.

    Returns
    -------
    h : (m+1,) array — projection coefficients (both passes summed), zero in
        inactive slots.
    w : (n,) array — the orthogonalized (NOT normalized) vector.
    beta : real scalar — ``||w||`` after orthogonalization.
    breakdown : bool scalar — ``beta < tol``.
    """
    mp1 = Vt.shape[0]
    mask = _row_mask(mp1, n_active, Vt.dtype)

    def project(w):
        # h_i = <v_i, w> = conj(Vt[i, :]) . w  — one (m+1, n) x (n,) matmul
        # over contiguous rows, then the rank-(m+1) update w -= sum h_i v_i.
        c = jnp.matmul(Vt.conj(), w, precision=_PREC) * mask
        return c, w - jnp.matmul(c, Vt, precision=_PREC)

    beta_before = _norm(w)
    c1, w1 = project(w)
    beta1 = _norm(w1)

    def second_pass(args):
        c1, w1, _ = args
        c2, w2 = project(w1)
        return c1 + c2, w2, _norm(w2)

    h, w2, beta = lax.cond(
        beta1 < eta * beta_before,
        second_pass,
        lambda args: args,
        (c1, w1, beta1),
    )
    return h, w2, beta, beta < tol


def mgs_dgks(Vt, w, n_active, *, tol=1e-8, eta=M_SQRT1_2):
    """Modified Gram-Schmidt with DGKS-controlled second pass.

    Same contract as :func:`cgs_dgks`.  Sequential over basis vectors —
    kept for parity and cross-validation; prefer :func:`cgs_dgks`.
    """
    mp1 = Vt.shape[0]

    def one_pass(w):
        def body(i, carry):
            w, h = carry
            active = i < n_active
            v_i = lax.dynamic_slice_in_dim(Vt, i, 1, axis=0)[0]
            c = jnp.where(
                active,
                jnp.vdot(v_i, w, precision=_PREC),
                jnp.zeros((), Vt.dtype),
            )
            return w - c * v_i, h.at[i].set(c)

        return lax.fori_loop(0, mp1, body, (w, jnp.zeros(mp1, Vt.dtype)))

    beta_before = _norm(w)
    w1, h1 = one_pass(w)
    beta1 = _norm(w1)

    def second_pass(args):
        h1, w1, _ = args
        w2, h2 = one_pass(w1)
        return h1 + h2, w2, _norm(w2)

    h, w2, beta = lax.cond(
        beta1 < eta * beta_before,
        second_pass,
        lambda args: args,
        (h1, w1, beta1),
    )
    return h, w2, beta, beta < tol


def block_cgs2(Vt, W, n_active, *, tol=1e-8):
    """Block classical Gram-Schmidt (two passes) + CholQR2 intra-block
    orthonormalization.

    Orthogonalizes the b row-vectors of ``W`` against the first ``n_active``
    rows of ``Vt`` with TWO block projections (each one gemm pair — the
    communication-avoiding structure from the two-stage block
    orthogonalization literature), then orthonormalizes within the block by
    Cholesky-QR applied twice ("CholQR2"), which is entirely gemm/chol on
    tiny b x b matrices — the matmul-shaped replacement for column-at-a-time
    Householder.

    Parameters
    ----------
    Vt : (m+b, n) transposed basis workspace.
    W : (b, n) block to orthogonalize (rows are vectors).
    n_active : traced int — valid leading rows of ``Vt``.

    Returns
    -------
    C : (m+b, b) projection coefficients (both passes summed; column j are
        the coefficients of W's j-th vector against the basis).
    Q : (b, n) orthonormalized block.
    R : (b, b) upper-triangular intra-block coupling (W_proj = R^T-stacked:
        in column convention ``W_cols = Q_cols @ R``).
    breakdown : bool scalar — the block was (numerically) rank deficient.
    """
    from jax.scipy.linalg import cholesky, solve_triangular

    mp = Vt.shape[0]
    b = W.shape[0]
    mask = _row_mask(mp, n_active, Vt.dtype)[:, None]

    def project(W):
        C = jnp.matmul(Vt.conj(), W.T, precision=_PREC) * mask  # (mp, b)
        return C, W - jnp.matmul(C.T, Vt, precision=_PREC)

    C1, W = project(W)
    C2, W = project(W)
    C = C1 + C2

    eps = jnp.finfo(Vt.dtype).eps

    def cholqr(W):
        G = jnp.matmul(W, W.conj().T, precision=_PREC)  # (b, b)
        # Regularize so cholesky never NaNs on a rank-deficient block; the
        # breakdown flag is raised from the diagonal magnitude instead.
        # The shift scale is RELATIVE to the block's own magnitude (floored
        # only at tiny to keep an exactly-zero block finite): an absolute
        # floor of 1.0 made the shift dominate any SMALL residual block
        # (row norms ~1e-7 in f32), returning a non-normalized Q with the
        # breakdown flag unraised — the block analog of the scalar path's
        # exact w/beta normalization must handle small-but-healthy blocks.
        scale = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(G))),
                            jnp.finfo(Vt.dtype).tiny)
        L = cholesky(G + (eps * scale) * jnp.eye(b, dtype=Vt.dtype),
                     lower=True)
        Q = solve_triangular(L, W, lower=True)
        return Q, L

    Q, L1 = cholqr(W)
    Q, L2 = cholqr(Q)  # CholQR2: second pass restores orthonormality
    # Row convention: W_proj = (L1 L2) Q, i.e. W_cols = Q_cols (L1 L2)^T —
    # a plain transpose (no conjugation) even for complex blocks.
    R = jnp.matmul(L1, L2, precision=_PREC).T  # upper (b, b)

    diag = jnp.abs(jnp.diagonal(L1))
    # Rank deficiency: a diagonal entry collapsed either below the absolute
    # tolerance or relative to the block's own scale (the chol
    # regularization floors it near sqrt(eps * scale), so the relative test
    # is what actually detects dependent directions).  A non-finite
    # diagonal (an f32 cholesky can return NaN on a rank-deficient Gram
    # despite the shift) must read as breakdown, not fail-open through a
    # False comparison.
    rel_floor = 10.0 * jnp.sqrt(eps) * jnp.max(diag)
    breakdown = (jnp.min(diag) < jnp.maximum(tol, rel_floor)
                 ) | ~jnp.all(jnp.isfinite(diag))
    return C, Q, R, breakdown


def cgs2(Vt, w, n_active, *, tol=1e-8, eta=None):
    """Unconditional twice-is-enough classical Gram-Schmidt.

    The recommended kernel at float32.  Straight-line code (no
    ``lax.cond``): both passes always run, which is both the numerically
    robust choice at low precision and cheaper than a conditional second
    pass whose predicate is almost always true.
    """
    mp1 = Vt.shape[0]
    mask = _row_mask(mp1, n_active, Vt.dtype)

    c1 = jnp.matmul(Vt.conj(), w, precision=_PREC) * mask
    w = w - jnp.matmul(c1, Vt, precision=_PREC)
    c2 = jnp.matmul(Vt.conj(), w, precision=_PREC) * mask
    w = w - jnp.matmul(c2, Vt, precision=_PREC)
    beta = _norm(w)
    return c1 + c2, w, beta, beta < tol


#: Registry used by solver drivers ("ortho" kwarg).
ORTHO_KERNELS = {
    "cgs_dgks": cgs_dgks,
    "mgs_dgks": mgs_dgks,
    # CGS2: unconditional double orthogonalization ("twice is enough") — the
    # recommended kernel at float32, where a single pass may lose
    # orthogonality faster than at the reference's complex128.
    "cgs2": cgs2,
    "cgs": partial(cgs_dgks, eta=0.0),
    "mgs": partial(mgs_dgks, eta=0.0),
}


def resolve_ortho(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return ORTHO_KERNELS[name_or_fn]
    except KeyError:
        raise ValueError(
            f"Unknown orthogonalization kernel {name_or_fn!r}; expected one of "
            f"{sorted(ORTHO_KERNELS)} or a callable"
        ) from None
