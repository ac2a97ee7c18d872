"""Partial SVD via thick-restart Lanczos (``svds``).

scipy.sparse.linalg.svds-compatible: the largest (``which='LM'``) or
smallest (``which='SM'``) ``k`` singular triplets of a rectangular
operator.  Built entirely from existing framework pieces: Lanczos runs on
the Gram operator over the *smaller* dimension — ``A^H A`` when ``A`` is
tall, ``A A^H`` when ``A`` is wide (the internal-transpose trick the
reference's scipy comparison path relies on) — with one extra matvec per
iteration and no explicit Gram matrix.  Singular values are
``sqrt(theta)``; the missing singular-vector side is recovered as
``A v / sigma`` (or ``A^H u / sigma``).
"""

import numpy as np

import jax
import jax.numpy as jnp

from ..linop import (CallableOperator, GramOperator, as_operator,
                     rmatmat as _rmatmat, rmatvec as _rmatvec)

__all__ = ["svds", "gram_companions"]

_PREC = jax.lax.Precision.HIGHEST


def svds(A, k=6, *, which="LM", sigma=None, tol=None, ncv=None,
         maxiter=1000, dtype=None, key=None, v0=None, block_size=1,
         inner_solver="gmres", inner_tol=None,
         return_singular_vectors=True, return_history=False,
         companions=None):
    """Compute ``k`` singular triplets of ``A`` (any shape; wide matrices
    are handled by running Lanczos on ``A A^H`` internally).

    Returns ``(U, s, Vh)`` like scipy.sparse.linalg.svds (with ``s``
    ascending), or just ``s`` when ``return_singular_vectors=False``.
    ``which='LM'`` selects the largest singular values, ``'SM'`` the
    smallest.  ``sigma`` (an extension over scipy's svds, which has no
    shift-invert surface at all — MATLAB-svds-style) selects the ``k``
    singular values NEAREST ``sigma``: shift-invert Lanczos on the Gram
    operator at ``sigma**2`` converges a buffered set (k + max(2, k//2)
    values, nearest in the SQUARED domain), from which the k nearest in
    the linear domain are selected — the two orderings can disagree near
    the cut because |s^2 - sigma^2| overweights values above sigma (an
    adversarial spectrum could in principle need a larger buffer; pass a
    larger ``k`` and slice if that matters).  The inner solve is an
    iterative Krylov solve (``inner_solver``, default GMRES — the shifted
    Gram is indefinite), so small-end spectra no longer need the slow
    direct ``which='SM'`` iteration.  ``v0`` is the scipy start vector of length
    ``min(A.shape)`` (the Gram dimension).
    """
    if which not in ("LM", "SM"):
        raise ValueError(
            f"which={which!r}: expected 'LM' (largest) or 'SM' (smallest)")

    from ..utils.profiling import phase_clock

    clock = phase_clock()     # no-op unless ARNOLDI_PHASES is set
    # Operator construction is real wall time at scale — format packing +
    # device upload for A, its materialized adjoint, and two cast-residual
    # companions is ~4x the matrix bytes.  Repeated solves on the same matrix
    # should PREBUILD: pass ``A`` as an operator (``as_operator``) and
    # ``companions=gram_companions(A_src, op)`` — then this section costs
    # nothing per call (same pattern as partial_schur's refine_op_lo).
    with clock("svds.operator_build"):
        op = as_operator(A, dtype=dtype)
        n_rows, n_cols = op.shape
        # Lanczos runs on the Gram operator over the smaller dimension.
        # GramOperator is a pytree (factor arrays are jit ARGUMENTS): a
        # closure-based Gram would embed the operator data as HLO
        # constants — hundreds of MB at 1M rows, which broke the remote
        # compile (r05).
        transposed = n_rows < n_cols
        gram_dim = n_rows if transposed else n_cols
        if companions is None:
            companions = gram_companions(A, op) or (None, None, None)
        gram = GramOperator(op, *companions, transposed=transposed,
                            nnz=op.nnz)

    from .lanczos import partial_eigh

    eig_which = "LA" if which == "LM" else "SA"
    if v0 is not None:
        v0 = np.asarray(v0)
        assert v0.shape == (gram_dim,), (v0.shape, gram_dim)
    if sigma is not None:
        # Shift-invert on the Gram operator: Gram eigenvalues are
        # sigma_i^2, so singular values nearest |sigma| are Gram
        # eigenvalues nearest sigma^2.  The transformed problem is solved
        # for its LARGEST eigenvalues (nu = 1/(theta - sigma^2)) and
        # back-transformed.
        from .spectral_transform import (_transform_back,
                                         shift_invert_operator)

        sig2 = float(np.real(sigma)) ** 2
        if tol is None:
            tol = float(np.sqrt(np.finfo(op.dtype).eps))
        itol = inner_tol if inner_tol is not None else tol * 1e-2
        si = shift_invert_operator(gram, sig2, solver=inner_solver,
                                   inner_tol=itol, dtype=dtype)
        # "Nearest sigma" is a LINEAR-domain metric, but shift-invert on
        # the Gram operator converges by |sigma_i^2 - sigma^2| =
        # |sigma_i - sigma| * (sigma_i + sigma), which overweights values
        # ABOVE sigma; the two orderings can disagree near the cut.  Solve
        # a buffered set in the Gram domain, then select the k nearest
        # |sigma| linearly.
        kk = k + max(2, k // 2)
        if ncv is not None:
            kk = min(kk, ncv - 1)
        kk = max(k, min(kk, gram_dim - 1))
        nu, W, hist = partial_eigh(
            si, kk, which="LM", max_dim=ncv, stopping_criterion=tol,
            max_restarts=maxiter, dtype=dtype, key=key, v0=v0,
            block_size=block_size,
        )
        theta = np.asarray(_transform_back(np.asarray(nu), sig2)).real
        if kk > k:
            sv_lin = np.sqrt(np.maximum(theta, 0.0))
            pick = np.argsort(np.abs(sv_lin - abs(float(np.real(sigma)))),
                              kind="stable")[:k]
            theta = theta[pick]
            W = np.asarray(W)[:, pick]
    else:
        theta, W, hist = partial_eigh(
            gram, k, which=eig_which, max_dim=ncv, stopping_criterion=tol,
            max_restarts=maxiter, dtype=dtype, key=key, v0=v0,
            block_size=block_size,
        )
    theta = np.maximum(np.asarray(theta), 0.0)
    order = np.argsort(theta)  # scipy returns ascending singular values
    s = np.sqrt(theta[order])
    if not return_singular_vectors:
        if hist is not None:
            hist.phases = {**(hist.phases or {}), **clock.report()}
        return (s, hist) if return_history else s

    with clock("svds.w_upload"):
        W = jnp.asarray(W)[:, jnp.asarray(order)]
    safe = np.where(s == 0, 1.0, s)
    with clock("svds.recover_side"):
        if transposed:
            # gram = A A^H: W holds left singular vectors; V = A^H U / s.
            U = W
            adj = (gram.opT.matmat(U) if gram.opT is not None
                   else _rmatmat(op, U))
            V = adj / jnp.asarray(safe, U.dtype)[None, :]
            V = _renormalize(V)
        else:
            # gram = A^H A: W holds right singular vectors; U = A V / s.
            V = W
            U = op.matmat(V) / jnp.asarray(safe, V.dtype)[None, :]
            U = _renormalize(U)
    with clock("svds.uv_pull"):
        out = (np.asarray(U), s, np.asarray(V).conj().T)
    if hist is not None:
        hist.phases = {**(hist.phases or {}), **clock.report()}
    # ``return_history=True`` appends the inner Lanczos History (matvec/
    # restart counts, residual trace, ARNOLDI_PHASES stopwatch) — the
    # scipy-compatible 3-tuple stays the default.
    return out + (hist,) if return_history else out


def gram_companions(A_src, op):
    """Companion operators enabling the Gram's double-word action
    (``GramOperator.matvec_dw``), so ``partial_eigh``'s dw refinement can
    engage for ``svds`` tolerances below the f32 floor.

    The adjoint leg is a MATERIALIZED ``A^H`` operator in a device format
    with its own cast residual (a compensated scatter-add adjoint per
    format would duplicate every df32 kernel; a host transpose is one
    cheap conversion at build time).  Returns ``(opT, lo, loT)``, or None
    when ``A_src`` carries no exact f64 source (closure input) or the
    work dtype is not f32 — then the f32 Gram is the exact target and
    refinement has nothing to recover.
    """
    import scipy.sparse as sp

    from .refine import build_cast_residual_operator

    if np.dtype(op.dtype) != np.float32:
        return None
    if sp.issparse(A_src):
        At = sp.csr_matrix(A_src).conj().T.tocsr()
    elif isinstance(A_src, np.ndarray):
        At = np.ascontiguousarray(A_src.conj().T)
    else:
        return None
    try:
        opT = as_operator(At, dtype=np.float32)
    except ValueError as e:
        # The adjoint can be unbuildable in any padded device format even
        # when A itself is fine (a few super-dense COLUMNS of A become
        # super-dense ROWS of A^H — linop._check_padded_layout).  Without
        # the companion the f32 Gram is the refinement target; warn so a
        # tol below the f32 floor fails loudly for a known reason.
        import warnings

        warnings.warn(
            "svds: no device layout for the adjoint operator — double-word "
            f"refinement disabled, f32-floor accuracy only ({e})",
            RuntimeWarning, stacklevel=3)
        return None
    lo = build_cast_residual_operator(A_src, op)
    loT = build_cast_residual_operator(At, opT)
    return opT, lo, loT


def _renormalize(X):
    """Unit-normalize columns (guards tiny-sigma roundoff; a zero column —
    exact null-space direction recovered with sigma=0 — is left as-is)."""
    norms = jnp.linalg.norm(X, axis=0)
    return X / jnp.where(norms == 0, 1.0, norms)[None, :]


