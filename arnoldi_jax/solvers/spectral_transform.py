"""Spectral transformations: shift-invert and scipy-compatible wrappers.

The reference exposes only direct (untransformed) iterations; ARPACK's
``sigma`` (shift-invert) mode is what makes interior and smallest-magnitude
eigenvalues practical.  Here the transformation is built from the
framework's own pieces: the matvec of ``(A - sigma I)^{-1}`` is an inner
Krylov solve (jax.scipy BiCGStab/GMRES/CG — jittable, runs on the device
and through shardings), wrapped as a :class:`CallableOperator` that the outer
Arnoldi consumes unchanged.  Eigenvalues transform back as
``lambda = sigma + 1/theta``.

:func:`eigs` / :func:`eigsh` mirror ``scipy.sparse.linalg`` signatures so a
SciPy/ARPACK user can switch drivers without relearning an API.
"""

import numpy as np

import jax
import jax.numpy as jnp

from ..linop import CallableOperator, as_operator
from ..utils.sorting import sort_function_for

__all__ = ["shift_invert_operator", "generalized_operator",
           "realify_operator", "eigs", "eigs_realified", "eigsh"]


class InnerSolveStats:
    """Mutable inner-solve accounting attached to shift-invert operators
    (surfaced so History-style convergence reporting can include the inner
    work; the reference has no shift-invert at all)."""

    def __init__(self):
        self.solves = 0
        self.inner_matvecs = 0

    def __repr__(self):
        return (f"InnerSolveStats(solves={self.solves}, "
                f"inner_matvecs={self.inner_matvecs})")


def _splu_inverse(A, sigma, dtype, stats):
    """Host sparse-LU inner solver: ``(A - sigma I)^{-1}`` by a one-time
    scipy ``splu`` factorization reached through ``jax.pure_callback`` —
    ARPACK's standard shift-invert strategy, and the robust choice for
    INDEFINITE shifts where unpreconditioned BiCGStab stalls.  The
    factorization lives on the host (CPU-resident operators); the solve is
    performed in float64 regardless of the device dtype."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    if sp.issparse(A):
        A_h = sp.csc_matrix(A)
    else:
        A_h = sp.csc_matrix(np.asarray(A))
    if np.iscomplexobj(sigma) and not np.issubdtype(A_h.dtype,
                                                    np.complexfloating):
        A_h = A_h.astype(np.complex128)
    complex_lu = np.issubdtype(A_h.dtype, np.complexfloating) \
        or np.iscomplexobj(sigma)
    hp = np.complex128 if complex_lu else np.float64
    shifted = (A_h.astype(hp) - sigma * sp.identity(A_h.shape[0], dtype=hp,
                                                    format="csc")).tocsc()
    lu = splu(shifted)
    n = A_h.shape[0]
    op_dtype = jax.dtypes.canonicalize_dtype(
        np.dtype(dtype) if dtype is not None else A_h.dtype)

    def host_solve(b):
        if stats is not None:
            stats.solves += 1
        b = np.asarray(b)
        if np.iscomplexobj(b) and not complex_lu:
            # Real factorization, complex right-hand side (the complex128
            # outer solver on CPU): solve the parts separately.
            x = (lu.solve(b.real.astype(np.float64))
                 + 1j * lu.solve(b.imag.astype(np.float64)))
        else:
            x = lu.solve(b.astype(hp))
        return x.astype(b.dtype)

    def inv_mv(b):
        return jax.pure_callback(
            host_solve, jax.ShapeDtypeStruct((n,), b.dtype), b,
            vmap_method="sequential")

    return CallableOperator(inv_mv, (n, n), op_dtype, nnz=int(A_h.nnz))


def shift_invert_operator(A, sigma, *, solver="bicgstab", inner_tol=1e-10,
                          maxiter=2000, M=None, dtype=None,
                          count_inner=False):
    """Wrap ``(A - sigma I)^{-1}`` as an operator.

    Parameters
    ----------
    A : operator-like (for ``solver='splu'``: a SciPy sparse matrix or
        dense array, factorized once on the host).
    sigma : real or complex shift.
    solver : "bicgstab" (general), "gmres" (robust for indefinite shifts),
        "cg" (Hermitian definite), or "splu" (host sparse LU through
        ``pure_callback`` — ARPACK's standard, exact to f64).
    inner_tol, maxiter : inner-solve controls (iterative solvers).  The
        inner tolerance must be a couple of digits tighter than the outer
        eigensolver tolerance.
    M : optional preconditioner operator (iterative solvers).
    count_inner : attach an :class:`InnerSolveStats` as ``.inner_stats``
        on the returned operator, counting inner solves and (for the
        iterative solvers, via a host callback per application) inner
        matvecs.

    Returns a :class:`CallableOperator`; when ``count_inner`` (or always
    for ``splu``) it carries ``.inner_stats``.
    """
    stats = InnerSolveStats() if (count_inner or solver == "splu") else None
    if solver == "splu":
        si_op = _splu_inverse(A, np.asarray(sigma).item(), dtype, stats)
        si_op.inner_stats = stats
        return si_op

    op = as_operator(A, dtype=dtype)
    n = op.shape[0]
    sigma = np.asarray(sigma).item()  # keeps complex shifts complex

    from jax.scipy.sparse.linalg import bicgstab, cg, gmres

    solvers = {"bicgstab": bicgstab, "cg": cg, "gmres": gmres}
    if solver not in solvers:
        raise ValueError(
            f"Unknown inner solver {solver!r}; expected one of "
            f"{sorted(solvers) + ['splu']}")
    solve_fn = solvers[solver]

    def shifted_mv(x):
        if stats is not None:
            jax.debug.callback(_count_inner_mv, stats)
        return op.matvec(x) - sigma * x

    # Restarted GMRES stagnates on indefinite systems with the default
    # tiny restart window; widen it (the basis is still small vs n).
    extra = {"restart": 80} if solver == "gmres" else {}

    def inv_mv(b):
        if stats is not None:
            # host callback, NOT a Python increment: inv_mv runs inside
            # the jitted outer expansion, so a plain += would count traces
            # (1-2), not solves (hundreds).  Same mechanism and same
            # CPU-only caveat as the inner-matvec counter.
            jax.debug.callback(_count_inner_solve, stats)
        x, _ = solve_fn(shifted_mv, b, tol=inner_tol, maxiter=maxiter,
                        M=M.matvec if M is not None else None, **extra)
        return x

    si_op = CallableOperator(inv_mv, (n, n), op.dtype, nnz=op.nnz)
    si_op.inner_stats = stats
    return si_op


def _count_inner_mv(stats):
    stats.inner_matvecs += 1


def _count_inner_solve(stats):
    stats.solves += 1


def _transform_back(theta, sigma, mode="normal"):
    if mode == "buckling":
        return sigma * theta / (theta - 1.0)
    if mode == "cayley":
        return sigma * (theta + 1.0) / (theta - 1.0)
    return sigma + 1.0 / theta


def realify_operator(A, dtype=None):
    """Real 2n x 2n representation of a COMPLEX operator, so a complex
    problem can run on the real-arithmetic path (real float32 plus the
    double-word continuation, or real float64).

    ``R = [[Ar, -Ai], [Ai, Ar]]`` acting on stacked ``[Re x; Im x]``.  Its
    spectrum is the spectrum of A together with its conjugates: each
    eigenvalue of A appears as a real-Schur 2x2 block (or twice when real),
    and a complex eigenvector ``w = [w1; w2]`` of R for eigenvalue lambda
    recovers A's eigenvector as ``z = w1``.  The real Krylov-Schur driver
    then runs the whole problem in real arithmetic.
    """
    # Never materialize the complex operator on device: inspect the host
    # dtype and split host-side.
    import scipy.sparse as sp

    a_dtype = getattr(A, "dtype", None)
    if a_dtype is None:
        a_dtype = np.asarray(A).dtype
    if not np.issubdtype(np.dtype(a_dtype), np.complexfloating):
        raise TypeError("realify_operator expects a complex operator")
    n = A.shape[0]

    rdt = None
    if dtype is not None:
        d = np.dtype(dtype)
        rdt = np.finfo(d).dtype if np.issubdtype(d, np.complexfloating) else d
    if sp.issparse(A):
        C = sp.csr_matrix(A)
        Ar = as_operator(C.real.tocsr(), dtype=rdt)
        Ai = as_operator(C.imag.tocsr(), dtype=rdt)
    else:
        M = np.asarray(A)
        Ar = as_operator(np.ascontiguousarray(M.real), dtype=rdt)
        Ai = as_operator(np.ascontiguousarray(M.imag), dtype=rdt)
    nnz = Ar.nnz + Ai.nnz

    def mv(u):
        x, y = u[:n], u[n:]
        return jnp.concatenate([
            Ar.matvec(x) - Ai.matvec(y),
            Ai.matvec(x) + Ar.matvec(y),
        ])

    return CallableOperator(mv, (2 * n, 2 * n), Ar.dtype, nnz=nnz)


def eigs_realified(A, k=6, *, which="LM", tol=None, ncv=None, maxiter=1000,
                   dtype=None, ortho="cgs_dgks", key=None, v0=None,
                   block_size=2, return_eigenvectors=True):
    """Eigenpairs of a COMPLEX matrix computed entirely in real arithmetic
    via :func:`realify_operator`.

    The doubled spectrum (lambda and conj(lambda)) is deduplicated by
    keeping one representative per conjugate-related pair (the one whose
    eigenvector best reproduces a distinct eigenpair); because conjugation
    doubles multiplicities, 2k Schur pairs are solved internally.
    """
    from .krylov_schur import eigenpairs_from_partial_schur, partial_schur

    if which not in ("LM", "LR", "SM", "SR"):
        raise NotImplementedError(
            f"which={which!r} is not conjugation-invariant: the realified "
            "spectrum contains conj(lambda) copies that would displace the "
            "wanted set; use LM/LR/SM/SR, or run on CPU with the complex "
            "path")
    R = realify_operator(A, dtype=dtype)
    n = R.shape[0] // 2
    sort_function = sort_function_for(which)
    if v0 is not None:
        # A complex start z maps to its real 2n representation [Re z; Im z]
        # (z = w1 + i w2 convention of realify_operator).
        v0 = np.asarray(v0)
        assert v0.shape == (n,), (v0.shape, n)
        v0 = np.concatenate([np.real(v0), np.imag(v0)])

    # nev doubles (lambda + conj copies share the sort rank for the
    # conjugation-invariant criteria above), so the Krylov dimension must
    # scale with it.
    # The real representation doubles every multiplicity (lambda appears
    # with its conjugate-pair 2x2 block structure), so a block size >= 2 is
    # structurally right — it also lets genuine multiplicities of A surface,
    # which a single-vector Krylov space cannot.
    Q, T, hist = partial_schur(
        R, 2 * k, max_dim=2 * ncv if ncv else None, stopping_criterion=tol,
        sort_function=sort_function, max_restarts=maxiter, ortho=ortho,
        key=key, v0=v0, block_size=block_size,
    )
    vals2, vecs2 = eigenpairs_from_partial_schur(Q, T)
    vals2 = np.asarray(vals2)
    vecs2 = np.asarray(vecs2)

    # Extraction + conjugate-copy rejection: for any real-representation
    # eigenpair (lambda, [w1; w2]), z = w1 + i w2 satisfies A z = lambda z
    # when lambda belongs to A's spectrum, and is IDENTICALLY ZERO for the
    # spurious conjugate copies (whose eigenvectors have w2 = +i w1).
    # Candidates passing the projector test are then VERIFIED by their true
    # residual against A whenever A supports a host matvec — the definitive
    # classifier for adversarial near-conjugate clusters where magnitude
    # heuristics alone can misfile a copy as genuine.
    import scipy.sparse as _sp

    tol_eff = tol if tol is not None else float(
        np.sqrt(np.finfo(np.dtype(dtype) if dtype is not None
                         else np.float32).eps))
    can_matvec = _sp.issparse(A) or isinstance(A, np.ndarray)
    res_tol = max(100.0 * tol_eff, 1e-6)

    order = np.asarray(sort_function(vals2))
    picked_vals, picked_vecs = [], []
    for i in order:
        lam = vals2[i]
        z = vecs2[:n, i] + 1j * vecs2[n:, i]
        nz = np.linalg.norm(z)
        if nz < 0.1:            # conjugate copy: the projector annihilates it
            continue
        z = z / nz
        if can_matvec:
            res = np.linalg.norm(A @ z - lam * z) / max(1.0, abs(lam))
            if res > res_tol:
                continue        # projector survivor that is NOT an eigenpair
        # Dedup by eigenvector DIRECTION, not value: a real eigenvalue of A
        # yields two real-representation copies whose z land in the same
        # 1-D span (collapse them), while a genuinely multiple eigenvalue
        # has independent eigenvectors (keep both).  The value window
        # scales with the convergence tolerance rather than a fixed 1e-6.
        val_tol = max(10.0 * tol_eff, 1e-9)
        dup = any(
            abs(lam - v) < val_tol * max(1.0, abs(lam))
            and abs(np.vdot(pz, z)) > 0.99
            for v, pz in zip(picked_vals, picked_vecs)
        )
        if dup:
            continue
        picked_vals.append(lam)
        picked_vecs.append(z)
        if len(picked_vals) == k:
            break
    vals = np.array(picked_vals)
    vecs = np.stack(picked_vecs, axis=1) if picked_vecs else np.zeros((n, 0))
    if return_eigenvectors:
        return vals, vecs
    return vals


def generalized_operator(A, B, sigma=None, *, solver="bicgstab",
                         inner_tol=1e-10, maxiter=2000, dtype=None,
                         mode="normal"):
    """Operator for the generalized problem ``A x = lambda B x``.

    Without ``sigma``: ``B^{-1} A`` (eigenvalues unchanged).  With
    ``sigma``, one of ARPACK's generalized spectral transforms (dsaupd
    modes 3-5, the scipy ``eigsh(mode=)`` surface):

    * ``"normal"`` — shift-invert ``(A - sigma B)^{-1} B``;
      ``lambda = sigma + 1/theta``.
    * ``"buckling"`` — ``(A - sigma B)^{-1} A``;
      ``lambda = sigma * theta / (theta - 1)``.
    * ``"cayley"`` — ``(A - sigma B)^{-1} (A + sigma B)``;
      ``lambda = sigma * (theta + 1) / (theta - 1)``.

    The inverse is an inner jittable Krylov solve, so the operator runs on
    the device and through shardings like any other.
    """
    opA = as_operator(A, dtype=dtype)
    opB = as_operator(B, dtype=dtype)
    n = opA.shape[0]
    assert opB.shape[0] == n

    from jax.scipy.sparse.linalg import bicgstab, cg, gmres

    solvers = {"bicgstab": bicgstab, "cg": cg, "gmres": gmres}
    solve_fn = solvers[solver]
    # Same indefinite-system hygiene as shift_invert_operator: restarted
    # GMRES stagnates with the default tiny window.
    extra = {"restart": 80} if solver == "gmres" else {}

    if sigma is None:
        def mv(x):
            y, _ = solve_fn(opB.matvec, opA.matvec(x), tol=inner_tol,
                            maxiter=maxiter, **extra)
            return y
    else:
        sig = np.asarray(sigma).item()

        def shifted(x):
            return opA.matvec(x) - sig * opB.matvec(x)

        if mode == "buckling":
            rhs = opA.matvec
        elif mode == "cayley":
            def rhs(x):
                return opA.matvec(x) + sig * opB.matvec(x)
        else:
            rhs = opB.matvec

        def mv(x):
            y, _ = solve_fn(shifted, rhs(x), tol=inner_tol,
                            maxiter=maxiter, **extra)
            return y

    return CallableOperator(mv, (n, n), opA.dtype,
                            nnz=opA.nnz + opB.nnz)


def _explicit_pencil_operator(op, M, sigma, Minv, OPinv, dtype,
                              mode="normal"):
    """scipy's user-supplied-inverse surface: the outer operator built from
    ``Minv`` (inverse of M; used when ``sigma is None``) or ``OPinv``
    (inverse of ``A - sigma M`` / ``A - sigma I``; used with ``sigma``),
    replacing the inner Krylov solve entirely.  Returns None when neither
    is given (callers fall back to the iterative-inverse operators).
    Validation mirrors scipy.sparse.linalg.eigs.
    """
    if OPinv is not None:
        if sigma is None:
            raise ValueError("OPinv should not be specified "
                             "unless sigma is specified")
        opinv = as_operator(OPinv, dtype=dtype)
        if M is None and mode == "normal":
            return opinv
        opM = as_operator(M, dtype=dtype) if M is not None else None
        sig = np.asarray(sigma).item()
        if mode == "buckling":
            rhs = op.matvec
        elif mode == "cayley":
            def rhs(x):
                return op.matvec(x) + sig * opM.matvec(x)
        else:
            rhs = opM.matvec
        return CallableOperator(
            lambda x: opinv.matvec(rhs(x)), op.shape, op.dtype,
            nnz=opinv.nnz + op.nnz + (opM.nnz if opM is not None else 0))
    if Minv is not None:
        if sigma is not None:
            raise ValueError("Minv should not be specified "
                             "when sigma is specified (supply OPinv)")
        if M is None:
            raise ValueError("Minv should not be specified with M = None")
        opMinv = as_operator(Minv, dtype=dtype)
        return CallableOperator(
            lambda x: opMinv.matvec(op.matvec(x)), op.shape, op.dtype,
            nnz=opMinv.nnz + op.nnz)
    return None


def eigs(A, k=6, *, which="LM", sigma=None, M=None, Minv=None, OPinv=None,
         tol=None, ncv=None,
         maxiter=1000, dtype=None, ortho="cgs_dgks", key=None, v0=None,
         return_eigenvectors=True, inner_solver="bicgstab", inner_tol=None):
    """scipy.sparse.linalg.eigs-compatible driver on the Krylov-Schur core.

    ``sigma`` activates shift-invert: eigenvalues of A nearest ``sigma``
    (the outer iteration runs LM on ``(A - sigma I)^{-1}``).  ``M``
    activates the generalized problem ``A x = lambda M x`` (inner Krylov
    solves against M, or against ``A - sigma M`` when combined with
    ``sigma``).  ``Minv``/``OPinv`` supply those inverses explicitly (any
    operator-like; scipy parity) and skip the inner solves.  ``v0`` is the
    scipy start vector (overrides ``key``).
    """
    from .krylov_schur import eigenpairs_from_partial_schur, partial_schur

    op = as_operator(A, dtype=dtype)
    explicit = _explicit_pencil_operator(op, M, sigma, Minv, OPinv, dtype)
    if M is not None:
        if tol is None:
            tol = float(np.sqrt(np.finfo(op.dtype).eps))
        itol = inner_tol if inner_tol is not None else tol * 1e-2
        gop = explicit if explicit is not None else generalized_operator(
            op, M, sigma, solver=inner_solver, inner_tol=itol, dtype=dtype)
        outer_sort = sort_function_for("LM" if sigma is not None else which)
        Q, T, hist = partial_schur(
            gop, k, max_dim=ncv, stopping_criterion=tol,
            sort_function=outer_sort, max_restarts=maxiter, ortho=ortho,
            dtype=dtype, key=key, v0=v0,
        )
        theta, vecs = eigenpairs_from_partial_schur(Q, T)
        vals = _transform_back(theta, sigma) if sigma is not None else theta
        if len(vals) > k:
            if sigma is not None:
                # transformed criterion: largest |theta| = nearest sigma
                order = np.argsort(-np.abs(np.asarray(theta)))[:k]
            else:
                order = np.asarray(sort_function_for(which)(vals))[:k]
            vals = np.asarray(vals)[order]
            vecs = np.asarray(vecs)[:, order]
        if return_eigenvectors:
            return np.asarray(vals), np.asarray(vecs)
        return np.asarray(vals)
    if sigma is not None:
        if tol is None:
            tol = float(np.sqrt(np.finfo(op.dtype).eps))
        itol = inner_tol if inner_tol is not None else tol * 1e-2
        # splu factorizes the ORIGINAL host matrix; iterative solvers run
        # against the device operator.
        solve_op = explicit if explicit is not None else \
            shift_invert_operator(
                A if inner_solver == "splu" else op, sigma,
                solver=inner_solver, inner_tol=itol, dtype=dtype)
        sort_function = sort_function_for("LM")
        Q, T, hist = partial_schur(
            solve_op, k, max_dim=ncv, stopping_criterion=tol,
            sort_function=sort_function, max_restarts=maxiter, ortho=ortho,
            dtype=dtype, key=key, v0=v0,
        )
        theta, vecs = eigenpairs_from_partial_schur(Q, T)
        vals = _transform_back(theta, sigma)
        # Trim by the transformed criterion (largest |theta| = nearest
        # sigma), NOT by `which` on the back-transformed values — otherwise
        # a straddling conjugate pair can evict the eigenvalue nearest
        # sigma.
        if len(vals) > k:
            order = np.argsort(-np.abs(np.asarray(theta)))[:k]
            vals = np.asarray(vals)[order]
            vecs = np.asarray(vecs)[:, order]
        if return_eigenvectors:
            return np.asarray(vals), np.asarray(vecs)
        return np.asarray(vals)
    sort_function = sort_function_for(which)
    Q, T, hist = partial_schur(
        op, k, max_dim=ncv, stopping_criterion=tol,
        sort_function=sort_function, max_restarts=maxiter, ortho=ortho,
        dtype=dtype, key=key, v0=v0,
    )
    vals, vecs = eigenpairs_from_partial_schur(Q, T)

    # scipy contract: exactly k pairs (the real path may carry k+1 when a
    # conjugate pair straddles; keep the k best under the sort).
    if len(vals) > k:
        order = np.asarray(sort_function(vals))[:k]
        vals = np.asarray(vals)[order]
        vecs = np.asarray(vecs)[:, order]
    if return_eigenvectors:
        return np.asarray(vals), np.asarray(vecs)
    return np.asarray(vals)


def eigsh(A, k=6, *, which="LM", sigma=None, M=None, Minv=None, OPinv=None,
          mode="normal",
          tol=None, ncv=None,
          maxiter=1000, dtype=None, key=None, v0=None,
          return_eigenvectors=True, inner_solver="cg", inner_tol=None,
          block_size=1):
    """scipy.sparse.linalg.eigsh-compatible driver on the thick-restart
    Lanczos core (Hermitian A).

    ``M`` activates the symmetric-definite generalized problem
    ``A x = lambda M x`` (reference's scipy oracle surface,
    /root/reference/tests/test_krylov_schur.py uses the standard form; M is
    scipy-API parity).  The pencil is solved through the generalized
    operator ``M^{-1} A`` (or ``(A - sigma M)^{-1} M`` with ``sigma``) on
    the real-Arnoldi Krylov-Schur core: the operator is self-adjoint in the
    M-inner product, so its eigenvalues are real and the Euclidean Arnoldi
    recovers them with real quasi-Schur 1x1 blocks; eigenvectors are
    returned M-orthonormalized (scipy contract).  ``Minv``/``OPinv``
    supply the pencil inverses explicitly (scipy parity) and skip the
    inner solves.  ``mode`` selects ARPACK's generalized spectral
    transform (scipy parity): 'normal' (shift-invert), 'buckling'
    (``OP = (A - sigma M)^{-1} A``, B = A) or 'cayley'
    (``OP = (A - sigma M)^{-1} (A + sigma M)``, B = M); the latter two
    require ``sigma`` and ``M``.

    ``which='BE'`` (both ends; scipy parity) returns ``k - k//2`` pairs
    from the high end and ``k//2`` from the low end, via two restarted
    solves sharing every other parameter.
    """
    from .lanczos import SYM_SORTS, partial_eigh

    if mode not in ("normal", "buckling", "cayley"):
        raise ValueError(
            f"mode={mode!r}: expected 'normal', 'buckling' or 'cayley'")
    if mode != "normal":
        # ARPACK dsaupd modes 4/5 (scipy parity): generalized transforms
        # requiring a shift.  buckling: OP = (A - sigma M)^{-1} A;
        # cayley: OP = (A - sigma M)^{-1} (A + sigma M).
        if sigma is None:
            raise ValueError(f"mode={mode!r} requires sigma")
        if M is None:
            raise ValueError(f"mode={mode!r} requires M (generalized "
                             "problem)")
    if which == "BE":
        # scipy: half from each end of the spectrum; odd k sends the extra
        # pair to the HIGH end.  Two independent restarted solves — the
        # Krylov spaces for the two ends share nothing useful after
        # restarting anyway.
        n_lo = k // 2
        n_hi = k - n_lo
        kw = dict(sigma=sigma, M=M, Minv=Minv, OPinv=OPinv, mode=mode,
                  tol=tol, ncv=ncv,
                  maxiter=maxiter, dtype=dtype, key=key, v0=v0,
                  return_eigenvectors=True, inner_solver=inner_solver,
                  inner_tol=inner_tol, block_size=block_size)
        vals_hi, vecs_hi = eigsh(A, n_hi, which="LA", **kw)
        if n_lo:
            vals_lo, vecs_lo = eigsh(A, n_lo, which="SA", **kw)
            vals = np.concatenate([vals_lo, vals_hi])
            vecs = np.concatenate([vecs_lo, vecs_hi], axis=1)
        else:
            vals, vecs = vals_hi, vecs_hi
        order = np.argsort(vals)
        vals, vecs = vals[order], vecs[:, order]
        if return_eigenvectors:
            return vals, vecs
        return vals

    op = as_operator(A, dtype=dtype)
    explicit = _explicit_pencil_operator(op, M, sigma, Minv, OPinv, dtype,
                                         mode=mode)
    if M is not None:
        from .krylov_schur import (
            eigenpairs_from_partial_schur,
            partial_schur,
        )

        if tol is None:
            tol = float(np.sqrt(np.finfo(op.dtype).eps))
        itol = inner_tol if inner_tol is not None else tol * 1e-2
        gop = explicit if explicit is not None else generalized_operator(
            op, M, sigma, solver=inner_solver, inner_tol=itol, dtype=dtype,
            mode=mode)
        # `which` acts on the pencil eigenvalues (sigma None) or on the
        # transformed nu = 1/(lambda - sigma) (scipy contract); both are
        # real, so the symmetric sorts map onto the real-Arnoldi ones.
        smap = {"LA": "LR", "SA": "SR", "LM": "LM", "SM": "SM"}
        if which not in smap:
            raise ValueError(
                f"which={which!r} not supported with M: expected one of "
                f"{('BE',) + tuple(smap)}")
        sort_function = sort_function_for(smap[which])
        Q, T, hist = partial_schur(
            gop, k, max_dim=ncv, stopping_criterion=tol,
            sort_function=sort_function, max_restarts=maxiter,
            dtype=dtype, key=key, v0=v0,
        )
        theta, vecs = eigenpairs_from_partial_schur(Q, T)
        theta = np.asarray(theta)
        vecs = np.asarray(vecs)
        if len(theta) > k:
            order = np.asarray(sort_function(theta))[:k]
            theta, vecs = theta[order], vecs[:, order]
        vals = (np.asarray(_transform_back(theta, sigma, mode))
                if sigma is not None else theta).real
        # A real symmetric pencil has real eigenvectors, but a complex (CPU)
        # work dtype can return them carrying a stray unit PHASE: transient
        # complex Ritz pairs of the non-normal iteration operator M^{-1}A,
        # retained by the thick restart, leave complex rounding in the
        # basis, and an eigenvector is only defined up to a complex scalar.
        # Rotate each column to its canonical phase (anchor = largest
        # component), then drop the imaginary part, which is now pure noise
        # at residual level.
        if np.iscomplexobj(vecs) and not np.issubdtype(
                np.dtype(op.dtype), np.complexfloating):
            anchor = np.take_along_axis(
                vecs, np.argmax(np.abs(vecs), axis=0)[None, :], axis=0)[0]
            phase = anchor / np.where(np.abs(anchor) == 0, 1.0,
                                      np.abs(anchor))
            vecs = (vecs * np.conj(phase)[None, :]).real
        # scipy contract: eigenvectors B-orthonormal in the transform's
        # inner product (B = A in buckling mode, M otherwise — ARPACK's
        # own B choice for dsaupd modes 3-5).
        opM = as_operator(A if mode == "buckling" else M, dtype=dtype)
        if np.iscomplexobj(vecs) and not np.issubdtype(
                np.dtype(opM.dtype), np.complexfloating):
            # complex Hermitian A over a real M: apply M limb-wise
            Mv = (np.asarray(opM.matmat(np.ascontiguousarray(vecs.real)))
                  + 1j * np.asarray(opM.matmat(
                      np.ascontiguousarray(vecs.imag))))
        else:
            Mv = np.asarray(opM.matmat(vecs.astype(opM.dtype, copy=False)))
        nrm = np.sqrt(np.abs(np.sum(np.conj(vecs) * Mv, axis=0).real))
        vecs = vecs / np.where(nrm == 0, 1.0, nrm)[None, :]
        order = np.argsort(vals)
        vals, vecs = vals[order], vecs[:, order]
        if return_eigenvectors:
            return vals, vecs
        return vals

    if sigma is not None:
        if tol is None:
            tol = float(np.sqrt(np.finfo(op.dtype).eps))
        itol = inner_tol if inner_tol is not None else tol * 1e-2
        solve_op = explicit if explicit is not None else \
            shift_invert_operator(
                A if inner_solver == "splu" else op, sigma,
                solver=inner_solver, inner_tol=itol, dtype=dtype)
        # scipy contract: under shift-invert, `which` selects on the
        # TRANSFORMED eigenvalues nu = 1/(lambda - sigma): the default 'LM'
        # means "nearest sigma", 'LA' means "just above sigma".
        if which not in SYM_SORTS:
            raise ValueError(f"which={which!r} not supported with sigma")
        theta, vecs, hist = partial_eigh(
            solve_op, k, which=which, max_dim=ncv,
            stopping_criterion=tol, max_restarts=maxiter, dtype=dtype,
            key=key, v0=v0, block_size=block_size,
        )
        vals = _transform_back(theta, sigma)
    else:
        vals, vecs, hist = partial_eigh(
            op, k, which=which, max_dim=ncv, stopping_criterion=tol,
            max_restarts=maxiter, dtype=dtype, key=key, v0=v0,
            block_size=block_size,
        )
    # scipy returns eigenvalues ascending.
    order = np.argsort(np.asarray(vals))
    vals = np.asarray(vals)[order]
    vecs = np.asarray(vecs)[:, order]
    if return_eigenvectors:
        return vals, vecs
    return vals
