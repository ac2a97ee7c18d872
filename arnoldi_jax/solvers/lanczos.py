"""Hermitian fast path: thick-restart Lanczos (``partial_eigh``).

The reference lists a Lanczos/Hermitian path as post-1.0 future work
(README.md:123); here it is a first-class driver because symmetric problems
are where the device path shines (everything real, the projected matrix is
symmetric so the host tier is an ``eigh``, and the restart compression is
exactly Krylov-Schur specialized to a diagonal Schur form — Wu & Simon's
thick-restart Lanczos).

Design notes:

* The device expansion reuses the Arnoldi machinery.  At float32, full
  (blocked CGS + DGKS) orthogonalization against the whole basis is the
  robust default — the classical 3-term recurrence loses orthogonality at
  sqrt(eps) which is immediately fatal at f32.  The ``selective`` kernel
  projects only against the last two columns plus the DGKS-triggered full
  fallback, recovering most of the 3-term speed when the spectrum is tame.
* After a thick restart the projected matrix is symmetric arrowhead
  (diag(theta) with a coupling row/col), which the host ``eigh`` treats
  uniformly; the device never sees it.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..linop import as_operator
from ..ops.ortho import M_SQRT1_2, cgs_dgks
from ..utils.history import History
from ..utils.random import rand_normalized_vector
from .decomposition import arnoldi_expand, default_invariant_tol
from .krylov_schur import _solver_dtype, _truncate_basis

__all__ = ["partial_eigh", "lanczos_selective_ortho", "SYM_SORTS"]


def make_lanczos_selective_ortho(n_locked):
    """Build a selective-orthogonalization kernel for thick-restart Lanczos.

    Projects against the ``n_locked`` leading (compressed Ritz) columns plus
    the last two active columns — the 3-term recurrence partners — and runs
    a full DGKS-checked CGS pass whenever the norm drop indicates leaked
    orthogonality.  Cheaper than full CGS when ``m >> n_locked + 2``; the
    full fallback bounds the damage from classical Lanczos orthogonality
    loss.  Kernels are cached per ``n_locked`` so jitted expansions do not
    retrace every restart.
    """
    return _selective_cache(int(n_locked))


import functools  # noqa: E402


@functools.lru_cache(maxsize=None)
def _selective_cache(n_locked):
    def kernel(V, w, n_active, *, tol=1e-8, eta=M_SQRT1_2):
        mp1 = V.shape[0]  # transposed layout: rows are basis vectors
        idx = jnp.arange(mp1)
        mask = (
            (idx < n_locked) | (idx == n_active - 1) | (idx == n_active - 2)
        ) & (idx < n_active)
        mask = mask.astype(V.dtype)

        beta_before = jnp.linalg.norm(w)
        c1 = jnp.matmul(V.conj(), w, precision=lax.Precision.HIGHEST) * mask
        w1 = w - jnp.matmul(c1, V, precision=lax.Precision.HIGHEST)
        beta1 = jnp.linalg.norm(w1)

        def full_pass(args):
            c1, w1, _ = args
            h2, w2, beta2, _ = cgs_dgks(V, w1, n_active, tol=tol, eta=eta)
            return c1 + h2, w2, beta2

        h, w2, beta = lax.cond(
            beta1 < eta * beta_before,
            full_pass,
            lambda args: args,
            (c1, w1, beta1),
        )
        return h, w2, beta, beta < tol

    return kernel


#: Backwards-compatible alias: selective kernel with no locked block.
lanczos_selective_ortho = make_lanczos_selective_ortho(0)


def _device_order(which, theta, m):
    """Device-side wanted-first ordering of eigh's ascending eigenvalues."""
    if which == "LA":
        return jnp.arange(m - 1, -1, -1)
    if which == "SA":
        return jnp.arange(m)
    if which == "LM":
        return jnp.argsort(-jnp.abs(theta))
    if which == "SM":
        return jnp.argsort(jnp.abs(theta))
    raise ValueError(which)


@partial(jax.jit, static_argnames=("nev", "p", "max_dim", "max_restarts",
                                   "which", "ortho", "b"))
def _trl_solve_jit(op, v0_block, tol, *, nev, p, max_dim, max_restarts,
                   which, ortho, b):
    """Thick-restart Lanczos with the ENTIRE restart loop on device.

    The projected eigenproblem is a small symmetric ``eigh`` — supported by
    XLA on the device — so unlike the non-Hermitian driver nothing needs the host:
    expansion, Rayleigh-Ritz rotation, truncation, and the convergence test
    all run inside one jitted ``lax.while_loop``.  One dispatch per SOLVE
    instead of several host round-trips per restart (which otherwise
    dominate wall time).

    Returns ``(V, theta, converged, healthy, restarts, trace)`` where
    ``healthy=False`` flags a breakdown (invariant subspace / block rank
    deficiency) that this fixed-shape loop cannot handle — the caller falls
    back to the host-orchestrated path.
    """
    from .krylov_schur import _truncate_basis

    n = v0_block.shape[1]
    m = max_dim
    rdtype = jnp.finfo(v0_block.dtype).dtype

    V = jnp.zeros((m + b, n), v0_block.dtype)
    V = lax.dynamic_update_slice(V, v0_block, (0, 0))
    H = jnp.zeros((m + b, m), v0_block.dtype)

    if b > 1:
        from .decomposition import _block_expand_jit

        V, H, jb = _block_expand_jit(op, V, H, tol, start_block=0,
                                     n_blocks=m // b, b=b)
        healthy0 = jb == m // b
    else:
        from .decomposition import _expand_auto

        V, H, it = _expand_auto(op, V, H, tol, start_dim=0, max_dim=m,
                                ortho=ortho)
        healthy0 = it == m

    trace0 = jnp.full((max_restarts,), jnp.nan, rdtype)

    def cond_fn(c):
        V, H, r, conv, healthy, theta, trace = c
        return (~conv) & healthy & (r < max_restarts)

    def body_fn(c):
        V, H, r, conv, healthy, _, trace = c
        H_active = H[:m, :m]
        H_sym = (H_active + H_active.T) * jnp.asarray(0.5, V.dtype)
        theta, S = jnp.linalg.eigh(H_sym)          # ascending
        order = _device_order(which, theta, m)
        theta = theta[order]
        S = S[:, order]

        coupling = H[m : m + b, :m]                # (b, m)
        res = jnp.linalg.norm(
            jnp.matmul(coupling, S, precision=lax.Precision.HIGHEST), axis=0)
        denom = jnp.maximum(jnp.abs(theta), jnp.asarray(1e-30, rdtype))
        rel = res / denom
        conv_now = jnp.all(rel[:nev] < tol)
        trace = trace.at[r].set(jnp.max(rel[:nev]))

        Sp = S[:, :p]
        V2 = _truncate_basis(V, Sp.astype(V.dtype), p=p, m=m, carry=b)
        H2 = jnp.zeros_like(H)
        H2 = H2.at[jnp.arange(p), jnp.arange(p)].set(theta[:p].astype(V.dtype))
        H2 = lax.dynamic_update_slice(
            H2,
            jnp.matmul(coupling, Sp,
                       precision=lax.Precision.HIGHEST).astype(V.dtype),
            (p, 0))

        def expand_again(args):
            V2, H2 = args
            if b > 1:
                from .decomposition import _block_expand_jit

                V3, H3, jb = _block_expand_jit(op, V2, H2, tol,
                                               start_block=p // b,
                                               n_blocks=m // b, b=b)
                return V3, H3, jb == m // b
            from .decomposition import _expand_auto

            V3, H3, it = _expand_auto(op, V2, H2, tol, start_dim=p,
                                      max_dim=m, ortho=ortho)
            return V3, H3, it == m

        V3, H3, ok = lax.cond(
            conv_now,
            lambda args: (args[0], args[1], jnp.asarray(True)),
            expand_again,
            (V2, H2),
        )
        return V3, H3, r + 1, conv_now, healthy & ok, theta, trace

    theta0 = jnp.zeros((m,), rdtype)
    V, H, r, conv, healthy, theta, trace = lax.while_loop(
        cond_fn, body_fn,
        (V, H, jnp.asarray(0), jnp.asarray(False), healthy0, theta0, trace0),
    )
    return V, theta, conv, healthy, r, trace


def _sym_sort(which):
    which = which.upper()
    if which == "LA":
        return lambda x: np.argsort(-np.real(x), kind="stable")
    if which == "SA":
        return lambda x: np.argsort(np.real(x), kind="stable")
    if which == "LM":
        return lambda x: np.argsort(-np.abs(x), kind="stable")
    if which == "SM":
        return lambda x: np.argsort(np.abs(x), kind="stable")
    raise ValueError(f"which={which!r}: expected LA, SA, LM or SM")


SYM_SORTS = ("LA", "SA", "LM", "SM")


def partial_eigh(
    A,
    nev,
    *,
    which="LA",
    max_dim=None,
    stopping_criterion=None,
    max_restarts=1000,
    ortho="cgs_dgks",
    dtype=None,
    key=None,
    v0=None,
    mesh=None,
    block_size=1,
    device_loop=None,
    refine="auto",
):
    """Compute ``nev`` extremal eigenpairs of a HERMITIAN operator by
    thick-restart Lanczos.

    ``device_loop`` (default: auto) runs the ENTIRE restart loop on device
    in one dispatch — expansion, on-device ``eigh`` rotation, truncation,
    and convergence test under ``lax.while_loop`` — eliminating the
    per-restart host round-trips; breakdowns fall back to the
    host-orchestrated loop automatically.

    Parameters mirror :func:`arnoldi_jax.partial_schur`; ``which`` is one of
    "LA", "SA", "LM", "SM".  ``ortho="selective"`` uses the 3-term-recurrence
    kernel with DGKS-triggered full reorthogonalization.

    ``block_size=b > 1`` runs BLOCK thick-restart Lanczos: each step applies
    the operator to b vectors at once (matmat) and orthogonalizes them with
    two block-gemm projections + CholQR2.  This both finds eigenvalues of
    multiplicity up to b (a single-vector Krylov space provably cannot) and
    amortizes every pass over the basis across b matvecs — the
    communication-avoiding structure that suits matrix units.

    ``refine``: like :func:`arnoldi_jax.partial_schur` — "auto" engages
    double-word refinement (``solvers/refine.py``) when the work dtype is
    real float32 and ``stopping_criterion`` < 1e-6, delivering 1e-8-grade
    residuals from a float32 solve; the refined eigenvectors come back as
    float64 host arrays.

    Returns ``(eigenvalues, eigenvectors, history)`` — eigenvalues are
    real and WANTED-FIRST ordered (e.g. descending for "LA"); the
    scipy-ascending convention lives in :func:`arnoldi_jax.eigsh`.
    Eigenvectors are the (real if A is real) Ritz basis columns.
    """
    op = as_operator(A)
    n = op.shape[0]
    assert op.shape[1] == n

    tol = default_invariant_tol(op.dtype) if stopping_criterion is None \
        else float(stopping_criterion)
    sort_function = _sym_sort(which)
    assert max_restarts > 0

    b = int(block_size)
    assert b >= 1
    if max_dim is None:
        max_dim = min(max(2 * nev + 1, 20), n)
    if b > 1:
        # Block driver: dimensions snap to whole blocks.
        max_dim = -(-max_dim // b) * b
        p = min(-(-(nev + max(5, b)) // b) * b, max_dim - b)
        assert nev <= p < max_dim, (
            f"block geometry failed: nev={nev}, p={p}, max_dim={max_dim}, "
            f"b={b}; increase max_dim")
    else:
        p = min(nev + 5, max_dim - 1)
        assert nev <= p < max_dim
    assert max_dim <= n

    # Hermitian problems keep the dtype real for real operators everywhere
    # (including CPU): the projected matrix is symmetric tridiagonal.
    if dtype is None and np.issubdtype(np.dtype(op.dtype), np.floating):
        wdtype = jax.dtypes.canonicalize_dtype(
            np.result_type(op.dtype, np.float32))
    else:
        wdtype = _solver_dtype(op.dtype, dtype)

    # Double-word refinement (see partial_schur): coarse f32 phase, then
    # compensated restarts to the requested tolerance.
    tol_target = tol
    if refine in (None, "none", False):
        do_refine = False
    elif refine == "dw":
        do_refine = True
    elif refine == "auto":
        from ..linop import (BandedOperator, BsrOperator, CallableOperator,
                             DenseOperator, EllOperator)

        do_refine = (
            np.dtype(wdtype) == np.float32 and tol < 1e-6
            and (isinstance(op, (BandedOperator, BsrOperator, DenseOperator,
                                 EllOperator))
                 or (isinstance(op, CallableOperator)
                     and op.fn_dw is not None)
                 or getattr(op, "has_dw", False)))
    else:
        raise ValueError(f"refine={refine!r}: expected 'auto', 'dw' or None")
    if do_refine:
        assert np.issubdtype(np.dtype(wdtype), np.floating)
        tol = max(tol, 2e-4)

    def _refine_result(V_rows, hist):
        from .refine import (build_padded_cast_residual, cast_operator_f32,
                             refine_schur_dw, refinement_start_vector)

        op32 = cast_operator_f32(op)
        # Device-side mix: never pull the basis rows to the host just to
        # build one start vector (see partial_schur).
        v0r = refinement_start_vector(V_rows, nev)
        op_lo = build_padded_cast_residual(A, op32, n_solve, mesh=mesh)
        max_dim_r = min(max_dim, max(2 * nev + 6, 16))
        p_r = min(nev + 5, max_dim_r - 1)
        Qr, Tr, r_extra, mv_extra = refine_schur_dw(
            op32, v0r, nev, max_dim=max_dim_r, p=p_r,
            tol=tol_target, sort_function=sort_function,
            max_restarts=max_restarts, op_lo=op_lo, mesh=mesh,
            clock=clock)
        hist.total = hist.total_matvecs + mv_extra
        hist.matvecs[:] = hist.total
        hist.restarts[:] = hist.restarts + r_extra
        vals = np.diag(Tr)[:nev].copy()
        hist.phases = clock.report()
        return vals, Qr[:n, :nev], hist

    # HOST TIER (see krylov_schur._host_matvec): small Hermitian problems
    # run the whole restart loop in NumPy/BLAS — no dispatches, no device-
    # loop compile (the one-dispatch device loop is the right call on an
    # accelerator, but its per-shape compile costs seconds, which dominates one-shot
    # small solves; ARPACK answers these in tens of ms).
    import os as _os_ht

    from .decomposition import HOST_ORTHO, host_arnoldi_expand
    from .krylov_schur import _HOST_TIER_MAX_N, _host_matvec, _host_truncate

    host_matvec = None
    # CPU backend: any size (see krylov_schur — NumPy/BLAS beats the
    # XLA-CPU device path across the board); accelerator: small n only.
    _cap = int(_os_ht.environ.get("ARNOLDI_HOST_TIER_N", _HOST_TIER_MAX_N))
    if (mesh is None and b == 1 and not do_refine and device_loop is not True
            and np.dtype(wdtype) in (np.float64, np.complex128)
            and isinstance(ortho, str) and ortho in HOST_ORTHO
            and (n <= _cap or jax.default_backend() == "cpu")):
        host_matvec = _host_matvec(A, np.dtype(wdtype))
    host_tier = host_matvec is not None
    # Native engine (see krylov_schur): C-speed CSR expansion for real-f64
    # sparse operators; the truncate stays a host BLAS gemm here because
    # this driver truncates BEFORE its convergence check.
    engine = None
    if host_tier and np.dtype(wdtype) == np.float64:
        from ..native import host_engine

        engine = host_engine.engine_for(A, wdtype, max_dim, ortho)

    selective = ortho == "selective"
    if selective:
        ortho = make_lanczos_selective_ortho(0)  # first expansion: no lock

    n_solve = n
    repl = None
    if mesh is not None:
        from ..linop import pad_operator
        from ..parallel.mesh import replicated_sharding

        n_dev = int(mesh.devices.size)
        gran = n_dev * getattr(op, "row_granularity", 1)
        n_solve = -(-n // gran) * gran
        op = pad_operator(op, n_solve)
        repl = replicated_sharding(mesh)

    if host_tier:
        V = np.zeros((max_dim + b, n_solve), dtype=wdtype)
        H = np.zeros((max_dim + b, max_dim), dtype=wdtype)
        V_alt = np.empty_like(V)     # double-buffered truncation scratch
    else:
        V = jnp.zeros((max_dim + b, n_solve), dtype=wdtype)
        H = jnp.zeros((max_dim + b, max_dim), dtype=wdtype)

    if mesh is not None:
        from ..parallel.sharded import shard_operator, shard_workspace

        op = shard_operator(op, mesh)
        V, H = shard_workspace(V, H, mesh)

    if v0 is None:
        if key is None:
            key = jax.random.key(0)
        v0 = rand_normalized_vector(key, n, wdtype)
    else:
        v0 = jnp.asarray(v0, dtype=wdtype)
        v0 = v0 / jnp.linalg.norm(v0)
    if n_solve != n:
        v0 = jnp.concatenate([v0, jnp.zeros(n_solve - n, wdtype)])
    if host_tier:
        V[0, :] = np.asarray(v0)
    else:
        V = V.at[0, :].set(v0)
    if b > 1:
        # Fill the rest of the start block with random vectors and
        # orthonormalize the block (CholQR keeps row 0 parallel to v0).
        from ..ops.ortho import block_cgs2

        key2 = jax.random.key(0) if key is None else jax.random.split(key)[1]
        extra = jax.random.normal(key2, (b - 1, n_solve), dtype=wdtype)
        W0 = jnp.concatenate([v0[None, :], extra], axis=0)
        _, Q0, _, _ = block_cgs2(V, W0, 0, tol=tol)
        V = jax.lax.dynamic_update_slice(V, Q0, (0, 0))

    from ..utils.profiling import phase_clock

    history = History.from_k(nev)
    clock = phase_clock()     # no-op unless ARNOLDI_PHASES is set
    has_converged = False
    total_matvecs = 0

    # Device restart loop: the whole solve in ONE dispatch (the small
    # symmetric eigh runs on-device, unlike the non-Hermitian Schur).
    # Used whenever the bookkeeping allows; a breakdown inside the fixed-
    # shape loop flags unhealthy and falls through to the host-orchestrated
    # loop below.
    # Auto-enabled except for features the fixed-shape device loop does not
    # carry (meshes keep GSPMD host orchestration for now; the selective
    # kernel mutates per restart): per-restart round-trips are
    # eliminated.
    use_device_loop = (
        device_loop if device_loop is not None
        else (mesh is None and not selective and which in SYM_SORTS
              and isinstance(ortho, str) and not host_tier)
    )
    if use_device_loop:
        v0_block = V[:b, :]
        with clock("trl.device_loop"):
            Vd, theta, conv, healthy, r_dev, trace = _trl_solve_jit(
                op, v0_block, jnp.asarray(tol, jnp.finfo(wdtype).dtype),
                nev=nev, p=p, max_dim=max_dim, max_restarts=max_restarts,
                which=which.upper(), ortho=ortho if isinstance(ortho, str)
                else "cgs_dgks", b=b,
            )
            healthy = bool(healthy)   # sync inside the clocked region
        if healthy:
            r_host = int(r_dev)
            trace_host = np.asarray(trace)[:r_host]
            history.residual_trace = [float(t) for t in trace_host]
            history.restarts[:] = r_host
            total = max_dim + max(r_host - 1, 0) * (max_dim - p)
            history.matvecs[:] = total
            history.total = total
            if not bool(conv):
                raise ValueError("Has not converged !")
            if do_refine and tol_target < tol:
                return _refine_result(Vd[:nev], history)
            eigenvalues = np.real(np.asarray(theta)[:nev])
            eigenvectors = Vd[:nev, :n].T
            history.phases = clock.report()
            return eigenvalues, eigenvectors, history
        # unhealthy (breakdown): fall through to the host-orchestrated loop

    if b > 1:
        from .decomposition import _block_expand_jit

        V, H, jb = _block_expand_jit(op, V, H, tol, start_block=0,
                                     n_blocks=max_dim // b, b=b)
        m = int(jb) * b
    elif engine is not None:
        V, H, m = engine.expand(V, H, tol, start_dim=0, max_dim=max_dim,
                                ortho=ortho)
    elif host_tier:
        V, H, m = host_arnoldi_expand(host_matvec, V, H, tol, start_dim=0,
                                      max_dim=max_dim, ortho=ortho)
    else:
        V, H, n_iter = arnoldi_expand(op, V, H, tol, start_dim=0,
                                      max_dim=max_dim, ortho=ortho)
        m = int(n_iter)
    total_matvecs += m

    hp = np.float64 if not np.issubdtype(np.dtype(wdtype), np.complexfloating) \
        else np.complex128
    H_trunc_hp = None
    prev_pa = 0
    theta_final = None
    for restart in range(max_restarts):
        happy_breakdown = m != max_dim
        if happy_breakdown and m < nev:
            raise ValueError(
                f"Invariant subspace of dimension {m} < nev={nev} found"
            )

        H_host = np.asarray(H).astype(hp)
        if H_trunc_hp is not None:
            H_host[: prev_pa + b, :prev_pa] = H_trunc_hp
        H_active = H_host[:m, :m]

        # Rayleigh-Ritz on the symmetric projected matrix (symmetrize to
        # scrub float32 roundoff).
        H_sym = (H_active + H_active.conj().T) / 2
        theta, S = np.linalg.eigh(H_sym)
        order = np.asarray(sort_function(theta))
        theta = theta[order]
        S = S[:, order]

        pa = min(p, m) if happy_breakdown else p
        if b > 1:
            pa = min(-(-pa // b) * b, m)
        Sp = S[:, :pa]

        if host_tier:
            V, V_alt = _host_truncate(V, Sp.astype(wdtype), p=pa, m=m,
                                      carry=b, scratch=V_alt), V
        else:
            V = _truncate_basis(V, jnp.asarray(Sp, dtype=wdtype), p=pa, m=m,
                                carry=b)

        H_new = np.zeros_like(H_host)
        H_new[np.arange(pa), np.arange(pa)] = theta[:pa]
        # Coupling block: the residual block's projections rotated by Sp
        # (for b == 1 this is the classic arrowhead row).
        H_new[pa : pa + b, :pa] = H_host[m : m + b, :m] @ Sp
        H_trunc_hp = H_new[: pa + b, :pa].copy()
        prev_pa = pa

        # Approximate residuals: || B S[last-b rows, i] || per Ritz pair.
        coupling_block = H_host[m : m + b, :m]
        approximate_residuals = np.linalg.norm(coupling_block @ S, axis=0)
        denom = np.abs(theta)
        denom = np.where(denom == 0, 1.0, denom)
        approximate_convergence = approximate_residuals / denom

        for k in range(nev):
            if approximate_convergence[k] <= tol:
                history.matvecs[k] = total_matvecs
                history.restarts[k] = restart + 1
        history.residual_trace.append(
            float(np.max(approximate_convergence[:nev])))

        has_converged = bool(np.all(approximate_convergence[:nev] < tol))
        if has_converged and happy_breakdown:
            history.matvecs[:] = np.maximum(history.matvecs, total_matvecs)
            history.restarts[:] = np.maximum(history.restarts, restart + 1)
        if (not has_converged) and happy_breakdown and pa >= m:
            raise ValueError(
                f"Krylov expansion saturated at dimension {m} without "
                f"convergence (block rank deficiency); reduce block_size or "
                f"max_dim, or use the scalar driver")
        if has_converged:
            theta_final = theta
            break

        if host_tier:
            H = H_new.astype(wdtype)
        else:
            H = jnp.asarray(H_new.astype(wdtype))
            if repl is not None:
                H = jax.device_put(H, repl)
        if b > 1:
            from .decomposition import _block_expand_jit

            V, H, jb = _block_expand_jit(op, V, H, tol, start_block=pa // b,
                                         n_blocks=max_dim // b, b=b)
            m_new = int(jb) * b
        elif engine is not None:
            V, H, n_iter = engine.expand(V, H, tol, start_dim=pa,
                                         max_dim=max_dim, ortho=ortho)
            m_new = int(n_iter)
        elif host_tier:
            V, H, n_iter = host_arnoldi_expand(host_matvec, V, H, tol,
                                               start_dim=pa, max_dim=max_dim,
                                               ortho=ortho)
            m_new = int(n_iter)
        else:
            if selective:
                # After a thick restart the leading pa+1 rows are the
                # compressed Ritz block; new vectors must stay orthogonal
                # to it.
                ortho = make_lanczos_selective_ortho(pa + 1)
            V, H, n_iter = arnoldi_expand(op, V, H, tol, start_dim=pa,
                                          max_dim=max_dim, ortho=ortho)
            m_new = int(n_iter)
        total_matvecs += m_new - pa
        m = m_new

    history.total = total_matvecs
    if not has_converged:
        raise ValueError("Has not converged !")

    if do_refine and tol_target < tol:
        return _refine_result(V[:nev], history)
    eigenvalues = np.real(theta_final[:nev])
    # Host tier: stay in NumPy — converting the workspace to a jax array
    # costs an eager slice+transpose XLA compile per (nev, ncv) shape.
    # Copy out of the workspace so the result does not pin the full
    # (max_dim+b, n) allocation.
    if host_tier:
        eigenvectors = np.ascontiguousarray(V[:nev, :n].T)
    else:
        eigenvectors = V[:nev, :n].T
    return eigenvalues, eigenvectors, history
