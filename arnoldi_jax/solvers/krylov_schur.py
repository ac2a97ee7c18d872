"""Krylov-Schur restarted eigensolver (flagship driver).

Algorithm parity with the reference ``src/arnoldi/krylov_schur.py:10-114``
(Stewart 2001): repeat [Arnoldi expand to m | Schur-rotate the projected H |
reorder wanted eigenvalues first | truncate the basis to p columns carrying
the residual vector | test ``|h_{m+1,m} q_{m,i}| / |t_ii| < tol``].

Host/device split (SURVEY §3.1): everything n-sized — the Arnoldi expansion
(matvec + masked CGS/DGKS, one ``lax.while_loop`` jit) and the truncation
tall-matmul ``V_active @ Q_p`` — runs on device and is sharding-transparent;
everything m-sized (Schur, reordering, convergence bookkeeping) runs
replicated on the host via the dense tier (native C++ or LAPACK), with only
the tiny ``(m+1, m)`` H crossing the boundary once per restart.

Capability extensions over the reference:

* happy breakdown (invariant subspace found mid-expansion) is *supported* —
  the reference raises (``krylov_schur.py:57-59``); here the exact invariant
  pairs are extracted and returned.
* any dtype: real float32/float64 (real Schur form) or complex64/complex128;
  the default follows the operator dtype (see :func:`_solver_dtype`).
* deterministic start vectors via ``jax.random`` keys.
* per-restart residual trace in ``History`` (first-class convergence
  tracking, which the reference README flags as missing API).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..linop import as_operator
from ..ops import dense_tier
from ..utils.history import History
from ..utils.random import rand_normalized_vector
from ..utils.sorting import arg_largest_magnitude
from .decomposition import arnoldi_expand, default_invariant_tol

#: Every n-sized product runs at full float32 precision: a default-precision
#: float32 product may run in TF32, far above the solver's tolerances.
_PREC = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("p", "m", "carry"))
def _truncate_basis(Vt, Qp, *, p, m, carry=1):
    """Device-side basis truncation in the transposed layout:
    ``Vt[:p, :] = Qp^T @ Vt[:m, :]`` (i.e. ``V[:, :p] = V[:, :m] @ Qp``) with
    the ``carry`` residual rows ``Vt[m:m+carry]`` carried to rows p..p+carry
    (reference ``krylov_schur.py:74-81`` — "not a typo"; ``carry`` is the
    block size for block drivers) and stale rows zeroed so the masked
    orthogonalization never sees them."""
    mpb, n = Vt.shape
    head = jnp.matmul(Qp.T, Vt[:m, :], precision=_PREC)
    carry_rows = Vt[m : m + carry, :]         # residual vector(s)
    tail = jnp.zeros((mpb - p - carry, n), Vt.dtype)
    return jnp.concatenate([head, carry_rows, tail], axis=0)


@partial(jax.jit, static_argnames=("rows",))
def _rotate_leading_rows(Vt, Qs, *, rows):
    """In-place-style rotation of the leading ``rows`` basis rows:
    ``Vt[:rows] = Qs^T @ Vt[:rows]`` — used for the final global reorder of
    a converged, locked output block (one tiny tall matmul)."""
    head = jnp.matmul(Qs.T, Vt[:rows, :],
                      precision=_PREC)
    return jax.lax.dynamic_update_slice(Vt, head, (0, 0))


#: Host-tier row cap (override with ARNOLDI_HOST_TIER_N).  Below this the
#: per-restart XLA dispatch overhead dominates the arithmetic on CPU and a
#: plain NumPy/BLAS loop is ~10x faster end-to-end (measured at mark(100):
#: 0.58 s warm device path vs 0.06 s host tier vs ARPACK 0.08 s).
_HOST_TIER_MAX_N = 32768


def _host_matvec(A, dtype):
    """A host float64/complex128 matvec for the small-problem tier, or None
    when ``A`` is not host-materializable (callables/jax operators)."""
    import scipy.sparse as _sp

    if _sp.issparse(A):
        A_h = A.astype(dtype).tocsr()
        return lambda v: A_h @ v
    if isinstance(A, np.ndarray) and A.ndim == 2:
        A_h = np.ascontiguousarray(A, dtype=dtype)
        return lambda v: A_h @ v
    return None


def _host_truncate(Vt, Qp, *, p, m, carry=1, scratch=None):
    """NumPy mirror of :func:`_truncate_basis` (same layout contract).

    With ``scratch`` (a second workspace buffer), the truncation gemm
    writes straight into it and the buffers swap roles — no allocation,
    no zero-fill (measured ~1/3 of the host truncate cost at mark(100)
    ncv=100: the (m+1, n) zeros + copy-back per restart).  Rows past
    ``p + carry`` of the returned buffer are stale; the host expansion
    loop only ever reads rows ``<= j``, and every downstream consumer
    (final output, checkpoints) reads head rows only.
    """
    if scratch is None:
        out = np.zeros_like(Vt)
        out[:p] = Qp.T @ Vt[:m]
        out[p : p + carry] = Vt[m : m + carry]
        return out
    np.matmul(Qp.T, Vt[:m], out=scratch[:p])
    scratch[p : p + carry] = Vt[m : m + carry]
    return scratch


@partial(jax.jit, static_argnames=("p", "m", "max_dim", "ortho"))
def _truncate_and_expand(op, Vt, Qp, H_new, invariant_tol, *, p, m, max_dim,
                         ortho):
    """Fused restart step: truncation tall-matmul + the next Arnoldi
    expansion in ONE device dispatch.  Each host-device round trip costs
    a dispatch and a synchronisation, so the restart loop performs exactly one upload (Qp, H_new) + one dispatch + one small
    download (H) per restart."""
    from .decomposition import _expand_auto

    Vt = _truncate_basis(Vt, Qp, p=p, m=m)
    return _expand_auto(op, Vt, H_new, invariant_tol, start_dim=p,
                        max_dim=max_dim, ortho=ortho)


def _solver_dtype(op_dtype, dtype):
    """Work dtype of the basis: ``dtype`` when given, else the complex
    promotion of the operator dtype — except that a real operator whose
    complex promotion would be complex64 (64-bit types disabled) keeps the
    real float32 path (real Schur form, 2x2 blocks): complex64 stalls near
    its ~1e-6 residual floor, while real float32 continues in double-word
    arithmetic (``refine="auto"``) down to tolerances below 1e-6."""
    if dtype is not None:
        return jax.dtypes.canonicalize_dtype(np.dtype(dtype))
    op_dtype = np.dtype(op_dtype)
    if (np.issubdtype(op_dtype, np.floating)
            and not jax.config.jax_enable_x64):
        return jax.dtypes.canonicalize_dtype(
            np.result_type(op_dtype, np.float32))
    ct = np.result_type(op_dtype, np.complex64)
    return jax.dtypes.canonicalize_dtype(ct)


def partial_schur(
    A,
    nev,
    *,
    max_dim=None,
    stopping_criterion=None,
    max_restarts=100,
    sort_function=None,
    p=None,
    ortho="cgs_dgks",
    dtype=None,
    key=None,
    v0=None,
    mesh=None,
    checkpoint_path=None,
    checkpoint_every=1,
    resume=False,
    block_size=1,
    refine="auto",
    refine_op_lo=None,
    lock="soft",
):
    """Compute a partial Schur decomposition ``A Q ~= Q T`` with the
    Krylov-Schur algorithm.

    Parameters (reference-compatible, ``krylov_schur.py:10-36``)
    ----------
    A : operator-like — SciPy sparse, dense array, or a framework operator.
    nev : number of wanted eigenpairs.
    max_dim : Krylov space dimension m; default ``min(max(2*nev+1, 20), n)``.
    stopping_criterion : relative-residual tolerance; default
        ``sqrt(eps(A.dtype))``.
    max_restarts : restart budget; raises on exhaustion.
    sort_function : "which" selector (callable or ARPACK-style handled by the
        caller); default largest magnitude.
    p : compressed (active) size after truncation.  Default (None) is the
        ADAPTIVE policy: per restart, keep the locked (converged) prefix
        plus half the unconverged window (SLEPc's Krylov-Schur default),
        quantized to a few static shapes.  An explicit integer pins the
        truncation size (the reference's fixed-p behavior).

    Extensions
    ----------
    ortho : orthogonalization kernel name (``cgs_dgks`` default, ``cgs2``
        recommended at float32).
    dtype : solver basis dtype; default complex promotion of ``A.dtype``
        (complex128 under x64), or real float32 for a real operator when
        64-bit types are disabled (see :func:`_solver_dtype`).
    key : ``jax.random`` key for the start vector (deterministic); default
        key 0.
    v0 : explicit start vector overriding ``key``.
    mesh : optional ``jax.sharding.Mesh`` — row-partition the operator and
        the Krylov basis across it (see ``arnoldi_jax.parallel``); the
        m-sized dense tier stays replicated.
    checkpoint_path : optional path — persist the restart-boundary solver
        state (basis + projected matrix + convergence history) every
        ``checkpoint_every`` restarts.
    resume : if True and ``checkpoint_path`` exists, continue from it
        (the solver state is exactly ``(V, H, p)`` — SURVEY §5).
    block_size : ``b > 1`` runs BLOCK Krylov-Schur — the operator is applied
        to b vectors per step (matmat) with two block-gemm projections +
        CholQR2 intra-block orthogonalization. Finds eigenvalues of
        multiplicity up to b and amortizes basis passes across b matvecs.
    lock : "soft" (default) or "hard".  Soft locking zeroes the coupling
        of converged leading pairs (they decouple permanently, at backward
        error within tol*|lambda|) but keeps them in the global sort-and-
        rotate — the safe policy when the sort has ties (e.g. LM over a
        +/-pair spectrum), where freezing too early can lock a wrong
        subset.  Hard locking additionally FREEZES the converged prefix:
        the ordered Schur, truncation rotation and coupling row act only
        on the active window, and the converged block is re-sorted
        globally once at exit.  Saves the O(k * m * n) re-rotation work
        per restart; use when the wanted eigenvalues are well separated
        under the sort key.
    refine_op_lo : optional prebuilt cast-residual operator
        (``solvers.refine.build_cast_residual_operator``) so repeated
        solves skip the O(nnz) host construction + device upload.
    refine : "auto" (default), "dw", or None/"none".  Double-word
        refinement for tolerances beyond the float32 floor: the f32 solve
        runs to a coarse tolerance, then
        the SAME Krylov-Schur loop continues in compensated float32-pair
        arithmetic (``solvers/refine.py``) warm-started from the f32 Schur
        basis, down to ``stopping_criterion``.  "auto" engages when the
        work dtype is real float32 and the requested tolerance is < 1e-6
        (with or without a mesh — the dw kernels are GSPMD-sharded under
        one).  When refinement runs, the returned Q and T are
        float64 HOST arrays (a plain f32 array cannot represent a 1e-8
        subspace).

    Returns
    -------
    schur_vecs : (n, nev) device array Q.
    schur_mat : (nev, nev) device array T (upper triangular, ordered).
    history : :class:`arnoldi_jax.utils.History`.
    """
    op = as_operator(A)
    n = op.shape[0]
    assert op.shape[1] == n

    if stopping_criterion is None:
        tol = default_invariant_tol(op.dtype)
    else:
        tol = float(stopping_criterion)
    if sort_function is None:
        sort_function = arg_largest_magnitude
    elif isinstance(sort_function, str):
        from ..utils.sorting import sort_function_for

        sort_function = sort_function_for(sort_function)
    assert max_restarts > 0

    b = int(block_size)
    assert b >= 1
    if max_dim is None:
        max_dim = min(max(2 * nev + 1, 20), n)
    if b > 1:
        max_dim = -(-max_dim // b) * b
        if p is None:
            p = min(-(-(nev + max(5, b)) // b) * b, max_dim - b)
        assert p % b == 0, "p must be a multiple of block_size"
        assert nev <= p < max_dim, (
            f"block geometry failed: nev={nev}, p={p}, max_dim={max_dim}, "
            f"b={b}; increase max_dim")
    else:
        # p=None runs the ADAPTIVE retention policy (thick restart with
        # locking): the truncation size is chosen per restart as
        # ``k_conv + (m - k_conv)//2`` — converged pairs are locked
        # (decoupled and frozen) and half the unconverged window is kept,
        # the policy SLEPc's Krylov-Schur defaults to.  Measured on the
        # mark(100) stress grid it converges in ~40% fewer matvecs than the
        # fixed ``p = nev + 5`` rule at large nev.  An explicit ``p`` pins
        # the truncation size (locking stays active).
        if p is not None:
            assert nev <= p < max_dim, (
                f"need nev <= p < max_dim, got {nev}, {p}, {max_dim}")
        assert nev < max_dim, f"need nev < max_dim, got {nev}, {max_dim}"
    assert max_dim <= n

    wdtype = _solver_dtype(op.dtype, dtype)

    # Double-word refinement: run the f32 phase to a coarse tolerance, then
    # continue in compensated arithmetic down to the requested one.
    tol_target = tol
    is_real_w = np.issubdtype(np.dtype(wdtype), np.floating)
    if refine in (None, "none", False):
        do_refine = False
    elif refine == "dw":
        do_refine = True
    elif refine == "auto":
        from ..linop import (BandedOperator, BsrOperator, CallableOperator,
                             DenseOperator, EllOperator)

        do_refine = (
            is_real_w and np.dtype(wdtype) == np.float32
            and tol < 1e-6
            and (isinstance(op, (BandedOperator, BsrOperator, DenseOperator,
                                 EllOperator))
                 or (isinstance(op, CallableOperator)
                     and op.fn_dw is not None)
                 or getattr(op, "has_dw", False)))
    else:
        raise ValueError(f"refine={refine!r}: expected 'auto', 'dw' or None")
    if do_refine:
        assert is_real_w, "dw refinement requires the real float32 path"
        tol = max(tol, 2e-4)  # f32-phase tolerance (the f32 residual floor)

    # HOST TIER: small problems run the whole solve in NumPy/BLAS float64.
    # Per-restart device dispatch + compile overhead costs more than the
    # arithmetic below a few 10^4 rows (the reference's own regime), and
    # the projected-matrix work is host-side anyway.  Engages only for the
    # scalar driver on host-materializable operators at 64-bit work dtypes
    # (the CPU x64 default), so device contracts (f32 dw refinement, mesh
    # sharding, callable operators) are untouched.
    import os as _os_ht

    host_matvec = None
    from .decomposition import HOST_ORTHO, host_arnoldi_expand
    # On a CPU backend the tier applies at ANY size: the XLA-CPU device
    # path loses to NumPy/BLAS across the board (measured 14.6x at
    # n=250k — complex work dtype, masked static-shape matmuls, dispatch
    # overhead).  On an accelerator backend only small problems route
    # here; large ones belong on the chip.
    _cap = int(_os_ht.environ.get("ARNOLDI_HOST_TIER_N", _HOST_TIER_MAX_N))
    if (mesh is None and b == 1 and not do_refine
            and np.dtype(wdtype) in (np.float64, np.complex128)
            and ortho in HOST_ORTHO
            and (n <= _cap or jax.default_backend() == "cpu")):
        # Decide the real-path downgrade BEFORE materializing the host
        # operator: building the complex128 copy first and throwing it
        # away would allocate a second full CSR (hundreds of MB at the
        # CPU-backend any-size tier).  Only host-materializable operators
        # qualify — a callable A never enters the tier and must keep the
        # device-path dtype.
        import scipy.sparse as _sp

        materializable = (_sp.issparse(A)
                          or (isinstance(A, np.ndarray) and A.ndim == 2))
        if (materializable and dtype is None
                and np.issubdtype(np.dtype(op.dtype), np.floating)
                and (v0 is None or not np.iscomplexobj(v0))):
            # A real operator on the host tier runs the REAL-arithmetic
            # path (real Schur form, 2x2 blocks — the same machinery as
            # the real device path): complex128-over-real-values is 4x the
            # flops and 2x the traffic for nothing.  ARPACK's dnaupd
            # makes the same call.
            wdtype = jax.dtypes.canonicalize_dtype(np.float64)
        host_matvec = _host_matvec(A, np.dtype(wdtype))
    host_tier = host_matvec is not None
    # Native engine: one C call per restart cycle (fused truncate+expand,
    # BLAS via scipy's cython_blas pointers) for real-f64 sparse operators
    # — removes the ~25%/iteration Python dispatch tax of the NumPy loop.
    engine = None
    if host_tier and np.dtype(wdtype) == np.float64:
        from ..native import host_engine

        engine = host_engine.engine_for(A, wdtype, max_dim, ortho)

    # Mesh execution pads the row dimension so every shard is the same size
    # (padding rows/columns are exactly zero and never enter the Krylov
    # space; Q is sliced back to n rows on return).
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

    from ..utils.profiling import phase_clock

    history = History.from_k(nev)
    # Phase stopwatch (no-op unless ARNOLDI_PHASES is set): host-visible
    # wall time per solver phase, reported on ``history.phases`` — the tool
    # that separates device compute from host and transfer overhead.
    clock = phase_clock()

    # Transposed workspace: basis vectors are contiguous rows (the
    # reference's F-order lever).  The eager setup ops below (workspace
    # zeros, keyed start vector, .at[0].set) are each a separate device
    # dispatch, so the phase clock covers them.
    with clock("f32.workspace_setup"):
        if host_tier:
            V = np.zeros((max_dim + b, n_solve), dtype=wdtype)
            H = np.zeros((max_dim + b, max_dim), dtype=wdtype)
            # Second workspace for the double-buffered truncation (see
            # _host_truncate); np.empty costs nothing until touched.
            V_alt = np.empty_like(V)
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
            from ..ops.ortho import block_cgs2

            key2 = jax.random.key(0) if key is None else jax.random.split(key)[1]
            extra = jax.random.normal(key2, (b - 1, n_solve), dtype=wdtype)
            W0 = jnp.concatenate([v0[None, :], extra], axis=0)
            _, Q0, _, _ = block_cgs2(V, W0, 0, tol=tol)
            V = jax.lax.dynamic_update_slice(V, Q0, (0, 0))

    has_converged = False
    total_matvecs = 0

    is_real = np.issubdtype(np.dtype(wdtype), np.floating)
    # Host dense tier always runs at 64-bit precision regardless of the
    # device dtype — it is tiny (m x m), and at float32 the Schur rotation
    # would otherwise compound rounding across restarts.  The truncated
    # leading block of H is kept in an authoritative high-precision host
    # copy between restarts (the device only ever *appends* columns).
    hp = np.float64 if is_real else np.complex128
    H_trunc_hp = None
    prev_pa = 0
    restart0 = 0

    import os as _os

    if resume and checkpoint_path and _os.path.exists(checkpoint_path):
        from ..utils.checkpoint import (checkpoint_is_sharded,
                                        load_checkpoint,
                                        load_checkpoint_sharded)

        # The snapshot holds the HEAD rows V[:pa+b] (truncated basis +
        # carry block) — the complete restart-boundary state.  The rest of
        # the freshly-allocated workspace stays zero and is refilled by the
        # next expansion.
        if checkpoint_is_sharded(checkpoint_path):
            assert mesh is not None, (
                "sharded checkpoint: pass a mesh (resume is mesh-elastic — "
                "any device count whose padding covers n)")
            ck = load_checkpoint_sharded(checkpoint_path, mesh,
                                         n_solve=n_solve)
        else:
            ck = load_checkpoint(checkpoint_path)
        head = ck.pa + b
        assert ck.H_hp.shape == (max_dim + b, max_dim), (
            f"checkpoint H shape {ck.H_hp.shape} does not match workspace "
            f"{(max_dim + b, max_dim)}")
        # Current checkpoints snapshot the HEAD rows only; older ones (or a
        # full-workspace writer) stored all max_dim+b rows — accept both by
        # slicing, since the head rows ARE the restart-boundary state.
        assert (ck.V.shape[0] >= head and ck.V.shape[1] == n_solve), (
            f"checkpoint V shape {ck.V.shape} incompatible with head rows "
            f"{(head, n_solve)}")
        ck_V = ck.V[:head]
        if host_tier:
            V[:head] = np.asarray(ck_V, dtype=wdtype)
            H = ck.H_hp.astype(wdtype)
        else:
            Vh_dev = (ck_V.astype(wdtype) if isinstance(ck_V, jax.Array)
                      else jnp.asarray(np.asarray(ck_V).astype(wdtype)))
            V = V.at[:head, :].set(Vh_dev)
            H = jnp.asarray(ck.H_hp.astype(wdtype))
            if repl is not None:
                H = jax.device_put(H, repl)
        H_trunc_hp = ck.H_hp[: ck.pa + b, : ck.pa].copy()
        prev_pa = ck.pa
        # A frozen prefix is a hard-lock concept: resuming a hard-lock
        # checkpoint under the (default) soft policy must NOT keep the
        # prefix frozen — soft locking keeps converged pairs in the global
        # sort precisely because freezing can lock a wrong tied subset.
        k_lock0 = ck.k_lock if (lock == "hard" and b == 1) else 0
        history.matvecs[:] = ck.matvecs
        history.restarts[:] = ck.restarts
        history.residual_trace = list(ck.residual_trace)
        total_matvecs = ck.total_matvecs
        restart0 = ck.restart
        start_dim0 = ck.pa
    else:
        start_dim0 = 0
        k_lock0 = 0

    with clock("f32.initial_expand"):
        if b > 1:
            from .decomposition import _block_expand_jit

            V, H, jb = _block_expand_jit(op, V, H, tol,
                                         start_block=start_dim0 // b,
                                         n_blocks=max_dim // b, b=b)
            m = int(jb) * b
        elif engine is not None:
            V, H, m = engine.expand(V, H, tol, start_dim=start_dim0,
                                    max_dim=max_dim, ortho=ortho)
        elif host_tier:
            V, H, m = host_arnoldi_expand(
                host_matvec, V, H, tol, start_dim=start_dim0,
                max_dim=max_dim, ortho=ortho)
        else:
            V, H, n_iter = arnoldi_expand(
                op, V, H, tol, start_dim=start_dim0, max_dim=max_dim,
                ortho=ortho
            )
            m = int(n_iter)
    total_matvecs += m - start_dim0

    nev_ret = nev
    saturated = 0   # consecutive rank-deficient saturations (see below)
    # Locking (thick restart): k_lock leading Schur pairs are CONVERGED and
    # decoupled — their coupling entries in the residual row are exactly
    # zero, the ordered-Schur rotation runs only on the active window
    # H[k_lock:m, k_lock:m], and the truncation leaves the locked rows of V
    # untouched (block-diagonal rotation).  New Krylov vectors still
    # orthogonalize against the locked rows (the masked CGS sees the whole
    # workspace), so locked directions cannot re-enter.  This is the
    # standard Krylov-Schur locking scheme (Stewart 2001 §4; ARPACK's
    # dnaup2 plays the same game with its "nev = nev + min(nconv, ...)"
    # adjustment) — without it, converged pairs are re-rotated and
    # re-tested every restart and convergence of the remaining pairs pays
    # full price each time.
    if lock not in ("soft", "hard"):
        raise ValueError(f"lock={lock!r}: expected 'soft' or 'hard'")
    hard_lock = lock == "hard" and b == 1
    k_lock = int(k_lock0)
    adaptive = p is None and b == 1
    T_out = None
    for restart in range(restart0, max_restarts):
        happy_breakdown = m != max_dim
        if happy_breakdown and m < nev:
            raise ValueError(
                f"Invariant subspace of dimension {m} < nev={nev} found; "
                "start vector lives in a too-small invariant subspace"
            )

        with clock("f32.h_pull"):
            H_host = np.asarray(H).astype(hp)
        if H_trunc_hp is not None:
            H_host[: prev_pa + b, :prev_pa] = H_trunc_hp
        ka = k_lock          # locked prefix size (0 for the block driver)
        ma = m - ka          # active window size
        H_active = H_host[ka:m, ka:m]

        ## Rotation: ordered Schur of the ACTIVE window of the projected
        # matrix (reference does schur() then ordered_schur() on the full
        # triangular factor, krylov_schur.py:69-72; fused into one call and
        # restricted to the unconverged window here).  The real path uses
        # the real Schur form with 2x2 blocks for conjugate pairs (ARPACK
        # dnaupd-style), so device arrays stay real throughout.
        if is_real:
            with clock("f32.rotate"):
                T2a, Qa, eigs_a = dense_tier.ordered_schur_real(
                    H_active, sort_function=sort_function
                )
            b_starts, b_sizes = dense_tier.real_schur_blocks(T2a)
            # in_block[i]: active positions i-1, i belong to one 2x2 block
            in_block = np.zeros(ma + 1, dtype=bool)
            for s, sz in zip(b_starts, b_sizes):
                if sz == 2:
                    in_block[s + 1] = True
        else:
            with clock("f32.rotate"):
                T2a, Qa = dense_tier.ordered_schur(
                    H_active, sort_function=sort_function
                )
            eigs_a = np.diag(T2a)
            b_starts, b_sizes = [], []
            in_block = np.zeros(ma + 1, dtype=bool)

        ## Convergence estimates: |h_{m+1,m} * Qa[last, i]| / |lambda_i|
        # (reference krylov_schur.py:91-99), in ACTIVE coordinates.  In the
        # real form a conjugate pair converges as a unit: its residual is
        # the coupling times the norm of the block's two last-row rotation
        # entries.
        if b > 1:
            # Block residuals: || B Qa[last-b rows, i] || per Schur vector,
            # shared across both positions of a 2x2 pair (ka == 0 here).
            coupling_block = H_host[m : m + b, :m]
            approximate_residuals = np.linalg.norm(
                coupling_block @ Qa, axis=0).astype(np.float64)
            if is_real:
                for s, sz in zip(b_starts, b_sizes):
                    if sz == 2:
                        pr = np.hypot(approximate_residuals[s],
                                      approximate_residuals[s + 1])
                        approximate_residuals[s] = pr
                        approximate_residuals[s + 1] = pr
        else:
            coupling = np.abs(H_host[m, m - 1])
            last_row = np.abs(Qa[ma - 1, :]).astype(np.float64)
            if is_real:
                for s, sz in zip(b_starts, b_sizes):
                    if sz == 2:
                        pr = np.hypot(Qa[ma - 1, s], Qa[ma - 1, s + 1])
                        last_row[s] = last_row[s + 1] = pr
            approximate_residuals = coupling * last_row
        denom = np.abs(eigs_a)
        denom = np.where(denom == 0, 1.0, denom)
        approximate_convergence = approximate_residuals / denom

        # Newly converged LEADING prefix of the active window.  A 2x2
        # pair's two positions share one residual (the hypot fix above),
        # so the scan cannot stop BETWEEN them: if it stops at the second
        # position, the first had the same value and would have stopped
        # the scan already.  The only index where in_block[nc] holds is
        # nc == ma (everything converged, trailing pair) — which needs no
        # adjustment; decrementing there would un-converge a converged
        # pair and stall a breakdown at m == nev forever.
        nc = 0
        while nc < ma and approximate_convergence[nc] <= tol:
            nc += 1
        assert nc == ma or not in_block[nc], (
            "prefix scan split a conjugate pair: unequal pair residuals")
        k_new = ka + nc

        for k in range(ka, min(k_new, nev)):
            if history.matvecs[k] == 0:
                history.matvecs[k] = total_matvecs
                history.restarts[k] = restart + 1
        rem = nev - ka
        history.residual_trace.append(
            float(np.max(approximate_convergence[:rem])) if rem > 0 else 0.0
        )

        # Convergence is decided by the residuals alone: a scalar happy
        # breakdown zeroes the coupling row so its residuals vanish, while a
        # block rank-deficiency leaves genuine nonzero residuals and must
        # NOT be treated as convergence.
        has_converged = k_new >= nev
        if has_converged:
            for k in range(nev):
                if history.matvecs[k] == 0:
                    history.matvecs[k] = total_matvecs
                    history.restarts[k] = restart + 1
            # A 2x2 block straddling the nev boundary cannot be cut: return
            # nev+1 pairs (ARPACK's k/k+1 contract for real problems).
            nev_ret = nev + 1 if in_block[nev - ka] else nev
            cr = nev_ret - ka
            Qp_full = np.zeros((m, nev_ret), dtype=H_host.dtype)
            Qp_full[:ka, :ka] = np.eye(ka, dtype=H_host.dtype)
            Qp_full[ka:, ka:] = Qa[:, :cr]
            T_out = np.zeros((nev_ret, nev_ret), dtype=hp)
            T_out[:ka, :ka] = H_host[:ka, :ka]
            if ka:
                T_out[:ka, ka:] = H_host[:ka, ka:m] @ Qa[:, :cr]
            T_out[ka:, ka:] = T2a[:cr, :cr]
            with clock("f32.final_truncate"):
                if host_tier:
                    V, V_alt = _host_truncate(
                        V, Qp_full.astype(wdtype), p=nev_ret, m=m, carry=b,
                        scratch=V_alt), V
                else:
                    V = _truncate_basis(V, jnp.asarray(Qp_full, dtype=wdtype),
                                        p=nev_ret, m=m, carry=b)
            if ka:
                # Locked pairs froze in lock order; re-sort the (small,
                # fully converged, quasi-triangular) output globally so the
                # presentation contract matches the no-locking path.
                if is_real:
                    T_out, Qs, _ = dense_tier.ordered_schur_real(
                        T_out, sort_function=sort_function)
                else:
                    T_out, Qs = dense_tier.ordered_schur(
                        T_out, sort_function=sort_function)
                if host_tier:
                    V[:nev_ret] = Qs.astype(wdtype).T @ V[:nev_ret]
                else:
                    V = _rotate_leading_rows(
                        V, jnp.asarray(Qs, dtype=wdtype), rows=nev_ret)
            break

        ## Not converged: saturation bookkeeping for the block driver.
        if b > 1 and happy_breakdown and min(p, m) >= m:
            # Saturated expansion without convergence (block rank
            # deficiency, e.g. eigenvalue multiplicity exceeding the
            # reachable Krylov space).  The unit-renormalized dead block
            # re-seeds the next expansion from its own rounding noise —
            # the block analog of ARPACK's random restart on invariance,
            # measured to recover missing multiplicity within a few
            # restarts — so keep going; only REPEATED saturation with a
            # stagnant residual trace is fatal.
            saturated += 1
            rt = history.residual_trace
            if saturated >= 3 and len(rt) >= 3 and not rt[-1] < 0.5 * rt[-3]:
                raise ValueError(
                    f"Krylov expansion saturated at dimension {m} without "
                    f"convergence (block rank deficiency); reduce "
                    f"block_size or max_dim, or use the scalar driver")
            reseed = True
        else:
            saturated = 0
            reseed = False

        ## Truncation size.  Adaptive (p=None, scalar): keep the locked
        # prefix plus HALF the unconverged window — quantized DOWN to a
        # multiple of 8 so the fused truncate+expand dispatch compiles for
        # a handful of distinct static shapes per solve instead of one per
        # restart (each fresh shape is one XLA compilation).  Explicit p:
        # fixed cut, as the reference.
        if adaptive:
            # Retention: at least half the space past the converged prefix
            # (SLEPc's keep-half rule, best at small nev/ncv ratios) and at
            # least ARPACK's nev + min(nconv, (ncv-nev)/2) (which floors
            # the retained space at ALL nev wanted directions — keep-half
            # alone re-discovers dropped wanted directions every restart
            # when nev > ncv/2).  Rounded UP to a multiple of q: a handful
            # of distinct static shapes per solve (each fused
            # truncate+expand shape is one XLA compilation) and never
            # fewer retained directions than the policy asks.
            # Quantum choice: every distinct pa is a fresh XLA compilation
            # of the fused truncate+expand dispatch.  The host tier pays
            # nothing per shape (fine quanta, fully adaptive); the DEVICE
            # path pays one compilation per shape, so its quantum is a third of the nev..max_dim span — the pa
            # ladder has at most ~3 deterministic rungs per solve
            # geometry, the warm/first solve compiles them all, and the
            # retention still grows with the converged count (freezing it
            # entirely costs 45% extra matvecs at nev=3ncv/4 on the
            # mark(100) grid; the coarse ladder costs ~0-6%).
            policy = _os.environ.get("ARNOLDI_RETAIN", "default")
            if policy == "arpack":
                raw = nev + min(k_new, max((m - nev) // 2, 1))
            elif policy == "half":
                raw = max(m // 2, k_new + 1)
            else:
                raw = max(k_new + max((m - k_new) // 2, 1),
                          nev + min(k_new, max((m - nev) // 2, 1)))
            if host_tier:
                # FINE quanta: the host tier pays nothing per truncation
                # shape, and rounding UP shrinks the expansion window —
                # q=8 cost ~20% extra restarts at ncv=100 (50 vs 42 at
                # nev=75 LM on mark(100); q=1 lands exactly on ARPACK's
                # restart/matvec counts there).
                q = 1
            else:
                q = max(8, -(-(max_dim - nev) // 3))
            pa = min(-(-raw // q) * q, m - 1)
            pa = max(pa, min(k_new + 1, m - 1))     # window never empty
        else:
            pa = min(p, m) if happy_breakdown else p
        ca = pa - ka             # cut position within the active window
        resolved = False
        if b == 1 and is_real and in_block[ca]:
            # Keep pa FIXED by relocating a 1x1 block across the cut (one
            # tiny host block move) — letting pa drift changes the STATIC
            # shapes of the fused truncate+expand dispatch.
            try:
                T2a, Qa = dense_tier.resolve_straddle(T2a, Qa, ca,
                                                      min_keep=max(rem, nc))
                resolved = True
            except RuntimeError:
                pass  # no prefix-safe relocation: fall to cut stepping
            if resolved:
                b_starts, b_sizes = dense_tier.real_schur_blocks(T2a)
                in_block = np.zeros(ma + 1, dtype=bool)
                for s_, sz_ in zip(b_starts, b_sizes):
                    if sz_ == 2:
                        in_block[s_ + 1] = True
        if in_block[ca] and not resolved:
            step = b if b > 1 else 1
            # Block driver: moving by one block can land on ANOTHER 2x2
            # pair boundary, so keep stepping (upward first, then downward)
            # until the cut is clean.
            floor = max(rem, nc + 1, 1)   # never drop wanted/locked work
            cand = ca
            limit = ma if happy_breakdown else ma - 1
            while cand + step <= limit and in_block[cand + step]:
                cand += step
            if cand + step <= limit and not in_block[cand + step]:
                ca = cand + step
            else:
                cand = ca
                while cand - step >= floor and in_block[cand - step]:
                    cand -= step
                if cand - step >= floor and not in_block[cand - step]:
                    ca = cand - step
                else:
                    raise ValueError(
                        "Cannot truncate without splitting a conjugate "
                        "pair; increase max_dim or p"
                    )
            pa = ka + ca

        ## Assemble the truncated projected matrix.  The rotation is block
        # diagonal — identity on the locked prefix, Qa[:, :ca] on the
        # active window — so the locked rows of V are never recomputed and
        # the locked block of H is bit-frozen; only the upper coupling
        # H[:ka, ka:] and the residual row rotate.
        Qp_full = np.zeros((m, pa), dtype=H_host.dtype)
        Qp_full[:ka, :ka] = np.eye(ka, dtype=H_host.dtype)
        Qp_full[ka:, ka:] = Qa[:, :ca]
        H_new = np.zeros_like(H_host)
        H_new[:ka, :ka] = H_host[:ka, :ka]
        if ka:
            H_new[:ka, ka:pa] = H_host[:ka, ka:m] @ Qa[:, :ca]
        H_new[ka:pa, ka:pa] = T2a[:ca, :ca]
        # Coupling row(s): the residual block's projections rotated by the
        # active rotation (reference krylov_schur.py:83-88; b rows for the
        # block driver)...
        H_new[pa : pa + b, ka:pa] = H_host[m : m + b, ka:m] @ Qa[:, :ca]
        # ... and LOCK: the newly converged prefix's coupling entries are
        # below tol*|lambda| — zero them exactly (backward error within the
        # convergence tolerance) so the pairs decouple permanently.
        H_new[pa : pa + b, :k_new] = 0.0
        H_trunc_hp = H_new[: pa + b, :pa].copy()
        prev_pa = pa
        if hard_lock:
            k_lock = k_new

        if host_tier:
            H = H_new.astype(wdtype)
        else:
            H = jnp.asarray(H_new.astype(wdtype))
            if repl is not None:
                H = jax.device_put(H, repl)
        # After an unconverged saturation, zero the breakdown tolerance for
        # the NEXT expansion: the dead block's unit-renormalized rounding
        # noise then extends the space past the invariant subspace (the
        # block analog of ARPACK's random restart on invariance).  A truly
        # exact zero block still reads as breakdown via the relative
        # rank-deficiency floor, so this cannot loop on exact invariance.
        exp_tol = 0.0 if reseed else tol
        if b > 1:
            from .decomposition import _block_expand_jit

            V = _truncate_basis(V, jnp.asarray(Qp_full, dtype=wdtype), p=pa,
                                m=m, carry=b)
            V, H, jb = _block_expand_jit(op, V, H, exp_tol,
                                         start_block=pa // b,
                                         n_blocks=max_dim // b, b=b)
            n_iter = int(jb) * b
        elif engine is not None:
            with clock("f32.restart_dispatch"):
                Vn, H, n_iter = engine.cycle(
                    V, V_alt, H, Qp_full, m=m, pa=pa, carry=b,
                    max_dim=max_dim, tol=exp_tol, ortho=ortho)
            V, V_alt = Vn, V
        elif host_tier:
            with clock("f32.truncate"):
                V, V_alt = _host_truncate(V, Qp_full.astype(wdtype), p=pa,
                                          m=m, carry=b, scratch=V_alt), V
            with clock("f32.restart_dispatch"):
                V, H, n_iter = host_arnoldi_expand(
                    host_matvec, V, H, exp_tol, start_dim=pa,
                    max_dim=max_dim, ortho=ortho)
        else:
            # Fused single-dispatch restart step.
            from ..ops.ortho import resolve_ortho as _r  # noqa: F401
            # jnp.finfo of a complex dtype yields the matching real dtype
            # (float64 for complex128), preserving the x64 breakdown tol.
            with clock("f32.restart_dispatch"):
                V, H, n_iter = _truncate_and_expand(
                    op, V, jnp.asarray(Qp_full, dtype=wdtype), H,
                    jnp.asarray(exp_tol, jnp.finfo(wdtype).dtype),
                    p=pa, m=m, max_dim=max_dim, ortho=ortho,
                )
                n_iter = int(n_iter)
        if checkpoint_path and (restart + 1) % max(checkpoint_every, 1) == 0:
            # The expansion only APPENDS rows past pa+b, so the head rows of
            # the post-dispatch workspace ARE the restart-boundary state —
            # the checkpoint rides the fused dispatch (no extra truncation
            # pass) and moves only (pa+b) rows, per process under a mesh.
            from ..utils.checkpoint import (RestartCheckpoint,
                                            save_checkpoint,
                                            save_checkpoint_sharded)

            head = pa + b
            ckpt = RestartCheckpoint(
                V=V[:head], H_hp=H_new, pa=pa, restart=restart + 1,
                total_matvecs=total_matvecs,
                matvecs=history.matvecs.copy(),
                restarts=history.restarts.copy(),
                residual_trace=list(history.residual_trace),
                k_lock=k_lock,
            )
            with clock("f32.checkpoint"):
                if mesh is not None:
                    save_checkpoint_sharded(checkpoint_path, ckpt)
                else:
                    save_checkpoint(checkpoint_path, ckpt)
        m_new = int(n_iter)
        total_matvecs += m_new - pa
        m = m_new

    history.total = total_matvecs

    if not has_converged:
        raise ValueError("Has not converged !")

    if do_refine and tol_target < tol:
        # Double-word phase: same restart loop, compensated arithmetic,
        # warm-started from the converged f32 Schur basis.
        from .refine import (build_padded_cast_residual, cast_operator_f32,
                             refine_schur_dw, refinement_start_vector)

        op32 = cast_operator_f32(op)
        # Pass the DEVICE workspace: the mix happens on device and only the
        # (n,) start vector ever exists (no (max_dim+1, n) host copy).
        with clock("refine.start_vector"):
            v0r = refinement_start_vector(V, max(nev_ret, 1))
        # Building/uploading the cast-residual operator is O(nnz) host work
        # + a device transfer; callers solving repeatedly (or benchmarking)
        # should prebuild it once and pass refine_op_lo (pre-padded/sharded
        # to match when a mesh is in play).
        if refine_op_lo is not None:
            op_lo = refine_op_lo
        else:
            # The mesh path padded the operator; the helper pads the exact
            # source identically so the cast residual shares the layout.
            op_lo = build_padded_cast_residual(A, op32, n_solve, mesh=mesh)
        # Each dw iteration costs a few f32 ones, and the warm start means
        # convergence needs few restarts — a compact refinement subspace
        # (not the full f32-phase max_dim) minimizes total dw work.
        max_dim_r = min(max_dim, max(2 * nev + 6, 16))
        p_r = min(nev + 5, max_dim_r - 1)
        Qr, Tr, r_extra, mv_extra = refine_schur_dw(
            op32, v0r, nev, max_dim=max_dim_r, p=p_r,
            tol=tol_target, sort_function=sort_function,
            max_restarts=max_restarts, op_lo=op_lo, clock=clock, mesh=mesh)
        history.total = total_matvecs + mv_extra
        history.matvecs[:] = history.total
        history.restarts[:] = history.restarts + r_extra
        history.residual_trace.append(float(tol_target))
        history.phases = clock.report()
        return Qr[:n], Tr, history

    history.phases = clock.report()
    if host_tier:
        # Stay in NumPy: converting the workspace to a jax array here costs
        # an eager dynamic_slice + transpose XLA compile PER (nev, ncv)
        # shape (~100 ms — more than the whole mark(100) solve).  Copy out
        # of the workspace: a transposed view would pin the full
        # (max_dim+b, n) allocation for the life of the result.
        schur_vecs = np.ascontiguousarray(V[:nev_ret, :n].T)
        schur_mat = T_out[:nev_ret, :nev_ret].astype(wdtype)
        return schur_vecs, schur_mat, history
    schur_vecs = V[:nev_ret, :n].T   # back to the (n, nev) contract
    schur_mat = jnp.asarray(T_out[:nev_ret, :nev_ret].astype(wdtype))

    # Note: same ordering contract as the reference — Schur form ordered by
    # sort_function, use eigenpairs_from_partial_schur for eigen post-processing.
    return schur_vecs, schur_mat, history


def eigenpairs_from_partial_schur(schur_vecs, schur_mat):
    """Eigen post-processing: eigenpairs from a partial Schur decomposition.

    The reference leaves this to user boilerplate (README.md:46-48:
    ``vals, S = eig(T); vecs = Q @ S``); here it is a library call using the
    dense tier's triangular back-substitution.

    Returns ``(values, vectors)`` with unit-norm columns.
    """
    T = np.asarray(schur_mat)
    if np.iscomplexobj(T) and _is_triangular(T):
        values, S = dense_tier.eig_from_schur(T)
    else:
        # Real quasi-triangular T (real Krylov-Schur path) or a general
        # small matrix: plain dense eig.
        values, S = dense_tier.eig(T)

    # Small CPU-resident bases: one BLAS gemm on the host.  Each distinct
    # (n, nev) shape otherwise costs an XLA compilation — at the stress
    # sweep's scale that is most of the post-processing wall time.
    q_host = (isinstance(schur_vecs, np.ndarray)
              or (isinstance(schur_vecs, jax.Array)
                  and schur_vecs.is_fully_addressable
                  and list(schur_vecs.devices())[0].platform == "cpu"
                  and schur_vecs.size <= 2**22))
    if q_host:
        Qh = np.asarray(schur_vecs)
        vectors = Qh.astype(np.result_type(Qh.dtype, S.dtype)) @ S
        norms = np.linalg.norm(vectors, axis=0)
        return values, vectors / np.where(norms == 0, 1.0, norms)[None, :]

    Q = jnp.asarray(schur_vecs)
    if np.iscomplexobj(S) and not jnp.issubdtype(Q.dtype, jnp.complexfloating):
        # Real basis, complex eigenvectors of T: one real device matmul
        # against [Re S | Im S] (no complex copy of the basis), recombined
        # on the host.
        k = S.shape[1]
        SS = jnp.asarray(np.concatenate([S.real, S.imag], axis=1),
                         dtype=Q.dtype)
        V2 = np.asarray(jnp.matmul(Q, SS, precision=_PREC))
        vectors = V2[:, :k] + 1j * V2[:, k:]
        norms = np.linalg.norm(vectors, axis=0)
        return values, vectors / np.where(norms == 0, 1.0, norms)[None, :]
    vectors = jnp.matmul(Q, jnp.asarray(S, dtype=Q.dtype), precision=_PREC)
    norms = jnp.linalg.norm(vectors, axis=0)
    vectors = vectors / jnp.where(norms == 0, 1.0, norms)[None, :]
    return values, vectors


def _is_triangular(T):
    return bool(np.allclose(T, np.triu(T)))
