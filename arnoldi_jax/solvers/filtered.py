"""Chebyshev-filtered subspace iteration: interior eigenpairs WITHOUT
linear solves (``eigsh_filtered``).

The reference (and scipy/ARPACK) reach interior eigenvalues only through
shift-invert, which needs a factorization or an inner iterative solve per
matvec — both poor fits for a device solve (``splu`` runs on the host
through a callback and its fill grows as O(n g^2) on 3-D grids, and
BiCGStab on an indefinite ``A - sigma I`` can stall; see
``solvers/spectral_transform.py``).  The matvec-only alternative is
POLYNOMIAL filtering (Saad, "Numerical
Methods for Large Eigenvalue Problems" ch. 7; the EVSL / ChASE design):

* build a Jackson-damped Chebyshev expansion ``p`` of the indicator
  function of the wanted window ``[a, b]`` over the spectral interval
  ``[lmin, lmax]`` — ``p(A)`` maps wanted eigenvalues near 1 and the rest
  near 0, and costs only ``degree`` matvecs per vector;
* run subspace iteration with Rayleigh-Ritz on ``A``: every step is a
  block three-term recurrence (gemm-rich, static trip count
  under ``lax.fori_loop``) followed by CholQR2 orthonormalization and a
  small host ``eigh`` — no factorization, no inner solves, no
  data-dependent shapes.

All (s, n) work is jitted device dispatches; the tiny (s, s)
factorizations (Cholesky, eigh) happen on the HOST in float64 — see
``_host_whiten`` for the measured reason the device f32 factorizations
cannot be trusted on filtered Grams.
"""

import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..linop import as_operator
from ..utils.history import History

__all__ = [
    "eigsh_filtered",
    "eigsh_window",
    "estimate_window_count",
    "spectral_moments",
    "count_from_moments",
    "spectrum_bounds",
    "jackson_cheby_coeffs",
    "cheby_filter",
]

_PREC = jax.lax.Precision.HIGHEST


def spectrum_bounds(A, m=40, *, key=None, dtype=None, mesh=None):
    """Safe enclosure ``[lmin, lmax]`` of a Hermitian operator's spectrum
    from one ``m``-step Lanczos run.

    The Chebyshev filter REQUIRES an enclosure (an eigenvalue outside the
    mapped ``[-1, 1]`` makes the recurrence diverge exponentially), so the
    extremal Ritz values are inflated by the factorization's residual bound
    ``|beta_m|`` plus a small relative safety margin.
    """
    from .decomposition import arnoldi_expand

    op = as_operator(A, dtype=dtype)
    n = op.shape[0]
    m = int(min(m, n - 1))
    wdtype = op.dtype
    if key is None:
        key = jax.random.key(0)
    from ..utils.random import rand_normalized_vector

    v0 = rand_normalized_vector(key, n, wdtype)
    Vt = jnp.zeros((m + 1, n), wdtype).at[0].set(v0)
    H = jnp.zeros((m + 1, m), wdtype)
    if mesh is not None:
        from ..parallel.sharded import shard_workspace

        Vt, H = shard_workspace(Vt, H, mesh)
    Vt, H, n_iter = arnoldi_expand(op, Vt, H, max_dim=m)
    k = int(n_iter)
    Hk = np.asarray(H, dtype=np.float64)[:k, :k]
    theta, U = np.linalg.eigh(0.5 * (Hk + Hk.T))
    beta = abs(float(np.asarray(H)[k, k - 1])) if k < H.shape[0] else 0.0
    spread = max(theta[-1] - theta[0], np.finfo(np.float64).tiny)
    # Per-pair Lanczos residual bound |beta * u_last| (Saad thm 6.6,
    # Paige): far tighter than the blanket |beta| for the converged
    # extremal pairs, which is all the enclosure needs.
    lo_res = beta * abs(float(U[-1, 0]))
    hi_res = beta * abs(float(U[-1, -1]))
    return (float(theta[0] - lo_res - 0.005 * spread),
            float(theta[-1] + hi_res + 0.005 * spread))


def jackson_cheby_coeffs(a, b, lmin, lmax, degree):
    """Chebyshev coefficients (Jackson-damped) of the indicator function of
    ``[a, b]`` on the spectrum interval ``[lmin, lmax]``.

    With the affine map ``t = (x - c)/e`` (``c`` center, ``e`` half-width of
    ``[lmin, lmax]``), the indicator of ``[alpha, beta]`` in ``t`` has the
    classical expansion ``c_0 = (ta - tb)/pi``,
    ``c_j = 2 (sin(j ta) - sin(j tb)) / (pi j)`` with
    ``ta = arccos(alpha) >= tb = arccos(beta)``.  Jackson damping kills the
    Gibbs oscillation so the filtered values stay in ``(~0, ~1)``.

    Returns a float64 numpy array of length ``degree + 1``.
    """
    N = int(degree)
    assert N >= 1
    c = 0.5 * (lmax + lmin)
    e = 0.5 * (lmax - lmin)
    assert e > 0
    alpha = min(max((a - c) / e, -1.0), 1.0)
    beta = min(max((b - c) / e, -1.0), 1.0)
    assert alpha < beta, f"empty window after mapping: [{alpha}, {beta}]"
    ta, tb = np.arccos(alpha), np.arccos(beta)
    j = np.arange(1, N + 1, dtype=np.float64)
    coeffs = np.empty(N + 1, np.float64)
    coeffs[0] = (ta - tb) / np.pi
    coeffs[1:] = 2.0 * (np.sin(j * ta) - np.sin(j * tb)) / (np.pi * j)
    # Jackson damping factors g_j (the kernel-polynomial-method form,
    # Weisse et al., Rev. Mod. Phys. 78, 275 (2006), eq. 71).
    jj = np.arange(0, N + 1, dtype=np.float64)
    den = N + 1.0
    g = ((den - jj) * np.cos(np.pi * jj / den)
         + np.sin(np.pi * jj / den) / np.tan(np.pi / den)) / den
    return coeffs * g


def _edge_sine(a, b, lmin, lmax):
    """Local Chebyshev resolution factor ``max(sqrt(1 - t^2))`` over the
    window edges mapped to the Chebyshev variable ``t``.

    Chebyshev nodes crowd toward the ends of the spectral interval, so a
    degree-``N`` damped indicator resolves a transition of half-width
    ``~2.5 (lmax - lmin) sin(theta) / N`` at local geometry ``sin(theta) =
    sqrt(1 - t^2)`` (measured on the Jackson expansion: the g=0.1..0.9 rise
    spans 1.0-1.3x this).  Near-edge windows therefore need a FAR lower
    degree than the naive ``spread / width`` scaling — 5.5x measured for
    the 3-D Laplacian band edge at sin(theta) = 0.17.
    """
    c = 0.5 * (lmax + lmin)
    e = 0.5 * (lmax - lmin)
    s = 0.0
    for x in (a, b):
        t = min(max((x - c) / e, -1.0), 1.0)
        s = max(s, float(np.sqrt(max(1.0 - t * t, 0.0))))
    return max(s, 0.01)


def _degree_rung(N):
    """Round a filter degree UP to a geometric ladder (ratio 1.25,
    multiples of 8).

    The coefficient length is a STATIC shape: every distinct degree
    compiles the filter/gram/scatter/gains (and dw) programs afresh —
    seconds each, and an interior
    solve meets many degrees (per slice geometry, count probes, dw
    continuation).  Rounding up shares compiles across slices and solves
    at <= 25% extra recurrence steps; a HIGHER degree only sharpens the
    damped indicator, so correctness is one-sided.  Same design as the
    Krylov pa ladder (solvers/krylov_schur.py).
    """
    N = int(N)
    rung = 16
    while rung < N:
        rung = -(-int(rung * 1.25) // 8) * 8
    return rung


def _auto_degree(lmin, lmax, sin_eff, delta_half, cap=40000):
    """Smallest ladder degree (see :func:`_degree_rung`) whose
    damped-indicator transition half-width is ``delta_half`` at local
    edge geometry ``sin_eff`` (see _edge_sine)."""
    N = 2.5 * (lmax - lmin) * sin_eff / max(delta_half, 1e-300)
    return int(min(_degree_rung(max(N, 16)), cap))


def cheby_filter(op, X, coeffs, lmin, lmax):
    """Apply the Chebyshev filter ``p(A)`` to the row-block ``X`` ``(s, n)``.

    Three-term recurrence with a STATIC trip count (``len(coeffs) - 1``)
    under ``lax.fori_loop``; each step is one operator matmat over the
    whole block — a gemm/gather-rich shape (cf. the block
    drivers in ``solvers/lanczos.py``).
    """
    coeffs = jnp.asarray(coeffs, X.dtype)
    N = int(coeffs.shape[0]) - 1
    c = jnp.asarray(0.5 * (lmax + lmin), X.dtype)
    inv_e = jnp.asarray(2.0 / (lmax - lmin), X.dtype)

    def amap(W):  # rows-of-vectors convention
        return (op.matmat(W.T).T - c * W) * inv_e

    T0 = X
    T1 = amap(X)
    Y = coeffs[0] * T0 + coeffs[1] * T1

    def body(jdx, carry):
        Tm1, T, Y = carry
        Tn = 2.0 * amap(T) - Tm1
        return (T, Tn, Y + coeffs[jdx] * Tn)

    if N >= 2:
        _, _, Y = lax.fori_loop(2, N + 1, body, (T0, T1, Y))
    return Y


def _cholqr2(X):
    """CholQR2 orthonormalization of the row-block ``(s, n)`` (gemm + tiny
    Cholesky twice — the same kernel as ``ops.ortho.block_cgs2``
    without the outer-basis projection)."""
    from jax.scipy.linalg import cholesky, solve_triangular

    eps = jnp.finfo(X.dtype).eps
    s = X.shape[0]

    def qr_pass(X):
        G = jnp.matmul(X, X.T, precision=_PREC)
        # relative shift scale (tiny floor only): see ops/ortho.py cholqr
        scale = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(G))),
                            jnp.finfo(X.dtype).tiny)
        L = cholesky(G + (eps * scale) * jnp.eye(s, dtype=X.dtype),
                     lower=True)
        return solve_triangular(L, X, lower=True)

    return qr_pass(qr_pass(X))


@jax.jit
def _kpm_moments(op, Z, lmin, lmax, mu_out):
    """Stochastic Chebyshev moments ``mu_j = mean_z z^T T_j(A~) z`` for
    ``j = 0..N`` (``N + 1 = mu_out.shape[0]``) in one recurrence pass.

    The moments are window-independent: ANY window's KPM count is then
    ``dot(jackson_coeffs(window), mu[:M+1])`` for any truncation ``M <=
    N`` — so one ``probes*(N+1)``-matvec pass prices every census cell
    and sizing count a driver needs (*the* reason eigsh_window's
    density census costs one count, not n_cells of them).
    """
    dt = Z.dtype
    c = jnp.asarray(0.5 * (lmax + lmin), dt)
    inv_e = jnp.asarray(2.0 / (lmax - lmin), dt)

    def amap(W):
        return (op.matmat(W.T).T - c * W) * inv_e

    T0 = Z
    T1 = amap(Z)
    mu = mu_out.at[0].set(jnp.mean(jnp.sum(Z * T0, axis=1)))
    mu = mu.at[1].set(jnp.mean(jnp.sum(Z * T1, axis=1)))

    def body(jdx, carry):
        Tm1, T, mu = carry
        Tn = 2.0 * amap(T) - Tm1
        return (T, Tn, mu.at[jdx].set(jnp.mean(jnp.sum(Z * Tn, axis=1))))

    N = int(mu_out.shape[0]) - 1
    if N >= 2:
        _, _, mu = lax.fori_loop(2, N + 1, body, (T0, T1, mu))
    return mu


def spectral_moments(op, degree, *, bounds, probes=8, key=None, mesh=None):
    """Host-f64 Chebyshev moment vector ``(degree + 1,)`` of ``op`` over
    the enclosure ``bounds`` (see :func:`_kpm_moments`).  Costs
    ``probes * (degree + 1)`` matvecs."""
    assert int(degree) >= 1, f"degree={degree}: the recurrence needs >= 1"
    lmin, lmax = float(bounds[0]), float(bounds[1])
    n = op.shape[0]
    wdtype = op.dtype
    if key is None:
        key = jax.random.key(1)
    Z = jax.random.rademacher(key, (int(probes), n), dtype=wdtype)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        Z = jax.device_put(Z, NamedSharding(
            mesh, PartitionSpec(None, mesh.axis_names[0])))
    mu = _kpm_moments(op, Z, lmin, lmax,
                      jnp.zeros(int(degree) + 1, wdtype))
    return np.asarray(mu, np.float64)


def count_from_moments(mu, interval, bounds, degree=None):
    """KPM eigenvalue count of ``interval`` from precomputed moments —
    ``dot(jackson_coeffs, mu)``, optionally truncated to a lower
    ``degree`` (the damping is degree-specific, so truncation re-damps
    rather than just slicing)."""
    lmin, lmax = float(bounds[0]), float(bounds[1])
    M = len(mu) - 1 if degree is None else int(min(degree, len(mu) - 1))
    coeffs = jackson_cheby_coeffs(float(interval[0]), float(interval[1]),
                                  lmin, lmax, M)
    return float(coeffs @ mu[:M + 1])


def estimate_window_count(A, interval, *, bounds=None, degree=120, probes=8,
                          key=None, dtype=None, bounds_dim=40, mesh=None):
    """Stochastic estimate of the NUMBER of eigenvalues of a Hermitian
    operator inside ``interval`` (the kernel-polynomial-method trace
    estimator: ``tr(1_{[a,b]}(A)) ~ mean_z z^T p(A) z`` over Rademacher
    probes — EVSL's spectrum-slicing counter).  Costs
    ``probes * (degree + 1)`` matvecs; used by :func:`eigsh_filtered` to
    size its iteration subspace.
    """
    op = as_operator(A, dtype=dtype)
    if key is None:
        key = jax.random.key(1)
    kb, kz = jax.random.split(key)
    if bounds is None:
        lmin, lmax = spectrum_bounds(op, bounds_dim, key=kb, mesh=mesh)
    else:
        lmin, lmax = float(bounds[0]), float(bounds[1])
    a = max(float(interval[0]), lmin)
    b = min(float(interval[1]), lmax)
    assert a < b, (interval, (lmin, lmax))
    mu = spectral_moments(op, degree, bounds=(lmin, lmax), probes=probes,
                          key=kz, mesh=mesh)
    return count_from_moments(mu, (a, b), (lmin, lmax))


def _host_whiten(G):
    """float64 inverse-Cholesky factor ``C`` (``C G C^T ~ I``) of a device
    (s, s) Gram, with an escalating diagonal shift.

    Small-matrix factorizations live on the HOST in float64: a filtered
    Gram has numerical rank < s (filter gains span many decades), so a
    device factorization at reduced internal precision can meet negative
    pivots and return NaN — observed on a Gram whose exact (f64)
    eigenvalues were all >= -2.6e-6 relative to the largest.  An (s, s)
    host factor costs microseconds plus one s^2-float transfer, ~1% of a
    degree-N filter sweep.
    """
    import scipy.linalg as sla

    Gh = np.asarray(G, np.float64)
    Gh = 0.5 * (Gh + Gh.T)
    s = Gh.shape[0]
    d = max(float(np.abs(Gh.diagonal()).max()), np.finfo(np.float64).tiny)
    eye = np.eye(s)
    # G carries the f32 gemm's rounding (measured eigenvalue floor ~ -3e-6
    # relative at n=262k), so escalate the shift until SPD.
    for shift in (0.0, 1e-9, 1e-6, 1e-4, 1e-2):
        try:
            L = np.linalg.cholesky(Gh + (shift * d) * eye)
            return sla.solve_triangular(L, eye, lower=True)
        except np.linalg.LinAlgError:
            continue
    w, W = np.linalg.eigh(Gh)  # last resort: eigh whitening with a floor
    w = np.maximum(w, 1e-12 * d)
    return (W / np.sqrt(w)).T


@jax.jit
def _filter_gram(op, X, coeffs, lmin, lmax):
    Y = cheby_filter(op, X, coeffs, lmin, lmax)
    return Y, jnp.matmul(Y, Y.T, precision=_PREC)


@jax.jit
def _filter_scatter_gram(op, X, idx, coeffs, lmin, lmax):
    """Soft-locking filter: apply ``p(A)`` only to rows ``idx`` of the
    Ritz block, carry the rest (converged pairs) through unchanged.

    The filter scales each row by its gain, so the refreshed rows are
    re-normalized before reassembly (the mixed-scale Gram would otherwise
    burn f32 mantissa for nothing).  Rayleigh-Ritz still runs over the
    WHOLE block, so locked pairs keep participating in the projection —
    if re-mixing ever degrades one, its residual rises and it simply
    becomes active again next sweep (self-correcting; no explicit
    deflation bookkeeping).
    """
    Xa = X[idx]
    Ya = cheby_filter(op, Xa, coeffs, lmin, lmax)
    nrm = jnp.linalg.norm(Ya, axis=1, keepdims=True)
    Ya = Ya / jnp.maximum(nrm, jnp.finfo(Ya.dtype).tiny)
    Y = X.at[idx].set(Ya)
    return Y, jnp.matmul(Y, Y.T, precision=_PREC)


def _active_rows(res, tol_abs, s):
    """Row indices to refresh this sweep under soft locking: the
    unconverged rows, padded with DISTINCT converged rows onto a HALVING
    ladder of row counts {s, s/2, s/4, ..., >=32}.

    The active count is a static shape: every distinct value compiles
    the degree-N filter afresh, and soft locking shrinks the count every
    sweep, so the old
    bucket-of-32 scheme compiled up to s/32 variants per solve (measured
    as the dominant wall of the g=64 interior bench, r05).  The halving
    ladder caps it at ~log2(s/32) shapes; the padding rows are converged
    rows whose refresh is redundant-but-valid work (a full sweep refreshes
    them anyway), bounded by one halving step ~ 2x the needed rows.
    Returns None when everything (or nothing) is active."""
    if res is None:
        return None
    active = np.nonzero(res > tol_abs)[0]
    if active.size == 0 or active.size >= s:
        return None if active.size else np.empty(0, np.intp)
    sb = s
    while sb > 32 and (sb + 1) // 2 >= active.size:
        sb = (sb + 1) // 2
    sb = min(int(-(-sb // 32) * 32), s)
    if sb >= s:
        return None
    done = np.setdiff1d(np.arange(s), active)
    return np.concatenate([active, done[: sb - active.size]])


@jax.jit
def _factor_gram(C, Y):
    Q = jnp.matmul(C, Y, precision=_PREC)
    return Q, jnp.matmul(Q, Q.T, precision=_PREC)


@jax.jit
def _factor_rr(C, Q1, op):
    Q = jnp.matmul(C, Q1, precision=_PREC)
    AQ = op.matmat(Q.T).T                              # (s, n)
    return Q, AQ, jnp.matmul(Q, AQ.T, precision=_PREC)


@jax.jit
def _rotate_residuals(Ut, theta, Q, AQ):
    V = jnp.matmul(Ut, Q, precision=_PREC)             # Ritz rows
    AV = jnp.matmul(Ut, AQ, precision=_PREC)
    return V, jnp.linalg.norm(AV - theta[:, None] * V, axis=1)


@jax.jit
def _filter_gains(op, V, coeffs, lmin, lmax):
    """``||p(A) v_i||`` for unit Ritz rows — the GHOST discriminator.

    A subspace sized past the captured cluster parks its surplus
    directions on mixtures of uncaptured (gain < ~0.1) eigendirections;
    Rayleigh-Ritz can land such a mixture's quotient INSIDE the owned
    window with a residual that never improves (measured: mid-spectrum
    3-D-Laplacian slice, 3 ghosts at 3.5e-3 relative blocking the gate
    for 25+ sweeps).  A true owned pair sits in the filter's flat top
    (gain >= 0.9 by the pad construction); a ghost is a combination of
    gain < ~0.1 directions, so one filter application separates them
    deterministically at threshold 0.5.
    """
    Y = cheby_filter(op, V, coeffs, lmin, lmax)
    return jnp.linalg.norm(Y, axis=1)


def _pending_gains(op, X, pending, coeffs, lmin, lmax):
    """:func:`_filter_gains` for the pending rows of ``X``, padded to a
    bucket of 8 rows so repeated checks with varying pending counts reuse
    ONE compiled filter (each fresh degree-N recurrence is one
    compilation)."""
    p = int(pending.size)
    idx = np.concatenate([pending, np.zeros((-p) % 8, pending.dtype)])
    gains = np.asarray(_filter_gains(op, X[jnp.asarray(idx)], coeffs,
                                     lmin, lmax), np.float64)
    return gains[:p]


def _ghost_gate(trace, sweep, pick, inside, res, theta, tol_abs, nev,
                center, scale, gains_fn):
    """Stall-triggered ghost discrimination, shared by the coarse and dw
    sweep loops (see :func:`_filter_gains` for the physics).

    Once the residual trace stalls with a small pending set among
    converged neighbors, ``gains_fn(pending)`` (one filter application on
    those rows) separates slow TRUE pairs (gain >= 0.9, keep waiting)
    from Ritz ghosts (gain < 0.5, drop from the gate AND the returned
    set).  Converged pairs need no check — a mixture of far-apart
    eigendirections cannot have a small residual.

    Returns ``(pick, inside, n_ghost, n_checked)``; ``n_checked`` is the
    8-bucketed row count actually filtered (0 when the gate did not fire)
    for the caller's matvec accounting.  ``trace[-1]`` is rewritten to
    the surviving pick's max relative residual when ghosts are dropped.
    """
    stalled = (sweep >= 2 and np.isfinite(trace[-1])
               and trace[-1] > 0.7 * trace[-3])
    if not (stalled and pick.size):
        return pick, inside, 0, 0
    pending = pick[res[pick] > tol_abs]
    if not (0 < pending.size <= max(8, int(np.ceil(0.25 * pick.size)))):
        return pick, inside, 0, 0
    n_checked = int(-(-pending.size // 8) * 8)
    ghost = pending[gains_fn(pending) < 0.5]
    if not ghost.size:
        return pick, inside, 0, n_checked
    inside = inside[~np.isin(inside, ghost)]
    if nev is None:
        pick = inside
    else:
        pick = inside[np.argsort(np.abs(theta[inside] - center))[:nev]]
    trace[-1] = float(res[pick].max() / scale) if pick.size else np.inf
    return pick, inside, int(ghost.size), n_checked


def _filter_rr_step(op, X, coeffs, lmin, lmax, active=None):
    """One filtered subspace sweep: filter (all rows, or only the
    ``active`` soft-locking subset — see :func:`_filter_scatter_gram`),
    CholQR2, Rayleigh-Ritz on A, residual norms.

    The (s, n) work (degree-N filter recurrence, all block gemms, the RR
    matvec) runs as jitted device dispatches; every (s, s) factorization
    happens on the host in float64 (see ``_host_whiten``).  The host round
    trips ride between dispatches the loop already syncs on (theta/res),
    and cost ~1% of a sweep.  Returns Ritz rows (device, ascending theta),
    theta and residual norms as host float64 arrays.
    """
    wdtype = X.dtype
    if active is None:
        Y, G = _filter_gram(op, X, coeffs, lmin, lmax)
        n_filtered = X.shape[0]
    elif active.size == 0:
        # everything locked (loop is only waiting on count stability):
        # re-project without refreshing any row
        Y = X
        G = jnp.matmul(Y, Y.T, precision=_PREC)
        n_filtered = 0
    else:
        Y, G = _filter_scatter_gram(op, X, jnp.asarray(active), coeffs,
                                    lmin, lmax)
        n_filtered = int(active.size)
    C1 = jnp.asarray(_host_whiten(G), wdtype)
    Q1, G2 = _factor_gram(C1, Y)                       # CholQR pass 2's Gram
    C2 = jnp.asarray(_host_whiten(G2), wdtype)
    Q, AQ, S = _factor_rr(C2, Q1, op)
    Sh = np.asarray(S, np.float64)
    theta, U = np.linalg.eigh(0.5 * (Sh + Sh.T))
    V, res = _rotate_residuals(jnp.asarray(U.T, wdtype),
                               jnp.asarray(theta, wdtype), Q, AQ)
    return V, theta, np.asarray(res, np.float64), n_filtered


def eigsh_filtered(
    A,
    nev,
    interval,
    *,
    degree=None,
    subspace=None,
    tol=None,
    max_iters=200,
    bounds=None,
    bounds_dim=40,
    dtype=None,
    key=None,
    refine="auto",
    mesh=None,
    X0=None,
    transition=1.5,
    _orig=None,
    _census_mu=None,
    _extras=False,
):
    """``nev`` eigenpairs of a HERMITIAN operator inside ``interval=(a, b)``
    by Chebyshev-filtered subspace iteration — interior spectrum WITHOUT
    shift-invert (no factorization, no inner solves; every step is
    ``degree`` matvecs per subspace vector).

    ``X0`` (optional, (k0, n) row block): warm-start subspace rows —
    :func:`eigsh_window` passes the previous slice's transition-band Ritz
    rows, whose directions overlap the next slice's window (adjacent
    slices share a transition band by construction), cutting the sweeps
    the fresh slice needs; rows beyond ``k0`` stay random, so coverage is
    never narrower than a cold start.  ``_extras`` (private) additionally
    returns ``(theta, X)`` — the final coarse Ritz values and the device
    row block — for exactly that handoff.

    ``_orig``/``_census_mu`` are :func:`eigsh_window`'s private plumbing:
    the slicing driver passes its already-built (and mesh-sharded)
    operator as ``A``, the ORIGINAL matrix as ``_orig`` (the dw tier's
    cast residual must target the true f64 matrix, not the f32 operator),
    and its census moment vector as ``_census_mu`` (reused for the sizing
    count when long enough; the collapse-guard count stays an independent
    draw regardless).

    Parameters
    ----------
    nev : how many pairs (nearest the window center); ``None`` means ALL
        pairs inside the window ("spectrum slice" mode, used by
        :func:`eigsh_window`): the subspace is sized at 2x the stochastic
        count of the capture window, and convergence requires every inside
        pair at ``tol`` with the inside count stable across two consecutive
        sweeps.  Statistical caveat: completeness rests on the KPM count
        (an in-window pair can be missed if the count underestimates badly
        — the 2x oversampling plus the stability test make this unlikely,
        not impossible).
    interval : the wanted window ``(a, b)`` in eigenvalue space.  The
        filter itself runs on a transition-padded superset of it (see the
        geometry comment in the body); convergence and the returned pairs
        are gated on ``(a, b)`` exactly.
    degree : Chebyshev degree of the filter; by default the smallest degree
        whose transition half-width is a quarter of the window at the
        window's LOCAL Chebyshev geometry (near-spectrum-edge windows
        resolve much more cheaply than mid-spectrum ones — see
        :func:`_edge_sine`; 5.5x measured on the 3-D Laplacian band edge).
    subspace : iteration block size; by default sized from a stochastic
        count of the eigenvalues inside the CAPTURE window (the padded
        window where the filter gain stays above ~0.1,
        :func:`estimate_window_count`) — the subspace must OVERSAMPLE the
        full captured cluster, not just ``nev``, or the unresolved
        neighbors stall convergence (measured 8x matvec swing on the 1-D
        Laplacian).
    tol : residual tolerance, RELATIVE to the spectral radius bound
        (``max(|lmin|, |lmax|)``); default ``sqrt(eps(work dtype))``.
    bounds : optional precomputed spectral enclosure ``(lmin, lmax)``;
        estimated by :func:`spectrum_bounds` otherwise (must ENCLOSE the
        spectrum — see that docstring).
    max_iters : outer (filter + Rayleigh-Ritz) iteration cap.
    refine : like :func:`arnoldi_jax.partial_schur` — "auto" engages the
        double-word continuation when the work dtype is float32 and ``tol``
        < 1e-6 (format operators only): the coarse f32 phase stops at 1e-5
        OR at its noise-floor stall (whichever comes first), and the same
        filtered sweep continues in compensated arithmetic to ``tol``
        against the TRUE matrix (1e-8-grade interior residuals on the
        f64-free device; outputs come back float64).  "dw" forces it,
        None disables.
    mesh : optional 1-D device mesh — the operator's rows, the subspace
        block, and every filter sweep (coarse AND dw) are GSPMD-partitioned
        over it; the operator size must divide the mesh
        (:func:`arnoldi_jax.linop.pad_operator` first otherwise).

    Returns
    -------
    vals : converged eigenvalues inside the window, ascending (scipy
        convention), at most ``nev`` (nearest window center first when more
        than ``nev`` converge).
    vecs : matching Ritz vectors, columns ``(n, len(vals))``.
    history : :class:`History` with the total matvec count and per-sweep
        residual trace.

    Raises ``RuntimeError`` ("Has not converged !") when fewer than ``nev``
    pairs inside the window reach ``tol`` within ``max_iters`` sweeps.
    """
    op = as_operator(A, dtype=dtype)
    n = op.shape[0]
    assert op.shape[1] == n
    wdtype = op.dtype
    assert not np.issubdtype(np.dtype(wdtype), np.complexfloating), (
        "eigsh_filtered is the real/Hermitian driver; realify complex "
        "operators first (linop.realify_operator)")
    a, b = float(interval[0]), float(interval[1])
    assert a < b, f"empty interval {interval}"

    if mesh is not None:
        from ..parallel.sharded import shard_operator

        assert n % int(mesh.devices.size) == 0, (
            f"n={n} does not divide the {mesh.devices.size}-device mesh; "
            "pad_operator first")
        op = shard_operator(op, mesh)

    if key is None:
        key = jax.random.key(0)
    kb, kx, kz = jax.random.split(key, 3)

    from ..utils.profiling import phase_clock

    clock = phase_clock()     # no-op unless ARNOLDI_PHASES is set

    if bounds is None:
        with clock("filter.bounds"):
            lmin, lmax = spectrum_bounds(op, bounds_dim, key=kb, mesh=mesh)
    else:
        lmin, lmax = float(bounds[0]), float(bounds[1])
    # The window must be inside the enclosure for the arccos map.
    a_m, b_m = max(a, lmin), min(b, lmax)
    assert a_m < b_m, (
        f"window [{a}, {b}] lies outside the spectral enclosure "
        f"[{lmin}, {lmax}]")

    # --- filter geometry (the slicing-correctness core) -------------------
    # Three nested intervals around the OWNED window [a_m, b_m] (the pairs
    # this call must converge and return):
    #   * the filter's indicator window is the owned window PADDED by one
    #     transition half-width `delta` per side, so the flat top
    #     (gain >= 0.9) covers every owned pair — without the pad, owned
    #     pairs near the edge sit mid-transition with gain ~0.5 and
    #     converge at rate g_out/g_in -> 1 against their just-outside
    #     neighbors (measured: a dense-spectrum slice stalled at 2e-3 for
    #     25+ sweeps with the unpadded window);
    #   * the CAPTURE window [a_m - 2 delta, b_m + 2 delta] is where gain
    #     stays >= ~0.1 — the subspace is sized to hold every pair in it,
    #     so the strongest UNCAPTURED direction has gain < 0.1 and each
    #     sweep contracts owned residuals by ~10x or better;
    #   * convergence is gated on the owned window only.
    w_own = b_m - a_m
    sin_eff = _edge_sine(a_m, b_m, lmin, lmax)
    # Degree choice (when not user-pinned): transition half-width =
    # ``transition`` x the owned window.  The subspace is sized to hold
    # the whole CAPTURE window (owned + transition pad), so the
    # convergence rate is set by the gain at the capture edge — which the
    # construction keeps ~fixed as the transition widens — while the
    # filter degree falls as 1/transition.  Total cost ~ s * degree has
    # its measured optimum FAR above the naive sharp-filter choice: on
    # 3-D-Laplacian interior windows the old 0.25 default cost 2.2-2.7x
    # the matvecs of transition ~1.5-2.0 at identical completeness
    # (g=48: 550k -> 218k @ 1.5, 201k @ 2.0, rising again by 2.5; g=64
    # bench window: 717k -> 325k, 60/60 pairs).  Default 1.5 — the
    # conservative side of the optimum; see docs/INTERIOR.md.  The
    # choice happens after the owned-count probe below (an empty window
    # forces a sharp transition).
    all_inside = nev is None
    matvecs = 0
    probes = 8
    expected = None
    _user_degree = degree
    # One stochastic moment pass prices every count this driver needs
    # (see _kpm_moments): the OWNED-window count (the empty-window
    # collapse guard and the sizing both need it) and the CAPTURE-window
    # count (what the subspace must hold).  Count-kernel degree: the
    # transition half-width must resolve a quarter of the counted window,
    # floor 150, capped by an explicit user degree.
    cdeg2 = _degree_rung(max(150, _auto_degree(lmin, lmax, sin_eff,
                                               0.25 * w_own, cap=8000)))
    if _user_degree is not None:
        cdeg2 = min(cdeg2, int(_user_degree))
    kz1, kz2 = jax.random.split(kz)
    if all_inside:
        # The OWNED count arms the empty-window collapse guard, and the
        # guard's value rests on being statistically INDEPENDENT of the
        # sizing count: one unlucky probe draw may defeat either, but
        # only an unlucky pair defeats both (p^2, not p).  So the owned
        # count gets its own probe draw rather than a truncation of the
        # sizing moments.
        with clock("filter.count_probe"):
            mu2 = spectral_moments(op, cdeg2, bounds=(lmin, lmax),
                                   probes=probes, key=kz2, mesh=mesh)
        matvecs += probes * (cdeg2 + 1)
        expected = count_from_moments(mu2, (a_m, b_m), (lmin, lmax))
        if expected < 1.0:
            # (Near-)empty owned window: a WIDE transition would pull the
            # neighbouring spectrum into the capture band and the inside
            # count would flap on boundary Rayleigh quotients; a sharp
            # filter keeps the capture band as empty as the window, so
            # the emptiness gate settles in two sweeps.
            transition = min(transition, 0.25)
    if _user_degree is None:
        degree = _auto_degree(lmin, lmax, sin_eff, transition * w_own)
    degree = int(degree)
    delta = 2.5 * (lmax - lmin) * sin_eff / degree
    lo_f, hi_f = max(a_m - delta, lmin), min(b_m + delta, lmax)
    lo_c, hi_c = max(a_m - 2 * delta, lmin), min(b_m + 2 * delta, lmax)
    coeffs = jackson_cheby_coeffs(lo_f, hi_f, lmin, lmax, degree)
    cdeg = int(min(degree, _degree_rung(max(150, _auto_degree(
        lmin, lmax, sin_eff, 0.25 * (hi_c - lo_c), cap=8000)))))
    if subspace is not None:
        s = int(subspace)
    else:
        if _census_mu is not None and cdeg <= len(_census_mu) - 1:
            mu = _census_mu   # moments are window-independent; free reuse
        else:
            with clock("filter.sizing_probe"):
                mu = spectral_moments(op, cdeg, bounds=(lmin, lmax),
                                      probes=probes, key=kz1, mesh=mesh)
            matvecs += probes * (cdeg + 1)
        # Size the subspace from the CAPTURE-window eigenvalue count.  The
        # owned cluster gets 2x oversampling in all-inside mode (missing a
        # tail pair is a completeness failure) / 1.5x otherwise; the
        # transition-band surplus (capture minus owned) only needs to be
        # PRESENT in the subspace, not completeness-guarded — 1.25x.
        count = max(count_from_moments(mu, (lo_c, hi_c), (lmin, lmax)), 0.0)
        if all_inside:
            owned = min(max(expected, 0.0), count)
            s = int(np.ceil(2.0 * owned + 1.25 * (count - owned))) + 8
        else:
            s = max(nev + 6, int(np.ceil(1.5 * count)) + 6)
    s = min(max(s, nev or 1), n)
    if tol is None:
        tol = float(np.sqrt(np.finfo(wdtype).eps))
    scale = max(abs(lmin), abs(lmax))

    # Double-word continuation (see the refinement tier below): the f32
    # loop runs to a coarse tolerance, then the same sweep continues in
    # compensated arithmetic against the true matrix.
    if refine in (None, "none", False):
        do_refine = False
    elif refine == "dw":
        do_refine = True
    elif refine == "auto":
        from ..linop import (BandedOperator, BsrOperator, DenseOperator,
                             EllOperator)

        do_refine = (
            np.dtype(wdtype) == np.float32 and tol < 1e-6
            and isinstance(op, (BandedOperator, BsrOperator, DenseOperator,
                                EllOperator)))
    else:
        raise ValueError(f"refine={refine!r}: expected 'auto', 'dw' or None")
    tol_target = tol
    if do_refine:
        tol = max(tol, 1e-5)

    X = jax.random.normal(kx, (s, n), dtype=wdtype)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        X = jax.device_put(X, NamedSharding(
            mesh, PartitionSpec(None, mesh.axis_names[0])))
    if X0 is not None and getattr(X0, "shape", (0,))[0]:
        k0 = min(int(X0.shape[0]), s)
        W = jnp.asarray(X0[:k0], dtype=wdtype)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            W = jax.device_put(W, NamedSharding(
                mesh, PartitionSpec(None, mesh.axis_names[0])))
        X = jax.lax.dynamic_update_slice(X, W, (0, 0))
    X = _cholqr2(X)

    verbose = bool(os.environ.get("ARNOLDI_FILTER_VERBOSE"))

    history = History.from_k(nev or 1)
    center = 0.5 * (a_m + b_m)
    prev_inside = -1
    res_prev = None   # previous sweep's residuals -> soft-locking actives
    t_sweep = time.perf_counter()
    for sweep in range(int(max_iters)):
        with clock("filter.f32_sweep"):
            X, theta_h, res_h, n_f = _filter_rr_step(
                op, X, coeffs, lmin, lmax,
                active=_active_rows(res_prev, tol * scale, s))
        res_prev = res_h
        matvecs += degree * n_f + s   # filter + the Rayleigh-Ritz matmat
        inside = np.nonzero((theta_h >= a_m) & (theta_h <= b_m))[0]
        # The break test checks EXACTLY the pairs that would be returned:
        # the nev nearest-center inside the OWNED window (or all owned
        # pairs in slice mode).  Testing "any nev converged inside" instead
        # lets a transient Ritz ghost (an unconverged subspace direction
        # whose Rayleigh quotient lands in the window) displace the true
        # nearest pairs at the break sweep.
        if all_inside:
            pick = inside
        else:
            pick = inside[np.argsort(np.abs(theta_h[inside] - center))[:nev]]
        history.residual_trace.append(
            float(res_h[pick].max() / scale) if pick.size else np.inf)
        trace = history.residual_trace
        pick, inside, n_ghost, n_chk = _ghost_gate(
            trace, sweep, pick, inside, res_h, theta_h, tol * scale, nev,
            center, scale,
            lambda pending: _pending_gains(op, X, pending, coeffs, lmin,
                                           lmax))
        matvecs += degree * n_chk
        if verbose:
            print(f"[filtered] sweep {sweep}: degree={degree} s={s} "
                  f"filtered={n_f} "
                  f"inside={inside.size} ghosts={n_ghost} max_rel_res="
                  f"{history.residual_trace[-1]:.2e} "
                  f"({time.perf_counter() - t_sweep:.1f}s)",
                  file=sys.stderr, flush=True)
            t_sweep = time.perf_counter()
        # An empty stable window is a valid result ONLY when the KPM count
        # agrees the window is empty — an inside-count collapse with a
        # populated count means the subspace rotated away from the window
        # (enclosure trouble) and must not read as success.
        empty_ok = expected is None or expected < 1.0
        stable = (inside.size == prev_inside
                  and (inside.size > 0 or empty_ok)
                  and (all_inside or pick.size >= nev))
        # dw handoff on stall: the f32 sweep floors at a problem-dependent
        # noise level; once the trace stops improving with the inside set
        # stable (and below a sanity ceiling), the double-word tier
        # continues the SAME contraction without the f32 floor.
        if (do_refine and sweep >= 2 and stable and np.isfinite(trace[-1])
                and trace[-1] < 1e-3 and trace[-1] > 0.7 * trace[-3]):
            break
        if all_inside:
            # every owned pair converged AND the inside count stable over
            # two consecutive sweeps (a pair still drifting into the window
            # means the subspace hasn't settled).
            if stable and np.all(res_h[pick] <= tol * scale):
                break
        elif pick.size >= nev and np.all(res_h[pick] <= tol * scale):
            break
        prev_inside = inside.size
    else:
        raise RuntimeError("Has not converged !")

    n_sweeps = sweep + 1
    if do_refine:
        from .refine import build_cast_residual_operator, cast_operator_f32

        op32 = cast_operator_f32(op)  # sharding-preserving (astype)
        # the cast residual must come from the TRUE (f64) matrix — when
        # eigsh_window passes a pre-built f32 operator as A, the original
        # rides in _orig
        op_lo = build_cast_residual_operator(
            A if _orig is None else _orig, op32)
        if mesh is not None and op_lo is not None:
            from ..parallel.sharded import shard_operator

            op_lo = shard_operator(op_lo, mesh)
        from ..ops.df32 import dw_to_f64

        with clock("filter.dw_phase"):
            theta_r, (Xh_r, Xl_r), res_r, pick, r_sweeps, r_mv = (
                _refine_filtered_dw(
                op32, op_lo, X, win=(lo_f, hi_f), own=(a_m, b_m), lmin=lmin,
                lmax=lmax, degree=degree, tol=tol_target, scale=scale,
                nev=nev, history=history,
                # dw theta placement is sharper than coarse, so a
                # cut-straddling pair may legitimately leave the owned
                # window — require most, not all, of the coarse inside
                # count as the collapse guard
                min_inside=(int(np.ceil(0.8 * inside.size)) if all_inside
                            else (nev or 0))))
        matvecs += r_mv
        n_sweeps += r_sweeps
        pick = pick[np.argsort(theta_r[pick])]  # scipy-ascending
        # Transfer ONLY the picked rows (both limbs), not the full (s, n)
        # workspace (see the refine.py output path).
        if pick.size:
            idx = jnp.asarray(pick)
            vals = theta_r[pick]
            # ONE batched device_get: both limb slices in flight together
            # (same pattern as the refine.py output path)
            with clock("filter.out_pull"):
                hi, lo = jax.device_get((Xh_r[idx], Xl_r[idx]))
            with clock("filter.out_combine"):
                # threaded chunked limb sum (this host converts large
                # arrays at ~100 MB/s per core; see refine.py)
                from .refine import _combine_limbs_transposed

                vecs = _combine_limbs_transposed(hi, lo)
        else:
            vals = np.empty(0)
            vecs = np.empty((n, 0))
        history.phases = clock.report()
        hist = _finalize_history(history, all_inside, len(vals), matvecs,
                                 n_sweeps)
        if _extras:
            # warm-start handoff rows come from the COARSE phase's state
            # (the next slice re-converges them anyway)
            return vals, vecs, hist, (theta_h, X)
        return vals, vecs, hist

    pick = pick[np.argsort(theta_h[pick])]  # scipy-ascending
    vals = theta_h[pick]
    # device-side row gather first: transfer only the wanted rows
    with clock("filter.out_pull"):
        vecs = (np.asarray(X[jnp.asarray(pick)], np.float64).T if pick.size
                else np.empty((n, 0)))
    history.phases = clock.report()
    hist = _finalize_history(history, all_inside, len(vals), matvecs,
                             n_sweeps)
    if _extras:
        return vals, vecs, hist, (theta_h, X)
    return vals, vecs, hist


def _finalize_history(history, all_inside, n_found, matvecs, n_sweeps):
    if all_inside and n_found != history.k:
        # all-inside mode: k is only known now.
        h2 = History.from_k(max(n_found, 1))
        h2.residual_trace = history.residual_trace
        h2.phases = history.phases
        history = h2
    history.total = matvecs
    history.matvecs[:] = matvecs
    history.restarts[:] = n_sweeps
    return history


# ---------------------------------------------------------------------------
# Double-word refinement tier: 1e-8-grade INTERIOR pairs on the f32 device.
#
# The f32 filter sweep cannot push past ~1e-6 relative residuals: each f32
# recurrence step scatters rounding noise across ALL eigendirections, so
# directions outside the window (filter gain ~0) are re-excited at the f32
# unit-roundoff level every sweep — the subspace angle floors near u_f32
# regardless of iteration count.  Running the SAME sweep in double-word
# arithmetic (ops/df32: error-free products, compensated accumulation,
# ~2^-49 unit roundoff) removes the floor; the tiny s x s factorizations
# (Cholesky, eigh) happen on the host in f64 and are applied back as
# compensated small-gemms.  Mirrors solvers/refine.py for the extremal
# drivers; engaged via ``eigsh_filtered(refine="auto")``.


def _dw_scalar(x):
    """Split a host f64 scalar into a dw (hi, lo) f32 pair."""
    h = np.float32(x)
    return h, np.float32(np.float64(x) - np.float64(h))


def _dw_matmat(op, Xh, Xl, op_lo=None):
    """Row-block dw matvec: vmap of the format dw matvec over the s rows."""
    from ..ops.df32_linop import dw_matvec

    return jax.vmap(lambda xh, xl: dw_matvec(op, xh, xl, op_lo=op_lo))(
        Xh, Xl)


def _dw_amap(op, Wh, Wl, cpair, epair, op_lo=None):
    """Affine spectral map ``(A W - c W) / e`` in dw (rows convention)."""
    from ..ops.df32 import dw_mul_fl, dw_sub, fast_two_sum, two_prod

    Ah, Al = _dw_matmat(op, Wh, Wl, op_lo)
    ch, cl = cpair
    # c * W with c a dw scalar: two_prod against the hi limb + first-order
    # cross terms (c_l * W_h + c_h * W_l), all O(u^2) accurate.
    ph, pl = two_prod(Wh, ch)
    ph, pl = fast_two_sum(ph, pl + (Wh * cl + Wl * ch))
    Sh, Sl = dw_sub(Ah, Al, ph, pl)
    eh, el = epair
    qh, ql = dw_mul_fl(Sh, Sl, eh)
    return fast_two_sum(qh, ql + Sh * el)


@jax.jit
def _dw_cheby_filter(op, Xh, Xl, ch_arr, cl_arr, cpair, epair, op_lo=None):
    """Jackson-Chebyshev filter application in double-word arithmetic
    (the dw mirror of :func:`cheby_filter`; static trip count)."""
    from ..ops.df32 import dw_add, dw_sub, fast_two_sum, two_prod

    N = int(ch_arr.shape[0]) - 1

    def cmul(j, Wh, Wl):  # coeffs[j] * W, coeff a dw scalar
        ph, pl = two_prod(Wh, ch_arr[j])
        return fast_two_sum(ph, pl + (Wh * cl_arr[j] + Wl * ch_arr[j]))

    T0 = (Xh, Xl)
    T1 = _dw_amap(op, Xh, Xl, cpair, epair, op_lo)
    Yh, Yl = dw_add(*cmul(0, *T0), *cmul(1, *T1))

    def body(j, carry):
        (Tm1h, Tm1l), (Th, Tl), (Yh, Yl) = carry
        Uh, Ul = _dw_amap(op, Th, Tl, cpair, epair, op_lo)
        # doubling is exact in binary fp
        Tnh, Tnl = dw_sub(2.0 * Uh, 2.0 * Ul, Tm1h, Tm1l)
        Yh, Yl = dw_add(Yh, Yl, *cmul(j, Tnh, Tnl))
        return ((Th, Tl), (Tnh, Tnl), (Yh, Yl))

    carry = (T0, T1, (Yh, Yl))
    if N >= 2:
        carry = lax.fori_loop(2, N + 1, body, carry)
    return carry[2]


@jax.jit
def _dw_filter_scatter(op, Xh, Xl, idx, ch_arr, cl_arr, cpair, epair,
                       op_lo=None):
    """Soft-locking dw filter: refresh only rows ``idx`` of the limb pair
    (see :func:`_filter_scatter_gram` for the scheme; no per-row
    normalization here — the host whitening runs in f64, which absorbs
    the mixed gain scales)."""
    ah, al = Xh[idx], Xl[idx]
    fh, fl = _dw_cheby_filter(op, ah, al, ch_arr, cl_arr, cpair, epair,
                              op_lo)
    return Xh.at[idx].set(fh), Xl.at[idx].set(fl)


@jax.jit
def _dw_gram(Xh, Xl, Yh, Yl):
    """``G_ij = <X_i, Y_j>`` in dw; returns (s, s) limb pairs.  Sequential
    ``lax.map`` over rows keeps temporaries at (s, n) — a vmap here would
    materialize (s, s, n)."""
    from ..ops.df32 import dw_dot

    return lax.map(
        lambda t: dw_dot(t[0][None, :], t[1][None, :], Yh, Yl, axis=-1),
        (Xh, Xl))


@jax.jit
def _dw_rotate(Ch_, Cl_, Xh, Xl):
    """``Y = C @ X`` with C a host-f64 (k, s) matrix shipped as dw limb
    pairs and X dw rows (s, n): compensated accumulation over the s terms
    (a plain f32 gemm would reintroduce u_f32-level subspace noise)."""
    from ..ops.df32 import dw_add, fast_two_sum, two_prod

    k, s = Ch_.shape
    n = Xh.shape[1]
    Yh = jnp.zeros((k, n), jnp.float32)
    Yl = jnp.zeros((k, n), jnp.float32)

    def body(j, carry):
        Yh, Yl = carry
        ch = Ch_[:, j][:, None]
        cl = Cl_[:, j][:, None]
        ph, pl = two_prod(Xh[j][None, :], ch)
        ph, pl = fast_two_sum(ph, pl + (Xh[j][None, :] * cl
                                        + Xl[j][None, :] * ch))
        return dw_add(Yh, Yl, ph, pl)

    return lax.fori_loop(0, s, body, (Yh, Yl))


@jax.jit
def _dw_residual_norms(AXh, AXl, Xh, Xl, th, tl):
    """Row norms of ``A V - theta V`` in dw (theta as dw (s,) pairs)."""
    from ..ops.df32 import dw_norm, dw_sub, fast_two_sum, two_prod

    ph, pl = two_prod(Xh, th[:, None])
    ph, pl = fast_two_sum(ph, pl + (Xh * tl[:, None] + Xl * th[:, None]))
    Rh, Rl = dw_sub(AXh, AXl, ph, pl)
    nh, _ = dw_norm(Rh, Rl, axis=1)
    return nh


def _refine_filtered_dw(op32, op_lo, X32, *, win, own, lmin, lmax, degree,
                        tol, scale, nev, history, min_inside=0,
                        max_sweeps=12):
    """Continue a stalled-f32 filtered subspace to ``tol`` in dw.

    Per sweep: one dw filter application (the PADDED window ``win``, same
    geometry as the coarse phase), dw Gram + host-f64 shifted-Cholesky
    orthonormalization, dw Rayleigh-Ritz against the TRUE matrix
    (``op32 + op_lo``), dw residual norms; convergence gated on the OWNED
    window ``own`` with at least ``min_inside`` pairs present.  Returns
    host-f64 ``theta`` and ``res`` plus the DEVICE-resident limb pair
    ``(Xh, Xl)`` of the final Ritz rows — the caller slices the wanted rows
    before any transfer.
    """
    from ..ops.df32 import dw_from_f64, dw_to_f64

    s = X32.shape[0]
    a, b = own
    coeffs = jackson_cheby_coeffs(win[0], win[1], lmin, lmax, degree)
    ch_arr, cl_arr = dw_from_f64(coeffs)
    cpair = _dw_scalar(0.5 * (lmax + lmin))
    epair = _dw_scalar(2.0 / (lmax - lmin))
    center = 0.5 * (a + b)

    Xh = jnp.asarray(X32, jnp.float32)
    Xl = jnp.zeros_like(Xh)
    matvecs = 0
    res_prev = None   # soft locking (see the coarse loop)
    t_sweep = time.perf_counter()
    for sweep in range(int(max_sweeps)):
        act = _active_rows(res_prev, tol * scale, s)
        if act is None:
            Xh, Xl = _dw_cheby_filter(op32, Xh, Xl, ch_arr, cl_arr, cpair,
                                      epair, op_lo)
            n_f = s
        elif act.size == 0:
            n_f = 0
        else:
            Xh, Xl = _dw_filter_scatter(op32, Xh, Xl, jnp.asarray(act),
                                        ch_arr, cl_arr, cpair, epair, op_lo)
            n_f = int(act.size)
        matvecs += degree * n_f
        Gh, Gl = _dw_gram(Xh, Xl, Xh, Xl)
        # filter gains span many decades, so the dw Gram can be
        # numerically indefinite even in f64 — _host_whiten's escalating
        # shift handles it (span is preserved under any invertible factor)
        C = _host_whiten(dw_to_f64(np.asarray(Gh), np.asarray(Gl)))
        Xh, Xl = _dw_rotate(*dw_from_f64(C), Xh, Xl)
        AXh, AXl = _dw_matmat(op32, Xh, Xl, op_lo)
        matvecs += s
        Sh, Sl = _dw_gram(Xh, Xl, AXh, AXl)
        S = dw_to_f64(np.asarray(Sh), np.asarray(Sl))
        theta, U = np.linalg.eigh(0.5 * (S + S.T))
        Uth, Utl = dw_from_f64(U.T)
        Xh, Xl = _dw_rotate(Uth, Utl, Xh, Xl)
        AXh, AXl = _dw_rotate(Uth, Utl, AXh, AXl)
        th, tl = dw_from_f64(theta)
        res = np.asarray(_dw_residual_norms(AXh, AXl, Xh, Xl, th, tl),
                         np.float64)
        res_prev = res
        inside = np.nonzero((theta >= a) & (theta <= b))[0]
        if nev is None:  # all-inside (spectrum-slice) mode
            pick = inside
        else:
            pick = inside[np.argsort(np.abs(theta[inside] - center))[:nev]]
        history.residual_trace.append(
            float(res[pick].max() / scale) if pick.size else np.inf)
        # dw edition of the ghost gate: a ghost that rode in from the
        # coarse subspace (or emerged as the dw Ritz rotation sharpened
        # theta placement) stalls the all-converged gate exactly as in
        # f32.  The gain check runs in plain f32 on the high limb — a
        # 0.5 threshold needs no compensation.
        trace = history.residual_trace
        pick, inside, n_ghost, n_chk = _ghost_gate(
            trace, sweep, pick, inside, res, theta, tol * scale, nev,
            center, scale,
            lambda pending: _pending_gains(op32, Xh,
                                           pending,
                                           jnp.asarray(coeffs, Xh.dtype),
                                           lmin, lmax))
        matvecs += degree * n_chk
        if os.environ.get("ARNOLDI_FILTER_VERBOSE"):
            print(f"[filtered/dw] sweep {sweep}: filtered={n_f} "
                  f"inside={inside.size} ghosts={n_ghost} "
                  f"max_rel_res={history.residual_trace[-1]:.2e} "
                  f"({time.perf_counter() - t_sweep:.1f}s)",
                  file=sys.stderr, flush=True)
            t_sweep = time.perf_counter()
        # the collapse guard discounts this sweep's identified ghosts (they
        # were counted by the coarse phase's inside set, but are not owned
        # pairs) — per-sweep, NOT cumulative: rows rotate every sweep, so
        # the same ghost is re-identified each stalled sweep.
        if (pick.size >= max(nev or 0, min_inside - n_ghost)
                and np.all(res[pick] <= tol * scale)):
            break
    else:
        raise RuntimeError("Has not converged !")

    # pick carries the ghost exclusion — the caller must NOT re-derive the
    # inside set from theta (a dropped ghost's Rayleigh quotient still
    # lies in the window).
    return theta, (Xh, Xl), res, pick, sweep + 1, matvecs


def eigsh_window(
    A,
    interval,
    *,
    max_slice=40,
    tol=None,
    degree=None,
    max_iters=200,
    bounds=None,
    bounds_dim=40,
    dtype=None,
    key=None,
    refine="auto",
    mesh=None,
    transition=1.5,
):
    """ALL eigenpairs of a HERMITIAN operator inside ``interval=(a, b)`` by
    SPECTRUM SLICING (the EVSL workflow): a KPM count sizes the job, the
    window is partitioned into sub-slices of at most ~``max_slice``
    eigenvalues each (balanced by the estimated local density), and each
    slice is solved independently by :func:`eigsh_filtered` in all-inside
    mode.  Slices are disjoint half-open intervals, so the union needs no
    deduplication; a final proximity merge guards the exactly-on-a-cut
    edge case.

    Slices are independent jobs — on a multi-chip mesh they are the
    embarrassingly-parallel axis (one slice per chip); this driver runs
    them sequentially on the current device.

    Returns ``(vals, vecs, history)`` with vals ascending and one History
    aggregating matvecs/sweeps across slices.  Completeness is statistical
    in the KPM count (see :func:`eigsh_filtered`'s ``nev=None`` caveat).
    """
    op = as_operator(A, dtype=dtype)
    a, b = float(interval[0]), float(interval[1])
    assert a < b, f"empty interval {interval}"
    if key is None:
        key = jax.random.key(0)
    kb, kz, ks = jax.random.split(key, 3)
    if mesh is not None:
        from ..parallel.sharded import shard_operator

        assert op.shape[0] % int(mesh.devices.size) == 0, (
            "pad_operator to the mesh first")
        op = shard_operator(op, mesh)
    from ..utils.profiling import phase_clock

    wclock = phase_clock()    # no-op unless ARNOLDI_PHASES is set
    if bounds is None:
        with wclock("filter.bounds"):
            lmin, lmax = spectrum_bounds(op, bounds_dim, key=kb, mesh=mesh)
    else:
        lmin, lmax = float(bounds[0]), float(bounds[1])
    a_m, b_m = max(a, lmin), min(b, lmax)
    assert a_m < b_m, (
        f"window [{a}, {b}] lies outside the spectral enclosure "
        f"[{lmin}, {lmax}]")
    scale = max(abs(lmin), abs(lmax))
    wdtype = op.dtype
    if tol is None:
        tol = float(np.sqrt(np.finfo(wdtype).eps))

    # Partition by estimated local density: KPM counts on a uniform
    # refinement grid give the cumulative distribution; cuts are placed at
    # equal-count quantiles so every slice holds ~max_slice eigenvalues
    # (a uniform-width split would overload high-density slices).
    probes = 8
    n_cells = 8
    # the count kernel must resolve a CELL: transition half-width half a
    # cell, at the window's local arccos geometry (see _edge_sine)
    cdeg = _degree_rung(max(150, _auto_degree(
        lmin, lmax, _edge_sine(a_m, b_m, lmin, lmax),
        0.5 * (b_m - a_m) / n_cells, cap=8000)))
    grid = np.linspace(a_m, b_m, n_cells + 1)
    # one moment pass prices all n_cells census counts (see _kpm_moments)
    with wclock("filter.census"):
        mu = spectral_moments(op, cdeg, bounds=(lmin, lmax), probes=probes,
                              key=kz, mesh=mesh)
    mv_count = probes * (cdeg + 1)
    cell_counts = np.array([
        max(count_from_moments(mu, (grid[i], grid[i + 1]), (lmin, lmax)),
            0.0)
        for i in range(n_cells)])
    total = float(cell_counts.sum())
    if total < 0.5:
        hist = History.from_k(1)
        hist.total = mv_count
        return np.empty(0), np.empty((op.shape[0], 0)), hist
    n_slices = int(np.ceil(total / max_slice))
    cum = np.concatenate([[0.0], np.cumsum(cell_counts)])
    targets = np.linspace(0.0, total, n_slices + 1)
    cuts = np.interp(targets, cum, grid)
    cuts[0], cuts[-1] = a_m, b_m

    all_vals, all_vecs = [], []
    matvecs, sweeps = mv_count, 0
    trace = []
    slice_phases = []
    carry = None   # previous slice's transition-band rows (warm start)
    for i in range(n_slices):
        lo, hi = float(cuts[i]), float(cuts[i + 1])
        if hi <= lo:
            continue
        # pass the BUILT (and mesh-sharded) operator — rebuilding and
        # re-uploading per slice cost O(nnz) host work + a device transfer
        # each; the
        # original A rides along for the dw tier's cast residual, and the
        # census moments serve each slice's sizing count when long enough
        vals_i, vecs_i, hist_i, (theta_i, X_i) = eigsh_filtered(
            op, None, (lo, hi), degree=degree, tol=tol,
            max_iters=max_iters, bounds=(lmin, lmax), dtype=dtype,
            key=jax.random.fold_in(ks, i), refine=refine, mesh=mesh,
            X0=carry, transition=transition, _orig=A, _census_mu=mu,
            _extras=True)
        # Warm-start handoff: this slice's transition band overlaps the
        # next slice's window, so its above-the-cut Ritz rows are
        # near-converged directions THERE — measured to cut the next
        # slice's sweep count (the rows are re-verified by the next
        # slice's own gate, so correctness is unaffected).
        if i + 1 < n_slices:
            up = np.nonzero(theta_i >= hi)[0]
            carry = X_i[jnp.asarray(up)] if up.size else None
        matvecs += hist_i.total_matvecs
        sweeps += int(hist_i.restarts.max()) if hist_i.restarts.size else 0
        trace.extend(hist_i.residual_trace)
        slice_phases.append(hist_i.phases or {})
        # half-open ownership [lo, hi) — the last slice keeps its right
        # edge — so a pair converging in two adjacent slices is kept once.
        own = (vals_i >= lo) & ((vals_i < hi) | (i == n_slices - 1))
        all_vals.append(vals_i[own])
        all_vecs.append(vecs_i[:, own])

    vals = np.concatenate(all_vals) if all_vals else np.empty(0)
    vecs = (np.concatenate(all_vecs, axis=1) if all_vecs
            else np.empty((op.shape[0], 0)))
    order = np.argsort(vals)
    vals, vecs = vals[order], vecs[:, order]
    # exactly-on-a-cut guard: merge value-coincident pairs whose vectors
    # are parallel (same eigenpair found by both neighbors).
    keep = np.ones(len(vals), bool)
    for i in range(1, len(vals)):
        if (vals[i] - vals[i - 1] <= 16 * tol * scale
                and abs(np.vdot(vecs[:, i], vecs[:, i - 1])) > 0.9):
            keep[i] = False
    vals, vecs = vals[keep], vecs[:, keep]

    history = History.from_k(max(len(vals), 1))
    history.total = matvecs
    history.matvecs[:] = matvecs
    history.restarts[:] = sweeps
    history.residual_trace = trace
    # phases: the window driver's own clocks + per-slice phases summed
    merged = dict(wclock.report())
    for ph in slice_phases:
        for k_, v_ in ph.items():
            if k_ in merged:
                merged[k_] = {
                    "seconds": round(merged[k_]["seconds"]
                                     + v_.get("seconds", 0.0), 6),
                    "calls": merged[k_].get("calls", 0) + v_.get("calls", 0),
                }
            else:
                merged[k_] = dict(v_)
    history.phases = merged
    return vals, vecs, history
