#!/usr/bin/env python
"""Benchmark modes, one JSON line each.

``python bench.py`` (hot loop): wall time per Arnoldi iteration (one SpMV +
one CGS2 orthogonalization against the Krylov workspace) on a 2-D
Laplacian, scalar and block-b, against ARPACK's measured per-iteration time
on the host CPU for the same operator, with the share of the device's
memory-bandwidth peak that the byte model of :func:`roofline_fraction`
implies.  An eigenvalue gate against the analytic spectrum runs first.

Other modes: ``solve [m_grid]`` (mark matrix, K=5 LR), ``scattered [n]``,
``complexpairs [n]``, ``svds [n]`` and ``interior [g]``, each against
ARPACK/SciPy or the analytic spectrum in the same run.

Every mode runs in float64 (x64 is enabled in :func:`main`), times with
``block_until_ready`` after a warm-up call of the same shapes, names the
device it ran on, and exits non-zero when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np


def device_fields():
    """Platform, device kind and device count, as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def correctness_gate(dtype=np.float64):
    """Small partial_eigh solve validated against the analytic spectrum.
    Gate: eigenvalue error AND true residual < 100*tol at tol 1e-8."""
    import jax

    from arnoldi_jax import partial_eigh
    from arnoldi_jax.matrices import laplace_2d, laplace_2d_eigen

    nx, ny = 40, 39
    A = laplace_2d(nx, ny)
    tol = 1e-8
    vals, vecs, hist = partial_eigh(
        A.astype(dtype), 4, which="LA", stopping_criterion=tol,
        max_restarts=3000, dtype=dtype, key=jax.random.key(0),
    )
    want = np.sort(laplace_2d_eigen(nx, ny))[-4:]
    err = float(np.abs(np.sort(vals) - want).max())
    vecs_h = np.asarray(vecs, np.float64)
    res = np.linalg.norm(A @ vecs_h - vecs_h * np.asarray(vals)[None, :],
                         axis=0)
    assert err < 100 * tol, f"correctness gate failed: eigenvalue err {err}"
    assert res.max() < 100 * tol, f"gate residual {res.max()}"
    return {"gate_tol": tol, "gate_eig_err": err,
            "gate_residual": float(res.max()),
            "gate_matvecs": int(hist.total_matvecs)}


def hot_loop(n_grid=724, max_dim=80, b=1, reps=5, dtype=np.float64):
    """Seconds per matvec of one full expansion cycle 0 -> ``max_dim``
    (scalar CGS2 when ``b == 1``, block CGS2 + CholQR2 otherwise): the
    median of ``reps`` timed cycles after one warm-up cycle."""
    import jax
    import jax.numpy as jnp

    from arnoldi_jax.linop import as_operator
    from arnoldi_jax.matrices import laplace_2d
    from arnoldi_jax.ops.ortho import block_cgs2
    from arnoldi_jax.solvers.decomposition import (_block_expand_jit,
                                                   _expand_auto)
    from arnoldi_jax.utils.random import rand_normalized_vector

    op = as_operator(laplace_2d(n_grid).astype(dtype))
    n = op.shape[0]
    tolv = float(np.sqrt(np.finfo(dtype).eps))

    @jax.jit
    def one_cycle(op, v0):
        H = jnp.zeros((max_dim + b, max_dim), dtype)
        Vt = jnp.zeros((max_dim + b, n), dtype)
        if b == 1:
            Vt = Vt.at[0, :].set(v0)
            return _expand_auto(op, Vt, H, tolv, start_dim=0,
                                max_dim=max_dim, ortho="cgs2")
        W0 = jnp.concatenate([
            v0[None, :],
            jax.random.normal(jax.random.key(7), (b - 1, n), dtype),
        ])
        _, Q0, _, _ = block_cgs2(Vt, W0, 0, tol=tolv)
        Vt = jax.lax.dynamic_update_slice(Vt, Q0, (0, 0))
        return _block_expand_jit(op, Vt, H, tolv, start_block=0,
                                 n_blocks=max_dim // b, b=b)

    v0 = rand_normalized_vector(jax.random.key(0), n, dtype)
    jax.block_until_ready(one_cycle(op, v0))          # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(one_cycle(op, v0))
        times.append(time.perf_counter() - t0)
    per_matvec = float(np.median(times)) / max_dim
    return op, per_matvec, {
        "n": n, "nnz": int(op.nnz), "max_dim": max_dim,
        "nnz_per_s": op.nnz / per_matvec,
    }


def arpack_per_iter(op_scipy, max_dim=80, budget_matvecs=600):
    """ARPACK's measured per-iteration (matvec + its orthogonalization)
    time on the host for the same operator and Krylov dimension."""
    from scipy.sparse.linalg import ArpackNoConvergence, eigsh

    from arnoldi_jax.harness.suite import MatvecCounter

    counter = MatvecCounter(op_scipy)
    maxiter = max(budget_matvecs // max(max_dim - 5, 1), 2)
    t0 = time.perf_counter()
    try:
        eigsh(counter, 5, which="SA", ncv=max_dim, maxiter=maxiter, tol=1e-14)
    except ArpackNoConvergence:
        pass
    elapsed = time.perf_counter() - t0
    return elapsed / max(counter.n_matvecs, 1), counter.n_matvecs


#: Published peak device-memory bandwidth, bytes/s, keyed by JAX's
#: ``device_kind``.  NVIDIA H100 SXM5 80 GB: 3.35 TB/s at its 700 W power
#: limit (NVIDIA H100 Tensor Core GPU data sheet).  A device that is not in
#: the table is an error, not a default.
HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_peak(device_kind):
    """Peak bandwidth of ``device_kind`` from :data:`HBM_PEAK`."""
    try:
        return HBM_PEAK[device_kind]
    except KeyError:
        raise KeyError(f"no bandwidth peak for device kind {device_kind!r}; "
                       f"known: {sorted(HBM_PEAK)}") from None


def roofline_fraction(per_matvec_s, n, nnz, max_dim, b, dtype_bytes,
                      device_kind):
    """Fraction of the device's bandwidth peak the hot loop achieves.

    Model bytes per matvec: CGS2's minimum of 4 streaming passes (2
    projection + 2 update) over the active basis, which averages
    (max_dim+1)/2 rows of n over an expansion from 0 to max_dim, amortized
    over the b vectors of a block; plus the SpMV's matrix + vector traffic
    (matrix data, x read, y write).  Index bookkeeping and the H/scalar
    traffic are excluded, so the fraction is slightly conservative.
    """
    basis = 4 * 0.5 * (max_dim + 1) * n * dtype_bytes / b
    spmv = nnz * dtype_bytes + 2 * n * dtype_bytes
    return (basis + spmv) / per_matvec_s / hbm_peak(device_kind)


def main_hot_loop():
    dev = device_fields()
    dtype = np.float64
    gate = correctness_gate(dtype)

    n_grid = int(os.environ.get("BENCH_GRID", "724"))
    blk = int(os.environ.get("BENCH_BLOCK", "8"))
    _, scalar_per_iter, ctx = hot_loop(n_grid=n_grid, b=1, dtype=dtype)
    _, block_per_iter, bctx = hot_loop(n_grid=n_grid, b=blk, dtype=dtype)

    import scipy.sparse as sp

    from arnoldi_jax.matrices import laplace_2d

    A_host = sp.csr_matrix(laplace_2d(n_grid).astype(np.float64))
    arpack_it, arpack_mv = arpack_per_iter(A_host, max_dim=ctx["max_dim"])

    nbytes = np.dtype(dtype).itemsize
    roof = roofline_fraction(block_per_iter, ctx["n"], ctx["nnz"],
                             ctx["max_dim"], blk, nbytes, dev["device_kind"])
    roof_scalar = roofline_fraction(scalar_per_iter, ctx["n"], ctx["nnz"],
                                    ctx["max_dim"], 1, nbytes,
                                    dev["device_kind"])
    print(json.dumps({
        "metric": f"arnoldi_hot_loop_ms_per_matvec_block{blk}",
        "value": block_per_iter * 1e3,
        "unit": "ms",
        "vs_baseline": arpack_it / block_per_iter,
        **dev,
        "dtype": str(np.dtype(dtype)),
        "arpack_ms_per_iteration": arpack_it * 1e3,
        "arpack_matvecs_sampled": arpack_mv,
        "scalar_ms_per_matvec": scalar_per_iter * 1e3,
        "scalar_vs_arpack": arpack_it / scalar_per_iter,
        "block_nnz_per_s": bctx["nnz_per_s"],
        "hbm_roofline_frac": roof,
        "hbm_roofline_frac_scalar": roof_scalar,
        **ctx,
        **gate,
    }))


def timed_twice(fn):
    """Run ``fn`` once to compile, then time a second call of the same
    shapes to completion; returns ``(result, seconds)``."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def hungarian_err(vals, ref):
    """Largest |difference| after matching ``vals`` to ``ref`` one-to-one
    (rectangular inputs match the shorter side)."""
    from scipy.optimize import linear_sum_assignment

    ri, ci = linear_sum_assignment(np.abs(vals[:, None] - ref[None, :]))
    return float(np.abs(vals[ri] - ref[ci]).max())


def _phases(hist):
    return {k: v.get("seconds", 0.0) for k, v in (hist.phases or {}).items()}


def _scattered_bandwidth(n):
    """Banded-scattered profile (bandwidth n/64, the FE/mesh shape real
    SuiteSparse matrices have); ``BENCH_SCATTER_BW=0`` selects globally
    random columns, any other value a bandwidth."""
    bw_env = os.environ.get("BENCH_SCATTER_BW", "")
    if bw_env == "0":
        return None, None
    return (int(bw_env) if bw_env else max(n // 64, 8)), 8


def _schur_solve_vs_arpack(A, k, name, dtype=np.float64):
    """Timed partial_schur (LR) on a prebuilt operator, checked against
    ARPACK; returns the eigenvalues and the common JSON fields."""
    import jax
    from scipy.sparse.linalg import eigs

    from arnoldi_jax import partial_schur
    from arnoldi_jax.harness.suite import MatvecCounter
    from arnoldi_jax.linop import as_operator
    from arnoldi_jax.utils.sorting import arg_largest_real

    tol = float(os.environ.get("BENCH_SOLVE_TOL", "1e-8"))
    max_dim = int(os.environ.get("BENCH_MAX_DIM", "40"))
    # The device operator is built once: matrix conversion and upload are
    # set-up, as ARPACK's timed region gets a prebuilt CSR.
    op = as_operator(A, dtype=dtype)
    os.environ.setdefault("ARNOLDI_PHASES", "1")
    (Q, T, hist), ours_s = timed_twice(lambda: partial_schur(
        op, k, max_dim=max_dim, stopping_criterion=tol,
        sort_function=arg_largest_real, max_restarts=2000, dtype=dtype,
        ortho="cgs2", key=jax.random.key(0)))

    Qh, Th = np.asarray(Q, np.float64), np.asarray(T, np.float64)
    vals = np.linalg.eigvals(Th)
    schur_rel = np.linalg.norm(A @ Qh - Qh @ Th, axis=0) / np.abs(vals).max()

    counter = MatvecCounter(A)
    t0 = time.perf_counter()
    r_vals, _ = eigs(counter, k, which="LR", tol=tol, ncv=max_dim)
    arpack_s = time.perf_counter() - t0
    return vals, {
        "metric": name,
        "value": ours_s,
        "unit": "s",
        "vs_baseline": arpack_s / ours_s,
        **device_fields(),
        "n": int(A.shape[0]),
        "nnz": int(A.nnz),
        "dtype": str(np.dtype(dtype)),
        "tol": tol,
        "matvecs": int(hist.total_matvecs),
        "restarts": int(hist.restarts.max()),
        "nev_returned": int(Th.shape[0]),
        "max_schur_residual": float(schur_rel.max()),
        "arpack_seconds": arpack_s,
        "arpack_matvecs": int(counter.n_matvecs),
        "eigval_match_err": hungarian_err(vals, r_vals),
        "phases": _phases(hist),
    }


def main_solve(m_grid=300):
    """End-to-end Krylov-Schur solve of mark(m_grid), K=5 LR, vs ARPACK."""
    from arnoldi_jax.matrices import mark

    _, line = _schur_solve_vs_arpack(
        mark(m_grid), 5, f"partial_schur_mark{m_grid}_k5_LR_wall")
    print(json.dumps(line))


def main_scattered(n=1 << 20):
    """K=5 LR of a banded-scattered matrix (SuiteSparse stand-in)."""
    from arnoldi_jax.matrices import random_scattered

    bandwidth, block = _scattered_bandwidth(n)
    A = random_scattered(n, 24, seed=1, bandwidth=bandwidth, block=block)
    _, line = _schur_solve_vs_arpack(
        A, 5, f"partial_schur_scattered_n{n}_k5_LR_wall")
    print(json.dumps({**line, "bandwidth": bandwidth}))


def main_complex_pairs(n=1 << 20):
    """K=6 LR of a scattered matrix whose DOMINANT eigenvalues are complex
    conjugate pairs: the real-Schur 2x2-block path at scale."""
    from arnoldi_jax.matrices import random_scattered_complex_pairs

    bandwidth, block = _scattered_bandwidth(n)
    A = random_scattered_complex_pairs(n, 24, seed=1, bandwidth=bandwidth,
                                       block=block)
    vals, line = _schur_solve_vs_arpack(
        A, 6, f"partial_schur_complex_pairs_n{n}_k6_LR_wall")
    min_imag = float(np.abs(vals.imag).min())
    print(json.dumps({**line, "bandwidth": bandwidth,
                      "min_abs_imag": min_imag,
                      "all_complex": bool(min_imag > 1e-3)}))


def main_svds(n=1 << 20, dtype=np.float64):
    """K=6 largest singular triplets of a scattered matrix vs
    scipy.sparse.linalg.svds."""
    import jax
    from scipy.sparse.linalg import svds as svds_scipy

    from arnoldi_jax import svds
    from arnoldi_jax.harness.suite import MatvecCounter
    from arnoldi_jax.linop import as_operator
    from arnoldi_jax.matrices import random_scattered

    k = 6
    bandwidth, block = _scattered_bandwidth(n)
    # edge="reflect": svds works through A AND A^H — the "clip" edge
    # concentrates out-of-band columns on the boundary, whose adjoint has
    # two super-dense rows no padded device layout can carry
    # (linop._check_padded_layout).
    A = random_scattered(n, 24, seed=1, bandwidth=bandwidth, block=block,
                         edge="reflect")
    tol = float(os.environ.get("BENCH_SOLVE_TOL", "1e-8"))
    ncv = int(os.environ.get("BENCH_MAX_DIM", "40"))
    op = as_operator(A, dtype=dtype)
    os.environ.setdefault("ARNOLDI_PHASES", "1")
    (U, s, Vh, hist), ours_s = timed_twice(lambda: svds(
        op, k, which="LM", tol=tol, ncv=ncv, maxiter=2000, dtype=dtype,
        key=jax.random.key(0), return_history=True))

    Uh = np.asarray(U, np.float64)
    Vhh = np.asarray(Vh, np.float64)
    sh = np.asarray(s, np.float64)
    res = np.linalg.norm(A @ Vhh.T - Uh * sh[None, :], axis=0) / sh

    counter = MatvecCounter(A)
    t0 = time.perf_counter()
    _, s_ref, _ = svds_scipy(counter, k=k, which="LM", tol=tol)
    scipy_s = time.perf_counter() - t0
    print(json.dumps({
        "metric": f"svds_scattered_n{n}_k{k}_LM_wall",
        "bandwidth": bandwidth,
        "value": ours_s,
        "unit": "s",
        "vs_baseline": scipy_s / ours_s,
        **device_fields(),
        "n": int(A.shape[0]),
        "nnz": int(A.nnz),
        "dtype": str(np.dtype(dtype)),
        "tol": tol,
        "singular_values": [float(x) for x in np.sort(sh)[::-1]],
        "max_residual": float(res.max()),
        "scipy_seconds": scipy_s,
        "scipy_matvecs": int(counter.n_matvecs),
        "sv_match_relerr": float(np.abs(np.sort(sh) - np.sort(s_ref)).max()
                                 / np.abs(s_ref).max()),
        "matvecs": int(hist.total_matvecs),
        "restarts": int(hist.restarts.max()),
        "phases": _phases(hist),
    }))


#: Interior windows per 3-D grid: truly interior, modest slice size.
INTERIOR_WINDOWS = {48: (-11.9, -11.84), 64: (-11.93, -11.89),
                    80: (-11.95, -11.93)}


def main_interior(g=64, dtype=np.float64):
    """Interior window of a 3-D Laplacian by polynomial filtering: the
    workload where shift-invert is off the table (sparse LU of the 7-point
    stencil fills O(n g^2)), checked against the ANALYTIC spectrum."""
    import jax

    from arnoldi_jax import eigsh_window
    from arnoldi_jax.matrices import laplace_3d, laplace_3d_eigen

    a, b = INTERIOR_WINDOWS.get(g, (-11.93, -11.89))
    A = laplace_3d(g)
    full = np.sort(laplace_3d_eigen(g))
    want = full[(full >= a) & (full <= b)]
    tol = float(os.environ.get("BENCH_SOLVE_TOL", "1e-8"))
    os.environ.setdefault("ARNOLDI_PHASES", "1")
    (vals, vecs, hist), wall = timed_twice(lambda: eigsh_window(
        A, (a, b), tol=tol, dtype=dtype, max_slice=60,
        key=jax.random.key(2)))

    res = (np.linalg.norm(A @ vecs - vals * vecs, axis=0)
           if len(vals) else np.zeros(0))
    dist = (np.abs(vals[:, None] - want[None, :]).min(axis=1)
            if len(vals) else np.zeros(0))
    print(json.dumps({
        "metric": f"eigsh_window_3d_laplacian_g{g}_wall",
        "value": wall,
        "unit": "s",
        **device_fields(),
        "n": g ** 3,
        "dtype": str(np.dtype(dtype)),
        "window": [a, b],
        "true_count": int(want.size),
        "found": int(len(vals)),
        "complete": bool(len(vals) == want.size),
        "max_residual": float(res.max()) if res.size else None,
        "max_eig_err": float(dist.max()) if dist.size else None,
        "matvecs": int(hist.total_matvecs),
        "tol": tol,
        "phases": _phases(hist),
    }))


MODES = {"hot_loop": main_hot_loop, "solve": main_solve,
         "scattered": main_scattered, "complexpairs": main_complex_pairs,
         "svds": main_svds, "interior": main_interior}


def main(argv):
    import jax

    jax.config.update("jax_enable_x64", True)
    from arnoldi_jax.utils.compile_cache import enable

    enable()
    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {platform!r}")
    mode = argv[1] if len(argv) > 1 else "hot_loop"
    if mode not in MODES:
        sys.exit(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    MODES[mode](*(int(a) for a in argv[2:3]))


if __name__ == "__main__":
    main(sys.argv)
