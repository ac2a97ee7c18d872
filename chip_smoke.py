#!/usr/bin/env python
"""Smoke run of the solver's main path on the GPU.

    python chip_smoke.py            # every one-card phase
    python chip_smoke.py --multi    # only the mesh paths, on four cards

Phases (one JSON line each): ``quickstart`` (the README quickstart at JAX's
default config), ``ks_scattered`` (Krylov-Schur on a 4M-row scattered
matrix, float64 and float32 + double-word routes, against ARPACK),
``ks_complexpairs`` (the real-Schur 2x2 path, 1M rows), ``lanczos``
(laplace_2d(512) against its analytic spectrum), ``hot_loop`` (bench.py's
per-matvec timing and bandwidth share) and ``surface`` (each remaining public
entry point against SciPy).  Every line names the device and the card's
power limit and carries the peak device memory after the phase; the last
line is ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when JAX finds no GPU or any check
fails.  Solves are timed with ``block_until_ready`` after a warm-up call of
the same shapes.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    """Raise (not ``assert``: checks must survive ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def card_identity():
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=120)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


class Report:
    """Prints one JSON line per phase with the device, the card and the
    peak device memory."""

    def __init__(self, card):
        import jax

        from bench import device_fields

        self.devices = jax.devices()
        self.base = {**device_fields(), "card": card}

    def peak_bytes(self):
        stats = [d.memory_stats() for d in self.devices]
        return [s.get("peak_bytes_in_use") if s else None for s in stats]

    def emit(self, phase, **fields):
        line = {"phase": phase, **self.base, **fields,
                "peak_bytes_in_use": self.peak_bytes()}
        print(json.dumps(line, default=float), flush=True)
        return line


def schur_check(A, Q, T, r_vals, tol):
    """Host float64 Schur residual ||AQ - QT|| / max|lambda(T)| (largest
    column) and the Hungarian-matched eigenvalue error relative to the
    largest reference eigenvalue."""
    from bench import hungarian_err

    Qh, Th = np.asarray(Q, np.float64), np.asarray(T, np.float64)
    vals = np.linalg.eigvals(Th)
    res = float((np.linalg.norm(A @ Qh - Qh @ Th, axis=0)
                 / np.abs(vals).max()).max())
    match = hungarian_err(vals, r_vals) / np.abs(r_vals).max()
    check(res < tol, f"Schur residual {res} >= {tol}")
    check(match < 1e-6, f"eigenvalues differ from ARPACK by {match}")
    return vals, res, match


def time_matvec(op, reps=20):
    """Median seconds of one jitted ``op.matvec`` after a warm-up call."""
    import jax
    import jax.numpy as jnp

    mv = jax.jit(lambda op, x: op.matvec(x))
    x = jnp.ones(op.shape[1], op.dtype)
    jax.block_until_ready(mv(op, x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(mv(op, x))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def ks_phase(A, k, *, tol=1e-8, max_dim=40, compare_formats=False):
    """partial_schur (LR) of the scipy matrix ``A`` on a prebuilt device
    operator, by both precision routes, each against ARPACK."""
    import jax
    from scipy.sparse.linalg import eigs

    from arnoldi_jax import partial_schur
    from arnoldi_jax.linop import as_operator
    from arnoldi_jax.solvers.refine import build_cast_residual_operator
    from arnoldi_jax.utils.sorting import arg_largest_real
    from bench import timed_twice

    t0 = time.perf_counter()
    r_vals = eigs(A, k, which="LR", tol=tol, ncv=max_dim)[0]
    out = {"n": int(A.shape[0]), "nnz": int(A.nnz), "k": k, "tol": tol,
           "max_dim": max_dim, "arpack_s": time.perf_counter() - t0,
           "routes": {}}
    if compare_formats:
        # Scattered-format rule: ELL vs BSR-8 matvec, both plain XLA.
        out["matvec_ms"] = {
            f"{fmt}_{np.dtype(dt).name}": 1e3 * time_matvec(
                as_operator(A, dtype=dt, format=fmt))
            for fmt in ("ell", "bsr") for dt in (np.float64, np.float32)}
    for route, dtype in (("f64", np.float64), ("f32_dw", np.float32)):
        op = as_operator(A, dtype=dtype)
        op_lo = (build_cast_residual_operator(A, op)
                 if dtype == np.float32 else None)
        (Q, T, hist), wall = timed_twice(lambda: partial_schur(
            op, k, sort_function=arg_largest_real, stopping_criterion=tol,
            max_dim=max_dim, dtype=dtype, refine="auto",
            refine_op_lo=op_lo, key=jax.random.key(0)))
        phases = {p: v["seconds"] for p, v in (hist.phases or {}).items()}
        if dtype == np.float64:
            # The host tier returns NumPy; the device path a device array.
            check(isinstance(Q, jax.Array), "f64 route left the device")
            where = sorted(d.platform for d in Q.devices())
        else:
            # Only the double-word continuation turns an f32 solve's
            # result into float64 host arrays (the host tier never runs
            # at f32).
            check(isinstance(Q, np.ndarray) and Q.dtype == np.float64,
                  f"f32 route returned {type(Q).__name__} {Q.dtype}")
            where = "double-word continuation"
        vals, res, match = schur_check(A, Q, T, r_vals, tol)
        out["routes"][route] = {
            "wall_s": wall, "matvecs": int(hist.total_matvecs),
            "restarts": int(hist.restarts.max()), "schur_residual": res,
            "eig_match_relerr": match, "ran_on": where,
            "nev_returned": int(np.asarray(T).shape[0]),
            "min_abs_imag": float(np.abs(vals.imag).min()),
            "phases": phases}
    return out


def phase_ks_scattered(n=1 << 22):
    from arnoldi_jax.matrices import random_scattered

    A = random_scattered(n, 24, seed=1, bandwidth=n // 64, block=8)
    return ks_phase(A, 5, compare_formats=True)


def phase_ks_complexpairs(n=1 << 20):
    from arnoldi_jax.matrices import random_scattered_complex_pairs

    A = random_scattered_complex_pairs(n, 24, seed=1, bandwidth=n // 64,
                                       block=8)
    out = ks_phase(A, 6)
    for route, r in out["routes"].items():
        check(r["min_abs_imag"] > 1e-3,
              f"{route}: a returned eigenvalue is real ({r['min_abs_imag']})")
    return out


def phase_lanczos(g=512, k=8):
    """The README's Hermitian calls against the analytic spectrum: block
    Lanczos on the square grid (its double eigenvalues need a block), and
    scalar Lanczos on a g x 3g/4 grid, whose spectrum is simple (a
    single-vector Krylov space holds one direction per eigenspace)."""
    from arnoldi_jax import partial_eigh
    from arnoldi_jax.matrices import laplace_2d, laplace_2d_eigen
    from bench import timed_twice

    out = {"k": k}
    for name, (nx, ny), b, m in (("scalar", (g, 3 * g // 4), 1, 40),
                                 ("block4", (g, g), 4, 64)):
        L = laplace_2d(nx, ny)
        want = np.sort(laplace_2d_eigen(nx, ny))[:k]
        (vals, _, hist), wall = timed_twice(lambda: partial_eigh(
            L, k, which="SA", stopping_criterion=1e-8, block_size=b,
            max_dim=m))
        err = float(np.abs(np.sort(np.asarray(vals)) - want).max()
                    / np.abs(want).max())
        check(err < 1e-8, f"lanczos {name}: eigenvalue error {err}")
        out[name] = {"grid": [nx, ny], "wall_s": wall, "eig_relerr": err,
                     "matvecs": int(hist.total_matvecs),
                     "restarts": int(hist.restarts.max())}
    return out


def phase_hot_loop(n_grid=724, max_dim=80):
    """bench.py's hot loop, scalar and block-8, with the bandwidth share
    of the byte model against the card's published peak."""
    import jax

    import bench

    kind = jax.devices()[0].device_kind
    out = {"n_grid": n_grid, "max_dim": max_dim,
           "peak_bytes_per_s": bench.hbm_peak(kind)}
    for b in (1, 8):
        _, per, ctx = bench.hot_loop(n_grid=n_grid, max_dim=max_dim, b=b)
        out[f"b{b}"] = {
            "ms_per_matvec": per * 1e3, "nnz_per_s": ctx["nnz_per_s"],
            "roofline_share": bench.roofline_fraction(
                per, ctx["n"], ctx["nnz"], max_dim, b, 8, kind)}
    return out


def quickstart_source(subs=()):
    """The first python block under README's "## Quickstart", with the
    ``(old, new)`` text substitutions applied (tests shrink the sizes)."""
    with open(os.path.join(REPO, "README.md")) as f:
        text = f.read()
    head = "## Quickstart\n\n```python\n"
    start = text.index(head) + len(head)
    src = text[start:text.index("```\n", start)]
    for old, new in subs:
        check(old in src, f"quickstart has no {old!r}")
        src = src.replace(old, new)
    return src


def phase_quickstart(subs=()):
    """The README quickstart as written, at JAX's default config (64-bit
    types off), in a scratch directory inside the checkout."""
    import jax

    src = quickstart_source(subs)
    ns = {}
    t0 = time.perf_counter()
    with jax.enable_x64(False), tempfile.TemporaryDirectory(dir=REPO) as d:
        cwd = os.getcwd()
        os.chdir(d)
        try:
            exec(compile(src, "README.md#quickstart", "exec"), ns)
        finally:
            os.chdir(cwd)
    wall = time.perf_counter() - t0
    A, Q, T = ns["A"], ns["Q"], ns["T"]
    Qh, Th = np.asarray(Q, np.float64), np.asarray(T, np.float64)
    lam = np.linalg.eigvals(Th)
    res = float((np.linalg.norm(A @ Qh - Qh @ Th, axis=0)
                 / np.abs(lam).max()).max())
    check(res < 1e-7, f"quickstart partial_schur residual {res}")
    return {"wall_s_cold": wall, "schur_residual": res,
            "schur_dtype": str(np.asarray(Q).dtype)}


def phase_surface(n_complex=1 << 16, g_si=128, n_svd=1 << 18, g_win=48,
                  window=None, m_defl=50):
    """Each remaining public entry point once, against SciPy or the
    analytic spectrum."""
    import jax
    from scipy.sparse.linalg import aslinearoperator
    from scipy.sparse.linalg import eigs as sp_eigs
    from scipy.sparse.linalg import svds as sp_svds

    from arnoldi_jax import (eigs, eigsh, eigsh_window,
                             explicit_restarts_with_deflation,
                             partial_schur, svds)
    from arnoldi_jax.linop import as_operator
    from arnoldi_jax.matrices import (laplace_2d, laplace_2d_eigen,
                                      laplace_3d, laplace_3d_eigen, mark,
                                      random_scattered)
    from bench import INTERIOR_WINDOWS, hungarian_err, timed_twice

    out = {}

    def rel(vals, ref):
        return hungarian_err(np.asarray(vals), np.asarray(ref)) / np.abs(
            ref).max()

    # eigs on a complex matrix (native complex128 on the device).
    C = (random_scattered(n_complex, 8, seed=2)
         + 1j * random_scattered(n_complex, 8, seed=3, coupling=0.05)
         ).tocsr()
    (vals, _), wall = timed_twice(lambda: eigs(C, 4, which="LM", tol=1e-10,
                                               ncv=30))
    err = rel(vals, sp_eigs(C, 4, which="LM", tol=1e-10, ncv=30)[0])
    check(err < 1e-6, f"complex eigs vs ARPACK: {err}")
    out["eigs_complex"] = {"n": n_complex, "wall_s": wall,
                           "eig_match_relerr": err}

    # Shift-invert through the host LU (jax.pure_callback).
    L = laplace_2d(g_si)
    sigma = -7.9
    (vals, _), wall = timed_twice(lambda: eigsh(
        L, 6, sigma=sigma, inner_solver="splu", tol=1e-10))
    ev = np.sort(laplace_2d_eigen(g_si))
    dist6 = np.sort(np.abs(ev - sigma))[5]
    vals = np.asarray(vals)
    err = float(np.abs(vals[:, None] - ev[None, :]).min(axis=1).max())
    check(err < 1e-8 and np.abs(vals - sigma).max() <= dist6 + 1e-8,
          f"splu shift-invert: error {err}, values {vals}")
    out["eigsh_splu"] = {"n": g_si * g_si, "wall_s": wall, "eig_err": err}

    # A SciPy LinearOperator (host matvec through pure_callback).
    M = mark(30)
    (Q, T, _), wall = timed_twice(lambda: partial_schur(
        as_operator(aslinearoperator(M)), 3, sort_function="LR",
        stopping_criterion=1e-10, max_restarts=2000))
    err = rel(np.linalg.eigvals(np.asarray(T)),
              sp_eigs(M, 3, which="LR", tol=1e-12)[0])
    check(err < 1e-6, f"LinearOperator input vs ARPACK: {err}")
    out["scipy_linear_operator"] = {"n": M.shape[0], "wall_s": wall,
                                    "eig_match_relerr": err}

    # svds on the bench's reflect-edge scattered matrix.
    S = random_scattered(n_svd, 24, seed=1, bandwidth=n_svd // 64, block=8,
                         edge="reflect")
    (_, s, _), wall = timed_twice(lambda: svds(S, 6, tol=1e-8, ncv=40))
    err = rel(s, sp_svds(S, k=6, tol=1e-8)[1])
    check(err < 1e-6, f"svds vs scipy: {err}")
    out["svds"] = {"n": n_svd, "wall_s": wall, "sv_match_relerr": err}

    # Interior window by Chebyshev filtering, against the analytic spectrum.
    a, b = window or INTERIOR_WINDOWS[g_win]
    L3 = laplace_3d(g_win)
    full = laplace_3d_eigen(g_win)
    want = np.sort(full[(full >= a) & (full <= b)])
    (vals, vecs, _), wall = timed_twice(lambda: eigsh_window(
        L3, (a, b), tol=1e-8, max_slice=60, key=jax.random.key(2)))
    vals = np.sort(np.asarray(vals))
    check(len(vals) == len(want),
          f"eigsh_window found {len(vals)} of {len(want)}")
    err = float(np.abs(vals - want).max()) if len(want) else 0.0
    check(err < 1e-8, f"eigsh_window eigenvalue error {err}")
    out["eigsh_window"] = {"n": g_win ** 3, "window": [a, b],
                           "count": len(want), "wall_s": wall,
                           "eig_err": err}

    # Explicit restarts with deflation.
    M = mark(m_defl)
    (vals, _, _), wall = timed_twice(lambda: explicit_restarts_with_deflation(
        M, 3, sort_function="LR", stopping_criterion=1e-10,
        max_restarts=2000))
    err = rel(vals, sp_eigs(M, 3, which="LR", tol=1e-12)[0])
    check(err < 1e-6, f"explicit restarts vs ARPACK: {err}")
    out["explicit_restarts_with_deflation"] = {
        "n": M.shape[0], "wall_s": wall, "eig_match_relerr": err}

    from arnoldi_jax.ops import dense_tier

    out["dense_tier"] = ("native" if dense_tier._native() is not None
                         else "scipy")
    return out


def phase_multi(n_devices=4, nx=2048):
    """__graft_entry__.dryrun_multichip: the mesh paths, each against the
    single-device solve and with the halo HLO checks."""
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n_devices, nx=nx)
    return {"n_devices": n_devices, "nx": nx, "n": nx * nx,
            "wall_s_cold": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the mesh paths, on four devices")
    args = ap.parse_args(argv)

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {platform!r}")
    return run(multi=args.multi, card=card_identity())


def run(*, multi, card):
    """Every phase (or, with ``multi``, the mesh paths only); prints the
    phase lines and the final result line."""
    import jax

    from arnoldi_jax.utils.compile_cache import enable

    enable()
    os.environ.setdefault("ARNOLDI_PHASES", "1")
    print(card, flush=True)
    rep = Report(card)
    if multi:
        jax.config.update("jax_enable_x64", True)
        rep.emit("multi", **phase_multi())
    else:
        rep.emit("quickstart", **phase_quickstart())
        jax.config.update("jax_enable_x64", True)
        for name, fn in (("ks_scattered", phase_ks_scattered),
                         ("ks_complexpairs", phase_ks_complexpairs),
                         ("lanczos", phase_lanczos),
                         ("hot_loop", phase_hot_loop),
                         ("surface", phase_surface)):
            t0 = time.perf_counter()
            fields = fn()
            rep.emit(name, phase_wall_s=time.perf_counter() - t0, **fields)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
