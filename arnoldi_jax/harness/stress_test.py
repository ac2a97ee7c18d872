"""Stress-test sweep CLI (reference ``scripts/stress-test.py``).

Runs a parameter grid over {krylov-schur (ours), ARPACK, deflated explicit
restarts} and writes a CSV with the reference's schema
(``stress-test.py:65-67``):

    method,dtype,nev,ncv,tol,max_restarts,p,which,elapsed,matvecs,restarts,match

Usage::

    python -m arnoldi_jax.harness.stress_test mark:100 -o stress.csv
    python -m arnoldi_jax.harness.stress_test path.mat --quick
"""

import argparse
import csv
import sys

import numpy as np

from .suite import (
    EigensolverParameters,
    arnoldi_py_ref_eig,
    arnoldi_jax_eig,
    arpack_eig,
    deflation_eig,
    eigenvalues_match,
    matrix_from_spec,
)

#: The reference's 18-config grid (``stress-test.py:29-41``): nev 3..75,
#: ncv 20..100, tol 1e-8, both LM and LR.
PARAMETERS = [
    EigensolverParameters(nev=nev, ncv=ncv, tol=1e-8, max_restarts=100_000,
                          p=None, which=which)
    for which in ("LM", "LR")
    for (nev, ncv) in [
        (3, 20), (5, 20), (5, 40), (10, 40), (10, 60), (25, 60),
        (25, 100), (50, 100), (75, 100),
    ]
]

#: The reference's grid VERBATIM (``stress-test.py:29-41``): explicit fixed
#: truncation sizes p — exercises the reference's fixed-p behavior (our
#: ``p=None`` adaptive policy never sweeps it; the CSV ``p`` column is
#: populated only by this preset).
REFERENCE_PARAMETERS = [
    EigensolverParameters(nev=nev, ncv=ncv, tol=1e-8, max_restarts=100_000,
                          p=p, which=which)
    for which in ("LM", "LR")
    for (nev, ncv, p) in [
        (3, 20, 10), (6, 20, 12), (10, 20, 16), (12, 30, 21), (20, 40, 30),
        (30, 50, 40), (50, 80, 65), (50, 100, 75), (75, 100, 85),
    ]
]

QUICK_PARAMETERS = [
    EigensolverParameters(nev=nev, ncv=ncv, tol=1e-8, max_restarts=10_000,
                          p=None, which=which)
    for which in ("LM", "LR")
    for (nev, ncv) in [(3, 20), (5, 40)]
]

GRIDS = {
    "adaptive": PARAMETERS,
    "ref-fixed-p": REFERENCE_PARAMETERS,
    "quick": QUICK_PARAMETERS,
}


def run_one(method, A, params, key):
    import jax

    if method == "arpack":
        # Same start vector as our driver: ARPACK's internal Fortran RNG
        # state persists across calls, and on matrices with tied-|lambda|
        # clusters (mark has +/- pairs) the converged cluster MEMBER
        # depends on the start vector.  Seeding both solvers from the
        # identical v0 makes rows independent of grid order/warmup AND
        # makes the match column compare like against like.
        from ..utils.random import rand_normalized_vector

        v0 = np.asarray(
            rand_normalized_vector(jax.random.key(key), A.shape[0],
                                   np.float64))
        return arpack_eig(A, params, v0=v0)
    if method == "krylov-schur":
        return arnoldi_jax_eig(A, params, key=jax.random.key(key))
    if method == "deflation":
        return deflation_eig(A, params, key=jax.random.key(key))
    if method == "arnoldi-py-ref":
        # The reference implementation itself (scripts/utils.py:161-187),
        # from the same v0 as the other methods.
        from ..utils.random import rand_normalized_vector

        v0 = np.asarray(
            rand_normalized_vector(jax.random.key(key), A.shape[0],
                                   np.float64))
        return arnoldi_py_ref_eig(A, params, v0=v0)
    raise ValueError(method)


def warmup(methods, A, seed):
    """One tiny-budget solve per method ON THE SWEEP MATRIX before timing.

    The first solve in a process pays one-time library costs — the eager
    ``jax.random`` threefry kernels compile PER SHAPE (~0.4 s at n=5050),
    the native dense tier dlopens, BLAS spins up its thread pool — that
    are benchmarking artifacts, not solver cost (measured ~0.43 s folded
    into the first grid row at mark(100), where the warm solve is
    ~0.07 s).  ARPACK pays no analogous cost (scipy is already imported
    by the harness), so warming keeps the elapsed columns
    apples-to-apples.  The warmup must use the sweep matrix itself: the
    RNG compile cache is keyed on the vector shape.
    """
    params = EigensolverParameters(nev=1, ncv=8, tol=1e-2,
                                   max_restarts=2, p=None, which="LM")
    for method in methods:
        try:
            run_one(method, A, params, seed)
        except Exception:
            pass  # a failing/non-converging warmup must not kill the sweep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("matrix")
    ap.add_argument("-o", "--output", default="stress-test.csv")
    ap.add_argument("--quick", action="store_true",
                    help="4-config grid for smoke testing")
    ap.add_argument("--grid", default="adaptive", choices=sorted(GRIDS),
                    help="parameter preset: 'adaptive' (this framework's "
                    "p=None policy over the reference's (nev,ncv) pairs), "
                    "'ref-fixed-p' (the reference grid VERBATIM, explicit "
                    "p per row — stress-test.py:29-41), 'quick'")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the untimed per-method warmup solve (one-time "
                    "jax/native/BLAS init then lands in the first grid row)")
    ap.add_argument("--methods", default="krylov-schur,arpack",
                    help="comma list of krylov-schur,arpack,deflation,"
                    "arnoldi-py-ref (the reference implementation itself, "
                    "imported from $ARNOLDI_REF_PATH)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-nev", type=int, default=None,
                    help="skip grid rows with nev above this (the "
                    "explicit-restart deflation method converges one "
                    "eigenpair at a time in complex128 — its nev>=50 "
                    "mark:100 rows cost 300-1300 s/seed, so they run at "
                    "reduced seed counts in separate sweeps)")
    ap.add_argument("--min-nev", type=int, default=None,
                    help="skip grid rows with nev below this (the "
                    "complement of --max-nev for the reduced-seed sweeps)")
    ap.add_argument("--reps", type=int, default=1,
                    help="repetitions per seed; the elapsed recorded for a "
                    "seed is the MIN over reps (steady-state estimate, "
                    "shedding transient system noise); matvec counts are "
                    "deterministic per seed")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds per row (start vectors seed..seed+N-1); the "
                    "CSV records PER-FIELD MEDIANS over the seeds and "
                    "match=True only if every seed matches.  Start-vector "
                    "luck moves matvec counts ~+/-10%% for BOTH solvers and "
                    "ARPACK's elapsed wobbles ~2x at n~5000, so "
                    "single-seed rows are noise; artifacts use 5.")
    ap.add_argument("--device", default="cpu", choices=["cpu", "default"],
                    help="cpu (default): force the CPU x64 path in-process "
                    "— the ARPACK-oracle comparison is a host benchmark; "
                    "'default' keeps whatever backend jax picked")
    args = ap.parse_args(argv)

    if args.device == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    A = matrix_from_spec(args.matrix)
    n = A.shape[0]
    grid = QUICK_PARAMETERS if args.quick else GRIDS[args.grid]
    methods = args.methods.split(",")

    if not args.no_warmup:
        warmup(methods, A, args.seed)

    seeds = list(range(args.seed, args.seed + max(args.seeds, 1)))
    rows = []
    for params in grid:
        if params.ncv >= n or params.nev >= n // 2:
            continue
        if args.max_nev is not None and params.nev > args.max_nev:
            continue
        if args.min_nev is not None and params.nev < args.min_nev:
            continue
        ref_vals = {}          # seed -> first method's eigenvalues
        # Interleave METHODS inside each (seed, rep): this box's sustained
        # throughput wobbles +/-30% on a minutes scale (shared VM), and a
        # method-blocked order would hand one solver the slow phase and
        # the other the fast one — adjacent-in-time pairs sample the same
        # noise, so the per-row ratio is honest even when absolutes drift.
        runs = {m: [] for m in methods}      # method -> per-seed stats
        match = {m: True for m in methods}
        err = {}
        for s in seeds:
            # Methods stay adjacent-in-time within each seed (the shared
            # VM's ±30% throughput drift), but REPS are the inner loop:
            # with a heavyweight method in the rotation (the complex128
            # reference runs ~10x longer and blows the cache), the run
            # that FOLLOWS it starts cache-cold — measured 1.5x inflation
            # on the following method's first rep (r05).  Rep 2+ of a
            # method follows itself, so min-over-reps is the steady-state
            # number; use --reps >= 2 whenever methods are mixed-weight.
            for method in methods:
                if method in err:
                    continue
                for rep in range(max(args.reps, 1)):
                    try:
                        vals, vecs, stats = run_one(method, A, params, s)
                    except Exception as e:  # record failure, keep sweeping
                        err[method] = e
                        break
                    if rep == 0:
                        runs[method].append(stats)
                        if method == methods[0]:
                            # only the FIRST method defines the reference;
                            # if it failed, others must not self-match
                            ref_vals[s] = np.asarray(vals)
                        elif s not in ref_vals:
                            match[method] = None   # reference failed
                        elif match[method]:
                            # Boundary-tie-aware gate: on tied-|lambda|
                            # clusters (mark is symmetric +/-) the cut
                            # member is ambiguous and both solvers are
                            # correct — see eigenvalues_match.
                            match[method] = bool(eigenvalues_match(
                                np.asarray(vals), ref_vals[s],
                                params.which))
                    elif stats.elapsed < runs[method][-1].elapsed:
                        runs[method][-1] = stats   # min over reps
        for method in methods:
            if method in err:
                e = err[method]
                rows.append([
                    method, "-", params.nev, params.ncv, params.tol,
                    params.max_restarts, params.p, params.which,
                    -1, -1, -1, f"error: {type(e).__name__}",
                ])
                print(f"{method:14s} nev={params.nev:3d} ncv={params.ncv:4d} "
                      f"{params.which}: FAILED {e}", file=sys.stderr)
                continue
            rr = runs[method]
            elapsed = float(np.median([r.elapsed for r in rr]))
            matvecs = int(np.median([r.matvecs for r in rr]))
            restarts = int(np.median([r.restarts for r in rr]))
            rows.append([
                method, rr[0].dtype, params.nev, params.ncv, params.tol,
                params.max_restarts, params.p, params.which,
                round(elapsed, 4), matvecs, restarts, match[method],
            ])
            print(f"{method:14s} nev={params.nev:3d} ncv={params.ncv:4d} "
                  f"{params.which}: {elapsed:8.3f}s {matvecs:7d} mv "
                  f"match={match[method]} ({len(rr)} seeds)",
                  file=sys.stderr)

    with open(args.output, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["method", "dtype", "nev", "ncv", "tol", "max_restarts",
                    "p", "which", "elapsed", "matvecs", "restarts", "match"])
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
