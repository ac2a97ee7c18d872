"""Benchmark/comparison harness library.

Parity with the reference's ``scripts/utils.py`` (SURVEY #9): uniform
parameters, wall-time + matvec statistics, ARPACK driver with matvec
counting, Hungarian eigenvalue matching, residual printing — plus this
framework's own driver.  SLEPc comparison (reference ``scripts/utils.py:
190-381``) is provided in :mod:`arnoldi_jax.harness.slepc` and activates
when petsc4py/slepc4py are installed.
"""

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator, eigs

from ..utils.sorting import sort_function_for


@dataclasses.dataclass
class EigensolverParameters:
    """Uniform solver configuration (reference ``scripts/utils.py:37-52``)."""

    nev: int
    ncv: int | None = None  # max Krylov dimension (ARPACK's ncv)
    tol: float = 1e-8
    max_restarts: int = 1000
    p: int | None = None
    which: str = "LM"

    @classmethod
    def from_cli_args(cls, args):
        return cls(
            nev=args.nev, ncv=args.max_dim, tol=args.tol,
            max_restarts=args.max_it, p=args.p, which=args.which,
        )


@dataclasses.dataclass
class Statistics:
    """Per-run measurement record (reference ``scripts/utils.py:29-35``)."""

    elapsed: float
    dtype: str
    matvecs: int
    restarts: int


class MatvecCounter(LinearOperator):
    """SciPy LinearOperator wrapper counting matvecs
    (reference ``scripts/utils.py:55-68``)."""

    def __init__(self, A):
        self.A = A
        self.n_matvecs = 0
        super().__init__(dtype=A.dtype, shape=A.shape)

    def _matvec(self, x):
        self.n_matvecs += 1
        return self.A @ x

    def _rmatvec(self, x):
        # (reference ``scripts/utils.py:66-68``) — scipy's svds needs the
        # adjoint action; counted identically.  The adjoint is cached:
        # rebuilding csc->csr per call would bill conversion as matvecs.
        self.n_matvecs += 1
        if not hasattr(self, "_AH"):
            self._AH = self.A.conj().T
            if sp.issparse(self._AH):
                self._AH = sp.csr_matrix(self._AH)
        return self._AH @ x


def find_best_matching(a, b):
    """Hungarian matching of two eigenvalue sets
    (reference ``scripts/utils.py:85-99``)."""
    from scipy.optimize import linear_sum_assignment

    a = np.asarray(a)
    b = np.asarray(b)
    k = min(a.shape[0], b.shape[0])
    cost = np.abs(a[:, None] - b[None, :])
    row_ind, col_ind = linear_sum_assignment(cost)
    return a[row_ind[:k]], b[col_ind[:k]]


#: Sort keys per ARPACK 'which' string, oriented so WANTED values have the
#: LARGEST key (the least-wanted returned value sits at the key minimum).
_WHICH_KEYS = {
    "LM": lambda x: np.abs(x), "SM": lambda x: -np.abs(x),
    "LR": lambda x: np.real(x), "SR": lambda x: -np.real(x),
    "LI": lambda x: np.imag(x), "SI": lambda x: -np.imag(x),
}


def eigenvalues_match(a, b, which="LM", rtol=1e-4, atol=1e-8):
    """Hungarian-matched eigenvalue agreement, tolerant of BOUNDARY TIES.

    On spectra with exactly tied sort keys (mark's spectrum is symmetric
    +/-lambda, so every |lambda| is shared by two eigenvalues), a request
    that cuts through a tied cluster is ambiguous: with nev=5 on mark, the
    5th slot can correctly hold either of +/-0.99771.  Two correct solvers
    can therefore return sets that differ in one element, and a plain
    ``allclose`` of the matched pairs reports a false disagreement (the
    reference works around the same effect with @flaky test markers).

    A mismatched pair is accepted iff (1) the two values have the same
    sort key to ``rtol`` (they are members of one tied cluster) and
    (2) that key lies at the selection boundary — the least-wanted key of
    the returned sets.  Interior clusters must still match exactly: both
    solvers return all their members, so the Hungarian assignment pairs
    them value-for-value.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    a_m, b_m = find_best_matching(a, b)
    close = np.isclose(a_m, b_m, rtol=rtol, atol=atol)
    if close.all():
        return True
    key = _WHICH_KEYS[which] if isinstance(which, str) else which
    ka, kb = key(a_m), key(b_m)
    boundary = min(key(a).min(), key(b).min())
    matched_a = a_m[close]
    matched_b = b_m[close]
    for i in np.nonzero(~close)[0]:
        scale = max(abs(ka[i]), abs(kb[i]), abs(boundary))
        tied = abs(ka[i] - kb[i]) <= rtol * scale + atol
        at_boundary = (abs(ka[i] - boundary) <= rtol * scale + atol
                       or abs(kb[i] - boundary) <= rtol * scale + atol)
        if not (tied and at_boundary):
            return False
        # A mismatched value that DUPLICATES one of its own side's matched
        # values is not a tie pick — it is the signature of a ghost/defect
        # copy of an already-found eigenvalue crowding out the other
        # cluster member.  Reject so the gate still catches it.
        vscale = max(abs(a_m[i]), abs(b_m[i]), 1e-30)
        if (np.any(np.abs(matched_a - a_m[i]) <= rtol * vscale + atol)
                or np.any(np.abs(matched_b - b_m[i]) <= rtol * vscale + atol)):
            return False
    return True


def print_residuals(name, A, vals, vecs, file=None):
    """Normalized residual report (reference ``scripts/utils.py:125-133``)."""
    vecs = np.asarray(vecs)
    res = np.linalg.norm(A @ vecs - vals * vecs, axis=0) / np.abs(vals)
    print(f"{name}: normalized residuals {res}", file=file)
    return res


def arpack_eig(A, params: EigensolverParameters, v0=None):
    """ARPACK oracle with matvec counting
    (reference ``scripts/utils.py:136-158``).

    ``v0``: explicit start vector.  Without it ARPACK draws from its own
    internal Fortran RNG whose state PERSISTS across calls in a process,
    so on matrices with tied-|lambda| clusters (mark has +/- pairs) the
    same call can converge to different cluster members depending on how
    many ARPACK solves ran before it.  Sweeps that want order-independent
    rows pass a seeded ``v0``.
    """
    counter = MatvecCounter(A)
    ncv = params.ncv
    t0 = time.perf_counter()
    vals, vecs = eigs(
        counter, params.nev, which=params.which, tol=params.tol,
        ncv=ncv, maxiter=params.max_restarts, v0=v0,
    )
    elapsed = time.perf_counter() - t0
    nev, ncv_eff = params.nev, ncv or min(A.shape[0], max(2 * params.nev + 1, 20))
    iters = max((counter.n_matvecs - ncv_eff) // max(ncv_eff - nev, 1), 1)
    stats = Statistics(elapsed, str(A.dtype), counter.n_matvecs, iters)
    return vals, vecs, stats


def arnoldi_jax_eig(A, params: EigensolverParameters, *, dtype=None,
                    ortho=None, key=None):
    """This framework's driver (reference ``scripts/utils.py:161-187``
    analogue): partial_schur + eigen post-processing + statistics."""
    import jax

    from ..solvers.krylov_schur import (
        eigenpairs_from_partial_schur,
        partial_schur,
    )

    sort_function = sort_function_for(params.which)
    kwargs = dict(
        max_dim=params.ncv, stopping_criterion=params.tol,
        sort_function=sort_function, max_restarts=params.max_restarts,
        p=params.p,
    )
    if dtype is not None:
        kwargs["dtype"] = dtype
    if ortho is not None:
        kwargs["ortho"] = ortho
    if key is not None:
        kwargs["key"] = key

    t0 = time.perf_counter()
    Q, T, history = partial_schur(A, params.nev, **kwargs)
    jax.block_until_ready(Q)
    elapsed = time.perf_counter() - t0

    vals, vecs = eigenpairs_from_partial_schur(Q, T)
    stats = Statistics(
        elapsed, str(np.asarray(Q).dtype), history.total_matvecs,
        int(history.restarts.max()),
    )
    return vals, vecs, stats


def _reference_package():
    """Import the REFERENCE implementation (cournape/arnoldi-py) from
    ``$ARNOLDI_REF_PATH`` (default ``/root/reference/src``).

    The reference is pure NumPy/SciPy, so it runs in-process as just
    another host method — the directly-measured "match-or-beat" anchor
    (its own stress harness is ``scripts/stress-test.py:43-67``).
    Returns the imported package or None when it is not available.
    """
    import importlib
    import os
    import sys

    path = os.environ.get("ARNOLDI_REF_PATH", "/root/reference/src")
    if not os.path.isdir(os.path.join(path, "arnoldi")):
        return None
    if path not in sys.path:
        sys.path.insert(0, path)
    try:
        return importlib.import_module("arnoldi")
    except ImportError:
        return None


def arnoldi_py_ref_eig(A, params: EigensolverParameters, v0=None):
    """THE REFERENCE implementation under this harness's interface
    (its own driver: ``scripts/utils.py:161-187`` ``arnoldi_py_eig``).

    Mirrors the reference stress harness exactly: the operator is cast to
    complex128 (``stress-test.py:61`` — the reference's ``partial_schur``
    works in complex arithmetic regardless), wrapped in a matvec counter,
    solved with ``arnoldi.krylov_schur.partial_schur``, and the
    eigenpairs extracted by diagonalizing the returned T.

    ``v0``: shared start vector.  The reference draws its start vector
    from the global ``np.random`` state inside ``partial_schur``
    (``krylov_schur.py:45``); to run it from the SAME v0 as the other
    methods (rows independent of grid order), the module-level
    ``rand_normalized_vector`` binding is temporarily replaced — the
    vector the reference sees is bit-identical to ARPACK's ``v0=``.
    """
    import importlib

    ref = _reference_package()
    if ref is None:
        raise RuntimeError(
            "reference package not importable (set ARNOLDI_REF_PATH)")
    ref_ks = importlib.import_module("arnoldi.krylov_schur")
    ref_utils = importlib.import_module("arnoldi.utils")

    sort_function = {
        "LM": ref_utils.arg_largest_magnitude,
        "LR": ref_utils.arg_largest_real,
    }[params.which]

    counter = MatvecCounter(sp.csr_matrix(A).astype(np.complex128))
    orig = ref_ks.rand_normalized_vector
    if v0 is not None:
        start = np.asarray(v0)
        start = start / np.linalg.norm(start)

        def rand_normalized_vector(n, dtype=np.float64):
            return start.astype(dtype)

        ref_ks.rand_normalized_vector = rand_normalized_vector
    try:
        t0 = time.perf_counter()
        Q, T, history = ref_ks.partial_schur(
            counter, params.nev, max_dim=params.ncv,
            stopping_criterion=params.tol,
            max_restarts=params.max_restarts,
            sort_function=sort_function, p=params.p,
        )
        elapsed = time.perf_counter() - t0
    finally:
        ref_ks.rand_normalized_vector = orig

    vals, S = np.linalg.eig(T)
    vecs = Q @ S
    idx = sort_function(vals)
    vals = vals[idx]
    vecs = vecs[:, idx]
    # restarts: the reference records per-eigenvalue restart counts in its
    # History; matvecs: the counter's ACTUAL count (same accounting as the
    # ARPACK rows — the reference's own formula undercounts by excluding
    # the initial expansion).
    stats = Statistics(elapsed, "complex128", counter.n_matvecs,
                       int(np.max(history.restarts)))
    return vals, vecs, stats


def deflation_eig(A, params: EigensolverParameters, *, key=None):
    """Explicit-restart-with-deflation driver under the same interface."""
    import jax

    from ..solvers.explicit_restarts import explicit_restarts_with_deflation

    sort_function = sort_function_for(params.which)
    t0 = time.perf_counter()
    vals, vecs, history = explicit_restarts_with_deflation(
        A, params.nev, max_dim=params.ncv, stopping_criterion=params.tol,
        sort_function=sort_function, max_restarts=params.max_restarts,
        key=key,
    )
    jax.block_until_ready(vecs)
    elapsed = time.perf_counter() - t0
    stats = Statistics(
        elapsed, str(np.asarray(vecs).dtype), history.total_matvecs,
        int(history.restarts.max()),
    )
    return vals, np.asarray(vecs), stats


def matrix_from_spec(spec, dtype=np.float64):
    """Resolve a matrix specification: a path to a SuiteSparse ``.mat`` /
    MatrixMarket ``.mtx`` file, or a generator spec like ``mark:100``,
    ``laplace:512``, ``laplace2d:64``, ``grcar:200``, ``clement:200``."""
    from .. import matrices as M

    if ":" in str(spec):
        name, _, arg = str(spec).partition(":")
        size = int(arg)
        if name == "mark":
            return M.mark(size, dtype=dtype)
        if name == "laplace":
            return sp.csr_matrix(M.laplace(size, dtype=dtype))
        if name == "laplace2d":
            return M.laplace_2d(size, dtype=dtype).astype(dtype)
        if name == "grcar":
            return grcar_matrix(size, dtype=dtype)
        if name == "clement":
            return clement_matrix(size, dtype=dtype)
        raise ValueError(f"Unknown matrix generator {name!r}")
    s = str(spec)
    if s.endswith(".mat"):
        return M.load_suitesparse_mat(s, dtype=dtype)
    if s.endswith((".mtx", ".mtx.gz")):
        return M.load_matrix_market(s, dtype=dtype)
    raise ValueError(f"Cannot interpret matrix spec {spec!r}")


def grcar_matrix(n, dtype=np.float64):
    """Grcar test matrix (reference ``scripts/compare-against-arpack.py:27``):
    -1 on the subdiagonal, 1 on the main and three superdiagonals."""
    diags = [-np.ones(n - 1, dtype=dtype)] + [
        np.ones(n - k, dtype=dtype) for k in range(0, 4)
    ]
    return sp.diags_array(diags, offsets=[-1, 0, 1, 2, 3]).tocsr()


def clement_matrix(n, dtype=np.float64):
    """Clement tridiagonal matrix with eigenvalues ±(n-1), ±(n-3), ...
    (reference ``scripts/compare-against-arpack.py:36``)."""
    k = np.arange(1, n, dtype=dtype)
    sub = np.sqrt(k * (n - k))
    return sp.diags_array([sub, sub], offsets=[-1, 1]).tocsr()
