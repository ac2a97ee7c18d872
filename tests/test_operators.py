"""Operator-layer tests: every device format must reproduce SciPy's matvec
exactly on random sparse, Markov, and Laplace matrices."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from arnoldi_jax.linop import (
    BandedOperator,
    DenseOperator,
    EllOperator,
    as_operator,
)
from arnoldi_jax.matrices import laplace, laplace_2d, mark


def random_sparse(rng, n, density=0.1, complex_=False):
    A = sp.random(n, n, density=density, random_state=np.random.RandomState(42))
    if complex_:
        A = A + 1j * sp.random(
            n, n, density=density, random_state=np.random.RandomState(43)
        )
    return sp.csr_matrix(A)


MATRICES = {
    "random": lambda rng: random_sparse(rng, 50),
    "random_complex": lambda rng: random_sparse(rng, 40, complex_=True),
    "mark10": lambda rng: mark(10),
    "laplace64": lambda rng: laplace(64).tocsr(),
    "laplace2d8": lambda rng: laplace_2d(8),
}


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("fmt", ["dense", "ell", "banded"])
def test_matvec_matches_scipy(name, fmt, rng):
    A = MATRICES[name](rng)
    op = as_operator(A, format=fmt)
    n = A.shape[0]
    x = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(x))), A @ x, rtol=1e-12, atol=1e-12
    )
    # complex input promotes
    xc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(xc))), A @ xc, rtol=1e-12, atol=1e-12
    )


@pytest.mark.parametrize("name", list(MATRICES))
def test_matmat(name, rng):
    A = MATRICES[name](rng)
    op = as_operator(A)
    n = A.shape[0]
    X = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
    np.testing.assert_allclose(
        np.asarray(op.matmat(jnp.asarray(X))), A @ X, rtol=1e-12, atol=1e-12
    )


def test_nnz_accounting(rng):
    A = mark(10)
    for fmt in ("ell", "banded"):
        op = as_operator(A, format=fmt)
        assert op.nnz == A.nnz


def test_default_format_selection(rng):
    # Stencil matrices pick the banded format, scattered ones ELL.
    assert isinstance(as_operator(laplace(100)), BandedOperator)
    assert isinstance(as_operator(random_sparse(rng, 60)), EllOperator)
    assert isinstance(as_operator(np.eye(5)), DenseOperator)


def test_operators_jit_through(rng):
    import jax

    A = as_operator(mark(10))

    @jax.jit
    def f(op, x):
        return op.matvec(x)

    x = jnp.asarray(rng.standard_normal(A.shape[0]))
    np.testing.assert_allclose(
        np.asarray(f(A, x)), mark(10) @ np.asarray(x), rtol=1e-12, atol=1e-12
    )


class TestBsrOperator:
    @pytest.mark.parametrize("gen,bs", [
        (lambda: mark(30), (4, 4)),
        (lambda: laplace_2d(20), (8, 8)),
        (lambda: random_sparse(None, 97), (8, 8)),
    ])
    def test_matches_scipy(self, gen, bs, rng):
        from arnoldi_jax.linop import BsrOperator

        A = gen()
        op = BsrOperator.from_scipy(A, blocksize=bs)
        assert op.shape == A.shape
        assert op.nnz == sp.csr_matrix(A).count_nonzero()
        x = rng.standard_normal(A.shape[1])
        np.testing.assert_allclose(
            np.asarray(op.matvec(jnp.asarray(x))), A @ x, atol=1e-12)
        X = rng.standard_normal((A.shape[1], 3))
        np.testing.assert_allclose(
            np.asarray(op.matmat(jnp.asarray(X))), A @ X, atol=1e-12)

    def test_rectangular(self, rng):
        from arnoldi_jax.linop import BsrOperator

        A = sp.random(97, 53, density=0.08,
                      random_state=np.random.RandomState(0)).tocsr()
        op = BsrOperator.from_scipy(A, blocksize=(8, 8))
        assert op.shape == (97, 53)
        x = rng.standard_normal(53)
        np.testing.assert_allclose(
            np.asarray(op.matvec(jnp.asarray(x))), A @ x, atol=1e-12)

    def test_in_solver_via_format(self, rng):
        from arnoldi_jax import partial_schur
        from arnoldi_jax.linop import as_operator

        op = as_operator(mark(30), format=("bsr", (4, 4)))
        Q, T, _ = partial_schur(op, 3, sort_function="LR",
                                stopping_criterion=1e-9, max_restarts=2000)
        Qh, Th = np.asarray(Q), np.asarray(T)
        res = np.linalg.norm(mark(30).todense() @ Qh - Qh @ Th, axis=0)
        np.testing.assert_allclose(res, 0, atol=1e-8)


def test_padded_layout_guard_and_reflect_edge():
    """A matrix with a few super-dense rows must be REFUSED by the padded
    ELL/BSR builders (r05: the clip-edge generator's adjoint OOM-killed the
    host at 34.8 GiB) — and the reflect-edge generator must stay buildable
    on BOTH sides."""
    import pytest
    import scipy.sparse as sp

    from arnoldi_jax.linop import EllOperator, BsrOperator
    from arnoldi_jax.matrices import random_scattered

    n = 4096
    A = random_scattered(n, 8, seed=2, bandwidth=n // 4, edge="clip")
    At = sp.csr_matrix(A).T.tocsr()
    deg = np.diff(At.indptr)
    assert deg.max() > 40 * deg.mean()      # the clip pathology is real
    with pytest.raises(ValueError, match="max row degree"):
        # force past the absolute-size floor by scaling the guard's view:
        # at this n the padded array is small, so call the check directly
        from arnoldi_jax.linop import _check_padded_layout

        _check_padded_layout("ELL", n * int(deg.max()) * (1 << 14),
                             At.nnz * (1 << 14), int(deg.max()), deg)

    B = random_scattered(n, 8, seed=2, bandwidth=n // 4, edge="reflect")
    Bt = sp.csr_matrix(B).T.tocsr()
    degs = np.diff(Bt.indptr)
    assert degs.max() <= 8 * max(degs.mean(), 1)  # adjoint stays bounded
    # both sides build in padded formats without tripping the guard
    EllOperator.from_scipy(Bt)
    BsrOperator.from_scipy(Bt, blocksize=(8, 8))


def test_random_scattered_reflect_same_spectral_profile():
    """edge='reflect' keeps the generator's contract: dominant separated
    outliers, bulk within coupling of [0, 1]."""
    from arnoldi_jax.matrices import random_scattered

    A = random_scattered(800, 8, seed=5, bandwidth=64, edge="reflect")
    vals = np.linalg.eigvals(A.toarray())
    top = np.sort(vals.real)[-10:]
    np.testing.assert_allclose(np.sort(top), 1.2 + 0.05 * np.arange(10),
                               atol=0.15)


def test_gram_operator_arrays_are_pytree_leaves():
    """GramOperator must expose the factor arrays as pytree CHILDREN so
    jit traces them as arguments — a closure-captured Gram embedded
    ~400 MB of operator data as HLO constants and broke the remote
    compile at 1M rows (r05)."""
    import jax
    import scipy.sparse as sp

    from arnoldi_jax.linop import GramOperator, as_operator
    from arnoldi_jax.matrices import random_scattered

    A = random_scattered(512, 8, seed=1, bandwidth=64, edge="reflect")
    op = as_operator(sp.csr_matrix(A))
    gram = GramOperator(op, transposed=False)
    leaves = jax.tree_util.tree_leaves(gram)
    assert sum(np.asarray(l).size for l in leaves) >= A.nnz
    # matvec agrees with the explicit Gram product
    x = np.random.default_rng(0).standard_normal(512)
    got = np.asarray(gram.matvec(jnp.asarray(x)))
    want = A.T @ (A @ x)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    # jit-compiling with the operator as an argument embeds no big consts
    fn = jax.jit(lambda g, v: g.matvec(v))
    text = fn.lower(gram, jnp.asarray(x)).as_text()
    assert len(text) < 500_000  # a constant-embedded program is megabytes


#: The shapes the removed Pallas kernels were tested at, now run through
#: each format's XLA path: stencils of several widths (banded), a
#: rectangular matrix (ELL), and Markov matrices whose size is and is not a
#: multiple of the 8x8 block (BSR).
FORMAT_CASES = {
    "banded-laplace777": ("banded", lambda: laplace(777).tocsr(), np.float32),
    "banded-laplace2d40": ("banded", lambda: laplace_2d(40), np.float32),
    "banded-laplace2d33x20": ("banded", lambda: laplace_2d(33, 20),
                              np.float32),
    "banded-laplace300-f64": ("banded", lambda: laplace(300).tocsr(),
                              np.float64),
    "ell-rect120x80": ("ell", lambda: sp.random(
        120, 80, density=0.15, random_state=0, format="csr"), np.float32),
    "bsr-mark60": ("bsr", lambda: mark(60), np.float32),
    "bsr-mark20": ("bsr", lambda: mark(20), np.float32),
}


@pytest.mark.parametrize("kind", ["matvec", "matmat"])
@pytest.mark.parametrize("case", list(FORMAT_CASES))
def test_format_xla_path_matches_scipy(case, kind):
    fmt, gen, dtype = FORMAT_CASES[case]
    A = gen()
    op = as_operator(A, dtype=dtype, format=fmt)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((A.shape[1], 3) if kind == "matmat"
                            else A.shape[1]).astype(dtype)
    y = getattr(op, kind)(jnp.asarray(x))
    assert y.dtype == dtype
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(np.asarray(y), A @ x.astype(np.float64),
                               rtol=tol, atol=tol)
