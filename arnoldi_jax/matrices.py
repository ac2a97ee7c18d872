"""Test-matrix generators and loaders (host tier).

Capability parity with the reference's ``src/arnoldi/matrices.py`` (``mark``,
``laplace``, ``laplace_eigen``) plus the SuiteSparse ``.mat`` loader that the
reference keeps in its script layer (``scripts/utils.py:102-116``), and a 2-D
Laplacian used by the benchmark configs.  Generators return SciPy CSR on the
host; convert with :func:`arnoldi_jax.linop.as_operator` for device execution.

The generators here are vectorized NumPy (the reference's ``mark`` is an
explicit Python loop it itself labels naive, ``matrices.py:22``); outputs are
validated against the reference's golden values in ``tests/test_matrices.py``.
"""

import numpy as np
import scipy.sparse as sp


def mark(m, dtype=np.float64):
    """Markov random-walk transition matrix on a triangular grid with ``m`` rows.

    ``n = m*(m+1)/2`` states ``(i, j)`` with ``0 <= i < m``, ``0 <= j < m-i``,
    enumerated row-major.  From state ``(i, j)`` the walk moves

    * north ``(i, j+1)`` and east ``(i+1, j)`` with weight
      ``pd = 0.5*(i+j+1)/(m-1)`` — doubled on the ``i == 0`` (north) and
      ``j == 0`` (east) boundaries (reflection),
    * south ``(i, j-1)`` and west ``(i-1, j)`` with weight
      ``pu = 0.5 - 0.5*(i+j-1)/(m-1)`` where those neighbours exist.

    This is the example operator of Saad, *Numerical Methods for Large
    Eigenvalue Problems* (2nd ed.) §2.5.1, whose convergence tables 6.1-6.3
    anchor the test suite.  Matches the reference generator
    (``src/arnoldi/matrices.py:5-73``) entry-for-entry.
    """
    if m < 2:
        raise ValueError("mark(m) requires m >= 2")
    n = m * (m + 1) // 2
    cst = 0.5 / (m - 1)

    # State coordinates, row-major: i is the grid row, j the offset inside it.
    i = np.repeat(np.arange(m), np.arange(m, 0, -1))
    j = np.arange(n) - np.repeat(np.cumsum(np.concatenate([[0], np.arange(m, 1, -1)])), np.arange(m, 0, -1))
    ix = np.arange(n)
    jmax = m - i

    pd = cst * (i + j + 1)
    pu = 0.5 - cst * (i + j - 1)

    rows, cols, vals = [], [], []

    interior = j < jmax - 1  # states with north/east moves
    # North: (i, j) -> (i, j+1); doubled on the i == 0 boundary.
    rows.append(ix[interior])
    cols.append(ix[interior] + 1)
    vals.append(pd[interior] * np.where(i[interior] == 0, 2.0, 1.0))
    # East: (i, j) -> (i+1, j); doubled on the j == 0 boundary.
    rows.append(ix[interior])
    cols.append(ix[interior] + jmax[interior])
    vals.append(pd[interior] * np.where(j[interior] == 0, 2.0, 1.0))
    # South: (i, j) -> (i, j-1).
    south = j > 0
    rows.append(ix[south])
    cols.append(ix[south] - 1)
    vals.append(pu[south])
    # West: (i, j) -> (i-1, j).
    west = i > 0
    rows.append(ix[west])
    cols.append(ix[west] - jmax[west] - 1)
    vals.append(pu[west])

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals).astype(dtype)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


def laplace(n, dtype=None):
    """1-D Laplacian: tridiagonal with -2 on the diagonal, 1 off-diagonal.

    Parity with ``src/arnoldi/matrices.py:87-95``.
    """
    off = np.ones(n - 1, dtype=dtype)
    main = -2 * np.ones(n, dtype=dtype)
    return sp.diags_array([main, off, off], offsets=[0, -1, 1])


def laplace_eigen(n):
    """Analytic spectrum of :func:`laplace`: ``-2 + 2 cos(k pi / (n+1))``.

    Parity with ``src/arnoldi/matrices.py:76-84``.
    """
    return -2 + 2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))


def laplace_2d(nx, ny=None, dtype=None):
    """2-D five-point Laplacian on an ``nx x ny`` grid (Dirichlet).

    ``n = nx*ny`` pentadiagonal matrix with -4 on the diagonal; used by the
    benchmark configs (BASELINE.json config #2).
    """
    ny = ny or nx
    lx = laplace(nx, dtype=dtype)
    ly = laplace(ny, dtype=dtype)
    return (sp.kron(sp.eye_array(ny), lx) + sp.kron(ly, sp.eye_array(nx))).tocsr()


def laplace_2d_eigen(nx, ny=None):
    """Analytic spectrum of :func:`laplace_2d` (all ``nx*ny`` eigenvalues)."""
    ny = ny or nx
    ex = laplace_eigen(nx)
    ey = laplace_eigen(ny)
    return (ex[None, :] + ey[:, None]).ravel()


def laplace_3d(nx, ny=None, nz=None, dtype=None):
    """3-D seven-point Laplacian on an ``nx x ny x nz`` grid (Dirichlet).

    The regime where shift-invert factorizations become infeasible
    (bandwidth ``nx*ny`` makes sparse-LU fill explode) — the target
    workload for the polynomial-filtered interior drivers
    (:func:`arnoldi_jax.eigsh_filtered` / :func:`arnoldi_jax.eigsh_window`).
    """
    ny = ny or nx
    nz = nz or nx
    Ix, Iy, Iz = (sp.eye_array(m) for m in (nx, ny, nz))
    lx, ly, lz = (laplace(m, dtype=dtype) for m in (nx, ny, nz))
    return (sp.kron(Iz, sp.kron(Iy, lx))
            + sp.kron(Iz, sp.kron(ly, Ix))
            + sp.kron(lz, sp.kron(Iy, Ix))).tocsr()


def laplace_3d_eigen(nx, ny=None, nz=None):
    """Analytic spectrum of :func:`laplace_3d` (all ``nx*ny*nz`` values)."""
    ny = ny or nx
    nz = nz or nx
    ex = laplace_eigen(nx)
    ey = laplace_eigen(ny)
    ez = laplace_eigen(nz)
    return (ex[None, None, :] + ey[None, :, None]
            + ez[:, None, None]).ravel()


def load_suitesparse_mat(path, dtype=None):
    """Load a SuiteSparse collection ``.mat`` file to CSR.

    Mirrors the reference harness loader (``scripts/utils.py:102-116``): the
    matrix lives at ``Problem['A'][0, 0]``.
    """
    from scipy.io import loadmat

    contents = loadmat(path)
    A = contents["Problem"]["A"][0, 0]
    A = sp.csr_matrix(A)
    if dtype is not None:
        A = A.astype(dtype)
    return A


def load_matrix_market(path, dtype=None):
    """Load a MatrixMarket ``.mtx``/``.mtx.gz`` file to CSR."""
    from scipy.io import mmread

    A = sp.csr_matrix(mmread(path))
    if dtype is not None:
        A = A.astype(dtype)
    return A


def _fold_into(x, limit, edge):
    """Map out-of-range indices into ``[0, limit)``: ``clip`` saturates at
    the boundary (historic default — NOTE it concentrates all out-of-band
    draws onto the first/last index, so the matrix's TRANSPOSE gets two
    super-dense rows; padded device layouts built on A^T then explode),
    ``reflect`` mirrors back inside (uniform row AND column occupancy —
    the realistic FE profile, and the right choice for adjoint-using
    workloads like svds)."""
    if edge == "clip":
        return np.clip(x, 0, limit - 1)
    if edge == "reflect":
        x = np.abs(x)
        return np.where(x > limit - 1, 2 * (limit - 1) - x, x)
    raise ValueError(f"edge={edge!r}: expected 'clip' or 'reflect'")


def random_scattered(n, nnz_per_row=8, *, coupling=0.1, seed=0,
                     bandwidth=None, block=None, dtype=np.float64,
                     edge="clip"):
    """Large random SCATTERED-sparsity test matrix with a controlled
    spectrum (the SuiteSparse stand-in for the zero-egress benchmark
    environment; the reference's corpus fetcher
    ``scripts/download_matrices.sh`` is unusable without network).

    Construction: ``A = diag(d) + C`` where ``d`` is linspace(0, 1, n)
    with its top 10 entries replaced by WELL-SEPARATED dominant values
    ``1.2 + 0.05*k`` (so the wanted eigenvalues have O(0.05) gaps at any
    n, not the hopeless 1/n bulk spacing), and ``C`` has ``nnz_per_row``
    uniformly random off-diagonal entries per row scaled so
    ``||C||_2 <~ coupling`` (Gershgorin).  The spectrum is a cloud within
    ``coupling`` of d: nonsymmetric, non-normal, largest-real eigenvalues
    near the separated outliers.

    ``bandwidth`` (optional) confines the random columns to
    ``|col - row| <= bandwidth`` — the scattered-within-a-band profile of
    FE/mesh matrices, and the shape the distributed ring-halo SpMV
    (``arnoldi_jax.parallel.halo_spmv``) is built for; None scatters
    columns globally.

    ``block`` (optional, e.g. 8) makes the nonzeros DENSE block x block
    tiles at random block positions — the multi-dof-per-node structure of
    FE matrices, and the shape the BSR operator's dense-block einsum takes
    (``nnz_per_row`` is then interpreted per-row within
    ``ceil(nnz_per_row / block)`` blocks).  Uniformly-random SCALAR
    columns are the pathological worst case for any gather hardware and
    resemble no physical discretization.

    Returns CSR.  Memory: O(n * nnz_per_row).
    """
    rng = np.random.default_rng(seed)
    if block is not None:
        b = int(block)
        assert n % b == 0, "block-structured generator needs block | n"
        nb = n // b
        bpb = max(-(-nnz_per_row // b), 1)   # blocks per block-row
        nnz_per_row = bpb * b
        brows = np.repeat(np.arange(nb, dtype=np.int64), bpb)
        if bandwidth is None:
            bcols = rng.integers(0, nb, size=nb * bpb, dtype=np.int64)
        else:
            bwb = max(int(bandwidth) // b, 1)
            delta = rng.integers(-bwb, bwb + 1, size=nb * bpb,
                                 dtype=np.int64)
            bcols = _fold_into(brows + delta, nb, edge)
        rows = (brows[:, None, None] * b
                + np.arange(b)[None, :, None]).repeat(b, axis=2).reshape(-1)
        cols = (bcols[:, None, None] * b
                + np.arange(b)[None, None, :]).repeat(b, axis=1).reshape(-1)
    else:
        rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
        if bandwidth is None:
            cols = rng.integers(0, n, size=n * nnz_per_row, dtype=np.int64)
        else:
            bw = int(bandwidth)
            delta = rng.integers(-bw, bw + 1, size=n * nnz_per_row,
                                 dtype=np.int64)
            cols = _fold_into(rows + delta, n, edge)
    # scale so each row's off-diagonal absolute sum ~= coupling
    vals = rng.uniform(-1.0, 1.0, size=rows.shape[0])
    vals *= coupling / nnz_per_row * 2.0
    d = np.linspace(0.0, 1.0, n)
    k_out = min(10, n)
    d[-k_out:] = 1.2 + 0.05 * np.arange(k_out)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A = A + sp.diags_array(d)
    A = sp.csr_matrix(A)
    if dtype is not None:
        A = A.astype(dtype)
    A.sum_duplicates()
    return A


def random_scattered_complex_pairs(n, nnz_per_row=8, *, coupling=0.05,
                                   omega=0.3, n_pairs=5, seed=0,
                                   bandwidth=None, block=None,
                                   dtype=np.float64):
    """REAL nonsymmetric scattered matrix whose DOMINANT eigenvalues are
    complex-conjugate pairs — the rotation-coupled profile of
    convection/advection discretizations (a real operator with local
    circulation), and the workload that exercises the real-Schur 2x2-block
    path at scale (the reference xfails its real ordered-Schur mode,
    ``src/arnoldi/utils.py:64-65``; here it is a production path).

    Construction: :func:`random_scattered`'s diagonally-dominant cloud,
    with the ``2 * n_pairs`` top diagonal outliers re-formed into 2x2
    rotation blocks ``[[d_j, -w_j], [w_j, d_j]]`` (eigenvalues
    ``d_j ± i w_j`` up to the O(coupling) cloud perturbation):

    * ``d_j = 1.2 + 0.06 j`` — well-separated real parts above the bulk
      (which lies within ``coupling`` of [0, 1]),
    * ``w_j = omega * (1 + 0.25 j)`` — distinct rotation rates so no two
      pairs collide in the complex plane.

    A largest-real-part request therefore returns ONLY genuinely complex
    pairs, which the real work dtype must carry as Schur 2x2 blocks.
    Returns CSR, real dtype.
    """
    base = random_scattered(n, nnz_per_row, coupling=coupling, seed=seed,
                            bandwidth=bandwidth, block=block, dtype=None)
    assert 2 * n_pairs <= min(10, n), \
        "pairs are carved from random_scattered's 10 diagonal outliers"
    d = base.diagonal()
    rows, cols, vals = [], [], []
    for j in range(n_pairs):
        i = n - 2 * (j + 1)
        dj = 1.2 + 0.06 * j
        wj = omega * (1.0 + 0.25 * j)
        rows += [i, i + 1, i, i + 1]
        cols += [i, i + 1, i + 1, i]
        vals += [dj - d[i], dj - d[i + 1], -wj, wj]
    R = sp.coo_matrix((np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
                      shape=(n, n))
    A = sp.csr_matrix(base + R)
    if dtype is not None:
        A = A.astype(dtype)
    A.sum_duplicates()
    return A
