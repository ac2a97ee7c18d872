"""1e-8-grade eigensolving from a float32 solve.

The reference library reaches tight residuals by working in complex128
throughout (reference src/arnoldi/krylov_schur.py:16-19).  This
framework also reaches them from float32 storage and arithmetic: ask for
``stopping_criterion=1e-8`` at ``dtype=np.float32`` and the solver runs its
cheap float32 phase to ~2e-4, then continues the SAME Krylov-Schur restart
loop in double-word (compensated float32-pair) arithmetic — see
``arnoldi_jax/ops/df32.py`` and ``arnoldi_jax/solvers/refine.py``.

Runs on the default device; the whole compute path is float32 ops.
"""

import numpy as np

import jax

from arnoldi_jax import partial_eigh, partial_schur
from arnoldi_jax.matrices import laplace_2d, laplace_2d_eigen, mark
from arnoldi_jax.utils.sorting import arg_largest_real


def hermitian():
    nx, ny = 40, 39
    A = laplace_2d(nx, ny)
    vals, vecs, hist = partial_eigh(
        A.astype(np.float32), 4, which="LA", stopping_criterion=1e-8,
        max_restarts=3000, dtype=np.float32, key=jax.random.key(0),
    )
    want = np.sort(laplace_2d_eigen(nx, ny))[-4:][::-1]
    vecs = np.asarray(vecs, np.float64)
    res = np.linalg.norm(A @ vecs - vecs * np.asarray(vals)[None, :], axis=0)
    print("Hermitian (laplace_2d 40x39, float32 device path):")
    print("  eigenvalue error vs analytic:",
          np.abs(np.sort(vals) - np.sort(want)).max())
    print("  true residuals:", res)
    print("  matvecs:", hist.total_matvecs)


def non_hermitian():
    A = mark(40)  # Saad's Markov matrix, n=820
    Q, T, hist = partial_schur(
        A, 4, max_dim=24, stopping_criterion=1e-8,
        sort_function=arg_largest_real, max_restarts=2000,
        dtype=np.float32, ortho="cgs2", key=jax.random.key(0),
    )
    # Refined results come back as float64 host arrays (an f32 array cannot
    # represent a 1e-8-accurate subspace).
    res = np.linalg.norm(A.todense() @ Q - Q @ T, axis=0)
    print("Non-Hermitian (mark(40), float32 device path):")
    print("  Schur residuals:", res)
    print("  matvecs:", hist.total_matvecs)


if __name__ == "__main__":
    hermitian()
    non_hermitian()
