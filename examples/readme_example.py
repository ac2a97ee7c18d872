"""The reference README example (mark(50), K=5 largest-real, tol 1e-8),
end to end: solve, eigen post-processing, residual check, ARPACK
cross-validation.

Runs on the default device (GPU or CPU), complex128-grade:
    python examples/readme_example.py
"""

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

from arnoldi_jax import partial_schur
from arnoldi_jax.matrices import mark
from arnoldi_jax import eigenpairs_from_partial_schur


def main():
    tol = 1e-8

    A = mark(50)  # n = 1275 Markov walk matrix
    Q, T, history = partial_schur(
        A, 5, max_dim=20, stopping_criterion=tol, sort_function="LR",
        max_restarts=2000,
    )
    vals, vecs = eigenpairs_from_partial_schur(Q, T)
    vecs = np.asarray(vecs)
    res = np.linalg.norm(A @ vecs - vals * vecs, axis=0)

    print(f"device: {jax.devices()[0].platform}")
    print(f"eigenvalues (largest real): {np.round(np.real(vals), 6)}")
    print(f"residuals: {res}")
    print(f"matvecs: {history.total_matvecs}, "
          f"restarts: {int(history.restarts.max())}")

    from scipy.sparse.linalg import eigs as arpack_eigs

    r_vals = arpack_eigs(A, 5, which="LR")[0]
    match = np.allclose(np.sort(np.real(vals)), np.sort(np.real(r_vals)),
                        atol=100 * tol)
    print(f"ARPACK agreement: {match}")


if __name__ == "__main__":
    main()
