"""Hermitian and SVD workflows: thick-restart Lanczos (scalar and block),
shift-invert for interior eigenvalues, and partial SVD.

    python examples/hermitian_and_svd.py
"""

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

from arnoldi_jax import eigsh, partial_eigh, svds
from arnoldi_jax.matrices import laplace_2d, laplace_2d_eigen


def main():
    tol = 1e-9

    # Smallest eigenvalues of a 2-D Laplacian — block mode finds the
    # degenerate pairs of the square grid that scalar Krylov cannot.
    A = laplace_2d(32)
    vals, vecs, hist = partial_eigh(
        A, 6, which="SA", stopping_criterion=tol, max_restarts=5000,
        block_size=4,
    )
    want = np.sort(laplace_2d_eigen(32))[:6]
    print("block Lanczos SA:", np.round(np.sort(vals), 6))
    print("analytic        :", np.round(want, 6))

    # Interior eigenvalues near sigma via shift-invert (inner CG on device).
    sig = -4.0
    vals2, _ = eigsh(A, 3, sigma=sig, tol=tol, maxiter=5000,
                     inner_solver="bicgstab")
    full = np.sort(laplace_2d_eigen(32))
    nearest = full[np.argsort(np.abs(full - sig))[:3]]
    print(f"eigsh sigma={sig}:", np.round(np.sort(vals2), 6))
    print("nearest analytic :", np.round(np.sort(nearest), 6))

    # Partial SVD of a random rectangular matrix.
    rng = np.random.default_rng(0)
    M = rng.standard_normal((300, 120))
    U, s, Vh = svds(M, 5, tol=tol, maxiter=5000)
    ref = np.linalg.svd(M, compute_uv=False)[:5]
    print("svds:", np.round(s[::-1], 5))
    print("ref :", np.round(ref, 5))


if __name__ == "__main__":
    main()
