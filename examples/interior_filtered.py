"""Interior eigenpairs WITHOUT factorizations: Chebyshev filtering.

Shift-invert (the classical interior route, scipy ``eigsh(sigma=...)``)
needs a sparse LU — infeasible for 3-D stencils (fill ~O(n g^2)) and
host-bound.  The polynomial-filtered drivers need only
matvecs:

    python examples/interior_filtered.py
"""

import numpy as np
import jax

from arnoldi_jax import eigsh_filtered, eigsh_window
from arnoldi_jax.matrices import laplace_3d, laplace_3d_eigen
from arnoldi_jax.solvers.filtered import estimate_window_count

jax.config.update("jax_enable_x64", True)

g = 24                      # 3-D grid -> n = 13824
A = laplace_3d(g)
full = np.sort(laplace_3d_eigen(g))   # analytic ground truth
window = (-11.0, -10.8)
true_inside = ((full >= window[0]) & (full <= window[1])).sum()

# how many eigenvalues live in the window? (stochastic KPM count)
est = estimate_window_count(A, window)
print(f"window {window}: ~{est:.1f} eigenvalues (true: {true_inside})")

# a few pairs nearest the window center
vals, vecs, hist = eigsh_filtered(A, 4, window, tol=1e-9)
res = np.linalg.norm(A @ vecs - vals * vecs, axis=0)
print("eigsh_filtered:", np.round(vals, 6),
      f"max residual {res.max():.2e}, {hist.total_matvecs} matvecs")

# ALL pairs in the window (spectrum slicing)
vals, vecs, hist = eigsh_window(A, window, tol=1e-9)
res = np.linalg.norm(A @ vecs - vals * vecs, axis=0)
print(f"eigsh_window: {len(vals)}/{true_inside} pairs, "
      f"max residual {res.max():.2e}, max eig err "
      f"{np.abs(vals[:, None] - full[None, :]).min(axis=1).max():.2e}")
