"""Dominant COMPLEX conjugate pairs through the REAL-arithmetic path.

A real nonsymmetric operator with local circulation (convection/rotation
physics) has complex eigenvalues, yet real arithmetic suffices for them:
`partial_schur`'s real path carries conjugate pairs as 2x2
blocks in a REAL Schur form (the mode the reference implementation
xfails, `src/arnoldi/utils.py:64-65`); eigenpairs come out complex from
the post-processing.  At the 1M-row scale the same pipeline runs in
`python bench.py complexpairs` and in `chip_smoke.py`'s ks_complexpairs
phase; this example is the small version.

Run: python examples/complex_pairs_real_path.py
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from arnoldi_jax import eigenpairs_from_partial_schur, partial_schur
from arnoldi_jax.matrices import random_scattered_complex_pairs
from arnoldi_jax.utils.sorting import arg_largest_real

n = 20_000
# Three dominant conjugate pairs d_j +/- i w_j above a real bulk.
A = random_scattered_complex_pairs(n, 8, coupling=0.02, omega=0.3, seed=7,
                                   bandwidth=512)

Q, T, hist = partial_schur(
    A, 6, max_dim=32, stopping_criterion=1e-10,
    sort_function=arg_largest_real, max_restarts=2000,
    dtype=np.float64, key=jax.random.key(0),
)
Qh, Th = np.asarray(Q), np.asarray(T)
assert not np.iscomplexobj(Th), "real Schur form: 2x2 blocks, no complex"

vals, vecs = eigenpairs_from_partial_schur(Q, T)
vals = np.asarray(vals)
res = np.linalg.norm(A @ np.asarray(vecs) - vals * np.asarray(vecs), axis=0)

print("real Schur T (first 4x4 block structure):")
print(np.round(Th[:4, :4], 4))
print("eigenvalues:", np.round(vals, 5))
print("max residual:", float(res.max()))
assert np.abs(vals.imag).min() > 0.2, "every wanted eigenvalue is complex"
assert res.max() < 1e-8
print("OK: complex spectrum recovered entirely in real arithmetic")
