"""Seeded start-vector generation.

Unlike the reference (``src/arnoldi/utils.py:7-13``) which draws from the
global NumPy RNG (making its convergence-rate tests flaky — see its
``@pytest.mark.flaky`` markers), every random draw here is keyed through
``jax.random`` so solver runs are reproducible.  Parity note: the reference
generates a *real* Gaussian vector and casts to the target dtype, so complex
start vectors have zero imaginary part; we keep that behaviour (a real start
vector keeps the whole Krylov basis of a real matrix real, which is the
real-arithmetic path).
"""

import jax
import jax.numpy as jnp


def rand_normalized_vector(key, n, dtype=jnp.float32):
    """Draw a unit-norm start vector of length ``n``.

    Parameters
    ----------
    key : jax.random.PRNGKey
    n : int
    dtype : dtype for the returned vector. Complex dtypes get a zero
        imaginary part (matching the reference's behaviour).
    """
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        real_dtype = jnp.finfo(dtype).dtype  # e.g. complex64 -> float32
    else:
        real_dtype = dtype
    v = jax.random.normal(key, (n,), dtype=real_dtype)
    v = v / jnp.linalg.norm(v)
    return v.astype(dtype)
