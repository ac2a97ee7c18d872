"""Double-word float32 ("df32") arithmetic — ~1e-15 accuracy from float32
operations.

The reference's route to 1e-8 residuals is complex128 everywhere
(reference ``src/arnoldi/krylov_schur.py:16-19``, tol=sqrt(eps)).
This module provides a float32 substitute for a solve that runs in float32
(64-bit types off, or float32 chosen for its bandwidth): every value is an
UNEVALUATED PAIR ``(hi, lo)`` of float32 with ``|lo| <= ulp(hi)/2``, giving
an effective ~49-bit mantissa (unit roundoff ~2^-49 = 1.8e-15) from pure
IEEE f32 elementwise ops.

Built on the classical error-free transformations (Knuth TwoSum, masking
Veltkamp split, exact-partial-product TwoProd) and the double-word
algorithms of Joldes, Muller & Popescu (2017).  All functions are
branch-free, elementwise-vectorized, jit/shard-safe, and — crucially —
CONTRACTION-IMMUNE: XLA backends may fuse mul+add into FMA with
per-fusion-site inconsistency, which silently destroys naive EFTs (see
the compiler-proofing note below).  The test suite validates every
primitive against float64 on CPU, including under jit.

Conventions: a double-word number is the pair of arrays ``(h, l)``; all
functions take/return such pairs (no wrapper class — pairs pass through
``jit``/``lax`` transparently and keep the hot loops allocation-free).
"""

import jax.numpy as jnp
from jax import lax

__all__ = [
    "two_sum", "fast_two_sum", "two_prod",
    "dw", "dw_from_f64", "dw_to_f64",
    "dw_add", "dw_sub", "dw_neg", "dw_add_fl", "dw_mul", "dw_mul_fl",
    "dw_div", "dw_sqrt", "dw_sum", "dw_dot", "dw_norm",
]

# CRITICAL — compiler-proofing: XLA backends may contract ``mul`` feeding
# ``add/sub`` into an FMA, and XLA duplicates elementwise subgraphs into
# every consumer fusion, so the same expression can round DIFFERENTLY at
# different sites.  For ordinary code that is a harmless ulp; for
# error-free transformations it is fatal (measured on XLA:CPU: dw_mul
# degraded to plain-f32 accuracy — the e-computation received an
# fma-contracted EXACT product where the ROUNDED one was required; the
# optimized HLO was faithful, the damage happened at LLVM codegen, and
# neither ``optimization_barrier`` nor full-width ``reduce_precision``
# survives to block it).  The primitives below are therefore built to be
# CONTRACTION-IMMUNE BY CONSTRUCTION:
#
# * the Veltkamp split uses integer mantissa masking (bit ops, no
#   multiply whose rounding carries information);
# * two_prod forms only EXACT partial products (12x12-bit halves) —
#   contracting an exact product into an add changes nothing — and
#   assembles the pair with TwoSum chains;
# * the remaining inexact multiplies (cross terms like ``xh*yl``) only
#   ever affect O(u^2) correction limbs, where a one-ulp duplicate
#   divergence is harmless.
#
# two_sum/fast_two_sum contain only adds/subs of non-multiply values, so
# no contraction pattern exists inside them.

def two_sum(a, b):
    """Error-free sum: returns ``(s, e)`` with ``s = fl(a+b)`` and
    ``a + b = s + e`` exactly (Knuth; 6 flops, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming ``|a| >= |b|`` (or a == 0); 3 flops."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Masking Veltkamp split: ``a = hi + lo`` with <=12 significant bits
    each (exact, bit-level — no rounded multiply for a compiler to
    contract)."""
    bits = lax.bitcast_convert_type(a, jnp.int32)
    hi = lax.bitcast_convert_type(bits & jnp.int32(-4096), jnp.float32)
    return hi, a - hi


def two_prod(a, b):
    """Compensated product: ``(p, e)`` with ``a * b = p + e`` up to
    O(u^2) relative (the partial products and TwoSum chain are exact; the
    final e-accumulation rounds, contributing up to ~5u^2 |ab|) and
    ``|e| <= ulp(p)``.  ``p`` may differ from ``fl(a*b)`` by one ulp —
    irrelevant for double-word use.

    Built EXCLUSIVELY from exact partial products of the 12-bit split
    halves plus TwoSum chains, so no floating-point op in it can be
    changed by FMA contraction (see the compiler-proofing note above)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    p1 = ah * bh  # each partial product is exact in f32 (12+12 bits)
    p2 = ah * bl
    p3 = al * bh
    p4 = al * bl
    s, e1 = two_sum(p1, p2)
    s, e2 = two_sum(s, p3)
    s, e3 = two_sum(s, p4)
    return fast_two_sum(s, (e1 + e2) + e3)


def dw(x):
    """Promote a float32 array to double-word ``(x, 0)``."""
    x = jnp.asarray(x, jnp.float32)
    return x, jnp.zeros_like(x)


def dw_from_f64(x):
    """Split a float64 HOST array into a double-word f32 pair (exact for
    values representable in 49 bits; used at host/device boundaries)."""
    import numpy as np

    x = np.asarray(x, np.float64)
    h = x.astype(np.float32)
    l = (x - h.astype(np.float64)).astype(np.float32)
    return jnp.asarray(h), jnp.asarray(l)


def dw_to_f64(h, l):
    """Reconstruct float64 on the HOST (exact: f32 + f32 -> f64)."""
    import numpy as np

    return np.asarray(h).astype(np.float64) + np.asarray(l).astype(np.float64)


def dw_add(xh, xl, yh, yl):
    """Double-word + double-word (accurate variant, Joldes et al. alg. 6;
    relative error ~3u^2)."""
    sh, sl = two_sum(xh, yh)
    th, tl = two_sum(xl, yl)
    vh, vl = fast_two_sum(sh, sl + th)
    return fast_two_sum(vh, tl + vl)


def dw_neg(xh, xl):
    return -xh, -xl


def dw_sub(xh, xl, yh, yl):
    return dw_add(xh, xl, -yh, -yl)


def dw_add_fl(xh, xl, y):
    """Double-word + single float32."""
    sh, sl = two_sum(xh, y)
    return fast_two_sum(sh, xl + sl)


def dw_mul(xh, xl, yh, yl):
    """Double-word * double-word (Joldes et al. alg. 12)."""
    ph, pl = two_prod(xh, yh)
    return fast_two_sum(ph, pl + (xh * yl + xl * yh))


def dw_mul_fl(xh, xl, y):
    """Double-word * single float32."""
    ph, pl = two_prod(xh, y)
    return fast_two_sum(ph, pl + xl * y)


def dw_div(xh, xl, yh, yl):
    """Double-word / double-word (one Newton-like correction)."""
    t = xh / yh
    rh, rl = dw_sub(xh, xl, *dw_mul_fl(yh, yl, t))
    return fast_two_sum(t, (rh + rl) / yh)


def dw_sqrt(xh, xl):
    """Double-word sqrt via one Heron correction of the f32 estimate.
    Non-positive inputs return exactly zero."""
    ok = xh > 0
    s = jnp.sqrt(jnp.where(ok, xh, 1.0))
    ph, pl = two_prod(s, s)
    rh, rl = dw_sub(xh, xl, ph, pl)
    h, l = fast_two_sum(s, (rh + rl) / (2.0 * s))
    zero = jnp.zeros_like(h)
    return jnp.where(ok, h, zero), jnp.where(ok, l, zero)


#: Minor-axis chunk for the single-pass compensated reduce.  Within a
#: chunk the accumulation order is XLA's choice (sequential worst case),
#: so the error bound is ~CHUNK * u^2 * sum|x| = 4e-12 * sum|x| — far
#: inside the 1e-8 targets this module serves, and 10x faster than a
#: materialized pairwise tree (whose per-level slices made XLA re-fuse the
#: producer into both halves, recomputing the product stage several
#: times).
_REDUCE_CHUNK = 1024


def _sum_combine(a, b):
    """Cheap compensated combine for reductions: error-free TwoSum of the
    hi limbs, plain accumulation of the lo limbs plus the TwoSum error.
    The lo adds round at O(u * |lo|) = O(u^2 * |hi|), so full double-word
    accuracy survives at ~40% of :func:`dw_add`'s flops.  The pair is left
    UN-normalized (|l| may exceed ulp(h)); callers must finish with
    :func:`fast_two_sum`."""
    s, e = two_sum(a[0], b[0])
    return s, a[1] + b[1] + e


def dw_sum(h, l, axis=-1):
    """Compensated reduction: double-word summation along ``axis``.

    Large axes reduce in one chunked variadic ``lax.reduce`` (single
    memory pass, no tree-level materialization), followed by a short
    pairwise tree over the chunk partials; the combine is error-free on
    the hi limbs with O(u^2) lo-limb accumulation (see
    :func:`_sum_combine`), normalized once at the end."""
    h = jnp.moveaxis(h, axis, -1)
    l = jnp.moveaxis(l, axis, -1)
    n = h.shape[-1]
    C = _REDUCE_CHUNK
    if n >= 2 * C:
        K = -(-n // C)
        if K * C - n:
            pad = [(0, 0)] * (h.ndim - 1) + [(0, K * C - n)]
            h = jnp.pad(h, pad)
            l = jnp.pad(l, pad)
        h = h.reshape(h.shape[:-1] + (K, C))
        l = l.reshape(l.shape[:-1] + (K, C))
        z = jnp.zeros((), h.dtype)
        h, l = lax.reduce((h, l), (z, z), _sum_combine, (h.ndim - 1,))
        n = K
    while n > 1:
        half = (n + 1) // 2
        if n % 2:
            pad = [(0, 0)] * (h.ndim - 1) + [(0, 1)]
            h = jnp.pad(h, pad)
            l = jnp.pad(l, pad)
        h, l = _sum_combine((h[..., :half], l[..., :half]),
                            (h[..., half:], l[..., half:]))
        n = half
    return fast_two_sum(h[..., 0], l[..., 0])


def dw_dot(ah, al, bh, bl, axis=-1):
    """Double-word inner product along ``axis`` (compensated products +
    pairwise compensated reduction — the dw analog of Ogita-Rump-Oishi
    dot2, accuracy ~u^2 ~ 1e-15 relative)."""
    ph, pl = two_prod(ah, bh)
    ph, pl = fast_two_sum(ph, pl + (ah * bl + al * bh))
    return dw_sum(ph, pl, axis=axis)


def dw_norm(h, l, axis=-1):
    """Double-word 2-norm along ``axis``."""
    return dw_sqrt(*dw_dot(h, l, h, l, axis=axis))
