"""Double-word float32 arithmetic: every primitive validated against
float64 (the module extends float32 solves to ~1e-15 working accuracy —
see ops/df32.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from arnoldi_jax.ops import df32 as dd

F = np.float32
U2 = 2.0 ** -49  # double-word unit roundoff


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(F)


class TestErrorFreeTransforms:
    def test_two_sum_exact(self, rng):
        a, b = _rand(rng, 1000), _rand(rng, 1000, scale=1e-4)
        s, e = jax.jit(dd.two_sum)(jnp.asarray(a), jnp.asarray(b))
        s, e = np.asarray(s, np.float64), np.asarray(e, np.float64)
        # a + b == s + e EXACTLY (both sides exact in f64)
        np.testing.assert_array_equal(
            a.astype(np.float64) + b.astype(np.float64), s + e)

    def test_two_prod_near_exact(self, rng):
        a, b = _rand(rng, 1000), _rand(rng, 1000, scale=3.7)
        p, e = jax.jit(dd.two_prod)(jnp.asarray(a), jnp.asarray(b))
        p, e = np.asarray(p, np.float64), np.asarray(e, np.float64)
        # a * b is exact in f64 (48-bit product); the contraction-immune
        # two_prod recovers it to O(u^2) (only the e-accumulation rounds).
        want = a.astype(np.float64) * b.astype(np.float64)
        assert np.all(np.abs(p + e - want) <= 5e-14 * np.abs(want) + 1e-30)
        # and the pair is normalized: |e| <= ulp(p)
        assert np.all(np.abs(e) <= np.spacing(np.abs(p).astype(np.float32),
                                              dtype=np.float32) + 1e-30)


class TestDwArithmetic:
    def _dw_pair(self, rng, shape, scale=1.0):
        x = rng.standard_normal(shape) * scale
        h = x.astype(F)
        l = (x - h.astype(np.float64)).astype(F)
        return (jnp.asarray(h), jnp.asarray(l)), x

    def test_roundtrip_f64(self, rng):
        x = rng.standard_normal(500)
        h, l = dd.dw_from_f64(x)
        # exact to double-word resolution (f64 values round to 49 bits)
        np.testing.assert_allclose(dd.dw_to_f64(h, l), x, rtol=U2, atol=0)

    @pytest.mark.parametrize("op,ref", [
        (dd.dw_add, lambda x, y: x + y),
        (dd.dw_sub, lambda x, y: x - y),
        (dd.dw_mul, lambda x, y: x * y),
        (dd.dw_div, lambda x, y: x / y),
    ])
    def test_binary_ops(self, rng, op, ref):
        (xh, xl), x = self._dw_pair(rng, 2000)
        (yh, yl), y = self._dw_pair(rng, 2000, scale=0.37)
        yh = jnp.where(jnp.abs(yh) < 0.01, 1.0, yh)  # keep div well-scaled
        y = np.asarray(dd.dw_to_f64(yh, yl))
        rh, rl = jax.jit(op)(xh, xl, yh, yl)
        got = dd.dw_to_f64(rh, rl)
        want = ref(x, y)
        # The dw error bound is relative to the operand scale (|x|+|y|),
        # not the (possibly cancelled) result.
        tol = 3e-14 * (np.abs(x) + np.abs(y) + np.abs(want))
        assert np.all(np.abs(got - want) <= tol)

    def test_mul_fl_add_fl(self, rng):
        (xh, xl), x = self._dw_pair(rng, 1000)
        y = _rand(rng, 1000)
        got = dd.dw_to_f64(*dd.dw_mul_fl(xh, xl, jnp.asarray(y)))
        np.testing.assert_allclose(got, x * y.astype(np.float64), rtol=2e-14)
        got = dd.dw_to_f64(*dd.dw_add_fl(xh, xl, jnp.asarray(y)))
        want = x + y.astype(np.float64)
        tol = 3e-14 * (np.abs(x) + np.abs(y) + np.abs(want))
        assert np.all(np.abs(got - want) <= tol)

    def test_sqrt(self, rng):
        (xh, xl), x = self._dw_pair(rng, 1000)
        xh = jnp.abs(xh) + 0.01
        x = np.asarray(dd.dw_to_f64(xh, xl))
        got = dd.dw_to_f64(*jax.jit(dd.dw_sqrt)(xh, xl))
        np.testing.assert_allclose(got, np.sqrt(x), rtol=2e-14)

    def test_sqrt_nonpositive_is_zero(self):
        h, l = dd.dw_sqrt(jnp.asarray([-1.0, 0.0], F),
                          jnp.zeros(2, F))
        np.testing.assert_array_equal(np.asarray(h), 0)
        np.testing.assert_array_equal(np.asarray(l), 0)


class TestDwReductions:
    def test_dw_sum_vs_f64(self, rng):
        # Summands spanning 8 orders of magnitude: plain f32 loses ~1e-4,
        # the compensated tree must track f64.
        x = rng.standard_normal(100_003) * np.logspace(-4, 4, 100_003)
        h, l = dd.dw_from_f64(x)
        sh, sl = jax.jit(dd.dw_sum)(h, l)
        got = float(dd.dw_to_f64(sh, sl))
        want = float(np.sum(x))  # f64 pairwise, accurate to ~1e-16 rel
        assert abs(got - want) <= 1e-11 * np.sum(np.abs(x))

    def test_dw_dot_cancellation(self, rng):
        # Ill-conditioned dot product (massive cancellation): f32 gets ~0
        # digits, dw must agree with f64 to ~1e-13 of the magnitude scale.
        n = 50_000
        x = rng.standard_normal(n)
        y = rng.standard_normal(n)
        # Force near-total cancellation: append the negated products.
        xs = np.concatenate([x, x])
        ys = np.concatenate([y, -y + 1e-7 * rng.standard_normal(n)])
        xh, xl = dd.dw_from_f64(xs)
        yh, yl = dd.dw_from_f64(ys)
        gh, gl = jax.jit(dd.dw_dot)(xh, xl, yh, yl)
        got = float(dd.dw_to_f64(gh, gl))
        want = float(xs @ ys)
        scale = float(np.abs(xs * ys).sum())
        assert abs(got - want) <= 1e-13 * scale
        # sanity: the magnitude really did cancel by ~7 orders
        assert abs(want) < 1e-4 * scale

    def test_dw_sum_axis(self, rng):
        x = rng.standard_normal((7, 33, 12))
        h, l = dd.dw_from_f64(x)
        for axis in (0, 1, 2, -1):
            sh, sl = dd.dw_sum(h, l, axis=axis)
            np.testing.assert_allclose(
                dd.dw_to_f64(sh, sl), x.sum(axis=axis), rtol=1e-12,
                atol=1e-14)

    def test_dw_norm(self, rng):
        x = rng.standard_normal(10_001) * 1e3
        h, l = dd.dw_from_f64(x)
        nh, nl = dd.dw_norm(h, l)
        np.testing.assert_allclose(float(dd.dw_to_f64(nh, nl)),
                                   np.linalg.norm(x), rtol=1e-13)
