"""JAX-transform composability: vmap, grad, repeated jit.

These are JAX capabilities with no reference analog (numpy code can't
be transformed) — the payoff of rebuilding the pipeline as pure, statically
shaped JAX (SURVEY.md §7 step 3 "vmap-compatible").
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xhistogram_tpu.core import histogram

bins_arr = np.linspace(-4, 4, 10)


def test_vmap_over_leading_axis():
    """vmap(histogram) over a batch axis == axis-preserving histogram."""
    rng = np.random.RandomState(0)
    data = rng.randn(6, 50).astype("f4")

    f = jax.vmap(lambda row: histogram(row, bins=bins_arr)[0])
    h_vmap = np.asarray(f(jnp.asarray(data)))

    h_axis, _ = histogram(data, bins=bins_arr, axis=(1,))
    np.testing.assert_array_equal(h_vmap, np.asarray(h_axis))

    expected = np.stack([np.histogram(r, bins=bins_arr)[0] for r in data])
    np.testing.assert_array_equal(h_vmap, expected)


def test_vmap_joint():
    rng = np.random.RandomState(1)
    a = rng.randn(4, 64).astype("f4")
    b = rng.randn(4, 64).astype("f4")
    bb = np.linspace(-4, 4, 8)

    f = jax.vmap(lambda x, y: histogram(x, y, bins=[bins_arr, bb])[0])
    h = np.asarray(f(jnp.asarray(a), jnp.asarray(b)))
    for i in range(4):
        expected, _, _ = np.histogram2d(a[i], b[i], bins=[bins_arr, bb])
        np.testing.assert_array_equal(h[i], expected)


def test_grad_wrt_weights():
    """The weighted histogram is linear in the weights: its vjp against a
    cotangent g is g gathered at each element's bin — differentiability the
    reference fundamentally can't offer."""
    rng = np.random.RandomState(2)
    data = jnp.asarray(rng.randn(40).astype("f4"))
    w0 = jnp.asarray(rng.rand(40).astype("f4"))

    def loss(w):
        h, _ = histogram(data, bins=bins_arr, weights=w, method="scatter")
        return jnp.sum(h * jnp.arange(h.shape[0], dtype=h.dtype))

    g = jax.grad(loss)(w0)

    # oracle: d loss / d w_i = coefficient of w_i = bin_index(data_i), or 0
    # when the element is out of range
    idx = np.searchsorted(bins_arr, np.asarray(data), side="right")
    idx[np.asarray(data) == bins_arr[-1]] -= 1
    expected = np.where(
        (idx >= 1) & (idx <= len(bins_arr) - 1), (idx - 1).astype("f4"), 0.0
    )
    np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-6)


def test_jit_cache_stability():
    """Repeated calls with the same static config must not retrace (static
    argnums are hashable); different axis sets compile separately."""
    data = np.random.randn(4, 32).astype("f4")
    f = lambda: histogram(data, bins=bins_arr, axis=(1,))[0]
    h1 = np.asarray(f())
    h2 = np.asarray(f())
    np.testing.assert_array_equal(h1, h2)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort", "auto"])
def test_methods_under_outer_jit(method):
    data = np.random.randn(128).astype("f4")

    @jax.jit
    def f(x):
        return histogram(x, bins=bins_arr, method=method)[0]

    np.testing.assert_array_equal(
        np.asarray(f(data)), np.histogram(data, bins=bins_arr)[0]
    )


@pytest.mark.parametrize("method", ["onehot", "sort", "auto"])
def test_grad_across_methods_matches_scatter(method):
    """XLA autodiff through each strategy (einsum, segmented scan, scatter)
    gives the same weight gradients, 1-D and joint."""
    rng = np.random.RandomState(7)
    data = jnp.asarray(rng.randn(64).astype("f4"))
    d2 = jnp.asarray(rng.randn(64).astype("f4"))
    w0 = jnp.asarray(rng.rand(64).astype("f4"))
    coef = jnp.arange(9.0)

    def loss(w, m):
        h, _ = histogram(data, bins=bins_arr, weights=w, method=m)
        return jnp.sum(h * coef)

    g_m = jax.grad(lambda w: loss(w, method))(w0)
    g_scatter = jax.grad(lambda w: loss(w, "scatter"))(w0)
    np.testing.assert_allclose(
        np.asarray(g_m), np.asarray(g_scatter), rtol=1e-5
    )

    b2 = np.linspace(-3, 3, 7)

    def loss2(w, m):
        h, _ = histogram(data, d2, bins=[bins_arr, b2], weights=w, method=m)
        return jnp.sum(h**2)

    g2m = jax.grad(lambda w: loss2(w, method))(w0)
    g2s = jax.grad(lambda w: loss2(w, "scatter"))(w0)
    np.testing.assert_allclose(np.asarray(g2m), np.asarray(g2s), rtol=1e-4)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_grad_matches_analytic(method):
    """d/dw_i of sum(h * coef) is coef at element i's bin (0 when the
    element is out of range or NaN)."""
    rng = np.random.RandomState(13)
    x = rng.randn(64).astype("f4") * 2
    x[:3] = [np.nan, 10.0, -10.0]
    w0 = jnp.asarray(rng.rand(64).astype("f4"))
    coef = jnp.arange(9.0)

    def loss(w):
        h, _ = histogram(jnp.asarray(x), bins=bins_arr, weights=w,
                         method=method)
        return jnp.sum(h * coef)

    g = np.asarray(jax.grad(loss)(w0))
    idx = np.searchsorted(bins_arr, x.astype("f8"), side="right") - 1
    idx[x.astype("f8") == bins_arr[-1]] = len(bins_arr) - 2
    ok = (idx >= 0) & (idx < 9) & ~np.isnan(x)
    expected = np.where(ok, np.asarray(coef)[np.clip(idx, 0, 8)], 0.0)
    np.testing.assert_array_equal(g, expected.astype("f4"))


def test_measure_helper():
    from xhistogram_tpu.utils.profiling import measure

    dt, times = measure(
        lambda x: histogram(x, bins=bins_arr)[0],
        jnp.asarray(np.random.randn(256).astype("f4")),
        reps=2,
        warmup=1,
    )
    assert dt > 0 and len(times) == 2
