"""Compiled-pipeline cache of the labeled wrapper: repeated calls reuse one
jitted device program, and the cache key is the *content* of the edges —
changing bin values (same shapes) must never serve stale results
(VERDICT r1 #8).
"""

import numpy as np

import xhistogram_tpu.labeled.api as api
from xhistogram_tpu.labeled import NamedArray, histogram


def _mk(seed=0, shape=(4, 32)):
    rng = np.random.RandomState(seed)
    return NamedArray(
        rng.randn(*shape).astype("f4"), ("time", "x"), name="T",
        attrs={"units": "degC"},
    )


def test_cache_hit_same_config():
    api._PIPELINE_CACHE.clear()
    a = _mk()
    edges = np.linspace(-3, 3, 9)
    h1 = histogram(a, bins=edges, dim=["x"])
    n_entries = len(api._PIPELINE_CACHE)
    h2 = histogram(a, bins=edges.copy(), dim=["x"])  # same content, new array
    assert len(api._PIPELINE_CACHE) == n_entries  # content-keyed: reused
    np.testing.assert_array_equal(h1.values, h2.values)
    expected = np.stack(
        [np.histogram(r, bins=edges)[0] for r in np.asarray(a.data, "f8")]
    )
    np.testing.assert_array_equal(h2.values, expected)


def test_cache_miss_on_bin_value_change():
    api._PIPELINE_CACHE.clear()
    a = _mk(1)
    e1 = np.linspace(-3, 3, 9)
    e2 = np.linspace(-2, 2, 9)  # same shape/dtype, different values
    h1 = histogram(a, bins=e1, dim=["x"])
    h2 = histogram(a, bins=e2, dim=["x"])
    for h, e in ((h1, e1), (h2, e2)):
        expected = np.stack(
            [np.histogram(r, bins=e)[0] for r in np.asarray(a.data, "f8")]
        )
        np.testing.assert_array_equal(h.values, expected)
    np.testing.assert_allclose(h1.coords["T_bin"].values,
                               0.5 * (e1[:-1] + e1[1:]))
    np.testing.assert_allclose(h2.coords["T_bin"].values,
                               0.5 * (e2[:-1] + e2[1:]))


def test_uncacheable_specs_still_work():
    api._PIPELINE_CACHE.clear()
    a = _mk(2)
    h = histogram(a, bins=5)  # int spec: data-dependent, uncached
    assert len(api._PIPELINE_CACHE) == 0
    expected = np.histogram(np.asarray(a.data, "f8"), bins=5)[0]
    np.testing.assert_array_equal(h.values, expected)
    h = histogram(a, bins=5, range=(-2, 2))
    expected = np.histogram(np.asarray(a.data, "f8"), bins=5,
                            range=(-2, 2))[0]
    np.testing.assert_array_equal(h.values, expected)


def test_wide_numpy_dtypes_take_exact_path():
    api._PIPELINE_CACHE.clear()
    vals = np.array([0, 1, 2, 2**40], dtype=np.int64)
    a = NamedArray(vals, ("x",), name="n")
    edges = np.array([0.5, 1.5, 2.5, 2.0**41])
    h = histogram(a, bins=edges)
    assert len(api._PIPELINE_CACHE) == 0  # exact host remap, uncached
    np.testing.assert_array_equal(h.values, np.histogram(vals, bins=edges)[0])


def test_cache_eviction_cap():
    api._PIPELINE_CACHE.clear()
    old_cap = api._PIPELINE_CACHE_CAP
    api._PIPELINE_CACHE_CAP = 3
    try:
        rng = np.random.RandomState(3)
        a = NamedArray(rng.randn(8).astype("f4"), ("x",), name="T")
        for k in range(5):
            edges = np.linspace(-3, 3, 4 + k)
            histogram(a, bins=edges)
        assert len(api._PIPELINE_CACHE) <= 3
        # evicted configs still recompute correctly
        e0 = np.linspace(-3, 3, 4)
        h = histogram(a, bins=e0)
        np.testing.assert_array_equal(
            h.values, np.histogram(np.asarray(a.data, "f8"), bins=e0)[0]
        )
    finally:
        api._PIPELINE_CACHE_CAP = old_cap


def test_ftz_unsafe_edges_skip_cache():
    """Edges with subnormal comparison thresholds must take the exact path:
    inside the cached jit the FTZ fallback of core._prepare_device cannot
    fire (r2 code-review finding — the fast path returned [1, 3] where
    numpy and the eager core path return [3, 1])."""
    api._PIPELINE_CACHE.clear()
    data = np.array([-0.5, 0.0, -0.0, 0.5], dtype=np.float32)
    edges = np.array([-1.0, 1e-42, 1.0])
    a = NamedArray(data, ("x",), name="v")
    h = histogram(a, bins=edges)
    assert len(api._PIPELINE_CACHE) == 0  # routed to the exact path
    np.testing.assert_array_equal(h.values, np.histogram(data, bins=edges)[0])


def test_cache_x64_preserves_float64():
    """Under jax_enable_x64 the fast path must NOT narrow float64 — the
    shared core.device_view policy keeps 64-bit dtypes, so the cached and
    uncached paths agree on the output dtype (ADVICE r2 #2)."""
    import jax

    api._PIPELINE_CACHE.clear()
    rng = np.random.RandomState(5)
    vals = rng.randn(4, 32)  # float64 that does NOT round-trip float32
    w = rng.rand(4, 32) + 1e-9
    edges = np.linspace(-3, 3, 9)
    jax.config.update("jax_enable_x64", True)
    try:
        a = NamedArray(vals, ("time", "x"), name="T")
        wa = NamedArray(w, ("time", "x"))
        h = histogram(a, bins=edges, dim=["x"], weights=wa)
        assert len(api._PIPELINE_CACHE) == 1  # cached (no exact-path detour)
        assert np.asarray(h.values).dtype == np.float64
        expected = np.stack(
            [np.histogram(r, bins=edges, weights=ww)[0]
             for r, ww in zip(vals, w)]
        )
        np.testing.assert_allclose(h.values, expected, rtol=1e-12)
    finally:
        jax.config.update("jax_enable_x64", False)
        api._PIPELINE_CACHE.clear()  # do not leak x64-traced pipelines


def test_cache_precision_in_key():
    """precision='f64' bypasses the pipeline cache (the exact tier runs on
    the host and returns float64); the default precision is cached and
    both deliver one weight per slot bit for bit."""
    api._PIPELINE_CACHE.clear()
    edges = np.linspace(-4, 4, 1025)
    centers = (0.5 * (edges[:-1] + edges[1:])).astype("f4")
    rng = np.random.RandomState(3)
    w = rng.uniform(0.5, 2.0, size=centers.shape).astype("f4")
    a = NamedArray(centers, ("x",), name="T")
    wa = NamedArray(w, ("x",))
    h_f64 = histogram(a, bins=edges, weights=wa, precision="f64")
    assert len(api._PIPELINE_CACHE) == 0
    h_def = histogram(a, bins=edges, weights=wa)
    assert len(api._PIPELINE_CACHE) == 1
    assert np.asarray(h_f64.values).dtype == np.float64
    np.testing.assert_array_equal(np.asarray(h_f64.values), w)
    np.testing.assert_array_equal(np.asarray(h_def.values), w)


def test_cache_int_weights_digit_mode():
    """Int32 weights ride the CACHED jitted pipeline (device-safe view):
    the internal digit mode must come from the dtype bounds under tracing,
    produce exact results, and key the cache consistently."""
    api._PIPELINE_CACHE.clear()
    a = _mk(3)
    rng = np.random.RandomState(4)
    w = NamedArray(
        rng.randint(-1000, 1000, (4, 32)).astype(np.int32), ("time", "x")
    )
    edges = np.linspace(-3, 3, 9)
    h1 = histogram(a, bins=edges, dim=["x"], weights=w)
    n_entries = len(api._PIPELINE_CACHE)
    h2 = histogram(a, bins=edges.copy(), dim=["x"], weights=w)
    assert len(api._PIPELINE_CACHE) == n_entries  # second call reused it
    expected = np.stack(
        [np.histogram(r, bins=edges, weights=ww)[0]
         for r, ww in zip(np.asarray(a.data, "f8"), np.asarray(w.data))]
    )
    assert np.asarray(h1.data).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(h1.data), expected)
    np.testing.assert_array_equal(np.asarray(h2.data), expected)
