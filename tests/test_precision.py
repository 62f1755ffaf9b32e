"""Weighted-sum precision of the counting strategies, and the accepted
``precision=`` / ``method=`` values.

Float weights accumulate in f32 under every strategy (numpy accumulates in
float64); ``precision='f64'`` is the exact tier (tests/test_f64_weights.py).
A slot holding ONE weight must come back bit for bit under every strategy:
nothing may round the weights themselves (a TF32 contraction would, and the
sort strategy's sums must not difference a global prefix sum).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from xhistogram_tpu import StreamingHistogram
from xhistogram_tpu.core import histogram
from xhistogram_tpu.labeled import NamedArray
from xhistogram_tpu.labeled import histogram as lhist
from xhistogram_tpu.parallel import histogram_sharded

METHODS = ("scatter", "onehot", "sort")


@pytest.mark.parametrize("method", METHODS)
def test_single_weight_per_bin_bit_exact(method):
    """One element per bin: every output slot is a single full-mantissa
    weight, so the result must equal the weights bit for bit."""
    edges = np.linspace(-4, 4, 1025)
    centers = 0.5 * (edges[:-1] + edges[1:])
    data = centers.astype("f4").reshape(1, -1)
    rng = np.random.RandomState(11)
    w = rng.uniform(0.5, 2.0, size=data.shape).astype("f4")
    h, _ = histogram(data, bins=edges, weights=w, method=method)
    np.testing.assert_array_equal(np.asarray(h), w.ravel())


@pytest.mark.parametrize("method", METHODS)
def test_weighted_end_to_end_f32_tolerance(method):
    """~1800 f32 weights per bin against numpy's float64 sums: the f32
    accumulation error stays within a few ulp of the bin total."""
    rng = np.random.RandomState(0)
    data = rng.uniform(-3.5, 3.5, size=(8, 2048)).astype("f4")
    w = (rng.rand(8, 2048) * 100).astype("f4")
    edges = np.linspace(-4, 4, 10)
    h, _ = histogram(data, bins=edges, weights=w, method=method)
    expected = np.histogram(data.ravel(), bins=edges,
                            weights=w.ravel().astype("f8"))[0]
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_weighted_kept_rows_and_joint(method):
    rng = np.random.RandomState(3)
    a = rng.uniform(-3.5, 3.5, size=(4, 600)).astype("f4")
    b = rng.uniform(-3.5, 3.5, size=(4, 600)).astype("f4")
    w = rng.rand(4, 600).astype("f4")
    ea, eb = np.linspace(-4, 4, 7), np.linspace(-4, 4, 9)
    h, _ = histogram(a, b, bins=[ea, eb], weights=w, axis=1, method=method)
    for r in range(4):
        expected, _, _ = np.histogram2d(
            a[r], b[r], bins=[ea, eb], weights=w[r].astype("f8")
        )
        np.testing.assert_allclose(np.asarray(h)[r], expected, rtol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_huge_finite_weights_stay_exact(method):
    """Finite weights up to f32's max survive every strategy unchanged."""
    fmax = np.finfo(np.float32).max
    edges = np.linspace(-4, 4, 9)
    centers = (0.5 * (edges[:-1] + edges[1:])).astype("f4").reshape(1, -1)
    w = np.full(centers.shape, 1.0, "f4")
    w[0, 2] = fmax
    w[0, 5] = np.float32(3.4e38)
    h, _ = histogram(centers, bins=edges, weights=w, method=method)
    np.testing.assert_array_equal(np.asarray(h), w.ravel())


@pytest.mark.parametrize("method", ["onehot", "sort"])
def test_fixed_order_strategies_repeat_bit_for_bit(method):
    """onehot and sort add weights in an order fixed by the shape."""
    rng = np.random.RandomState(4)
    data = rng.randn(3, 5000).astype("f4")
    w = rng.rand(3, 5000).astype("f4")
    edges = np.linspace(-3, 3, 31)
    runs = [
        np.asarray(histogram(data, bins=edges, weights=w, axis=1,
                             method=method)[0])
        for _ in range(2)
    ]
    np.testing.assert_array_equal(runs[0], runs[1])


def test_per_call_precision_invalid():
    data = np.zeros((2, 8), "f4")
    w = np.ones((2, 8), "f4")
    with pytest.raises(ValueError, match="precision"):
        histogram(data, bins=np.linspace(-1, 1, 5), weights=w,
                  precision="exact")


def test_precision_empty_string_rejected():
    data = np.zeros((2, 8), "f4")
    w = np.ones((2, 8), "f4")
    with pytest.raises(ValueError, match="precision"):
        histogram(data, bins=np.linspace(-1, 1, 5), weights=w, precision="")


def test_unweighted_precision_does_not_fork_cache():
    """precision= is meaningless without weights: it must normalize away
    before it could become part of a jit key."""
    from xhistogram_tpu.core import _histogram_impl

    data = np.random.RandomState(0).randn(4, 64).astype("f4")
    edges = np.linspace(-3, 3, 9)
    h0, _ = histogram(data, bins=edges)
    n0 = _histogram_impl._cache_size()
    h1, _ = histogram(data, bins=edges, precision="f64")
    assert _histogram_impl._cache_size() == n0  # same trace reused
    np.testing.assert_array_equal(np.asarray(h0), np.asarray(h1))
    # still validated eagerly even though ignored
    with pytest.raises(ValueError, match="precision"):
        histogram(data, bins=edges, precision="bogus")


def test_streaming_precision_validated_at_init():
    with pytest.raises(ValueError, match="precision"):
        StreamingHistogram([np.linspace(-1, 1, 5)], precision="exact")


def _call_entry(entry, **kw):
    data = np.linspace(-0.9, 0.9, 16).astype("f4").reshape(2, 8)
    w = np.ones((2, 8), "f4")
    edges = np.linspace(-1, 1, 5)
    if entry == "core":
        return histogram(data, bins=edges, weights=w, **kw)
    if entry == "sharded":
        mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
        return histogram_sharded(data, mesh=mesh, in_spec=P("x"),
                                 bins=edges, weights=w, **kw)
    if entry == "labeled":
        a = NamedArray(data, ("y", "x"), name="a")
        return lhist(a, bins=[edges], weights=NamedArray(w, ("y", "x")),
                     **kw)
    return StreamingHistogram([edges], **kw)


ENTRIES = ["core", "sharded", "labeled", "streaming"]


@pytest.mark.parametrize("mode", ["split", "highest", "i8", "i8x3"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_removed_precision_modes_raise(entry, mode):
    """The kernel-only weighted modes are gone; every entry point names the
    accepted values."""
    with pytest.raises(ValueError, match="valid values are None .* 'f64'"):
        _call_entry(entry, precision=mode)


@pytest.mark.parametrize("entry", ENTRIES)
def test_method_pallas_raises(entry):
    """method='pallas' is gone; the error lists the accepted methods."""
    with pytest.raises(ValueError, match="auto\\|scatter\\|onehot\\|sort"):
        _call_entry(entry, method="pallas")
