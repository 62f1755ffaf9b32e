"""Oracle tests for the array API: every result is compared against numpy
(np.histogram / histogram2d / histogramdd) — the same bit-exact-parity
contract the reference test suite enforces
(/root/reference/xhistogram/test/test_core.py).
"""

from itertools import combinations

import numpy as np
import pytest

from xhistogram_tpu.core import histogram

bins_arr = np.linspace(-4, 4, 10)


@pytest.mark.parametrize("density", [False, True])
@pytest.mark.parametrize("block_size", ["auto", 7])
@pytest.mark.parametrize("axis", [1, None])
@pytest.mark.parametrize("range_", [None, (-4, 4)])
@pytest.mark.parametrize("add_nans", [False, True])
def test_histogram_results_1d(block_size, density, axis, range_, add_nans):
    nrows, ncols = 5, 20
    np.random.seed(2)
    data = np.random.randn(nrows, ncols)
    if add_nans:
        n_nans = 20
        data.ravel()[np.random.choice(data.size, n_nans, replace=False)] = np.nan
    bins = np.linspace(-4, 4, 10)

    h, bin_edges = histogram(
        data, bins=bins, range=range_, axis=axis, block_size=block_size,
        density=density,
    )
    h = np.asarray(h)

    expected_shape = (
        (nrows, len(bin_edges[0]) - 1) if axis == 1 else (len(bin_edges[0]) - 1,)
    )
    assert h.shape == expected_shape

    if axis:
        bins_np = np.histogram_bin_edges(data, bins=bins, range=range_)
        expected = np.stack(
            [
                np.histogram(data[i], bins=bins_np, range=range_, density=density)[0]
                for i in range(nrows)
            ]
        )
    else:
        expected = np.histogram(data, bins=bins, range=range_, density=density)[0]
    np.testing.assert_allclose(h, expected, rtol=1e-6)

    if density:
        widths = np.diff(bins)
        integral = np.sum(h * widths, axis)
        np.testing.assert_allclose(integral, 1.0, rtol=1e-6)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_histogram_methods_agree_1d(method):
    np.random.seed(3)
    data = np.random.randn(5, 20)
    h, _ = histogram(data, bins=bins_arr, axis=1, method=method)
    expected = np.stack(
        [np.histogram(row, bins=bins_arr)[0] for row in data]
    )
    np.testing.assert_array_equal(np.asarray(h), expected)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_histogram_results_1d_weighted(method):
    np.random.seed(4)
    data = np.random.randn(5, 20)
    h, _ = histogram(data, bins=bins_arr, axis=1, method=method)
    weights = 2.0 * np.ones_like(data)
    h_w, _ = histogram(data, bins=bins_arr, axis=1, weights=weights, method=method)
    np.testing.assert_allclose(2 * np.asarray(h), np.asarray(h_w), rtol=1e-6)


def test_histogram_results_1d_weighted_broadcasting():
    # weights with shape (1, ncols) broadcast against (nrows, ncols) data —
    # reference test_core.py:84-92
    np.random.seed(5)
    data = np.random.randn(5, 20)
    h, _ = histogram(data, bins=bins_arr, axis=1)
    weights = 2.0 * np.ones((1, 20))
    h_w, _ = histogram(data, bins=bins_arr, axis=1, weights=weights)
    np.testing.assert_allclose(2 * np.asarray(h), np.asarray(h_w), rtol=1e-6)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_histogram_right_edge(method):
    """Last bin must be right-edge inclusive, as for np.histogram
    (reference test_core.py:95-113)."""
    nrows, ncols = 5, 20
    data = np.ones((nrows, ncols))
    bins = np.array([0, 0.5, 1])  # all data at the rightmost edge

    h, _ = histogram(data, bins=bins, axis=1, method=method)
    assert h.shape == (nrows, len(bins) - 1)

    hist, _ = np.histogram(data, bins=bins)
    np.testing.assert_array_equal(hist, np.asarray(h).sum(axis=0))

    h_na, _ = histogram(data, bins=bins, method=method)
    np.testing.assert_array_equal(hist, np.asarray(h_na))


def test_histogram_results_2d():
    np.random.seed(6)
    nrows, ncols = 5, 20
    data_a = np.random.randn(nrows, ncols)
    data_b = np.random.randn(nrows, ncols)
    nbins_a, nbins_b = 9, 10
    bins_a = np.linspace(-4, 4, nbins_a + 1)
    bins_b = np.linspace(-4, 4, nbins_b + 1)

    h, _ = histogram(data_a, data_b, bins=[bins_a, bins_b])
    assert h.shape == (nbins_a, nbins_b)
    hist, _, _ = np.histogram2d(data_a.ravel(), data_b.ravel(), bins=[bins_a, bins_b])
    np.testing.assert_array_equal(hist, np.asarray(h))


def test_histogram_results_2d_broadcasting():
    # 1-D input broadcast against 2-D input (reference test_core.py:132-157)
    np.random.seed(7)
    nrows, ncols = 5, 20
    data_a = np.random.randn(ncols)
    data_b = np.random.randn(nrows, ncols)
    bins_a = np.linspace(-4, 4, 10)
    bins_b = np.linspace(-4, 4, 11)
    h, _ = histogram(data_a, data_b, bins=[bins_a, bins_b])
    hist, _, _ = np.histogram2d(
        np.broadcast_to(data_a, data_b.shape).ravel(),
        data_b.ravel(),
        bins=[bins_a, bins_b],
    )
    np.testing.assert_array_equal(hist, np.asarray(h))


@pytest.mark.parametrize("add_nans", [False, True])
def test_histogram_results_2d_density(add_nans):
    np.random.seed(8)
    nrows, ncols = 5, 20
    data_a = np.random.randn(nrows, ncols)
    data_b = np.random.randn(nrows, ncols)
    if add_nans:
        n_nans = 20
        data_a.ravel()[np.random.choice(data_a.size, n_nans, replace=False)] = np.nan
        data_b.ravel()[np.random.choice(data_b.size, n_nans, replace=False)] = np.nan
    bins_a = np.linspace(-4, 4, 10)
    bins_b = np.linspace(-4, 4, 11)

    h, _ = histogram(data_a, data_b, bins=[bins_a, bins_b], density=True)
    hist, _, _ = np.histogram2d(
        data_a.ravel(), data_b.ravel(), bins=[bins_a, bins_b], density=True
    )
    np.testing.assert_allclose(np.asarray(h), hist, rtol=1e-5)

    areas = np.outer(np.diff(bins_a), np.diff(bins_b))
    integral = np.sum(np.asarray(h) * areas)
    np.testing.assert_allclose(integral, 1.0, rtol=1e-6)


@pytest.mark.parametrize("add_nans", [False, True])
def test_histogram_results_3d_density(add_nans):
    np.random.seed(9)
    nrows, ncols = 5, 20
    data = [np.random.randn(nrows, ncols) for _ in range(3)]
    if add_nans:
        for d in data:
            d.ravel()[np.random.choice(d.size, 20, replace=False)] = np.nan
    bins = [np.linspace(-4, 4, n + 1) for n in (9, 10, 9)]

    h, _ = histogram(*data, bins=bins, density=True)
    assert h.shape == (9, 10, 9)
    hist, _ = np.histogramdd([d.ravel() for d in data], bins=bins, density=True)
    np.testing.assert_allclose(np.asarray(h), hist, rtol=1e-5)

    areas = np.einsum(
        "i,j,k", np.diff(bins[0]), np.diff(bins[1]), np.diff(bins[2])
    )
    np.testing.assert_allclose(np.sum(np.asarray(h) * areas), 1.0, rtol=1e-6)


def test_histogram_shape():
    """Output shapes for every scalar/pair/full-permutation axis choice on a
    4-D array (reference test_core.py:231-273)."""
    shape = 6, 7, 4, 8
    b = np.random.randn(*shape)
    bins = np.linspace(-4, 4, 27)

    c, _ = histogram(b, bins=bins)
    assert c.shape == (len(bins) - 1,)
    for axis in [(0, 1, 2, 3), (0, 1, 3, 2), (3, 2, 1, 0), (3, 2, 0, 1)]:
        c, _ = histogram(b, bins=bins, axis=axis)
        assert c.shape == (len(bins) - 1,)

    for axis in list(range(4)) + list(range(-1, -5, -1)):
        c, _ = histogram(b, bins=bins, axis=axis)
        expected = list(b.shape)
        del expected[axis]
        assert c.shape == tuple(expected) + (len(bins) - 1,)

    for i, j in combinations(range(4), 2):
        c, _ = histogram(b, bins=bins, axis=(i, j))
        expected = [b.shape[k] for k in range(b.ndim) if k not in (i, j)]
        assert c.shape == tuple(expected) + (len(bins) - 1,)


def test_histogram_shape_correctness_4d():
    """Value parity (not just shape) for axis subsets of a 4-D array."""
    np.random.seed(10)
    shape = (3, 4, 5, 6)
    b = np.random.randn(*shape)
    bins = np.linspace(-4, 4, 9)

    # reduce axes (1, 3), keep (0, 2)
    h, _ = histogram(b, bins=bins, axis=(1, 3))
    h = np.asarray(h)
    assert h.shape == (3, 5, len(bins) - 1)
    for i in range(3):
        for k in range(5):
            expected = np.histogram(b[i, :, k, :], bins=bins)[0]
            np.testing.assert_array_equal(h[i, k], expected)


def test_traced_requires_array_bins():
    """The jit analog of the reference's dask guard (core.py:377-381,
    test_core.py:276-313): traced inputs + non-array bins → TypeError."""
    import jax

    data = np.random.randn(10)

    @jax.jit
    def f(x):
        return histogram(x, bins=10)[0]

    with pytest.raises(TypeError):
        f(data)

    # explicit edges work under jit
    @jax.jit
    def g(x):
        return histogram(x, bins=bins_arr)[0]

    np.testing.assert_array_equal(
        np.asarray(g(data)), np.histogram(data, bins=bins_arr)[0]
    )


def test_concrete_device_edges_accepted():
    """CONCRETE jax edge arrays are valid bins everywhere numpy edges are
    (coerced host-side, bins.concrete_edges) — including under a user jit;
    TRACED edge arrays raise TypeError (no host values for compare_form)."""
    import jax
    import jax.numpy as jnp

    data = np.random.RandomState(7).randn(6, 200).astype(np.float32)
    dev_edges = jnp.asarray(bins_arr)
    expected = np.stack(
        [np.histogram(row.astype(np.float64), bins=bins_arr)[0]
         for row in data]
    )

    # eager, list entry, and single-spec forms
    h1, _ = histogram(data, bins=[dev_edges], axis=1)
    h2, _ = histogram(data, bins=dev_edges, axis=1)
    np.testing.assert_array_equal(np.asarray(h1), expected)
    np.testing.assert_array_equal(np.asarray(h2), expected)

    # under a user jit (traced data, concrete device edges)
    @jax.jit
    def g(x):
        return histogram(x, bins=[dev_edges], axis=1)[0]

    np.testing.assert_array_equal(np.asarray(g(data)), expected)

    # traced edges: loud error, not silent wrong exactness
    @jax.jit
    def bad(x, e):
        return histogram(x, bins=[e], axis=1)[0]

    with pytest.raises(TypeError, match="concrete"):
        bad(data, dev_edges)


def test_histogram_results_datetime():
    """Datetime data and edges (reference test_core.py:365-382)."""
    data = np.arange(
        np.datetime64("2000-06-01"), np.datetime64("2000-06-06")
    ).astype("datetime64[ns]")
    bins = np.array(
        [
            np.datetime64("1999-01-01"),
            np.datetime64("2000-01-01"),
            np.datetime64("2001-01-01"),
        ],
        dtype="datetime64[ns]",
    )
    h, _ = histogram(data, bins=bins)
    expected = np.histogram(data.view("i8"), bins=bins.view("i8"))[0]
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_int64_inputs_hit_int32_pipeline_safely():
    data = np.array([1, 2, 2, 3, 100], dtype=np.int64)
    bins = np.array([0, 2, 4, 101], dtype=np.int64)
    h, _ = histogram(data, bins=bins)
    np.testing.assert_array_equal(np.asarray(h), np.histogram(data, bins=bins)[0])


def test_no_args_raises():
    with pytest.raises(ValueError):
        histogram(bins=10)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_density_exact_bin_areas_f64_edges(method):
    """Density must divide by areas of the ORIGINAL edges, not the
    transformed comparison edges (regression: the half-open transform
    perturbs the last edge by one ulp)."""
    np.random.seed(11)
    data = np.random.randn(4, 50).astype("f4")
    edges = np.linspace(-2.0, 30.0, 12)  # widths not f32-exact
    h, _ = histogram(data, bins=edges, axis=(1,), density=True, method=method)
    expected = np.stack(
        [np.histogram(r.astype("f8"), bins=edges, density=True)[0] for r in data]
    )
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5)


@pytest.mark.parametrize("bins", [10, "auto", "fd"])
@pytest.mark.parametrize("range_", [None, (-3, 3)])
def test_int_and_str_bins_full_path(bins, range_):
    """int/str bin specs resolve host-side and must match numpy end to end
    (reference test_core.py parametrizes bins over int/array/'auto')."""
    np.random.seed(12)
    data = np.random.randn(400).astype("f4")
    h, edges = histogram(data, bins=bins, range=range_)
    # oracle on the same f32 data (edge resolution is dtype-sensitive)
    expected, expected_edges = np.histogram(data, bins=bins, range=range_)
    np.testing.assert_allclose(edges[0], expected_edges)
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_nan_weights_scatter_contract():
    """NaN weights poison exactly their own bin under method='scatter'
    (the reference documents NaN weights fill the bin with NaN,
    xarray.py:72-74)."""
    data = np.array([0.5, 1.5, 2.5, 0.6], dtype="f4")
    w = np.array([1.0, np.nan, 2.0, 3.0], dtype="f4")
    bins = np.array([0.0, 1.0, 2.0, 3.0])
    h, _ = histogram(data, bins=bins, weights=w, method="scatter")
    h = np.asarray(h)
    assert h[0] == 4.0
    assert np.isnan(h[1])
    assert h[2] == 2.0


def test_multi_input_broadcast_with_weights():
    """3 inputs of different ranks + weights all broadcast together
    (reference core.py:366 broadcast_arrays over args+weights)."""
    np.random.seed(13)
    a = np.random.randn(6).astype("f4")           # (6,)
    b = np.random.randn(4, 6).astype("f4")        # (4, 6)
    c = np.random.randn(1, 6).astype("f4")        # (1, 6)
    w = np.random.rand(4, 1).astype("f4")         # (4, 1)
    bins = [np.linspace(-3, 3, n) for n in (5, 6, 7)]
    h, _ = histogram(a, b, c, bins=bins, weights=w)
    ab = np.broadcast_to(a, (4, 6)).ravel()
    bb = b.ravel()
    cb = np.broadcast_to(c, (4, 6)).ravel()
    wb = np.broadcast_to(w, (4, 6)).ravel()
    expected, _ = np.histogramdd([ab, bb, cb], bins=bins, weights=wb)
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-6)


def test_degenerate_shapes_match_numpy():
    """Empty inputs, zero-size kept/reduced axes, single elements — all
    shapes the reference inherits from numpy must round-trip."""
    bins = np.linspace(0, 1, 5)
    h, _ = histogram(np.array([], "f4"), bins=bins)
    np.testing.assert_array_equal(np.asarray(h), np.zeros(4, "i4"))
    h, _ = histogram(np.zeros((0, 5), "f4"), bins=bins, axis=1)
    assert np.asarray(h).shape == (0, 4)
    h, _ = histogram(np.zeros((3, 0), "f4"), bins=bins, axis=1)
    np.testing.assert_array_equal(np.asarray(h), np.zeros((3, 4), "i4"))
    h, _ = histogram(np.array([0.5], "f4"), bins=bins)
    np.testing.assert_array_equal(
        np.asarray(h), np.histogram([0.5], bins=bins)[0]
    )
