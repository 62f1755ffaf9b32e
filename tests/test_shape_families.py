"""Shape families through every counting strategy, against numpy.

Ragged and odd shapes, joint grids from tens to ~10^5 slots, kept rows with
narrow and wide reduce axes, thousands of edges, nonfinite weights: each
case runs under ``scatter``, ``onehot`` and ``sort`` (the ``method``
fixture) and checks the numpy oracle — the parity contract from SURVEY.md
§4.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from xhistogram_tpu.bins import compare_form
from xhistogram_tpu.core import histogram
from xhistogram_tpu.ops.bincount import bincount2d
from xhistogram_tpu.ops.digitize import digitize_edges, joint_bin_index

bins9 = np.linspace(-4, 4, 10)


@pytest.fixture(params=["scatter", "onehot", "sort"])
def method(request):
    return request.param


def test_ops_layer_direct_1d(method):
    """digitize -> joint index -> bincount, called directly: the trash slot
    is the last column and the rest is numpy's histogram per row."""
    rng = np.random.RandomState(0)
    data = rng.randn(3, 40).astype("f4")
    ce = compare_form(bins9, np.dtype("f4"))
    idx = digitize_edges(jnp.asarray(data), jnp.asarray(ce.edges))
    g, n_slots = joint_bin_index([idx], (9,))
    counts = bincount2d(g, None, n_slots, method=method)
    assert counts.shape == (3, 10)
    expected = np.stack([np.histogram(r, bins=bins9)[0] for r in data])
    np.testing.assert_array_equal(np.asarray(counts)[:, :-1], expected)


@pytest.mark.parametrize("add_nans", [False, True])
@pytest.mark.parametrize("axis", [None, 1])
def test_method_1d(method, add_nans, axis):
    rng = np.random.RandomState(1)
    data = rng.randn(5, 20).astype("f4")
    if add_nans:
        data.ravel()[rng.choice(data.size, 15, replace=False)] = np.nan
    h, _ = histogram(data, bins=bins9, axis=axis, method=method)
    if axis == 1:
        expected = np.stack([np.histogram(r, bins=bins9)[0] for r in data])
    else:
        expected = np.histogram(data, bins=bins9)[0]
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_right_edge_inclusive(method):
    data = np.ones((4, 8), "f4")
    bins = np.array([0, 0.5, 1], "f4")
    h, _ = histogram(data, bins=bins, method=method)
    np.testing.assert_array_equal(np.asarray(h), np.histogram(data, bins=bins)[0])


def test_joint_2d(method):
    rng = np.random.RandomState(2)
    a = rng.randn(6, 30).astype("f4")
    b = rng.randn(6, 30).astype("f4")
    bins_a = np.linspace(-4, 4, 9)
    bins_b = np.linspace(-4, 4, 12)
    h, _ = histogram(a, b, bins=[bins_a, bins_b], method=method)
    expected, _, _ = np.histogram2d(a.ravel(), b.ravel(), bins=[bins_a, bins_b])
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_weighted(method):
    rng = np.random.RandomState(3)
    data = rng.randn(4, 25).astype("f4")
    w = rng.rand(4, 25).astype("f4")
    h, _ = histogram(data, bins=bins9, axis=1, weights=w, method=method)
    expected = np.stack(
        [np.histogram(r, bins=bins9, weights=wr)[0] for r, wr in zip(data, w)]
    )
    # f32 sums of ~3 weights per bin vs numpy's float64
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5)


def test_3input_joint(method):
    rng = np.random.RandomState(4)
    data = [rng.randn(2, 50).astype("f4") for _ in range(3)]
    bins = [np.linspace(-4, 4, n + 1) for n in (5, 6, 7)]
    h, _ = histogram(*data, bins=bins, method=method)
    expected, _ = np.histogramdd([d.ravel() for d in data], bins=bins)
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_matches_auto(method):
    rng = np.random.RandomState(5)
    data = rng.randn(7, 33).astype("f4")
    hp, _ = histogram(data, bins=bins9, axis=1, method="auto")
    hm, _ = histogram(data, bins=bins9, axis=1, method=method)
    np.testing.assert_array_equal(np.asarray(hp), np.asarray(hm))


def test_huge_joint_grid(method):
    """A 120k-slot joint grid — exact counts."""
    rng = np.random.RandomState(8)
    a = rng.randn(4, 500).astype("f4")
    b = rng.randn(4, 500).astype("f4")
    bins_a = np.linspace(-4, 4, 301)   # 300 x 400 = 120k slots
    bins_b = np.linspace(-4, 4, 401)
    h, _ = histogram(a, b, bins=[bins_a, bins_b], method=method)
    expected, _, _ = np.histogram2d(a.ravel(), b.ravel(), bins=[bins_a, bins_b])
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_weighted_and_3input(method):
    rng = np.random.RandomState(9)
    data = [rng.randn(2000).astype("f4") for _ in range(3)]
    w = rng.rand(2000).astype("f4")
    bins = [np.linspace(-4, 4, n) for n in (33, 41, 29)]  # 35840 slots
    h, _ = histogram(*data, bins=bins, weights=w, method=method)
    expected, _ = np.histogramdd(
        [d.ravel() for d in data], bins=bins, weights=w
    )
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-4, atol=1e-4)
    h2, _ = histogram(*data, bins=bins, method=method)
    e2, _ = np.histogramdd([d.ravel() for d in data], bins=bins)
    np.testing.assert_array_equal(np.asarray(h2), e2)


def test_kept_rows_large_grid(method):
    """Kept (bystander) rows with a 13,500-slot joint grid — exact counts
    per row."""
    rng = np.random.RandomState(10)
    a = rng.randn(5, 400).astype("f4")
    b = rng.randn(5, 400).astype("f4")
    bins_a = np.linspace(-4, 4, 151)   # 150 x 90 = 13500 slots > 8192
    bins_b = np.linspace(-4, 4, 91)
    h, _ = histogram(a, b, bins=[bins_a, bins_b], axis=1, method=method)
    assert h.shape == (5, 150, 90)
    for r in range(5):
        expected, _, _ = np.histogram2d(a[r], b[r], bins=[bins_a, bins_b])
        np.testing.assert_array_equal(np.asarray(h)[r], expected)


def test_kept_rows_single_input_many_bins(method):
    """Single input, kept rows, 9000 bins."""
    rng = np.random.RandomState(11)
    data = rng.randn(3, 600).astype("f4")
    edges = np.linspace(-4, 4, 9001)   # 9000 bins
    h, _ = histogram(data, bins=edges, axis=1, method=method)
    expected = np.stack([np.histogram(r, bins=edges)[0] for r in data])
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_kept_rows_weighted_and_odd_columns(method):
    """Weights and an odd column count (the onehot block padding)."""
    rng = np.random.RandomState(12)
    a = rng.randn(4, 333).astype("f4")
    b = rng.randn(4, 333).astype("f4")
    w = rng.rand(4, 333).astype("f4")
    bins_a = np.linspace(-4, 4, 101)
    bins_b = np.linspace(-4, 4, 121)   # 100*120 = 12000 slots
    h, _ = histogram(a, b, bins=[bins_a, bins_b], weights=w, axis=1,
                     method=method)
    for r in range(4):
        expected, _, _ = np.histogram2d(
            a[r], b[r], bins=[bins_a, bins_b], weights=w[r].astype("f8")
        )
        np.testing.assert_allclose(
            np.asarray(h)[r], expected, rtol=1e-4, atol=1e-4
        )


def test_kept_rows_nonfinite_weights(method):
    """Kept rows + narrow reduce axis: the nonfinite-weight channels must
    isolate the poisoned bin."""
    rng = np.random.RandomState(13)
    a = rng.uniform(-3.5, 3.5, (3, 60)).astype("f4")
    b = rng.uniform(-3.5, 3.5, (3, 60)).astype("f4")
    w = rng.rand(3, 60).astype("f4")
    a[1, 0], b[1, 0], w[1, 0] = 0.1, 0.1, np.nan
    bins_a = np.linspace(-4, 4, 40)
    bins_b = np.linspace(-4, 4, 50)
    h, _ = histogram(a, b, bins=[bins_a, bins_b], weights=w, axis=1,
                     method=method)
    h = np.asarray(h)
    assert np.isnan(h[1]).sum() == 1 and np.isnan(h[[0, 2]]).sum() == 0
    w_clean = w.copy()
    w_clean[1, 0] = 0
    for r in range(3):
        expected, _, _ = np.histogram2d(
            a[r], b[r], bins=[bins_a, bins_b], weights=w_clean[r].astype("f8")
        )
        fin = ~np.isnan(h[r])
        np.testing.assert_allclose(
            h[r][fin], expected[fin], rtol=1e-4, atol=1e-4
        )


@pytest.mark.parametrize("rows", [4, 32])
def test_joint_grid_36000_slots(method, rows):
    """A 36,000-slot joint grid, reduce-all and per row."""
    rng = np.random.RandomState(14)
    a = rng.randn(rows, 500).astype("f4")
    b = rng.randn(rows, 500).astype("f4")
    bins_a = np.linspace(-4, 4, 201)
    bins_b = np.linspace(-4, 4, 181)
    h, _ = histogram(a, b, bins=[bins_a, bins_b], method=method)
    expected, _, _ = np.histogram2d(a.ravel(), b.ravel(),
                                    bins=[bins_a, bins_b])
    np.testing.assert_array_equal(np.asarray(h), expected)
    hr, _ = histogram(a[:4], b[:4], bins=[bins_a, bins_b], axis=1,
                      method=method)
    for r in range(4):
        er, _, _ = np.histogram2d(a[r], b[r], bins=[bins_a, bins_b])
        np.testing.assert_array_equal(np.asarray(hr)[r], er)


def test_narrow_reduce_axis_large_grid(method):
    """Kept rows with a NARROW reduce axis (c = 64) and a 10,800-slot
    grid."""
    rng = np.random.RandomState(20)
    a = rng.randn(16, 64).astype("f4")
    b = rng.randn(16, 64).astype("f4")
    bins_a = np.linspace(-4, 4, 121)   # 120 x 90 = 10800 slots > 8192
    bins_b = np.linspace(-4, 4, 91)
    h, _ = histogram(a, b, bins=[bins_a, bins_b], axis=1, method=method)
    assert h.shape == (16, 120, 90)
    for r in range(16):
        expected, _, _ = np.histogram2d(a[r], b[r], bins=[bins_a, bins_b])
        np.testing.assert_array_equal(np.asarray(h)[r], expected)


def test_few_rows_many_bins_odd_columns(method):
    """Three rows, 9000 bins, 45 columns."""
    rng = np.random.RandomState(21)
    data = rng.randn(3, 45).astype("f4")
    edges = np.linspace(-4, 4, 9001)   # 9000 bins > 8192 slots, c=45 < 256
    h, _ = histogram(data, bins=edges, axis=1, method=method)
    expected = np.stack([np.histogram(r, bins=edges)[0] for r in data])
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_many_bins_weighted_nan_inf(method):
    """Weights incl. nonfinite values over 10,000 bins (the faithful
    channels must stay per-row exact)."""
    rng = np.random.RandomState(22)
    a = rng.randn(9, 100).astype("f4")
    w = rng.rand(9, 100).astype("f4")
    w[0, 3] = np.nan
    w[4, 7] = np.inf
    edges = np.linspace(-4, 4, 10001)  # 10000 bins
    h, _ = histogram(a, bins=edges, weights=w, axis=1, method=method)
    for r in range(9):
        # scatter-semantics oracle (np.histogram's cumsum path would smear a
        # NaN weight across all later bins; the library contract is
        # np.bincount-style single-bin poisoning — see ops/nonfinite.py)
        idx = np.searchsorted(edges, a[r].astype("f8"), side="right") - 1
        idx = np.where(a[r].astype("f8") == edges[-1], len(edges) - 2, idx)
        expected = np.zeros(len(edges) - 1)
        for e, ww in zip(idx, w[r].astype("f8")):
            if 0 <= e < len(expected):
                expected[e] += ww
        np.testing.assert_allclose(
            np.asarray(h)[r], expected, rtol=1e-4, atol=1e-4, equal_nan=True
        )


@pytest.mark.parametrize("axis", [None, 1])
def test_many_edges(method, axis):
    """1,537 edges: counts stay bit-exact."""
    rng = np.random.RandomState(23)
    data = rng.randn(4, 2500).astype("f4")
    edges = np.linspace(-4, 4, 1537)
    h, _ = histogram(data, bins=edges, axis=axis, method=method)
    if axis is None:
        expected = np.histogram(data, bins=edges)[0]
    else:
        expected = np.stack([np.histogram(r, bins=edges)[0] for r in data])
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_three_inputs_kept_rows(method):
    """Three inputs, kept rows, 10,000 slots."""
    rng = np.random.RandomState(25)
    arrs = [rng.randn(12, 80).astype("f4") for _ in range(3)]
    edges = [np.linspace(-4, 4, 21), np.linspace(-4, 4, 26),
             np.linspace(-4, 4, 21)]  # 20*25*20 = 10000 slots > 8192
    h, _ = histogram(*arrs, bins=edges, axis=1, method=method)
    assert h.shape == (12, 20, 25, 20)
    for r in range(12):
        expected, _ = np.histogramdd(
            np.stack([a[r] for a in arrs], -1), bins=edges
        )
        np.testing.assert_array_equal(np.asarray(h)[r], expected)
