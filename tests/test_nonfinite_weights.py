"""Nonfinite-weight faithfulness across every counting strategy.

The reference's inner kernel is ``np.bincount(idx, weights=w)`` (reference
core.py:81): a NaN/±inf weight lands in its element's bin ONLY. Matmul /
einsum / prefix-sum reformulations would poison whole rows (NaN·0 = NaN,
inf - inf = NaN); ops/nonfinite.py restores scatter semantics. These tests
pin that contract for scatter, onehot, sort and auto, over one- to
three-input shapes.
"""

import numpy as np
import pytest

from xhistogram_tpu.core import histogram

METHODS = ["scatter", "onehot", "sort", "auto"]


def oracle_1d(data, edges, w):
    """Reference scatter semantics: per-bin IEEE sum of weights (python
    loop — the unambiguous ground truth)."""
    nb = len(edges) - 1
    out = np.zeros(nb, dtype=np.float64)
    for v, ww in zip(np.ravel(data), np.ravel(w)):
        if np.isnan(v):
            continue
        i = np.searchsorted(edges, v, side="right") - 1
        if v == edges[-1]:
            i = nb - 1
        if 0 <= i < nb:
            out[i] += np.float64(ww)
    return out


def assert_structure_equal(actual, expected):
    """NaN/±inf placement must match exactly; finite values to tolerance."""
    actual = np.asarray(actual, dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(actual), np.isnan(expected))
    np.testing.assert_array_equal(
        np.isposinf(actual), np.isposinf(expected)
    )
    np.testing.assert_array_equal(
        np.isneginf(actual), np.isneginf(expected)
    )
    fin = np.isfinite(expected)
    np.testing.assert_allclose(actual[fin], expected[fin], rtol=1e-4, atol=1e-5)


CASES = {
    "nan": [np.nan],
    "posinf": [np.inf],
    "neginf": [-np.inf],
    "both_inf_same_bin": [np.inf, -np.inf],
    "nan_and_inf": [np.nan, np.inf],
}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_nonfinite_1d_reduce_all(method, case):
    rng = np.random.RandomState(0)
    data = rng.uniform(-3.5, 3.5, size=200).astype("f4")
    w = rng.rand(200).astype("f4")
    # plant the special weights on elements known to be in range, in one bin
    # region (indices 0..k get data near 0.1 → bin of 0.1)
    specials = CASES[case]
    for k, sw in enumerate(specials):
        data[k] = 0.1 + 0.01 * k
        w[k] = sw
    edges = np.linspace(-4, 4, 10)
    h, _ = histogram(data, bins=edges, weights=w, method=method)
    assert_structure_equal(h, oracle_1d(data, edges, w))


@pytest.mark.parametrize("method", METHODS)
def test_nonfinite_rows_isolated(method):
    """A NaN weight in one kept row must not leak into other rows or bins
    (the row-block contamination failure mode of matmul counting)."""
    rng = np.random.RandomState(1)
    data = rng.uniform(-3.5, 3.5, size=(6, 64)).astype("f4")
    w = rng.rand(6, 64).astype("f4")
    data[2, 5], w[2, 5] = 0.1, np.nan
    data[4, 7], w[4, 7] = -2.0, np.inf
    edges = np.linspace(-4, 4, 10)
    h, _ = histogram(data, bins=edges, weights=w, axis=1, method=method)
    expected = np.stack(
        [oracle_1d(d, edges, ww) for d, ww in zip(data, w)]
    )
    assert_structure_equal(h, expected)


@pytest.mark.parametrize("method", METHODS)
def test_nonfinite_out_of_range_weight_ignored(method):
    """A nonfinite weight on an out-of-range (or NaN) element is trimmed
    with its element — it must not poison anything."""
    data = np.array([0.5, 99.0, np.nan, -99.0], dtype="f4")
    w = np.array([2.0, np.nan, np.inf, -np.inf], dtype="f4")
    edges = np.linspace(0, 1, 5)
    h, _ = histogram(data, bins=edges, weights=w, method=method)
    expected = oracle_1d(data, edges, w)
    assert np.all(np.isfinite(np.asarray(h)))
    assert_structure_equal(h, expected)


@pytest.mark.parametrize("method", METHODS)
def test_nonfinite_joint2_kernel(method):
    """2-input full reduction: a NaN and an inf weight stay in their own
    joint bins."""
    rng = np.random.RandomState(2)
    a = rng.uniform(-3.5, 3.5, size=(4, 50)).astype("f4")
    b = rng.uniform(-3.5, 3.5, size=(4, 50)).astype("f4")
    w = rng.rand(4, 50).astype("f4")
    a[0, 0], b[0, 0], w[0, 0] = 0.1, 0.2, np.nan
    a[1, 1], b[1, 1], w[1, 1] = -1.0, 1.0, np.inf
    edges_a = np.linspace(-4, 4, 9)
    edges_b = np.linspace(-4, 4, 12)
    h, _ = histogram(a, b, bins=[edges_a, edges_b], weights=w, method=method)
    # oracle over the flattened joint grid
    ia = np.clip(np.searchsorted(edges_a, a.ravel(), "right") - 1, -1, 8)
    ib = np.clip(np.searchsorted(edges_b, b.ravel(), "right") - 1, -1, 11)
    expected = np.zeros((8, 11))
    for x, y, va, vb, ww in zip(ia, ib, a.ravel(), b.ravel(), w.ravel()):
        if edges_a[0] <= va <= edges_a[-1] and edges_b[0] <= vb <= edges_b[-1]:
            expected[min(x, 7), min(y, 10)] += np.float64(ww)
    assert_structure_equal(h, expected)


@pytest.mark.parametrize("method", METHODS)
def test_nonfinite_factored_kernel(method):
    """3-input full reduction with a 35,840-slot joint grid."""
    rng = np.random.RandomState(3)
    data = [rng.uniform(-3.5, 3.5, size=1000).astype("f4") for _ in range(3)]
    w = rng.rand(1000).astype("f4")
    data[0][0], data[1][0], data[2][0] = 0.1, 0.1, 0.1
    w[0] = np.nan
    bins = [np.linspace(-4, 4, n) for n in (33, 41, 29)]
    h, _ = histogram(*data, bins=bins, weights=w, method=method)
    h = np.asarray(h)
    # exactly one joint bin got the NaN
    assert np.isnan(h).sum() == 1
    # the rest match the sanitized-weight histogram
    w_clean = w.copy()
    w_clean[0] = 0.0
    expected, _ = np.histogramdd(
        [d.ravel() for d in data], bins=bins, weights=w_clean.astype("f8")
    )
    fin = ~np.isnan(h)
    np.testing.assert_allclose(h[fin], expected[fin], rtol=1e-4, atol=1e-4)


def test_int_weights_unaffected():
    """Integer weights skip the faithful machinery entirely and stay exact."""
    rng = np.random.RandomState(4)
    data = rng.uniform(-3.5, 3.5, size=(4, 40)).astype("f4")
    w = rng.randint(0, 10, size=(4, 40)).astype(np.int32)
    edges = np.linspace(-4, 4, 10)
    for method in METHODS:
        h, _ = histogram(data, bins=edges, weights=w, axis=1, method=method)
        expected = np.stack(
            [np.histogram(d, bins=edges, weights=ww)[0]
             for d, ww in zip(data, w)]
        )
        np.testing.assert_array_equal(np.asarray(h), expected)
