"""Ragged shapes: row and column counts that divide no block size (the
onehot strategy pads its column blocks; the sort strategy splits long rows
into padded chunk rows). These tests sweep deliberately misaligned shapes
through every counting strategy and demand exact (unweighted) / f32-
tolerance (weighted) parity with numpy."""

import numpy as np
import pytest

from xhistogram_tpu.core import histogram


def _oracle_rows(arrays, edges, weights=None):
    outs = []
    for r in range(arrays[0].shape[0]):
        h, _ = np.histogramdd(
            np.stack([np.asarray(a[r], "f8") for a in arrays], -1),
            bins=edges,
            weights=np.asarray(weights[r], "f8") if weights is not None
            else None,
        )
        outs.append(h)
    return np.stack(outs)


# (shape, nbins, axis): odd m and c, one to two inputs, 17 to ~800k slots
CASES = [
    ((3, 997), (17,), None, "one input reduce-all, odd c"),
    ((13, 509), (17,), (1,), "one input kept rows, ragged both dims"),
    ((5, 1237), (23, 19), None, "joint 2-D reduce-all, ragged"),
    ((9, 773), (150, 90), (1,), "joint 2-D kept rows, wide c"),
    ((21, 37), (120, 90), (1,), "joint 2-D kept rows, narrow c"),
    ((11, 45), (40, 40), (1,), "joint 2-D kept rows, small grid"),
    ((2, 1111), (901, 901), None, "joint 2-D reduce-all, 811k slots"),
]


@pytest.fixture(params=["scatter", "onehot", "sort"])
def method(request):
    return request.param


@pytest.mark.parametrize("shape,nbins,axis,label", CASES,
                         ids=[c[3] for c in CASES])
def test_ragged_unweighted_exact(shape, nbins, axis, label, method):
    rng = np.random.RandomState(hash(label) % 2**31)
    arrays = [rng.randn(*shape).astype("f4") for _ in nbins]
    edges = [np.linspace(-4, 4, nb + 1) for nb in nbins]
    h, _ = histogram(*arrays, bins=edges, axis=axis, method=method)
    if axis is None:
        exp = _oracle_rows([a.reshape(1, -1) for a in arrays], edges)[0]
    else:
        exp = _oracle_rows(arrays, edges)
    np.testing.assert_array_equal(np.asarray(h), exp)


@pytest.mark.parametrize("shape,nbins,axis,label", CASES[:6],
                         ids=[c[3] for c in CASES[:6]])
def test_ragged_weighted(shape, nbins, axis, label, method):
    rng = np.random.RandomState(hash(label) % 2**31)
    arrays = [rng.randn(*shape).astype("f4") for _ in nbins]
    w = rng.rand(*shape).astype("f4")
    edges = [np.linspace(-4, 4, nb + 1) for nb in nbins]
    h, _ = histogram(*arrays, bins=edges, axis=axis, weights=w,
                     method=method)
    if axis is None:
        exp = _oracle_rows(
            [a.reshape(1, -1) for a in arrays], edges, w.reshape(1, -1)
        )[0]
    else:
        exp = _oracle_rows(arrays, edges, w)
    np.testing.assert_allclose(np.asarray(h), exp, rtol=2e-4, atol=2e-4)


def test_ragged_weighted_nan_weights_isolated(method):
    """Padding in ragged blocks must not leak into the nonfinite channels:
    exactly the poisoned element's bin goes NaN."""
    rng = np.random.RandomState(3)
    a = rng.randn(5, 333).astype("f4")
    w = rng.rand(5, 333).astype("f4")
    a[2, 7], w[2, 7] = 0.1, np.nan
    edges = np.linspace(-4, 4, 18)
    h, _ = histogram(a, bins=edges, axis=1, weights=w, method=method)
    h = np.asarray(h)
    assert np.isnan(h).sum() == 1 and np.isnan(h[2, np.digitize(0.1, edges) - 1])
