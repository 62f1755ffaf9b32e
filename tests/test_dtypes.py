"""Input-dtype coverage: float16/32, ints of several widths, bool-ish data.

The comparison-edge transform (bins.edges_for_compare) must stay exact for
every dtype the pipeline accepts.
"""

import numpy as np
import pytest

from xhistogram_tpu.core import histogram


@pytest.mark.parametrize(
    "dtype", ["float32", "float16", "int32", "int16", "uint8", "int64"]
)
@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_dtype_roundtrip(dtype, method):
    rng = np.random.RandomState(0)
    if np.issubdtype(np.dtype(dtype), np.floating):
        data = (rng.randn(300) * 10).astype(dtype)
        edges = np.linspace(-25.0, 25.0, 11)
    else:
        info = np.iinfo(dtype)
        data = rng.randint(max(info.min, -50), min(info.max, 50), 300).astype(
            dtype
        )
        edges = np.linspace(-50, 50, 11)
    h, _ = histogram(data, bins=edges, method=method)
    expected = np.histogram(data.astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), expected)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_float16_borderline(method):
    # f16 data vs f64 edges: exactness through the half-open transform
    edges = np.linspace(-1.0, 1.0, 7)  # f64, steps not f16-representable
    e16 = edges.astype(np.float16)
    data = np.concatenate(
        [e16, np.nextafter(e16, np.inf), np.nextafter(e16, -np.inf)]
    ).astype(np.float16)
    h, _ = histogram(data, bins=edges, method=method)
    expected = np.histogram(data.astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_mixed_dtype_joint():
    rng = np.random.RandomState(1)
    a = rng.randn(500).astype("f4")
    b = rng.randint(0, 50, 500).astype("i4")
    bins_a = np.linspace(-4, 4, 9)
    bins_b = np.arange(0, 55, 5)
    h, _ = histogram(a, b, bins=[bins_a, bins_b])
    expected, _, _ = np.histogram2d(
        a.astype("f8"), b.astype("f8"), bins=[bins_a, bins_b]
    )
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_weights_f64_downcast_documented():
    # f64 weights downcast to f32 under JAX's default 32-bit config
    rng = np.random.RandomState(2)
    data = rng.randn(200).astype("f4")
    w = rng.rand(200)  # float64
    bins = np.linspace(-3, 3, 9)
    h, _ = histogram(data, bins=bins, weights=w)
    expected = np.histogram(data.astype("f8"), bins=bins, weights=w)[0]
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_bool_data(method):
    """Bool inputs bin like numpy's (0/1 values; ref core.py:366 broadcasts
    whatever numpy accepts, and np.histogram takes bool data)."""
    rng = np.random.RandomState(4)
    data = rng.rand(257) > 0.4
    edges = np.linspace(0.0, 1.0, 5)
    h, _ = histogram(data, bins=edges, method=method)
    expected = np.histogram(data, bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_bool_weights():
    """Bool weights act as a selection mask (counts of the True subset).

    numpy's own ``np.histogram(..., weights=bool_array)`` raises a ufunc
    casting error, so this is strictly MORE permissive than the oracle;
    the contract pinned here is equivalence with pre-masked counts.
    """
    rng = np.random.RandomState(5)
    data = rng.randn(400).astype("f4")
    w = rng.rand(400) > 0.5
    edges = np.linspace(-3, 3, 9)
    h, _ = histogram(data, bins=edges, weights=w)
    expected = np.histogram(data[w].astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(
        np.asarray(h).astype("i8"), expected
    )


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_bf16_and_f16_data(method):
    """Narrow floats bin bit-exactly (edge transform is dtype-aware) — a
    capability the numpy reference never needed."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    edges = np.linspace(-4, 4, 10)
    for dt in (jnp.bfloat16, jnp.float16):
        data = jnp.asarray(rng.randn(4, 64), dt)
        h, _ = histogram(data, bins=edges, axis=1, method=method)
        expected = np.stack(
            [np.histogram(r, bins=edges)[0]
             for r in np.asarray(data, "f8")]
        )
        np.testing.assert_array_equal(np.asarray(h), expected)
