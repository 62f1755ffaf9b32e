"""Edge-comparison exactness: float64 edges vs float32 data.

numpy compares data against edges in the promoted (float64) dtype; a naive
float32 cast of the edges misplaces borderline elements. The half-open
transform (bins.edges_for_compare) must make float32-native comparisons
*bit-exactly* equivalent — these tests construct adversarial borderline
values to prove it.
"""

import numpy as np
import pytest

from xhistogram_tpu.bins import edges_for_compare
from xhistogram_tpu.core import histogram


def _oracle(data, edges):
    h, _ = np.histogram(data.astype(np.float64), bins=edges)
    return h


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort", "auto"])
def test_f64_edges_borderline_values(method):
    # edges not representable in f32; data sits exactly at the f32 neighbors
    # of each edge
    edges = np.linspace(-2.0, 30.0, 281)  # step 32/280 — not f32-exact
    assert not np.all(edges.astype(np.float32).astype(np.float64) == edges)

    e32 = edges.astype(np.float32)
    below = np.nextafter(e32, -np.inf).astype(np.float32)
    above = np.nextafter(e32, np.inf).astype(np.float32)
    data = np.concatenate([e32, below, above]).astype(np.float32)

    h, _ = histogram(data, bins=edges, method=method)
    np.testing.assert_array_equal(np.asarray(h), _oracle(data, edges))


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_f64_edges_closed_last_bin(method):
    # last edge not f32-representable: no f32 value equals it, but values
    # just below must still fall in the (closed) last bin
    edges = np.array([0.0, 0.1, 0.30000000000000004])
    data = np.array(
        [
            np.float32(0.3),                      # < e_last in f64 → last bin
            np.nextafter(np.float32(0.3), np.inf),  # > e_last → out of range
            np.float32(0.29),
        ],
        dtype=np.float32,
    )
    h, _ = histogram(data, bins=edges, method=method)
    np.testing.assert_array_equal(np.asarray(h), _oracle(data, edges))


def test_f64_edges_joint_2d():
    edges_a = np.linspace(-2.0, 30.0, 281)
    edges_b = np.linspace(30.0, 40.0, 341)
    rng = np.random.RandomState(0)
    # mix random data with exact-borderline values
    a = np.concatenate(
        [rng.uniform(-3, 31, 2000), edges_a.astype(np.float32)]
    ).astype(np.float32)
    b = np.concatenate(
        [rng.uniform(29, 41, 2000), edges_b[: len(edges_a)].astype(np.float32)]
    ).astype(np.float32)
    h, _ = histogram(a, b, bins=[edges_a, edges_b])
    expected, _, _ = np.histogram2d(
        a.astype(np.float64), b.astype(np.float64), bins=[edges_a, edges_b]
    )
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_edges_for_compare_properties():
    rng = np.random.RandomState(1)
    edges = np.sort(rng.uniform(-5, 5, 33))
    t = edges_for_compare(edges, np.float32)
    assert t.dtype == np.float32
    # transformed edges are monotone non-decreasing
    assert np.all(np.diff(t) >= 0)
    # semantic equivalence on a dense grid of f32 values
    vals = np.unique(
        np.concatenate(
            [
                edges.astype(np.float32),
                np.nextafter(edges.astype(np.float32), np.inf),
                np.nextafter(edges.astype(np.float32), -np.inf),
                rng.uniform(-6, 6, 500).astype(np.float32),
            ]
        )
    )
    # reference digitize in f64 with closed last bin
    ref = np.searchsorted(edges, vals.astype(np.float64), side="right")
    ref[vals.astype(np.float64) == edges[-1]] -= 1
    # ours: plain searchsorted-right over transformed edges
    got = np.searchsorted(t, vals, side="right")
    np.testing.assert_array_equal(got, ref)


def test_int_edges_closed_last_bin():
    data = np.array([1, 5, 9, 10, 11], dtype=np.int32)
    edges = np.array([0, 5, 10], dtype=np.int32)
    h, _ = histogram(data, bins=edges)
    np.testing.assert_array_equal(np.asarray(h), np.histogram(data, bins=edges)[0])


def test_traced_caller_subnormal_threshold_edges():
    """A traced (jitted) caller with subnormal comparison thresholds must
    NOT be routed to the host-only exact remap — tracers cannot leave the
    device (regression: the r3 _prepare_device refactor dropped
    ftz_exact_fallback's isinstance(ndarray) guard and raised
    TracerArrayConversionError here). On the CPU backend the device path
    is exact, so counts still match numpy."""
    import jax
    import jax.numpy as jnp

    edges = np.array([-1.0, -1e-39, 0.0, 1.0])  # -1e-39: subnormal f32
    data = np.linspace(-1, 1, 16).astype("f4")

    f = jax.jit(lambda x: histogram(x, bins=edges)[0])
    out = np.asarray(f(jnp.asarray(data)))
    exp = np.histogram(data.astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(out, exp)

    # concrete numpy input with the same edges keeps the exact host path
    h, _ = histogram(data, bins=edges)
    np.testing.assert_array_equal(np.asarray(h), exp)
