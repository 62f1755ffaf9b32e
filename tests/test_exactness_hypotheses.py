"""Property-based dtype/edge exactness (the r2 analog of the reference's
hypothesis-over-chunkings suite, aimed at the comparison machinery instead):
arbitrary data dtypes x adversarial edges (values at rounding cutovers,
dtype boundaries, duplicated/denormal-spaced edges) must reproduce
np.histogram bit-exactly through the whole pipeline.
"""

import numpy as np
import pytest

from xhistogram_tpu.core import histogram

pytest.importorskip("hypothesis")

import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402


def _np_parity(data, edges):
    h, _ = histogram(data, bins=edges)
    expected = np.histogram(data, bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), expected)


@st.composite
def int_problems(draw):
    dtype = draw(st.sampled_from([np.int32, np.int64, np.uint64]))
    info = np.iinfo(dtype)
    scale = draw(st.integers(1, 62))
    base = draw(st.integers(max(info.min, -(2**scale)),
                            min(info.max, 2**scale)))
    spread = draw(st.integers(1, 2**scale))
    vals = draw(
        st.lists(
            st.integers(max(info.min, base - spread),
                        min(info.max, base + spread)),
            min_size=1, max_size=64,
        )
    )
    # always include the dtype boundaries (the r1 corner class)
    vals = vals + [info.min, info.max]
    n_edges = draw(st.integers(2, 8))
    kind = draw(st.sampled_from(["f64", "i64", "u64"]))
    if kind == "f64":
        # float edges near the data (incl. fractional + rounding cutovers)
        es = draw(
            st.lists(
                st.floats(float(base - spread), float(base + spread + 1),
                          allow_nan=False, allow_subnormal=False),
                min_size=n_edges, max_size=n_edges,
            )
        )
        edges = np.sort(np.asarray(es, np.float64))
    else:
        # integer edges, possibly of MIXED signedness vs the data (numpy
        # promotes int64-vs-uint64 comparisons through a lossy f64 cast)
        # and possibly beyond the data dtype's range
        einfo = np.iinfo(np.int64 if kind == "i64" else np.uint64)
        lo = max(einfo.min, base - 4 * spread)
        hi = min(einfo.max, base + 4 * spread)
        if lo >= hi:
            lo, hi = einfo.min, einfo.max
        es = draw(
            st.lists(st.integers(lo, hi), min_size=n_edges,
                     max_size=n_edges)
        )
        edges = np.sort(
            np.asarray(es, np.int64 if kind == "i64" else np.uint64)
        )
    return np.asarray(vals, dtype), edges


@given(int_problems())
@settings(max_examples=60, deadline=None)
def test_integer_data_exact(problem):
    data, edges = problem
    if edges[0] == edges[-1]:
        edges = np.concatenate([edges[:1], [edges[-1] + 1]]).astype(
            edges.dtype
        )
    _np_parity(data, edges)


@st.composite
def float_problems(draw):
    dtype = draw(st.sampled_from([np.float32, np.float64]))
    base = draw(st.floats(-1e6, 1e6, allow_nan=False, allow_subnormal=False))
    spread = draw(st.floats(1e-6, 1e3))
    lo, hi = base - spread, base + spread
    if dtype is np.float32:
        # width-32 bounds must be exactly f32-representable
        lo, hi = float(np.float32(lo)), float(np.float32(hi))
        if lo >= hi:
            hi = float(np.nextafter(np.float32(lo), np.float32(np.inf)))
    vals = draw(
        st.lists(
            st.floats(lo, hi, allow_nan=False, allow_subnormal=False,
                      width=32 if dtype is np.float32 else 64),
            min_size=1, max_size=64,
        )
    )
    n_edges = draw(st.integers(2, 8))
    es = draw(
        st.lists(
            st.floats(base - spread, base + spread, allow_nan=False, allow_subnormal=False),
            min_size=n_edges, max_size=n_edges,
        )
    )
    edges = np.sort(np.asarray(es, np.float64))
    data = np.asarray(vals, dtype)
    # sprinkle values exactly AT edges and one-ulp around them — the
    # half-open/closed-last-bin decisions live there
    extra = np.concatenate(
        [edges, np.nextafter(edges, np.inf), np.nextafter(edges, -np.inf)]
    ).astype(dtype)
    return np.concatenate([data, extra]), edges


@given(float_problems())
@settings(max_examples=60, deadline=None)
def test_float_data_exact(problem):
    data, edges = problem
    if edges[0] == edges[-1]:
        edges = np.concatenate([edges[:1], [edges[-1] + 1.0]])
    _np_parity(data, edges)


@given(
    st.integers(min_value=-3, max_value=3),
    st.sampled_from([0.125, 0.25, 0.5, 1.0, 2.0]),
    st.integers(min_value=66, max_value=300),
    st.integers(min_value=0, max_value=2**31 - 1),
)
@settings(max_examples=30, deadline=None)
@pytest.mark.slow
def test_uniform_certified_grids_bit_exact(t0i, d, nb, seed):
    """Certified-uniform grids (pow-2 / integer spacing) through the
    arithmetic-digitize route must stay bit-exact vs numpy, including
    boundary-straddling values."""
    edges = t0i + d * np.arange(nb + 1)
    rng = np.random.RandomState(seed)
    data = np.concatenate([
        edges.astype("f4").astype("f8"),
        rng.uniform(edges[0] - d, edges[-1] + d, 400),
    ]).astype("f4")
    h, _ = histogram(data, bins=edges)
    expected = np.histogram(data.astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), expected)


@given(
    st.floats(min_value=-1e4, max_value=1e4, allow_nan=False),
    st.floats(min_value=-4.0, max_value=4.0, allow_nan=False),
    st.integers(min_value=66, max_value=1200),
    st.integers(min_value=0, max_value=2**31 - 1),
)
@settings(max_examples=30, deadline=None)
@pytest.mark.slow
def test_uniform_ds_grids_bit_exact(a, logw, nb, seed):
    """Generic linspace grids (double-single certificate tier, or the
    compare-chain fallback when certification rejects) must stay
    bit-exact vs numpy, including every threshold and its one-ulp
    neighbors."""
    width = 10.0 ** logw
    edges = np.linspace(a, a + width, nb + 1)
    if not np.all(np.diff(edges) > 0):
        return  # degenerate sub-resolution grid
    rng = np.random.RandomState(seed)
    e32 = edges.astype("f4")
    data = np.concatenate([
        e32, np.nextafter(e32, np.inf), np.nextafter(e32, -np.inf),
        rng.uniform(edges[0] - width / 8, edges[-1] + width / 8,
                    300).astype("f4"),
    ]).astype("f4")
    h, _ = histogram(data, bins=edges)
    expected = np.histogram(data.astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), expected)


@given(
    st.booleans(),
    st.integers(min_value=25, max_value=160),
    st.integers(min_value=0, max_value=2**31 - 1),
)
@settings(max_examples=25, deadline=None)
@pytest.mark.slow
def test_uniform_weighted_routing_bands_exact(ds_tier, nb, seed):
    """Weighted certified-uniform grids (arith and DS tiers) through the
    O(1) digitize. Small integer weights make every partial sum exact in
    f32, so the weighted result must EQUAL numpy's."""
    if ds_tier:
        edges = np.linspace(-4.2, 4.2, nb + 1)  # generic spacing → DS
    else:
        edges = 0.25 * np.arange(nb + 1) - nb / 8.0  # pow-2 d → arith
    rng = np.random.RandomState(seed)
    data = np.concatenate([
        edges.astype("f4").astype("f8"),
        rng.uniform(edges[0] - 0.5, edges[-1] + 0.5, 400),
    ]).astype("f4")
    w = rng.randint(0, 9, data.size).astype("f4")
    h, _ = histogram(data, bins=edges, weights=w)
    expected = np.histogram(data.astype("f8"), bins=edges,
                            weights=w.astype("f8"))[0]
    np.testing.assert_array_equal(np.asarray(h, np.float64), expected)
