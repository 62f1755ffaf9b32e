"""precision='f64': EXACT float64-weighted sums.

The default weighted paths represent weights through float32 (the
documented f64→f32 downcast, test_dtypes.py); the reference sums float64
weights with np.bincount's sequential float64 accumulator (reference
core.py:81) — exact representation, O(n·eps64) accumulation error. The
'f64' tier is stronger than both: per-slot sums are computed exactly
(exponent-grouped integer decomposition + the exact digit engine +
double-double host combine) and rounded ONCE, so results are correctly
rounded to <= 1 ulp. The oracle here is exact rational arithmetic
(fractions.Fraction), not np.histogram.
"""

from fractions import Fraction

import numpy as np
import pytest

from xhistogram_tpu.core import histogram


def _exact_slot_sums(data, edges, weights):
    """Per-slot EXACT rational sums (data strictly inside the bins —
    callers avoid edge collisions so plain right-open digitize is the
    correct oracle)."""
    idx = np.searchsorted(edges, data, side="right") - 1
    sums = [Fraction(0)] * (len(edges) - 1)
    for i, w in zip(idx.ravel(), np.asarray(weights, np.float64).ravel()):
        if 0 <= i < len(sums):
            sums[i] += Fraction(w)
    return sums


def _assert_correctly_rounded(h, exact_sums):
    h = np.asarray(h)
    assert h.dtype == np.float64
    for got, ex in zip(h.ravel(), exact_sums):
        want = float(ex)
        assert abs(got - want) <= np.spacing(abs(want)), (got, want)


def test_correctly_rounded_vs_rational_oracle():
    rng = np.random.RandomState(0)
    data = rng.rand(400).astype("f4") * 0.98 + 0.01
    edges = np.linspace(0.0, 1.0, 9)
    # exponents spanning ~130 binades — far beyond any float32 carrier
    w = rng.randn(400) * 10.0 ** rng.uniform(-20, 20, 400)
    h, _ = histogram(data, bins=edges, weights=w, precision="f64")
    _assert_correctly_rounded(h, _exact_slot_sums(data, edges, w))


def test_exact_on_catastrophic_cancellation():
    # alternating ±1e16 with unit survivors: any float32-carrier mode (and
    # a naive sequential f64 sum) loses the units entirely
    k = 50
    w = np.tile([1e16, 1.0, -1e16, 1.0], k)
    data = np.full(w.shape, 0.5, "f4")
    edges = np.linspace(0.0, 1.0, 3)
    h, _ = histogram(data, bins=edges, weights=w, precision="f64")
    np.testing.assert_array_equal(np.asarray(h), [0.0, float(2 * k)])


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_matches_f32_default_within_f32_error(method):
    """The default f32 sums of ~170 weights per bin agree with the exact
    tier within n * 2**-24."""
    rng = np.random.RandomState(1)
    data = rng.rand(1000).astype("f4")
    edges = np.linspace(0.0, 1.0, 7)
    w = rng.rand(1000)  # plain [0,1) float64
    h64, _ = histogram(data, bins=edges, weights=w, precision="f64",
                       method=method)
    h32, _ = histogram(data, bins=edges, weights=w.astype("f4"),
                       method=method)
    np.testing.assert_allclose(
        np.asarray(h64), np.asarray(h32, np.float64), rtol=1e-5
    )


def test_subnormal_and_zero_weights():
    data = np.array([0.25, 0.25, 0.75, 0.75, 0.25, 0.75], "f4")
    edges = np.linspace(0.0, 1.0, 3)
    w = np.array([5e-324, 2.2250738585072014e-308, 1.0, -0.0, 0.0, 4e-310])
    h, _ = histogram(data, bins=edges, weights=w, precision="f64")
    exact = _exact_slot_sums(data, edges, w)
    _assert_correctly_rounded(h, exact)


def test_nonfinite_weights_scatter_semantics():
    data = np.array([0.1, 0.1, 0.5, 0.5, 0.9, 0.9], "f4")
    edges = np.linspace(0.0, 1.0, 4)
    w = np.array([np.nan, 1.0, np.inf, -np.inf, np.inf, 3.0])
    h = np.asarray(histogram(data, bins=edges, weights=w,
                             precision="f64")[0])
    assert np.isnan(h[0])          # nan + 1.0
    assert np.isnan(h[1])          # inf + -inf
    assert h[2] == np.inf          # inf + 3.0


def test_too_many_exponent_groups_raises():
    # the cap counts NONEMPTY exponent groups (each is one engine pass),
    # so it takes > 32 distinct ~10-binade windows to trip it
    data = np.full(40, 0.5, "f4")
    edges = np.linspace(0.0, 1.0, 3)
    w = 10.0 ** np.linspace(-290, 290, 40)
    with pytest.raises(ValueError, match="exponent groups"):
        histogram(data, bins=edges, weights=w, precision="f64")


def test_traced_caller_raises():
    import jax

    data = np.linspace(0.1, 0.9, 16).astype("f4")
    edges = np.linspace(0.0, 1.0, 5)

    def f(w):
        return histogram(data, bins=edges, weights=w, precision="f64")[0]

    with pytest.raises(ValueError, match="tracing"):
        jax.jit(f)(np.ones(16, "f4"))


def test_integer_weights_normalize_to_exact_int_path():
    data = np.array([0.2, 0.4, 0.6], "f4")
    edges = np.linspace(0.0, 1.0, 3)
    w = np.array([2**40, 3, 5], np.int64)
    h64, _ = histogram(data, bins=edges, weights=w, precision="f64")
    hint, _ = histogram(data, bins=edges, weights=w)
    np.testing.assert_array_equal(np.asarray(h64), np.asarray(hint))
    assert np.asarray(h64).dtype.kind == "i"  # the exact int path, untouched


def test_unweighted_request_is_mode_independent():
    data = np.linspace(0.1, 0.9, 32).astype("f4")
    edges = np.linspace(0.0, 1.0, 5)
    h, _ = histogram(data, bins=edges, precision="f64")
    np.testing.assert_array_equal(
        np.asarray(h), np.histogram(data, bins=edges)[0]
    )


def test_kept_axes_and_joint_and_density():
    rng = np.random.RandomState(2)
    a = rng.rand(3, 200).astype("f4")
    b = rng.rand(3, 200).astype("f4")
    ea = np.linspace(0.0, 1.0, 5)
    eb = np.linspace(0.0, 1.0, 4)
    w = rng.randn(3, 200) * 10.0 ** rng.uniform(-12, 12, (3, 200))
    h, _ = histogram(a, b, bins=[ea, eb], axis=1, weights=w,
                     precision="f64")
    assert np.asarray(h).shape == (3, 4, 3)
    # oracle: per-row exact rational sums on the joint grid
    for r in range(3):
        ia = np.searchsorted(ea, a[r], side="right") - 1
        ib = np.searchsorted(eb, b[r], side="right") - 1
        ex = {}
        for i, j, wv in zip(ia, ib, w[r].astype(np.float64)):
            ex[(i, j)] = ex.get((i, j), Fraction(0)) + Fraction(wv)
        for (i, j), s in ex.items():
            want = float(s)
            got = float(np.asarray(h)[r, i, j])
            assert abs(got - want) <= np.spacing(abs(want))
    # density normalizes in float64 like the other wide host paths
    hd, _ = histogram(a, b, bins=[ea, eb], axis=1, weights=w,
                      precision="f64", density=True)
    widths = np.outer(np.diff(ea), np.diff(eb))
    integral = (np.asarray(hd) * widths).sum(axis=(-2, -1))
    np.testing.assert_allclose(integral, 1.0, rtol=1e-12)


def test_broadcast_weights():
    rng = np.random.RandomState(3)
    data = rng.rand(4, 64).astype("f4")
    edges = np.linspace(0.0, 1.0, 6)
    w = rng.randn(64) * 10.0 ** rng.uniform(-15, 15, 64)  # broadcast rows
    h, _ = histogram(data, bins=edges, axis=1, weights=w, precision="f64")
    for r in range(4):
        _assert_correctly_rounded(
            np.asarray(h)[r], _exact_slot_sums(data[r], edges, w)
        )


def test_streaming_f64_within_chunk_exact():
    from xhistogram_tpu import StreamingHistogram

    edges = np.linspace(0.0, 1.0, 3)
    acc = StreamingHistogram(bins=[edges], precision="f64")
    # cancellation WITHIN each chunk is computed exactly (per-chunk sums
    # are correctly rounded before they enter the accumulator)
    acc.update(np.array([0.25, 0.25, 0.25], "f4"),
               weights=np.array([1e16, 1.0, -1e16]))
    acc.update(np.array([0.25], "f4"), weights=np.array([1.0]))
    h, _ = acc.result()
    np.testing.assert_array_equal(h, [2.0, 0.0])


def test_streaming_f64_dd_across_chunks():
    """Cross-chunk cancellation: the double-double accumulator adds the
    correctly-rounded chunk partials EXACTLY, so magnitude spread across
    chunks does not lose the small terms (plain f64 accumulation — the
    pre-r5 behavior — returns 0.0 here: 1e16 + 1.0 rounds to 1e16)."""
    from xhistogram_tpu import StreamingHistogram

    edges = np.linspace(0.0, 1.0, 3)
    acc = StreamingHistogram(bins=[edges], precision="f64")
    acc.update(np.array([0.25], "f4"), weights=np.array([1e16]))
    acc.update(np.array([0.25], "f4"), weights=np.array([1.0]))
    acc.update(np.array([0.25], "f4"), weights=np.array([-1e16]))
    h, _ = acc.result()
    np.testing.assert_array_equal(h, [1.0, 0.0])
    # mid-stream state surfaces the combined (hi + lo) value too
    assert acc.counts[0] == 1.0
    assert acc.blocks[()][0] == 1.0


def test_streaming_f64_overflow_returns_inf():
    """A slot whose exact stream sum overflows float64 returns +inf, not
    NaN (the dd compensation term is inf-poisoned there and must be
    masked — same guard as the eager f64 combine, ADVICE r4)."""
    from xhistogram_tpu import StreamingHistogram

    edges = np.linspace(0.0, 1.0, 3)
    acc = StreamingHistogram(bins=[edges], precision="f64")
    acc.update(np.array([0.25], "f4"), weights=np.array([1.7e308]))
    acc.update(np.array([0.25], "f4"), weights=np.array([1.7e308]))
    h, _ = acc.result()
    assert h[0] == np.inf and h[1] == 0.0


def test_labeled_f64_uncached_path():
    from xhistogram_tpu.labeled import NamedArray
    from xhistogram_tpu.labeled import histogram as lhist

    rng = np.random.RandomState(4)
    data = NamedArray(rng.rand(5, 40).astype("f4"), dims=("y", "x"),
                      name="v")
    w = NamedArray(
        rng.randn(5, 40) * 10.0 ** rng.uniform(-10, 10, (5, 40)),
        dims=("y", "x"),
    )
    edges = np.linspace(0.0, 1.0, 5)
    out = lhist(data, bins=[edges], dim=["x"], weights=w,
                precision="f64")
    ref, _ = histogram(np.asarray(data.data), bins=edges, axis=1,
                       weights=np.asarray(w.data), precision="f64")
    np.testing.assert_array_equal(np.asarray(out.data), ref)


def test_sharded_f64_matches_eager():
    """precision='f64' on histogram_sharded (r5, VERDICT r4 #3): per-digit
    int32 psums + host double-double combine — bit-identical to the eager
    exact tier."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from xhistogram_tpu.parallel import histogram_sharded

    devs = np.array(jax.devices()[:4]).reshape(4)
    mesh = Mesh(devs, ("dp",))
    rng = np.random.RandomState(5)
    data = rng.rand(8, 16).astype("f4")
    w = rng.randn(8, 16) * 10.0 ** rng.uniform(-12, 12, (8, 16))
    edges = np.linspace(0.0, 1.0, 5)
    hs, _ = histogram_sharded(data, mesh=mesh, in_spec=P("dp", None),
                              bins=[edges], axis=1, weights=w,
                              precision="f64")
    he, _ = histogram(data, bins=[edges], axis=1, weights=w,
                      precision="f64")
    assert hs.dtype == np.float64
    np.testing.assert_array_equal(np.asarray(hs), np.asarray(he))
    # density composes too
    hsd, _ = histogram_sharded(data, mesh=mesh, in_spec=P("dp", None),
                               bins=[edges], axis=1, weights=w,
                               precision="f64", density=True)
    hed, _ = histogram(data, bins=[edges], axis=1, weights=w,
                       precision="f64", density=True)
    np.testing.assert_array_equal(np.asarray(hsd), np.asarray(hed))


def test_sharded_f64_cancellation_across_shards():
    """Huge +w on one shard, -w on another, tiny survivor on a third:
    the per-digit int64-exact psums preserve the cancellation exactly
    (plain f32/f64 psum accumulation would lose the 1.0)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from xhistogram_tpu.parallel import histogram_sharded

    devs = np.array(jax.devices()[:4]).reshape(4)
    mesh = Mesh(devs, ("dp",))
    data = np.full((4, 4), 0.25, "f4")
    w = np.zeros((4, 4))
    w[0, 0] = 1e15
    w[1, 0] = 1.0
    w[2, 0] = -1e15
    edges = np.linspace(0.0, 1.0, 3)
    h, _ = histogram_sharded(data, mesh=mesh, in_spec=P("dp", None),
                             bins=[edges], weights=w, precision="f64")
    np.testing.assert_array_equal(np.asarray(h), [1.0, 0.0])


def test_sharded_f64_nonfinite_weights():
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from xhistogram_tpu.parallel import histogram_sharded

    devs = np.array(jax.devices()[:4]).reshape(4)
    mesh = Mesh(devs, ("dp",))
    data = np.array([[0.25, 0.75]] * 4, "f4")
    w = np.ones((4, 2))
    w[0, 0] = np.inf
    w[1, 1] = np.nan
    edges = np.linspace(0.0, 1.0, 3)
    h, _ = histogram_sharded(data, mesh=mesh, in_spec=P("dp", None),
                             bins=[edges], weights=w, precision="f64")
    h = np.asarray(h)
    assert h[0] == np.inf and np.isnan(h[1])
