"""O(1) digitize for host-verified uniform thresholds (bins.uniform_form +
ops.digitize.digitize_uniform): must be BIT-IDENTICAL to the edge-compare
digitize (searchsorted) and to numpy, including values exactly at
thresholds, one-ulp neighbors, NaN/inf, int data, and the wide-dtype
rank-code path. ``ops.digitize.UNIFORM_DIGITIZE = False`` turns the
certificates off (A/B used here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xhistogram_tpu import bins as bins_mod
from xhistogram_tpu.core import histogram
from xhistogram_tpu.ops import digitize as dg

FORMS = ["searchsorted", "uniform", "uniform_jit"]
METHODS = ["scatter", "onehot", "sort"]


def _bins_by_form(vals, edges, form):
    """Per-element bin id (``nb`` = out of range / NaN) from one digitize
    form, called directly on the comparison-form thresholds
    (``uniform_jit``: the certificate values as traced operands of one
    compiled program, as the pipeline passes them)."""
    T = np.asarray(bins_mod.compare_form(edges, vals.dtype).edges)
    x = jnp.asarray(vals)
    if form == "searchsorted":
        idx = dg.digitize_edges(x, jnp.asarray(T))
    else:
        cert = bins_mod.uniform_form(T, np.asarray(edges, "f8"))
        assert cert is not None
        key, v = dg.uniform_operands(cert)
        fn = dg.digitize_uniform
        if form == "uniform_jit":
            fn = jax.jit(fn, static_argnums=(1, 3))
        idx = fn(x, key, v, T.shape[0])
    g, _ = dg.joint_bin_index([idx], (len(edges) - 1,))
    return np.asarray(g)


def _np_bins(vals, edges):
    v = np.asarray(vals, "f8")
    nb = len(edges) - 1
    i = np.searchsorted(edges, v, side="right") - 1
    i[v == edges[-1]] = nb - 1
    i[(i < 0) | (i >= nb) | np.isnan(v)] = nb
    return i


def _boundary_values(edges):
    e32 = edges.astype("f4").astype("f8")
    return np.concatenate([
        e32, np.nextafter(e32.astype("f4"), np.inf).astype("f8"),
        np.nextafter(e32.astype("f4"), -np.inf).astype("f8"),
        np.random.RandomState(0).uniform(edges[0] - 1, edges[-1] + 1, 500),
        [np.nan, np.inf, -np.inf],
    ]).astype("f4")


def _np_oracle(data, edges, axis=None, weights=None):
    if axis is None:
        return np.histogram(
            np.asarray(data, "f8").ravel(), bins=edges,
            weights=None if weights is None
            else np.asarray(weights, "f8").ravel(),
        )[0]
    return np.stack([
        np.histogram(np.asarray(r, "f8"), bins=edges,
                     weights=None if weights is None
                     else np.asarray(wr, "f8"))[0]
        for r, wr in zip(
            data, weights if weights is not None else data
        )
    ])


UNIFORM_EDGE_SETS = [
    np.linspace(-4, 4, 65),            # d = 0.125 (power of two)
    np.linspace(0, 1, 1025),           # d = 2^-10
    np.arange(-50.0, 51.0),            # d = 1
    np.linspace(-3, 3, 5),             # d = 1.5 = 3*2^-1
]


def test_uniform_form_accepts_and_rejects():
    accept = [np.asarray(bins_mod.compare_form(e, np.float32).edges)
              for e in UNIFORM_EDGE_SETS]
    for T in accept:
        assert bins_mod.uniform_arith_form(T) is not None
    rej = np.asarray(
        bins_mod.compare_form(np.linspace(-4, 4, 91), np.float32).edges
    )
    assert bins_mod.uniform_arith_form(rej) is None  # d = 8/90 rounds


UNIFORM_IDS = ["d1/8", "d2^-10", "d1", "d1.5"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("edges", UNIFORM_EDGE_SETS, ids=UNIFORM_IDS)
def test_uniform_boundary_values_bit_exact(edges, form):
    """Every threshold value, its one-ulp neighbors, random data and
    NaN/inf get numpy's bin under each digitize form."""
    vals = _boundary_values(edges)
    np.testing.assert_array_equal(
        _bins_by_form(vals, edges, form), _np_bins(vals, edges)
    )


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("edges", UNIFORM_EDGE_SETS, ids=UNIFORM_IDS)
def test_uniform_boundary_values_through_methods(edges, method):
    """The same values through the whole pipeline (which consumes the
    certificate) and each counting strategy."""
    vals = _boundary_values(edges)
    data = vals.reshape(1, -1)
    h, _ = histogram(data, bins=edges, method=method)
    exp = np.histogram(data.ravel().astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), exp)


@pytest.mark.parametrize("edges", UNIFORM_EDGE_SETS[:2],
                         ids=["d1/8", "d2^-10"])
def test_uniform_vs_fallback_identical(edges, monkeypatch):
    rng = np.random.RandomState(1)
    data = rng.uniform(edges[0] - 0.5, edges[-1] + 0.5, (4, 700)).astype("f4")
    h1, _ = histogram(data, data, bins=[edges, edges], axis=1)
    monkeypatch.setattr(dg, "UNIFORM_DIGITIZE", False)
    h0, _ = histogram(data, data, bins=[edges, edges], axis=1)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h0))


def test_uniform_int_data_and_rank_codes():
    rng = np.random.RandomState(2)
    ints = rng.randint(-60, 60, (3, 400)).astype("i4")
    edges = np.arange(-50.0, 51.0)
    h, _ = histogram(ints, ints, bins=[edges, edges])
    exp, _, _ = np.histogram2d(ints.ravel().astype("f8"),
                               ints.ravel().astype("f8"),
                               bins=[edges, edges])
    np.testing.assert_array_equal(np.asarray(h), exp)
    # wide int64 data -> host rank codes (uniform int thresholds) on device
    wide = (rng.randint(-5, 5, (2, 300)).astype("i8") * 10**12)
    e2 = np.linspace(-6e12, 6e12, 13)
    h2, _ = histogram(wide, bins=e2)
    np.testing.assert_array_equal(
        np.asarray(h2), np.histogram(wide.ravel(), bins=e2)[0]
    )


@pytest.mark.parametrize("method", METHODS)
def test_uniform_many_edges_per_row(method):
    """The many-edge regime (the arithmetic digitize's main win)."""
    rng = np.random.RandomState(3)
    data = rng.uniform(0, 1, (5, 3000)).astype("f4")
    edges = np.linspace(0, 1, 4097)  # d = 2^-12
    h, _ = histogram(data, bins=edges, axis=1, method=method)
    exp = np.stack([np.histogram(np.asarray(r, "f8"), bins=edges)[0]
                    for r in data])
    np.testing.assert_array_equal(np.asarray(h), exp)


@pytest.mark.parametrize("method", METHODS)
def test_uniform_weighted_and_grad(method):
    rng = np.random.RandomState(4)
    data = rng.uniform(-4, 4, (1, 2000)).astype("f4")
    w = rng.rand(1, 2000).astype("f4")
    edges = np.linspace(-4, 4, 2049)  # d = 2^-8
    h, _ = histogram(data, bins=edges, weights=w, method=method)
    exp = np.histogram(data.ravel().astype("f8"), bins=edges,
                       weights=w.ravel().astype("f8"))[0]
    np.testing.assert_allclose(np.asarray(h), exp, rtol=1e-4, atol=1e-5)


def test_negative_subnormal_data_vs_zero_edge():
    """FTZ regression: XLA:CPU flushes subnormal compare operands to ±0, so
    a negative-subnormal value would cross a 0.0 edge. The bitwise
    rewrite (ops/ftz.py) must restore numpy parity on every method."""
    vals = np.array(
        [np.nextafter(np.float32(0), -1), np.nextafter(np.float32(0), 1),
         -1e-38, 1e-38, -0.0, 0.0, -0.5, 0.5], dtype="f4",
    )
    data = np.broadcast_to(vals, (4, 8)).copy()
    edges = np.array([-1.0, 0.0, 1.0])
    expected = np.stack(
        [np.histogram(np.asarray(r, "f8"), bins=edges)[0] for r in data]
    )
    for method in ("auto", "scatter", "onehot", "sort"):
        h, _ = histogram(data, bins=edges, axis=1, method=method)
        np.testing.assert_array_equal(
            np.asarray(h), expected, err_msg=f"method={method}"
        )


DS_EDGE_SETS = [
    np.linspace(0, 1, 1001),       # d = 1e-3: not f32-exact -> DS tier
    np.linspace(0, 7, 401),        # 13 certified exceptions
    np.linspace(-4, 4, 601),       # 1 exception, zero-crossing grid
    np.linspace(-33, 91, 1001),    # 4 exceptions, asymmetric range
    np.arange(0, 800) * 0.1,       # accumulated-rounding "uniform" grid
    np.linspace(-4.2, 4.2, 4097),  # 39 exceptions: scaled nu//32 cap
]
DS_IDS = ["d1e-3", "exc13", "exc1-zero", "exc4-wide", "arange0.1",
          "exc39-4k"]


def test_ds_form_accepts_generic_linspace():
    """Generic (non-power-of-two-spacing) uniform grids certify via the
    double-single tier that the exact arithmetic form rejects."""
    for e in DS_EDGE_SETS:
        T = np.asarray(bins_mod.compare_form(e, np.float32).edges)
        assert bins_mod.uniform_arith_form(T) is None
        f = bins_mod.uniform_form(T, e)
        assert f is not None and f[0] == "ds", e[:3]
    # below the size floor the DS tier certifies nothing
    small = np.linspace(0, 1, 11)
    Ts = np.asarray(bins_mod.compare_form(small, np.float32).edges)
    assert bins_mod.uniform_form(Ts, small) is None


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("edges", DS_EDGE_SETS, ids=DS_IDS)
def test_ds_boundary_values_bit_exact(edges, form):
    """Every threshold, its one-ulp f32 neighbors, random data, and
    NaN/inf get numpy's bin under each digitize form (the DS tier includes
    grids with certified exception lists)."""
    vals = _boundary_values(edges)
    np.testing.assert_array_equal(
        _bins_by_form(vals, edges, form), _np_bins(vals, edges)
    )


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("edges", DS_EDGE_SETS, ids=DS_IDS)
def test_ds_boundary_values_through_methods(edges, method):
    vals = _boundary_values(edges)
    data = vals.reshape(1, -1)
    h, _ = histogram(data, bins=edges, method=method)
    exp = np.histogram(data.ravel().astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), exp)


def test_ds_vs_fallback_identical(monkeypatch):
    rng = np.random.RandomState(7)
    edges = np.linspace(0, 7, 401)
    data = rng.uniform(-0.5, 7.5, (3, 900)).astype("f4")
    h1, _ = histogram(data, bins=edges, axis=1)
    monkeypatch.setattr(dg, "UNIFORM_DIGITIZE", False)
    h0, _ = histogram(data, bins=edges, axis=1)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h0))


@pytest.mark.parametrize("method", METHODS)
def test_ds_weighted_kept_rows(method):
    """DS digitize with weights and kept rows."""
    rng = np.random.RandomState(8)
    edges = np.linspace(-4, 4, 601)
    data = rng.uniform(-4.5, 4.5, (4, 2048)).astype("f4")
    w = rng.rand(4, 2048).astype("f4")
    h, _ = histogram(data, bins=edges, axis=1, weights=w, method=method)
    exp = np.stack([
        np.histogram(np.asarray(r, "f8"), bins=edges,
                     weights=np.asarray(wr, "f8"))[0]
        for r, wr in zip(data, w)
    ])
    np.testing.assert_allclose(np.asarray(h), exp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["scatter", "sort"])
def test_uniform_65k_bins(method):
    """A 65,536-bin certified grid stays exact."""
    rng = np.random.RandomState(5)
    data = rng.uniform(0, 1, (1, 20000)).astype("f4")
    edges = np.linspace(0, 1, 65537)  # d = 2^-16: certified
    h, _ = histogram(data, bins=edges, method=method)
    exp = np.histogram(data.ravel().astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), exp)


@pytest.mark.parametrize(
    "form,n_hi_clip,on,want",
    [
        ((0.0, 1.0, 2.0), 0, True, True),    # arith certificate
        (("ds", 0.0), 0, True, True),        # DS certificate
        (None, 0, True, False),              # no certificate
        ((0.0, 1.0, 2.0), 1, True, False),   # top-value clip not modeled
        ((0.0, 1.0, 2.0), 0, False, False),  # switched off
        (("ds", 0.0), 0, False, False),      # switched off
    ],
)
def test_uniform_digitize_rule(form, n_hi_clip, on, want, monkeypatch):
    """The digitize consumes a certificate whenever one exists (it beats
    searchsorted at every measured edge count), unless the top-value clip
    needs the edge-compare form."""
    monkeypatch.setattr(dg, "UNIFORM_DIGITIZE", on)
    assert dg.uniform_wanted(form, n_hi_clip) is want


@pytest.mark.parametrize(
    "grid_a,grid_b",
    [
        ((-4.0, 4.0, 33), (-8.0, 8.0, 33)),      # arith, pow-2 spacings
        ((-50.0, 50.0, 101), (0.0, 100.0, 101)),  # arith, integer spacing
        ((-4.1, 4.1, 202), (-4.2, 4.2, 202)),     # DS, no exceptions
        ((0.0, 7.0, 401), (0.0, 7.5, 401)),       # DS, exceptions
        ((-33.0, 91.0, 1001), (-4.0, 4.0, 1001)),  # DS, exceptions
        ((-4.2, 4.2, 4097), (-4.0, 4.0, 4097)),   # DS (39 exceptions), arith
    ],
)
def test_uniform_operands_structure(grid_a, grid_b):
    """A certificate splits into a static structure and float32 values
    that hold every certified value exactly. Same-tier grids with equally
    many (power-of-two padded) exceptions share a structure, hence one
    compile; the padding entries change no bin."""
    forms = []
    for lo, hi, n in (grid_a, grid_b):
        e = np.linspace(lo, hi, n)
        T = np.asarray(bins_mod.compare_form(e, np.float32).edges)
        form = bins_mod.uniform_form(T, e)
        assert form is not None
        key, v = dg.uniform_operands(form)
        assert v.dtype == np.float32
        if key[0] == "ds":
            exc = form[-1]
            assert key[1] >= len(exc) and (key[1] & (key[1] - 1)) == 0
            head = [float(x) for x in form[1:10]]
            assert v[:9].astype(np.float64).tolist() == head
            t, f, st = v[9:].reshape(3, key[1])
            assert [(float(a), float(b), bool(c > 0)) for a, b, c in
                    zip(t, f, st)][: len(exc)] == list(exc)
            assert not st[len(exc):].any()
            assert (t[len(exc):] == f[len(exc):]).all()
        else:
            assert v.astype(np.float64).tolist()[:2] == list(form[:2])
        forms.append((key, form))
        vals = _boundary_values(e)
        np.testing.assert_array_equal(
            _bins_by_form(vals, e, "uniform_jit"), _np_bins(vals, e)
        )
    (ka, fa), (kb, fb) = forms
    if ka[0] == kb[0] == "arith" or (
        ka[0] == kb[0] == "ds" and len(fa[-1]) == len(fb[-1])
    ):
        assert ka == kb


def test_unconsumed_certificates_share_one_jit_trace(monkeypatch):
    """Uniform certificate values are traced operands of the pipeline: N
    same-shaped calls over different grids share ONE trace, whether the
    digitize consumes the certificates (default) or compares edges."""
    from xhistogram_tpu import core as core_mod

    rng = np.random.RandomState(21)
    data = rng.randn(4, 512).astype("f4")

    for on in (True, False):
        monkeypatch.setattr(dg, "UNIFORM_DIGITIZE", on)
        before = core_mod._histogram_impl._cache_size()
        for hw in (4.0, 8.0, 16.0):
            edges = np.linspace(-hw, hw, 33)  # pow-2 spacings: arith tier
            h, _ = histogram(data, bins=edges)
            exp = np.histogram(data.ravel().astype("f8"), bins=edges)[0]
            np.testing.assert_array_equal(np.asarray(h), exp)
        assert core_mod._histogram_impl._cache_size() - before == 1

        before = core_mod._histogram_impl._cache_size()
        for hw in (4.2, 4.3):
            edges = np.linspace(-hw, hw, 201)  # DS tier
            h, _ = histogram(data, bins=edges)
            exp = np.histogram(data.ravel().astype("f8"), bins=edges)[0]
            np.testing.assert_array_equal(np.asarray(h), exp)
        assert core_mod._histogram_impl._cache_size() - before == 1

    # bins=int: edges from each call's data range, one compile for all
    monkeypatch.setattr(dg, "UNIFORM_DIGITIZE", True)
    before = core_mod._histogram_impl._cache_size()
    for scale in (1.0, 2.5, 0.3, 7.0):
        x = (rng.randn(4, 512) * scale).astype("f4")
        h, e = histogram(x, bins=64)
        exp = np.histogram(x.ravel().astype("f8"), bins=e[0])[0]
        np.testing.assert_array_equal(np.asarray(h), exp)
    assert core_mod._histogram_impl._cache_size() - before == 1


@pytest.mark.slow
def test_huge_certified_grid_skips_edge_column():
    """A 2^20-bin integer-spaced certified grid stays bit-exact."""
    nb = 1 << 20
    edges = np.arange(nb + 1, dtype=np.float64) - (nb // 2)
    rng = np.random.RandomState(22)
    data = rng.randint(-(nb // 2) - 50, nb // 2 + 50, (1, 4096)).astype(
        np.int32
    )
    from xhistogram_tpu import bins as bins_mod

    T = np.asarray(bins_mod.compare_form(edges, np.int32).edges)
    form = bins_mod.uniform_form(T, edges)
    assert form is not None
    h, _ = histogram(data, bins=edges)
    exp = np.histogram(data.ravel().astype("f8"), bins=edges)[0]
    np.testing.assert_array_equal(np.asarray(h), exp)


class TestXlaUniformDigitize:
    """The pipeline consumes uniform certificates with the O(1) digitize
    (pinned on here via the module switch); parity must be bit-exact."""

    @staticmethod
    def _force(monkeypatch):
        monkeypatch.setattr(dg, "UNIFORM_DIGITIZE", True)

    @pytest.mark.parametrize(
        "edges",
        [
            np.linspace(-8.0, 8.0, 257),  # pow-2 spacing: arith tier
            np.linspace(-4.0, 4.0, 202),  # generic linspace: DS tier
            np.arange(-300.0, 301.0),  # integer-width: arith tier
        ],
    )
    def test_scatter_route_bit_exact(self, monkeypatch, edges):
        self._force(monkeypatch)
        rng = np.random.RandomState(40)
        lo, hi = edges[0], edges[-1]
        data = rng.uniform(lo - 1, hi + 1, (3, 4000)).astype("f4")
        data.ravel()[:4] = [np.nan, np.inf, -np.inf, lo]
        data.ravel()[4:104] = rng.choice(edges, 100).astype("f4")
        h, _ = histogram(data, bins=edges, axis=1, method="scatter")
        exp = np.stack(
            [np.histogram(r.astype("f8"), bins=edges)[0] for r in data]
        )
        np.testing.assert_array_equal(np.asarray(h), exp)

    def test_int_data_integer_grid(self, monkeypatch):
        self._force(monkeypatch)
        rng = np.random.RandomState(41)
        edges = np.arange(-500, 501, 2, dtype=np.float64)
        data = rng.randint(-520, 520, (2, 3000)).astype(np.int32)
        h, _ = histogram(data, bins=edges, method="scatter")
        exp = np.histogram(data.ravel().astype("f8"), bins=edges)[0]
        np.testing.assert_array_equal(np.asarray(h), exp)

    def test_static_key_keeps_consumed_values(self, monkeypatch):
        """With the pipeline consuming certificates, each call must read
        its own grid's values (a stale or placeholder value would mis-bin)
        while calls over different grids of one structure share one
        compile."""
        self._force(monkeypatch)
        from xhistogram_tpu import core as core_mod

        rng = np.random.RandomState(42)
        data = rng.randn(2, 1000).astype("f4")
        before = core_mod._histogram_impl._cache_size()
        for hw in (4.1, 4.2, 4.2):
            edges = np.linspace(-hw, hw, 202)
            h, _ = histogram(data, bins=edges, method="scatter")
            exp = np.histogram(data.ravel().astype("f8"), bins=edges)[0]
            np.testing.assert_array_equal(np.asarray(h), exp)
        assert core_mod._histogram_impl._cache_size() - before == 1

    def test_weighted_joint_mixed_certificates(self, monkeypatch):
        """Joint call where one input is certified and the other is not:
        per-input consumption, weighted sums allclose + count placement
        exact."""
        self._force(monkeypatch)
        rng = np.random.RandomState(43)
        ea = np.linspace(-4.0, 4.0, 91)  # DS-certified
        eb = np.sort(rng.uniform(-4, 4, 41))  # irregular: compare path
        a = rng.randn(1, 5000).astype("f4")
        b = rng.randn(1, 5000).astype("f4")
        w = rng.rand(1, 5000).astype("f4")
        h, _ = histogram(a, b, bins=[ea, eb], weights=w, method="scatter")
        exp = np.histogram2d(
            a.ravel().astype("f8"), b.ravel().astype("f8"),
            bins=[ea, eb], weights=w.ravel().astype("f8"),
        )[0]
        np.testing.assert_allclose(np.asarray(h), exp, rtol=1e-4)
        hu, _ = histogram(a, b, bins=[ea, eb], method="scatter")
        expu = np.histogram2d(
            a.ravel().astype("f8"), b.ravel().astype("f8"), bins=[ea, eb]
        )[0]
        np.testing.assert_array_equal(np.asarray(hu), expu)
