"""Direct unit coverage of the XLA bincount strategies' memory-bounding
paths (ops/bincount.py) — the regimes too large to exercise through
core.histogram at real size:

- the sort strategy's scanned chunk-row split (huge reductions at huge
  n_slots: an unscanned batch at 2^24 slots x 256 chunk rows of bucket
  positions would take ~17 GB);
- the scatter strategy's 2-D index fallback where the fused row offset
  ``g + n_slots*row`` would overflow int32 (m x n_slots >= 2**31).

Both knobs (_SORT_POS_BUDGET / _SCATTER_FLAT_LIMIT) are lowered so the
big-shape code paths run at test size, oracle-checked vs np.bincount.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from xhistogram_tpu.ops import bincount as bc

CHUNK = 1 << 20


@pytest.fixture
def small_sort_budget(monkeypatch):
    # rows_per_step = 4096 // (n_slots + 1) -> multiple scan steps at the
    # test's n_slots, exercising the scanned accumulation
    monkeypatch.setattr(bc, "_SORT_POS_BUDGET", 4096)


def _split_case(n_slots=1000, c=3 * CHUNK + 12345, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randint(0, n_slots, (1, c)).astype(np.int32)
    w = rng.rand(1, c).astype(np.float32)
    return g, w


def test_sort_scanned_split_unweighted(small_sort_budget):
    g, _ = _split_case()
    out = np.asarray(bc.bincount2d_sort(jnp.asarray(g), None, 1000))
    exp = np.bincount(g.ravel(), minlength=1000)[None]
    np.testing.assert_array_equal(out, exp)


def test_sort_scanned_split_weighted(small_sort_budget):
    g, w = _split_case()
    out = np.asarray(bc.bincount2d_sort(jnp.asarray(g), jnp.asarray(w), 1000))
    exp = np.bincount(
        g.ravel(), weights=w.ravel().astype("f8"), minlength=1000
    )[None]
    np.testing.assert_allclose(out, exp, rtol=1e-4)


def test_sort_scanned_split_matches_unscanned(small_sort_budget):
    """Scanned and batched splits accumulate in the same per-chunk order,
    so weighted sums must be BIT-identical, not just close."""
    g, w = _split_case(seed=3)
    scanned = np.asarray(
        bc.bincount2d_sort(jnp.asarray(g), jnp.asarray(w), 1000)
    )
    # restore the default budget -> single batched step
    bc_budget = bc._SORT_POS_BUDGET
    try:
        bc._SORT_POS_BUDGET = 1 << 24
        batched = np.asarray(
            bc.bincount2d_sort(jnp.asarray(g), jnp.asarray(w), 1000)
        )
    finally:
        bc._SORT_POS_BUDGET = bc_budget
    np.testing.assert_array_equal(scanned, batched)


def test_sort_scanned_split_nonfinite_faithful(small_sort_budget):
    """NaN/inf weights resolved inside each scan step stay faithful across
    the cross-step sum (inf + finite = inf, NaN propagates)."""
    g, w = _split_case(seed=1)
    w[0, 7] = np.nan
    w[0, 123456] = np.inf
    w[0, CHUNK + 5] = np.inf  # second chunk row: crosses a scan step
    out = np.asarray(
        bc.bincount2d_sort(jnp.asarray(g), jnp.asarray(w), 1000)
    )[0]
    exp = np.bincount(
        g.ravel(), weights=w.ravel().astype("f8"), minlength=1000
    )
    fin = np.isfinite(exp)
    np.testing.assert_allclose(out[fin], exp[fin], rtol=1e-4)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(exp))
    np.testing.assert_array_equal(np.isposinf(out), np.isposinf(exp))


def test_sort_split_trash_pad_correction(small_sort_budget):
    """The trash-slot padding subtraction stays exact when the scanned
    split pads more rows than the plain ceil-to-chunk split would."""
    n_slots = 513
    c = 2 * CHUNK + 777  # k=3 chunk rows; scanned k_pad may exceed 3
    rng = np.random.RandomState(2)
    g = rng.randint(0, n_slots, (1, c)).astype(np.int32)
    out = np.asarray(bc.bincount2d_sort(jnp.asarray(g), None, n_slots))
    exp = np.bincount(g.ravel(), minlength=n_slots)[None]
    np.testing.assert_array_equal(out, exp)


def test_scatter_2d_index_fallback(monkeypatch):
    """m x n_slots over the flat-offset limit switches to 2-D scatter
    indices; counts and weighted sums match the flat path exactly."""
    monkeypatch.setattr(bc, "_SCATTER_FLAT_LIMIT", 1)  # force the 2-D path
    rng = np.random.RandomState(4)
    m, n_slots, c = 5, 37, 301
    g = rng.randint(0, n_slots, (m, c)).astype(np.int32)
    w = rng.rand(m, c).astype(np.float32)
    out = np.asarray(bc.bincount2d_scatter(jnp.asarray(g), None, n_slots))
    exp = np.stack([np.bincount(r, minlength=n_slots) for r in g])
    np.testing.assert_array_equal(out, exp)
    outw = np.asarray(
        bc.bincount2d_scatter(jnp.asarray(g), jnp.asarray(w), n_slots)
    )
    expw = np.stack(
        [
            np.bincount(r, weights=wr.astype("f8"), minlength=n_slots)
            for r, wr in zip(g, w)
        ]
    )
    np.testing.assert_allclose(outw, expw, rtol=1e-5)


def test_scatter_nonfinite_weights_inherently_faithful():
    """Scatter-add IS the reference semantics: a NaN/inf weight lands in
    its own slot only, no sanitize/resolve machinery involved."""
    g = jnp.asarray([[0, 1, 2, 1, 0]], jnp.int32)
    w = jnp.asarray([[1.0, np.nan, np.inf, 2.0, 3.0]], jnp.float32)
    out = np.asarray(bc.bincount2d_scatter(g, w, 4))[0]
    assert out[0] == 4.0
    assert np.isnan(out[1])
    assert np.isposinf(out[2])
    assert out[3] == 0.0


class TestEdgeDigitize:
    """The edge-compare digitize (ops/digitize.py::digitize_edges) must
    give numpy's searchsorted-right index on comparison-form edges,
    including NaN/inf, signed zeros, subnormals and the top-value clip."""

    def _both(self, a, edges, **kw):
        from xhistogram_tpu.ops import digitize as dg

        got = np.asarray(dg.digitize_edges(jnp.asarray(a),
                                           jnp.asarray(edges), **kw))
        ref = np.searchsorted(edges, a, side="right")
        if np.issubdtype(a.dtype, np.floating):
            ref[np.isnan(a)] = len(edges)
        else:
            ref = ref - kw.get("n_hi_clip", 0) * (a == np.iinfo(a.dtype).max)
        np.testing.assert_array_equal(got, ref)
        return got

    def test_float_tricky_values(self):
        edges = np.array([-np.inf, -1.0, -2e-38, 0.0, 2e-38, 1.0, np.inf],
                         np.float32)
        a = np.array(
            [np.nan, -np.inf, np.inf, -0.0, 0.0, -1e-39, 1e-39, -2e-38,
             2e-38, -1.0, 1.0,
             np.nextafter(np.float32(1.0), np.float32(0)),
             np.nextafter(np.float32(-1.0), np.float32(0))],
            np.float32,
        )
        self._both(a.reshape(1, -1), edges)

    def test_integer_edges_and_top_value(self):
        edges = np.array([-100, -3, 0, 7, 127], np.int32)
        a = np.array([[-128, -100, -99, -3, -1, 0, 6, 7, 126, 127,
                       np.iinfo(np.int32).max]], np.int32)
        self._both(a, edges, n_hi_clip=1)

    def test_random_with_exact_edge_hits(self):
        """Fuzz against numpy on a large random draw including exact-edge
        hits."""
        rng = np.random.RandomState(7)
        edges = np.sort(rng.randn(129)).astype(np.float32)
        a = rng.randn(3, 5000).astype(np.float32)
        a.ravel()[rng.choice(a.size, 500, replace=False)] = rng.choice(
            edges, 500
        )  # exact threshold hits
        a.ravel()[:3] = [np.nan, np.inf, -np.inf]
        self._both(a, edges)

    def test_full_pipeline_parity(self, monkeypatch):
        """End-to-end: histogram() with the uniform digitize switched off
        (every input compares edges) matches numpy bit-exactly."""
        from xhistogram_tpu.ops import digitize as dg

        monkeypatch.setattr(dg, "UNIFORM_DIGITIZE", False)
        from xhistogram_tpu import histogram

        rng = np.random.RandomState(8)
        data = rng.randn(4, 3000).astype("f4")
        edges = np.linspace(-4, 4, 100)
        h, _ = histogram(data, bins=edges, axis=1, method="scatter")
        exp = np.stack(
            [np.histogram(r.astype("f8"), bins=edges)[0] for r in data]
        )
        np.testing.assert_array_equal(np.asarray(h), exp)
