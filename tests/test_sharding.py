"""Multi-device tests on an 8-device virtual CPU mesh.

The replacement for the reference's chunking suites
(the reference's test/test_chunking.py and
test_chunking_hypotheses.py): instead of dask chunk grids, data is laid out
over a ``jax.sharding.Mesh``; partial per-device histograms must combine (via
psum inside shard_map, or GSPMD-inserted collectives) to the bit-exact
unsharded numpy oracle for *all* layouts.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from xhistogram_tpu.core import histogram
from xhistogram_tpu.parallel import histogram_sharded, reduce_spec

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def mesh2d():
    return Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))


def test_reduce_spec():
    out, psum = reduce_spec(P("x", "y"), axis=(1,), ndim=2)
    assert out == P("x") and psum == ("y",)
    out, psum = reduce_spec(P("x", "y"), axis=None, ndim=2)
    assert out == P() and psum == ("x", "y")
    out, psum = reduce_spec(P(None, "y"), axis=(0,), ndim=3)
    assert out == P("y", None) and psum == ()


@pytest.mark.parametrize("axis", [None, (1,), (0,), (0, 1)])
def test_sharded_matches_numpy_1input(axis):
    rng = np.random.RandomState(0)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()

    h, _ = histogram_sharded(
        data, mesh=mesh, in_spec=P("x", "y"), bins=bins, axis=axis
    )
    h = np.asarray(h)

    h_ref, _ = histogram(data, bins=bins, axis=axis)
    np.testing.assert_array_equal(h, np.asarray(h_ref))

    # oracle
    if axis is None or set(axis) == {0, 1}:
        np.testing.assert_array_equal(h, np.histogram(data, bins=bins)[0])
    elif axis == (1,):
        expected = np.stack([np.histogram(r, bins=bins)[0] for r in data])
        np.testing.assert_array_equal(h, expected)


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_joint_2d(weighted):
    rng = np.random.RandomState(1)
    data_a = rng.randn(8, 16).astype("f4")
    data_b = rng.randn(8, 16).astype("f4")
    w = rng.rand(8, 16).astype("f4") if weighted else None
    bins_a = np.linspace(-4, 4, 9)
    bins_b = np.linspace(-4, 4, 11)
    mesh = mesh2d()

    h, _ = histogram_sharded(
        data_a, data_b, mesh=mesh, in_spec=P("x", "y"),
        bins=[bins_a, bins_b], weights=w,
    )
    expected, _, _ = np.histogram2d(
        data_a.ravel(), data_b.ravel(), bins=[bins_a, bins_b],
        weights=None if w is None else w.ravel(),
    )
    if weighted:
        np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5)
    else:
        np.testing.assert_array_equal(np.asarray(h), expected)


def test_sharded_density():
    rng = np.random.RandomState(2)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    h, _ = histogram_sharded(
        data, mesh=mesh, in_spec=P("x", "y"), bins=bins, density=True
    )
    expected = np.histogram(data, bins=bins, density=True)[0]
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5)


def test_sharded_kept_axis_output_sharding():
    """Kept axes stay sharded: the output must carry the kept-axis mesh dim."""
    rng = np.random.RandomState(3)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    h, _ = histogram_sharded(
        data, mesh=mesh, in_spec=P("x", "y"), bins=bins, axis=(1,)
    )
    assert h.shape == (8, 9)
    spec = h.sharding.spec
    assert spec[0] == "x"
    expected = np.stack([np.histogram(r, bins=bins)[0] for r in data])
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_gspmd_implicit_sharding():
    """The implicit path: jit over sharded inputs, XLA inserts collectives —
    result equals the unsharded oracle."""
    rng = np.random.RandomState(4)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    sharded = jax.device_put(data, NamedSharding(mesh, P("x", "y")))
    h, _ = histogram(sharded, bins=bins)
    np.testing.assert_array_equal(
        np.asarray(h), np.histogram(data, bins=bins)[0]
    )


@pytest.mark.parametrize("layout", [P("x", None), P(None, "y"), P(("x", "y"), None)])
def test_all_sharding_layouts_1d(layout):
    """Every mesh layout must reproduce the numpy oracle (the analog of the
    reference's hypothesis-over-chunkings suite)."""
    rng = np.random.RandomState(5)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 9)
    mesh = mesh2d()
    h, _ = histogram_sharded(data, mesh=mesh, in_spec=layout, bins=bins)
    np.testing.assert_array_equal(np.asarray(h), np.histogram(data, bins=bins)[0])


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort", "auto"])
def test_sharded_every_method(method):
    """The full multi-device composition: each counting strategy per device
    inside shard_map + psum."""
    rng = np.random.RandomState(6)
    T = rng.randn(8, 512).astype("f4")
    S = rng.randn(8, 512).astype("f4")
    ba = np.linspace(-4, 4, 29)
    bb = np.linspace(-4, 4, 37)
    mesh = mesh2d()
    h, _ = histogram_sharded(
        T, S, mesh=mesh, in_spec=P("x", "y"), bins=[ba, bb], method=method
    )
    expected = np.histogram2d(T.ravel(), S.ravel(), bins=[ba, bb])[0]
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_sharded_kept_rows_large_grid_per_row_factored():
    """Kept rows + a 9,600-slot joint grid inside shard_map; psum over the
    reduced mesh axis must still be bit-exact."""
    rng = np.random.RandomState(7)
    a = rng.randn(8, 1024).astype("f4")
    b = rng.randn(8, 1024).astype("f4")
    bins_a = np.linspace(-4, 4, 121)   # 120 x 80 = 9600 slots
    bins_b = np.linspace(-4, 4, 81)
    mesh = mesh2d()
    h, _ = histogram_sharded(
        a, b, mesh=mesh, in_spec=P("x", "y"), bins=[bins_a, bins_b], axis=1
    )
    h = np.asarray(h)
    assert h.shape == (8, 120, 80)
    for r in range(8):
        expected, _, _ = np.histogram2d(a[r], b[r], bins=[bins_a, bins_b])
        np.testing.assert_array_equal(h[r], expected)


def test_sharded_nonfinite_weights_survive_psum():
    """A NaN-weight bin must stay NaN (and only that bin) after the
    cross-device psum of partial histograms."""
    rng = np.random.RandomState(8)
    data = rng.uniform(-3.5, 3.5, (8, 64)).astype("f4")
    w = rng.rand(8, 64).astype("f4")
    data[3, 2], w[3, 2] = 0.1, np.nan
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    h, _ = histogram_sharded(
        data, mesh=mesh, in_spec=P("x", "y"), bins=bins, axis=1, weights=w
    )
    h = np.asarray(h)
    assert np.isnan(h[3]).sum() == 1
    assert np.isfinite(np.delete(h, 3, axis=0)).all()


def test_labeled_api_on_sharded_data_gspmd():
    """Realistic user flow: labeled histogram over device_put-sharded data;
    GSPMD inserts the collectives inside the jitted core pipeline and the
    labeled result still matches the unsharded numpy oracle."""
    from xhistogram_tpu.labeled import NamedArray, histogram as lhist

    rng = np.random.RandomState(11)
    T = rng.randn(8, 64).astype("f4")
    mesh = mesh2d()
    Ts = jax.device_put(T, NamedSharding(mesh, P("x", "y")))
    na = NamedArray(Ts, dims=("depth", "cell"), name="T",
                    coords={"depth": np.arange(8.0)})
    bins = np.linspace(-4, 4, 10)
    out = lhist(na, bins=bins, dim=["cell"])
    assert out.dims == ("depth", "T_bin")
    expected = np.stack([np.histogram(r, bins=bins)[0] for r in T])
    np.testing.assert_array_equal(np.asarray(out.data), expected)


# --------------------------------------------------------------------------
# mismatched input shardings under the implicit GSPMD path (r3, VERDICT #6):
# the reference rechunks unaligned dask chunks onto a common grid
# (reference test_chunking.py:104-146); the JAX analog is XLA resharding
# the operands onto one sharding on-device. SURVEY §5 claims the
# equivalence — these tests exercise it.


def test_gspmd_mismatched_data_weights_shardings():
    rng = np.random.RandomState(20)
    data = rng.randn(8, 16).astype("f4")
    w = rng.rand(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    d_sh = jax.device_put(data, NamedSharding(mesh, P("x", "y")))
    w_sh = jax.device_put(w, NamedSharding(mesh, P()))  # fully replicated
    h, _ = histogram(d_sh, bins=bins, weights=w_sh)
    expected = np.histogram(data.astype("f8"), bins=bins,
                            weights=w.astype("f8"))[0]
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5)


def test_gspmd_mismatched_weights_partial_layout():
    rng = np.random.RandomState(21)
    data = rng.randn(8, 16).astype("f4")
    w = rng.rand(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    d_sh = jax.device_put(data, NamedSharding(mesh, P("x", "y")))
    w_sh = jax.device_put(w, NamedSharding(mesh, P(None, "y")))
    h, _ = histogram(d_sh, bins=bins, weights=w_sh, axis=1)
    expected = np.stack([
        np.histogram(r.astype("f8"), bins=bins, weights=ww.astype("f8"))[0]
        for r, ww in zip(data, w)
    ])
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5)


def test_gspmd_mismatched_joint_inputs():
    rng = np.random.RandomState(22)
    a = rng.randn(8, 16).astype("f4")
    b = rng.randn(8, 16).astype("f4")
    ea = np.linspace(-3, 3, 7)
    eb = np.linspace(-3, 3, 5)
    mesh = mesh2d()
    a_sh = jax.device_put(a, NamedSharding(mesh, P("x", "y")))
    b_sh = jax.device_put(b, NamedSharding(mesh, P("y", None)))
    h, _ = histogram(a_sh, b_sh, bins=[ea, eb])
    expected, _, _ = np.histogram2d(a.ravel(), b.ravel(), bins=[ea, eb])
    np.testing.assert_array_equal(np.asarray(h), expected.astype("i4"))


def test_gspmd_mismatch_resharded_on_device():
    """The compiled program must stay distributed (collectives in the HLO:
    XLA reshards the operands on-device) rather than degenerating to a
    single-device gather."""
    rng = np.random.RandomState(23)
    data = rng.randn(8, 16).astype("f4")
    w = rng.rand(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    d_sh = jax.device_put(data, NamedSharding(mesh, P("x", "y")))
    w_sh = jax.device_put(w, NamedSharding(mesh, P(None, "y")))

    f = jax.jit(lambda a, ww: histogram(a, bins=bins, weights=ww)[0])
    text = f.lower(d_sh, w_sh).compile().as_text()
    assert any(
        coll in text
        for coll in ("all-reduce", "all-gather", "collective-permute",
                     "reduce-scatter")
    ), "expected on-device collectives (resharding), found none in the HLO"
    h = f(d_sh, w_sh)
    expected = np.histogram(data.astype("f8"), bins=bins,
                            weights=w.astype("f8"))[0]
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5)


def test_sharded_uniform_certified_bins():
    """The uniform-digitize certificate flows through histogram_sharded's
    static args into the shard_map'd digitize: certified many-bin grids
    must stay exact across the mesh."""
    rng = np.random.RandomState(30)
    data = rng.rand(8, 4096).astype("f4")
    edges = np.linspace(0, 1, 4097)  # d = 2^-12: certified
    mesh = mesh2d()
    h, _ = histogram_sharded(
        data, mesh=mesh, in_spec=P("x", "y"), bins=edges
    )
    np.testing.assert_array_equal(
        np.asarray(h), np.histogram(data.astype("f8"), bins=edges)[0]
    )
    # kept axis sharded + reduced axis psum, uniform certified
    h, _ = histogram_sharded(
        data, mesh=mesh, in_spec=P("x", "y"), bins=edges, axis=(1,),
        method="onehot",
    )
    exp = np.stack(
        [np.histogram(r.astype("f8"), bins=edges)[0] for r in data]
    )
    np.testing.assert_array_equal(np.asarray(h), exp)


def test_sharded_unconsumed_certificates_share_one_trace(monkeypatch):
    """Certificate values are traced operands in histogram_sharded too:
    same-shaped calls over different certified grids share ONE
    _sharded_impl trace, with the uniform digitize on or off."""
    from xhistogram_tpu.ops import digitize as dg
    from xhistogram_tpu.parallel.sharded import _sharded_impl

    rng = np.random.RandomState(31)
    data = rng.randn(8, 256).astype("f4")
    mesh = mesh2d()
    for on in (True, False):
        monkeypatch.setattr(dg, "UNIFORM_DIGITIZE", on)
        before = _sharded_impl._cache_size()
        for hw in (4.0, 8.0, 16.0):
            edges = np.linspace(-hw, hw, 33)  # pow-2 spacings: certified
            h, _ = histogram_sharded(
                data, mesh=mesh, in_spec=P("x", "y"), bins=edges,
            )
            np.testing.assert_array_equal(
                np.asarray(h), np.histogram(data.astype("f8"), bins=edges)[0]
            )
        assert _sharded_impl._cache_size() - before == 1


def test_sharded_above_cap_scatter_route():
    """A 532k-slot weighted joint grid: the per-device partials + psum must
    match the numpy oracle."""
    rng = np.random.RandomState(33)
    a = rng.randn(8, 1024).astype("f4")
    b = rng.randn(8, 1024).astype("f4")
    w = rng.rand(8, 1024).astype("f4")
    ea = np.linspace(-4, 4, 1025)
    eb = np.linspace(-4, 4, 521)
    mesh = mesh2d()
    h, _ = histogram_sharded(
        a, b, mesh=mesh, in_spec=P("x", "y"), bins=[ea, eb], weights=w
    )
    exp = np.histogram2d(
        a.ravel().astype("f8"), b.ravel().astype("f8"),
        bins=[ea, eb], weights=w.ravel().astype("f8"),
    )[0]
    np.testing.assert_allclose(np.asarray(h), exp, rtol=1e-4)


@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_sharded_precision_kwarg(method):
    """Weighted sums through shard_map: a one-element-per-bin layout (each
    device holds a kept-rows slice) is bit-exact per weight."""
    edges = np.linspace(-4, 4, 257)
    centers = (0.5 * (edges[:-1] + edges[1:])).astype("f4")
    data = np.tile(centers, (8, 1))
    rng = np.random.RandomState(9)
    w = rng.uniform(0.5, 2.0, size=data.shape).astype("f4")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("r",))

    h, _ = histogram_sharded(
        data, mesh=mesh, in_spec=P("r", None), bins=edges, axis=(1,),
        weights=w, method=method,
    )
    np.testing.assert_array_equal(np.asarray(h), w)


class TestShardedWideCounts:
    """Sharded mirror of the core int64 wide-count contract (reference
    core.py:363): global reductions >= core._WIDE_LIMIT return exact numpy
    int64 via psum-overflow-proof uint32-pair halves (ADVICE r2 #1 asked
    for a guard 'until a sharded wide-count path exists' — this is that
    path). Tests lower _WIDE_LIMIT/_PAIR_BITS like tests/test_wide_counts."""

    def _mesh(self, n=8):
        return Mesh(np.array(jax.devices()[:n]).reshape(n), ("r",))

    def test_global_wide_local_narrow(self, monkeypatch):
        import xhistogram_tpu.core as core_mod

        monkeypatch.setattr(core_mod, "_WIDE_LIMIT", 1 << 12)
        rng = np.random.RandomState(4)
        data = rng.randn(8, 1024).astype("f4")  # global 8192 >= 2**12;
        bins = np.linspace(-3, 3, 9)            # local 1024 stays int32
        h, _ = histogram_sharded(
            data, mesh=self._mesh(), in_spec=P("r", None), bins=bins,
            axis=None,
        )
        assert isinstance(h, np.ndarray) and h.dtype == np.int64
        np.testing.assert_array_equal(
            h, np.histogram(data.astype("f8"), bins=bins)[0]
        )

    def test_local_wide_chunked_under_shard_map(self, monkeypatch):
        import xhistogram_tpu.core as core_mod

        monkeypatch.setattr(core_mod, "_WIDE_LIMIT", 1 << 10)
        rng = np.random.RandomState(5)
        data = rng.randn(8, 3000).astype("f4")  # local 3000 >= 2**10:
        bins = np.linspace(-3, 3, 7)            # per-shard chunked pairs
        h, _ = histogram_sharded(
            data, mesh=self._mesh(), in_spec=P("r", None), bins=bins,
            axis=None,
        )
        assert h.dtype == np.int64
        np.testing.assert_array_equal(
            h, np.histogram(data.astype("f8"), bins=bins)[0]
        )

    def test_carry_and_halves_observable(self, monkeypatch):
        """pair_bits=8 makes lo wrap at 256 per shard (hi != 0) and makes
        the 4-bit psum halves carry — the whole recombine chain is
        observable at test sizes."""
        import xhistogram_tpu.core as core_mod

        monkeypatch.setattr(core_mod, "_WIDE_LIMIT", 1 << 8)
        monkeypatch.setattr(core_mod, "_PAIR_BITS", 8)
        data = np.zeros((8, 500), np.float32)  # all in one bin
        bins = np.array([-1.0, 1.0])
        h, _ = histogram_sharded(
            data, mesh=self._mesh(), in_spec=P("r", None), bins=bins,
            axis=None,
        )
        assert h.dtype == np.int64 and int(h[0]) == 8 * 500

    def test_kept_axis_wide_and_density(self, monkeypatch):
        import xhistogram_tpu.core as core_mod

        monkeypatch.setattr(core_mod, "_WIDE_LIMIT", 1 << 11)
        rng = np.random.RandomState(6)
        data = rng.randn(8, 2048).astype("f4")  # reduced 2048 >= 2**11
        bins = np.linspace(-3, 3, 9)
        h, _ = histogram_sharded(
            data, mesh=self._mesh(), in_spec=P("r", None), bins=bins,
            axis=(1,),
        )
        assert h.dtype == np.int64
        expected = np.stack(
            [np.histogram(r.astype("f8"), bins=bins)[0] for r in data]
        )
        np.testing.assert_array_equal(h, expected)
        hd, _ = histogram_sharded(
            data, mesh=self._mesh(), in_spec=P("r", None), bins=bins,
            axis=(1,), density=True,
        )
        expd = np.stack(
            [np.histogram(r.astype("f8"), bins=bins, density=True)[0]
             for r in data]
        )
        np.testing.assert_allclose(hd, expd, rtol=1e-12)

    def test_wide_traced_caller_raises(self, monkeypatch):
        import xhistogram_tpu.core as core_mod

        monkeypatch.setattr(core_mod, "_WIDE_LIMIT", 1 << 12)
        mesh = self._mesh()
        bins = np.linspace(-3, 3, 9)

        def call(x):
            return histogram_sharded(
                x, mesh=mesh, in_spec=P("r", None), bins=bins, axis=None
            )[0]

        big = jax.ShapeDtypeStruct((8, 1024), np.float32)
        with pytest.raises(ValueError, match="traced"):
            jax.eval_shape(call, big)


# ---------------------------------------------------------------------------
# broadcast parity (VERDICT r3 #8): histogram_sharded accepts broadcastable
# inputs AND weights, like the reference (core.py:366) and core.histogram


def test_sharded_broadcast_lower_rank_input():
    rng = np.random.RandomState(41)
    a = rng.randn(8, 16).astype("f4")
    b = rng.randn(16).astype("f4")  # broadcasts along the sharded rows
    bins_a = np.linspace(-4, 4, 9)
    bins_b = np.linspace(-4, 4, 7)
    mesh = mesh2d()
    h, _ = histogram_sharded(
        a, b, mesh=mesh, in_spec=P("x", "y"), bins=[bins_a, bins_b]
    )
    bb = np.broadcast_to(b, a.shape)
    expected, _, _ = np.histogram2d(
        a.ravel(), bb.ravel(), bins=[bins_a, bins_b]
    )
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_sharded_broadcast_length1_axis_weights():
    rng = np.random.RandomState(42)
    a = rng.randn(8, 16).astype("f4")
    w = rng.rand(8, 1).astype("f4")  # per-row weight, length-1 reduce axis
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    h, _ = histogram_sharded(
        a, mesh=mesh, in_spec=P("x", "y"), bins=bins, weights=w, axis=(1,)
    )
    wb = np.broadcast_to(w, a.shape)
    expected = np.stack(
        [np.histogram(r, bins=bins, weights=ww)[0] for r, ww in zip(a, wb)]
    )
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-5, atol=1e-6)


def test_sharded_broadcast_scalar_like_weights_kept_axis():
    # weights with FEWER dims than the data, kept axis sharded
    rng = np.random.RandomState(43)
    a = rng.randn(8, 16).astype("f4")
    w = np.float32(2.0) * np.ones((16,), "f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    h, _ = histogram_sharded(
        a, mesh=mesh, in_spec=P("x", "y"), bins=bins, weights=w, axis=(1,)
    )
    expected = 2.0 * np.stack(
        [np.histogram(r, bins=bins)[0] for r in a]
    )
    np.testing.assert_allclose(np.asarray(h), expected, rtol=1e-6)


# ---------------------------------------------------------------------------
# implicit-path delegation: eager calls on mesh-sharded arrays take the
# shard_map path (one per-device count + one psum, independent of the
# partitioner's choices)


def test_eager_sharded_call_delegates_to_shard_map(monkeypatch):
    import xhistogram_tpu.parallel as par

    calls = {}
    orig = par.histogram_sharded

    def spy(*a, **k):
        calls["mesh"] = k.get("mesh")
        calls["in_spec"] = k.get("in_spec")
        return orig(*a, **k)

    monkeypatch.setattr(par, "histogram_sharded", spy)
    rng = np.random.RandomState(50)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    sharded = jax.device_put(data, NamedSharding(mesh, P("x", "y")))
    h, _ = histogram(sharded, bins=bins)
    assert calls and calls["in_spec"] == P("x", "y")
    np.testing.assert_array_equal(
        np.asarray(h), np.histogram(data, bins=bins)[0]
    )


def test_eager_sharded_kept_axis_output_stays_sharded():
    rng = np.random.RandomState(51)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    sharded = jax.device_put(data, NamedSharding(mesh, P("x", "y")))
    h, _ = histogram(sharded, bins=bins, axis=(1,))
    # shard_map's out_spec keeps the kept axis sharded over "x"
    assert h.sharding.spec[0] == "x"
    expected = np.stack([np.histogram(r, bins=bins)[0] for r in data])
    np.testing.assert_array_equal(np.asarray(h), expected)


def test_replicated_and_single_device_arrays_do_not_delegate(monkeypatch):
    import xhistogram_tpu.parallel as par

    def boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("must not delegate")

    monkeypatch.setattr(par, "histogram_sharded", boom)
    rng = np.random.RandomState(52)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    repl = jax.device_put(data, NamedSharding(mesh, P(None, None)))
    h, _ = histogram(repl, bins=bins)
    np.testing.assert_array_equal(
        np.asarray(h), np.histogram(data, bins=bins)[0]
    )
    h2, _ = histogram(jnp.asarray(data), bins=bins)
    np.testing.assert_array_equal(
        np.asarray(h2), np.histogram(data, bins=bins)[0]
    )


def test_traced_sharded_caller_keeps_gspmd(monkeypatch):
    """Inside a USER jit the inputs are tracers: no delegation — the XLA
    strategies partition via GSPMD (parity pinned here)."""
    import xhistogram_tpu.parallel as par

    def boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("traced callers must not delegate")

    monkeypatch.setattr(par, "histogram_sharded", boom)
    rng = np.random.RandomState(53)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    sharded = jax.device_put(data, NamedSharding(mesh, P("x", "y")))
    f = jax.jit(lambda a: histogram(a, bins=bins)[0])
    h = f(sharded)
    np.testing.assert_array_equal(
        np.asarray(h), np.histogram(data, bins=bins)[0]
    )


def test_eager_sharded_delegation_composes_with_wide_counts(monkeypatch):
    """Sharded eager arrays + the int64 wide-count contract: delegation
    lands on histogram_sharded's psum-safe pair path."""
    import xhistogram_tpu.core as core_mod

    monkeypatch.setattr(core_mod, "_WIDE_LIMIT", 64)
    rng = np.random.RandomState(54)
    data = rng.randn(8, 16).astype("f4")
    bins = np.linspace(-4, 4, 10)
    mesh = mesh2d()
    sharded = jax.device_put(data, NamedSharding(mesh, P("x", "y")))
    h, _ = histogram(sharded, bins=bins)
    assert h.dtype == np.int64
    np.testing.assert_array_equal(h, np.histogram(data, bins=bins)[0])
