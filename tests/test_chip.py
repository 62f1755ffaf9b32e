"""GPU numerics the CPU suite cannot see: TF32 contractions, subnormal
flushing, and the run-to-run contract of each counting method.

Every test here is marked ``chip`` and takes the ``gpu`` fixture, which
skips it on any other backend. ``python chip_smoke.py`` runs them on the
card before it starts its own phases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import xhistogram_tpu as xh
from xhistogram_tpu.ops.ftz import fix_neg_subnormals

pytestmark = pytest.mark.chip

METHODS = ("scatter", "onehot", "sort")


@pytest.mark.parametrize("method", METHODS)
def test_single_weight_per_slot_is_bit_exact(gpu, method):
    """One weight with a full 24-bit mantissa per slot comes back bit for
    bit: a TF32 contraction (11 significant bits) would round it. On the
    H100 the onehot strategy's batched contraction did not round at
    default precision at any probed shape (a plain GEMM did), so this
    checks the result, not that ``Precision.HIGHEST`` is needed."""
    n = 200
    edges = np.arange(n + 1, dtype=np.float32)
    data = jnp.asarray(np.arange(n, dtype=np.float32) + 0.5)
    w = (1.0 + np.arange(1, n + 1) * 2.0**-23).astype(np.float32)
    h, _ = xh.histogram(data, bins=edges, weights=jnp.asarray(w),
                        method=method)
    assert np.array_equal(np.asarray(h), w)


@pytest.mark.parametrize("fixed", [True, False], ids=["with_fix", "without_fix"])
def test_negative_subnormal_against_zero_edge(gpu, fixed):
    """A negative subnormal sits below a 0.0 edge, as numpy says, with the
    flush-to-zero fix and without it: the GPU does not flush f32 compare
    operands."""
    v = np.array([-1e-40, 1e-40, -0.0, 0.0], np.float32)
    edges = np.array([-1.0, 0.0, 1.0], np.float32)
    expect = np.searchsorted(edges, v, side="right")

    def digitize(a):
        a = fix_neg_subnormals(a) if fixed else a
        return jnp.searchsorted(jnp.asarray(edges), a, side="right")

    got = np.asarray(jax.jit(digitize)(jnp.asarray(v)))
    assert np.array_equal(got, expect)


def test_unweighted_counts_identical_across_methods_and_runs(gpu):
    """Integer counts are exact and independent of summation order."""
    x = jax.random.normal(jax.random.PRNGKey(0), (64, 4096), jnp.float32)
    edges = np.linspace(-3.0, 3.0, 41)
    expect = np.stack([np.histogram(r, edges)[0] for r in np.asarray(x)])
    for method in METHODS:
        for _ in range(2):
            h, _ = xh.histogram(x, bins=edges, axis=(1,), method=method)
            assert np.array_equal(np.asarray(h), expect), method


@pytest.mark.parametrize("method", ["sort", "onehot"])
def test_fixed_order_weighted_sums_repeat(gpu, method):
    """``sort`` and ``onehot`` add weights in a fixed order, so repeated
    calls agree bit for bit (``scatter`` adds atomically and may not)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    x = jax.random.normal(k1, (1 << 20,), jnp.float32)
    w = jax.random.uniform(k2, (1 << 20,), jnp.float32)
    edges = np.linspace(-3.0, 3.0, 41)
    runs = [
        np.asarray(xh.histogram(x, bins=edges, weights=w, method=method)[0])
        for _ in range(3)
    ]
    assert all(np.array_equal(runs[0], r) for r in runs[1:])


def test_onehot_nonfinite_channels_compile_and_agree(gpu):
    """The onehot strategy's nonfinite-weight channels (int32 contractions)
    compile on the GPU and give scatter's IEEE per-slot results."""
    x = np.linspace(-0.99, 0.99, 1000).astype(np.float32)
    w = np.ones(1000, np.float32)
    w[[3, 500]] = np.nan
    w[[10]] = np.inf
    w[[900, 901]] = [np.inf, -np.inf]
    edges = np.linspace(-1.0, 1.0, 11)
    h_one = np.asarray(xh.histogram(x, bins=edges, weights=w,
                                    method="onehot")[0])
    h_sc = np.asarray(xh.histogram(x, bins=edges, weights=w,
                                   method="scatter")[0])
    assert np.array_equal(h_one, h_sc, equal_nan=True)
