"""Laziness / graph-construction tests.

The reference proves its dask path never triggers computation at graph-build
time with a poisoned dask array (reference fixtures.py:8-17, the
``empty_dask_array`` whose compute raises). The JAX analog: the whole
pipeline must abstract-evaluate (``jax.eval_shape``) — tracing the program
without touching any data — and jit-compile without executing.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xhistogram_tpu.core import histogram

bins_arr = np.linspace(-4, 4, 10)


def test_eval_shape_no_compute():
    """Abstract evaluation must succeed with explicit edges — no data values
    are ever read (the laziness contract)."""
    def f(x, w):
        return histogram(x, bins=bins_arr, axis=(1,), weights=w)[0]

    out = jax.eval_shape(
        f,
        jax.ShapeDtypeStruct((7, 100), jnp.float32),
        jax.ShapeDtypeStruct((7, 100), jnp.float32),
    )
    assert out.shape == (7, 9)
    assert out.dtype == jnp.float32


def test_eval_shape_density_and_methods():
    for method in ("scatter", "onehot", "sort", "auto"):
        out = jax.eval_shape(
            lambda x: histogram(x, bins=bins_arr, density=True, method=method)[0],
            jax.ShapeDtypeStruct((4, 50), jnp.float32),
        )
        assert out.shape == (9,)


def test_lowering_without_execution():
    """jit lowering/compilation must not execute the kernel (build the graph,
    don't run it) — the analog of dask graph construction."""
    f = jax.jit(lambda x: histogram(x, bins=bins_arr)[0])
    lowered = f.lower(jax.ShapeDtypeStruct((10, 10), jnp.float32))
    compiled = lowered.compile()
    assert compiled is not None


def test_int_bins_trigger_like_dask_guard():
    """int/str bins *do* require data; under tracing that's a TypeError
    (mirrors the reference's dask TypeError truth table,
    test_core.py:276-313)."""
    for bad_bins in (10, "auto"):
        with pytest.raises(TypeError):
            jax.eval_shape(
                lambda x: histogram(x, bins=bad_bins)[0],
                jax.ShapeDtypeStruct((10,), jnp.float32),
            )
