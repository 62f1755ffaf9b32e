"""Property-based sharding tests.

The JAX analog of the reference's hypothesis-over-chunkings suite
(/root/reference/xhistogram/test/test_chunking_hypotheses.py): instead of
generating arbitrary dask chunk tuples, generate arbitrary mesh shapes and
input layouts over 8 virtual devices; every layout must reproduce the
unsharded numpy oracle exactly.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, PartitionSpec as P

from xhistogram_tpu.parallel import histogram_sharded

pytest.importorskip("hypothesis")

import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@st.composite
def mesh_layouts(draw, ndim=2):
    """Generate (mesh shape over 8 devices, PartitionSpec) pairs."""
    factorizations = [(8,), (4, 2), (2, 4), (2, 2, 2), (1, 8)]
    mesh_shape = draw(st.sampled_from(factorizations))
    names = tuple(f"m{i}" for i in range(len(mesh_shape)))
    # each data axis gets a (possibly empty) disjoint subset of mesh axes
    remaining = list(names)
    entries = []
    for _ in range(ndim):
        k = draw(st.integers(0, len(remaining)))
        take, remaining = remaining[:k], remaining[k:]
        entries.append(tuple(take) if len(take) != 1 else take[0])
        if not take:
            entries[-1] = None
    return mesh_shape, names, P(*entries)


class TestShardingHypotheses:
    @settings(deadline=None, max_examples=20)
    @given(mesh_layouts(ndim=1))
    def test_all_layouts_1d(self, layout):
        mesh_shape, names, spec = layout
        rng = np.random.RandomState(0)
        data = rng.randn(16).astype("f4")
        bins = np.linspace(-4, 4, 9)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(mesh_shape), names)
        h, _ = histogram_sharded(data, mesh=mesh, in_spec=spec, bins=bins)
        np.testing.assert_array_equal(
            np.asarray(h), np.histogram(data, bins=bins)[0]
        )

    @settings(deadline=None, max_examples=20)
    @given(mesh_layouts(ndim=2))
    def test_all_layouts_2d_joint(self, layout):
        mesh_shape, names, spec = layout
        rng = np.random.RandomState(1)
        data_a = rng.randn(8, 16).astype("f4")
        data_b = rng.randn(8, 16).astype("f4")
        bins_a = np.linspace(-4, 4, 9)
        bins_b = np.linspace(-4, 4, 10)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(mesh_shape), names)
        h, _ = histogram_sharded(
            data_a, data_b, mesh=mesh, in_spec=spec, bins=[bins_a, bins_b]
        )
        expected, _, _ = np.histogram2d(
            data_a.ravel(), data_b.ravel(), bins=[bins_a, bins_b]
        )
        np.testing.assert_array_equal(np.asarray(h), expected)

    @settings(deadline=None, max_examples=10)
    @given(mesh_layouts(ndim=2), st.sampled_from([None, (0,), (1,)]))
    def test_layouts_with_kept_axes(self, layout, axis):
        mesh_shape, names, spec = layout
        rng = np.random.RandomState(2)
        data = rng.randn(8, 16).astype("f4")
        bins = np.linspace(-4, 4, 9)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(mesh_shape), names)
        h, _ = histogram_sharded(
            data, mesh=mesh, in_spec=spec, bins=bins, axis=axis
        )
        if axis is None:
            expected = np.histogram(data, bins=bins)[0]
        elif axis == (1,):
            expected = np.stack([np.histogram(r, bins=bins)[0] for r in data])
        else:
            expected = np.stack(
                [np.histogram(c, bins=bins)[0] for c in data.T]
            )
        np.testing.assert_array_equal(np.asarray(h), expected)
