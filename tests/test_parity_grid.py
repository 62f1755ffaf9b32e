"""Parity grid of the XLA pipeline against numpy.

One to three inputs; joint slot counts on both sides of the GPU strategy
rule (``ops.bincount.gpu_method``: sort up to 1025 slots and 2**16
rows x slots, scatter above); kept rows {1, 3, 17}; reduce columns
{1, 5, 130}; weighted and unweighted. Each case runs the strategy the GPU rule picks for its
shape, so both sides of the rule are checked here on the CPU.
"""

import math

import numpy as np
import pytest

from xhistogram_tpu.core import histogram
from xhistogram_tpu.ops.bincount import auto_method, gpu_method

# per input count: (bins below the rule's slot limit, bins above it)
BINS = {
    1: ((10,), (1500,)),
    2: ((6, 5), (40, 37)),
    3: ((4, 3, 3), (12, 11, 9)),
}


def _case_method(rows, nbins):
    return gpu_method(rows, math.prod(nbins) + 1)


@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "weights"])
@pytest.mark.parametrize("cols", [1, 5, 130])
@pytest.mark.parametrize("rows", [1, 3, 17])
@pytest.mark.parametrize("side", [0, 1], ids=["few_slots", "many_slots"])
@pytest.mark.parametrize("n_inputs", [1, 2, 3])
def test_pipeline_matches_numpy(n_inputs, side, rows, cols, weighted):
    nbins = BINS[n_inputs][side]
    rng = np.random.RandomState(
        1000 * n_inputs + 100 * side + 10 * rows + cols + weighted
    )
    arrays = [rng.randn(rows, cols).astype("f4") for _ in nbins]
    arrays[0].ravel()[::7] = np.nan  # NaN routes to no bin
    edges = [np.linspace(-2.5, 2.5, nb + 1) for nb in nbins]
    w = rng.rand(rows, cols).astype("f4") if weighted else None
    method = _case_method(rows, nbins)
    h, _ = histogram(*arrays, bins=edges, axis=(1,), weights=w,
                     method=method)
    for r in range(rows):
        exp, _ = np.histogramdd(
            np.stack([a[r].astype("f8") for a in arrays], -1),
            bins=edges,
            weights=None if w is None else w[r].astype("f8"),
        )
        if weighted:
            np.testing.assert_allclose(np.asarray(h)[r], exp, rtol=1e-5)
        else:
            np.testing.assert_array_equal(np.asarray(h)[r], exp)


def test_grid_covers_both_sides_of_the_rule():
    picked = {
        _case_method(rows, BINS[n][side])
        for n in BINS for side in (0, 1) for rows in (1, 3, 17)
    }
    assert picked == {"sort", "scatter"}


@pytest.mark.parametrize(
    "m,n_slots,want",
    [
        (1, 52, "sort"),          # config 1: 50 bins, full reduction
        (1000, 52, "sort"),       # config 2: kept rows
        (1, 1025, "sort"),        # the rule's slot limit
        (1, 1026, "scatter"),
        (64, 1024, "sort"),       # the rule's rows x slots limit
        (65, 1024, "scatter"),
        (1000, 256, "scatter"),
        (16384, 51, "scatter"),
        (1, 95201, "scatter"),    # config 3: 280 x 340 T-S grid
        (1036800, 81, "scatter"), # config 4 at 0.25 degree: per grid point
    ],
)
def test_gpu_strategy_rule(m, n_slots, want):
    assert gpu_method(m, n_slots) == want


def test_cpu_auto_is_scatter():
    assert auto_method(1000, 52) == "scatter"
