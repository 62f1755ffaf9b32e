"""Out-of-core histogram of a dataset larger than device memory.

Simulates a multi-year ocean-model output read month by month (the zarr /
netCDF access pattern) and accumulates a volume-weighted joint T-S histogram
on the device with ``StreamingHistogram`` — the JAX analog of the
reference's dask out-of-core path (reference core.py:403-439: blockwise
partial histograms + tree-sum; here the "tree" is a device-resident
accumulator and the chunks are whatever the loader yields).

Run: `python examples/streaming_climatology.py` (CPU or GPU).
"""

import numpy as np

from xhistogram_tpu import StreamingHistogram
from xhistogram_tpu.core import histogram

NZ, NY, NX = 6, 48, 96
N_MONTHS = 24

t_edges = np.linspace(-2.0, 30.0, 161)
s_edges = np.linspace(30.0, 38.0, 121)


def load_month(month):
    """Stand-in for a zarr/netCDF chunk read: (depth, lat, lon) fields."""
    rng = np.random.RandomState(month)
    season = 2.5 * np.sin(2 * np.pi * month / 12)
    T = (14 + season + 6 * rng.randn(NZ, NY, NX)).astype("f4")
    S = (35 + 1.2 * rng.randn(NZ, NY, NX)).astype("f4")
    vol = rng.rand(NZ, NY, NX).astype("f4")  # cell volumes as weights
    return T, S, vol


# accumulate per depth level (axis 0 kept), reducing lat/lon per chunk and
# months across chunks
acc = StreamingHistogram(bins=[t_edges, s_edges], axis=(1, 2))
for month in range(N_MONTHS):
    T, S, vol = load_month(month)
    acc.update(T, S, weights=vol)

h, edges = acc.result(density=False)
print("accumulated histogram:", h.shape, "total weight:",
      float(np.asarray(h).sum()))

# sanity: identical to the one-shot histogram over the concatenated months
allT, allS, allV = (np.concatenate(x, axis=0) for x in zip(
    *[load_month(m) for m in range(N_MONTHS)]
))
# concatenating months along a reduced axis == streaming them; compare the
# full reduction of one depth level
h_ref, _ = histogram(
    allT[0::NZ].ravel(), allS[0::NZ].ravel(),
    bins=[t_edges, s_edges], weights=allV[0::NZ].ravel(),
)
np.testing.assert_allclose(
    np.asarray(h)[0], np.asarray(h_ref), rtol=2e-4, atol=1e-2
)
print("streaming == one-shot for depth level 0: OK")
