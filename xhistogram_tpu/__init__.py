"""xhistogram_tpu: N-dimensional, axis-selective histograms on JAX/XLA.

A from-scratch JAX/XLA rebuild of the capabilities of xgcm/xhistogram
(reference: /root/reference/xhistogram): weighted, optionally density-normalized
joint histograms over chosen axes of N input arrays, preserving the remaining
("bystander") axes, with a labeled (named-dimension) wrapper and multi-chip
scaling via sharded per-device partial histograms combined over the device mesh.

Public layers (mirrors the reference layer map, SURVEY.md §1):
  - ``xhistogram_tpu.core.histogram``       — array API (reference core.py:250)
  - ``xhistogram_tpu.labeled.histogram``    — labeled API (reference xarray.py:13)
  - ``xhistogram_tpu.parallel``             — explicit mesh/shard_map scaling
    (replaces the reference's dask blockwise + tree-sum, core.py:403-439)
  - ``xhistogram_tpu.ops``                  — digitize / bincount strategies
    (the "native layer": the XLA equivalent of numpy's C
    searchsorted/bincount kernels reached at reference core.py:10-17)
"""

__version__ = "0.1.0"

from . import core  # noqa: F401
from . import ops  # noqa: F401
from . import parallel  # noqa: F401
from . import labeled  # noqa: F401
from . import streaming  # noqa: F401
from . import compat  # noqa: F401
from .core import histogram  # noqa: F401
from .streaming import StreamingHistogram  # noqa: F401

__all__ = [
    "core",
    "ops",
    "parallel",
    "labeled",
    "streaming",
    "compat",
    "histogram",
    "StreamingHistogram",
    "__version__",
]
