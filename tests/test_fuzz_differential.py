"""Seeded slice of the differential fuzzer (scripts/fuzz_differential.py):
random shapes/axes/dtypes/bins/weights/density configs, every method vs the
numpy oracle. The standalone script runs arbitrarily long hunts; this keeps
a fixed-seed regression slice in CI.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

_SCRIPT = (
    pathlib.Path(__file__).resolve().parent.parent
    / "scripts"
    / "fuzz_differential.py"
)
spec = importlib.util.spec_from_file_location("fuzz_differential", _SCRIPT)
fuzz = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fuzz)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_slice(seed):
    rng = np.random.RandomState(seed)
    methods = ["auto", "scatter", "onehot", "sort"]
    for i in range(20):
        assert fuzz.one_case(rng, i, methods), f"seed={seed} case={i}"


@pytest.mark.slow
@pytest.mark.parametrize("seed", [2, 3])
def test_fuzz_slice_forced_xla_digitize(seed, monkeypatch):
    """Same differential fuzz with the uniform-certificate digitize off:
    every input takes the searchsorted edge compare."""
    from xhistogram_tpu.ops import digitize as dg

    monkeypatch.setattr(dg, "UNIFORM_DIGITIZE", False)
    rng = np.random.RandomState(seed)
    methods = ["auto", "scatter", "sort"]
    for i in range(15):
        assert fuzz.one_case(rng, i, methods), f"seed={seed} case={i}"
