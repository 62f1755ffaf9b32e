"""Labeled-API tests: dim-subset reduction, bin-center coords, weights,
density, coord carrying — mirrors the reference xarray integration suite
(/root/reference/xhistogram/test/test_xarray.py) against our NamedArray.
"""

from itertools import combinations

import numpy as np
import pytest

from xhistogram_tpu.labeled import NamedArray, histogram
from xhistogram_tpu.labeled.array import full_like

DIMS = {"time": 5, "depth": 10, "lat": 45, "lon": 90}
COORDS = {
    "time": np.arange(DIMS["time"]) * 86400.0,
    "depth": np.arange(DIMS["depth"]) * 100.0 + 50,
    "lat": np.arange(DIMS["lat"]) * 180 / DIMS["lat"] - 90 + 90 / DIMS["lat"],
    "lon": np.arange(DIMS["lon"]) * 360 / DIMS["lon"] + 180 / DIMS["lon"],
}


@pytest.fixture(
    params=[
        ("lon",),
        ("lat", "lon"),
        ("depth", "lat", "lon"),
        ("time", "depth", "lat", "lon"),
    ],
    ids=["1D", "2D", "3D", "4D"],
)
def ones(request):
    dims = request.param
    shape = [DIMS[d] for d in dims]
    coords = {k: v for k, v in COORDS.items() if k in dims}
    return NamedArray(np.ones(shape, dtype="f4"), dims, coords=coords, name="ones")


@pytest.mark.parametrize("ndims", [1, 2, 3, 4])
def test_histogram_ones(ones, ndims):
    dims = ones.dims
    if ones.ndim < ndims:
        pytest.skip("combination count exceeds array rank")

    bins = np.array([0, 0.9, 1.1, 2])
    bins_c = 0.5 * (bins[1:] + bins[:-1])

    for d in combinations(dims, ndims):
        h = histogram(ones, bins=[bins], dim=d)
        other_dims = [dim for dim in ones.dims if dim not in d]
        if other_dims:
            assert set(other_dims) <= set(h.dims)
        h_sum = h.sum(other_dims)
        assert h_sum.dims == ("ones_bin",)
        np.testing.assert_array_equal(h_sum.values, [0, ones.size, 0])
        np.testing.assert_allclose(h_sum.coords["ones_bin"].values, bins_c)
        assert h.name == "histogram_ones"


@pytest.mark.parametrize("ndims", [1, 2, 3, 4])
def test_histogram_ones_density(ones, ndims):
    dims = ones.dims
    if ones.ndim < ndims:
        pytest.skip("combination count exceeds array rank")
    bins = np.array([0, 0.9, 1.1, 2])
    bin_area = 0.2
    for d in combinations(dims, ndims):
        h_density = histogram(ones, bins=[bins], dim=d, density=True)
        integrals = (h_density.values * bin_area).sum(
            axis=h_density.dims.index("ones_bin")
        )
        np.testing.assert_allclose(integrals, 1.0, rtol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("ndims", [1, 2])
def test_weights(ones, ndims):
    dims = ones.dims
    if ones.ndim < ndims:
        pytest.skip("combination count exceeds array rank")
    bins = np.array([0, 0.9, 1.1, 2])
    weight_value = 0.5

    # weights over every dim-subset broadcast (reference test_xarray.py:100-135)
    for n_comb in range(ones.ndim):
        for weight_dims in combinations(dims, n_comb):
            i_selector = {dim: 0 for dim in weight_dims}
            weights = full_like(ones.isel(**i_selector), weight_value)
            for nc in range(ndims):
                for d in combinations(dims, nc + 1):
                    h = histogram(ones, weights=weights, bins=[bins], dim=d)
                    other = [dim for dim in ones.dims if dim not in d]
                    h_sum = h.sum(other)
                    np.testing.assert_allclose(
                        h_sum.values, [0, weight_value * ones.size, 0], rtol=1e-6
                    )


def test_dims_and_coords():
    """Output dim order and coordinate identity (reference
    test_xarray.py:139-173, issue #5)."""
    shape = (4, 10, 30, 30)
    dims = ["time", "depth", "X", "Y"]
    coords = {
        "time": np.arange(4),
        "depth": np.arange(10),
        "X": np.arange(30),
        "Y": np.arange(30),
    }
    rng = np.random.RandomState(0)
    array1 = NamedArray(
        rng.randint(0, 100, shape).astype("f4"), dims, coords=coords, name="one"
    )
    array2 = NamedArray(
        rng.randint(0, 50, shape).astype("f4"), dims, coords=coords, name="two"
    )
    bins1 = np.linspace(0, 100, 50)
    bins2 = np.linspace(0, 50, 25)

    result = histogram(array1, array2, dim=["X", "Y"], bins=[bins1, bins2])
    assert result.dims == ("time", "depth", "one_bin", "two_bin")
    np.testing.assert_array_equal(result.coords["time"].values, coords["time"])
    np.testing.assert_array_equal(result.coords["depth"].values, coords["depth"])

    # value parity against numpy per (time, depth) slice
    expected = np.stack(
        [
            np.stack(
                [
                    np.histogram2d(
                        np.asarray(array1.data)[t, d].ravel(),
                        np.asarray(array2.data)[t, d].ravel(),
                        bins=[bins1, bins2],
                    )[0]
                    for d in range(10)
                ]
            )
            for t in range(4)
        ]
    )
    np.testing.assert_array_equal(result.values, expected)


@pytest.mark.parametrize("number_of_inputs", [1, 2])
@pytest.mark.parametrize("keep_coords", [True, False])
@pytest.mark.parametrize("include_weights", [True, False])
def test_carry_coords(keep_coords, number_of_inputs, include_weights):
    """Non-dim coords carried iff keep_coords (reference
    test_xarray.py:176-211)."""
    shape = (40, 10, 10)
    dims = ["time", "X", "Y"]
    coords = {d: np.arange(s) for d, s in zip(dims, shape)}
    rng = np.random.RandomState(1)
    da = NamedArray(
        rng.randint(0, 100, shape).astype("f4"), dims, coords=coords, name="one"
    )
    # fake a non-dimension coordinate over (X, Y)
    lon = np.add.outer(coords["X"] ** 2, coords["Y"] ** 2).astype("f8")
    da.coords["lon"] = NamedArray(lon, ("X", "Y"), name="lon")

    weights = full_like(da, 0.5) if include_weights else None
    bins = np.linspace(0, 100, 10)
    result = histogram(
        *[da] * number_of_inputs,
        bins=[bins] * number_of_inputs,
        dim=["time"],
        weights=weights,
        keep_coords=keep_coords,
    )
    if keep_coords:
        assert "lon" in result.coords
        np.testing.assert_array_equal(result.coords["lon"].values, lon)
    else:
        assert "lon" not in result.coords


def test_bin_attrs_and_suffix():
    da = NamedArray(
        np.linspace(0, 1, 16).reshape(4, 4),
        ("x", "y"),
        name="T",
        attrs={"units": "degC"},
    )
    bins = np.linspace(0, 1, 5)
    h = histogram(da, bins=[bins], bin_dim_suffix="_edges")
    assert h.dims == ("T_edges",)
    assert h.coords["T_edges"].attrs == {"units": "degC"}


def test_input_type_check():
    with pytest.raises(TypeError):
        histogram(np.arange(100), bins=10)


def test_name_required():
    da = NamedArray(np.arange(4.0), ("x",))
    with pytest.raises(ValueError, match="name"):
        histogram(da, bins=np.linspace(0, 4, 3))


def test_align_exact_raises():
    a = NamedArray(np.ones((3, 4)), ("x", "y"), name="a")
    b = NamedArray(np.ones((5, 4)), ("x", "y"), name="b")
    with pytest.raises(ValueError, match="align"):
        histogram(a, b, bins=[np.linspace(0, 2, 3)] * 2)


def test_labeled_above_cap_scatter_route():
    """Labeled weighted joint call over a 532k-slot grid runs inside the
    cached labeled pipeline and matches the numpy oracle."""
    rng = np.random.RandomState(50)
    a = NamedArray(rng.randn(6, 500).astype("f4"), ("t", "x"), name="a")
    b = NamedArray(rng.randn(6, 500).astype("f4"), ("t", "x"), name="b")
    ea = np.linspace(-4, 4, 1025)
    eb = np.linspace(-4, 4, 521)  # 1024x520 = 532k slots
    w = NamedArray(rng.rand(6, 500).astype("f4"), ("t", "x"))
    h = histogram(a, b, bins=[ea, eb], weights=w)
    exp = np.histogram2d(
        np.asarray(a.data).ravel().astype("f8"),
        np.asarray(b.data).ravel().astype("f8"),
        bins=[ea, eb],
        weights=np.asarray(w.data).ravel().astype("f8"),
    )[0]
    np.testing.assert_allclose(np.asarray(h.data), exp, rtol=1e-4)
    assert h.dims == ("a_bin", "b_bin")
