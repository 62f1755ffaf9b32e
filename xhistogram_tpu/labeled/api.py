"""Labeled histogram API (the reference's xarray layer, rebuilt).

``histogram`` provides the full labeled contract of
``xhistogram.xarray.histogram`` (reference xarray.py:13-201): reduce over
named ``dim``s, preserve the remaining dims, emit bin-center coordinates
(named ``<input name> + bin_dim_suffix``) carrying each input's attrs, carry
kept-dim coordinates (plus compatible extra coords under ``keep_coords``),
and name the output ``histogram_<name1>_<name2>...``.

Structure (own decomposition, not the reference's):

  validate → union-dim layout plan → positional dispatch → relabel

It never touches binning math: labels become positional axes, data goes to
``xhistogram_tpu.core.histogram``, labels are rebuilt — the same strict
layering as the reference (L4 never touches bins, SURVEY.md §1).

Repeated calls with the same (shapes, dtypes, dims, explicit edges, kwargs)
— the per-timestep diagnostics pattern — hit a compiled-pipeline cache: the
layout transforms, broadcast, and the counting pipeline all run as ONE jitted
device call with the edges baked in as constants (no per-call host re-work
or edge re-uploads). Data-dependent bin specs (int/str) and wide numpy
dtypes that need the exact host remap fall back to the uncached exact path.

Inputs may be ``labeled.NamedArray`` or any duck-compatible labeled type
(e.g. ``xarray.DataArray``): the function only uses ``dims / coords / attrs /
name / data / reset_coords``.
"""

from __future__ import annotations

import numpy as np

from .. import bins as _bins_mod
from ..core import check_options
from ..core import histogram as _positional_histogram
from .array import NamedArray

__all__ = ["histogram"]

_LABEL_SURFACE = ("dims", "coords", "data", "name")


def _require_labeled(operands, named=True):
    for a in operands:
        if not all(hasattr(a, attr) for attr in _LABEL_SURFACE):
            raise TypeError(
                "labeled histogram accepts only labeled arrays (NamedArray /"
                f" xarray.DataArray) but a {type(a).__name__} was provided"
            )
        if named and a.name is None:
            raise ValueError("all labeled arrays must have a name")


def _union_sizes(operands):
    """Ordered {dim: size} union over operands with an exact-join size check
    — the reference's xr.align(join="exact") contract
    (reference xarray.py:126,133-138)."""
    sizes = {}
    for a in operands:
        for d, s in zip(a.dims, a.data.shape):
            if sizes.setdefault(d, s) != s:
                raise ValueError(
                    f"cannot align: dim {d!r} has conflicting sizes"
                    f" {sizes[d]} and {s}"
                )
    return sizes


def _union_dims(operands):
    """Ordered union of operand dims (first-seen order), exact-join checked."""
    return list(_union_sizes(operands))


def _layout_plan(operand_dims, union):
    """(n_new_leading, permutation) placing an operand's data on the union
    dim order: missing dims become leading length-1 axes, then a transpose
    lines everything up. The permutation is None when already in order."""
    have = list(operand_dims)
    missing = [d for d in union if d not in have]
    expanded = missing + have
    perm = tuple(expanded.index(d) for d in union)
    if perm == tuple(range(len(union))):
        perm = None
    return len(missing), perm


def _apply_plan(data, plan):
    n_new, perm = plan
    if n_new:
        data = data.reshape((1,) * n_new + data.shape)
    if perm is not None:
        data = data.transpose(perm)
    return data


def _reduction_axes(union, dim):
    """dim names → (positional axis tuple | None, kept dim names)."""
    if dim is None:
        return None, []
    dim = [dim] if isinstance(dim, str) else list(dim)
    for d in dim:
        if d not in union:
            raise ValueError(f"dimension {d!r} not found in inputs")
    kept = [d for d in union if d not in dim]
    return tuple(union.index(d) for d in dim), kept


# --------------------------------------------------------------------------
# compiled-pipeline cache (explicit-edge calls only)

_PIPELINE_CACHE = {}
_PIPELINE_CACHE_CAP = 128


def _edges_signature(bins, n_inputs):
    """Hashable content signature of an explicit-edge bins spec, or None when
    the spec is data-dependent (int/str — uncacheable by construction)."""
    try:
        per_input = _bins_mod.normalize_bins(bins, n_inputs)
    except ValueError:
        return None  # let the uncached path raise the contract error
    sig = []
    for b in per_input:
        if not isinstance(b, np.ndarray):
            return None
        sig.append((b.tobytes(), str(b.dtype), b.shape))
    return tuple(sig)


def _device_safe(x):
    """A device-dtype-lossless view of ``x`` for the jitted fast path, or
    None when the value needs the exact host remap. This is exactly
    ``core.device_view`` — the labeled cache holds NO dtype policy of its
    own (it desynchronized once, r2 FTZ regression; VERDICT r2 #5)."""
    from ..core import device_view

    return device_view(x)


def _cached_pipeline(key, edges_np, plans, axis, density, block_size, method,
                     weighted, precision):
    """One jitted function per configuration: layout + broadcast + count in
    a single device program, edges baked in as compile-time constants."""
    entry = _PIPELINE_CACHE.get(key)
    if entry is not None:
        return entry

    import jax

    def run(*flat):
        datas = [_apply_plan(d, p) for d, p in zip(flat, plans)]
        w = datas.pop() if weighted else None
        h, _ = _positional_histogram(
            *datas,
            bins=edges_np,
            axis=axis,
            weights=w,
            density=density,
            block_size=block_size,
            method=method,
            precision=precision,
        )
        return h

    entry = jax.jit(run)
    if len(_PIPELINE_CACHE) >= _PIPELINE_CACHE_CAP:
        _PIPELINE_CACHE.pop(next(iter(_PIPELINE_CACHE)))
    _PIPELINE_CACHE[key] = entry
    return entry


# --------------------------------------------------------------------------


def histogram(
    *args,
    bins=None,
    range=None,
    dim=None,
    weights=None,
    density=False,
    block_size="auto",
    method="auto",
    keep_coords=False,
    bin_dim_suffix="_bin",
    precision=None,
):
    """Histogram of labeled arrays over named dimensions.

    Parameters mirror the reference (xarray.py:13-23); ``dim`` is a sequence
    of dimension names to reduce (default: all). ``method`` and
    ``precision`` are those of ``core.histogram``. Returns a
    ``NamedArray`` (counts/weighted sums/density) with bin-center
    coordinates.
    """
    check_options(method, precision)
    if weights is None:
        # mode-independent when unweighted: don't fork the pipeline cache
        precision = None
    inputs = list(args)
    n_inputs = len(inputs)
    _require_labeled(inputs)
    if weights is not None:
        # weights need labels for alignment but no name (reference requires
        # names only of the histogrammed inputs, xarray.py:116-117)
        _require_labeled([weights], named=False)

    # Drop non-dim coords to simplify alignment unless asked to keep them
    # (reference xarray.py:120-123).
    if not keep_coords:
        inputs = [a.reset_coords(drop=True) for a in inputs]
        if weights is not None:
            weights = weights.reset_coords(drop=True)
    operands = inputs + ([weights] if weights is not None else [])

    union = _union_dims(operands)
    plans = [_layout_plan(a.dims, union) for a in operands]
    axis, kept_dims = _reduction_axes(union, dim)

    raw = [a.data for a in operands]
    cacheable = range is None
    if precision == "f64":
        if np.dtype(weights.data.dtype).kind in "iub":
            # integer weights are exact in every mode — core normalizes
            # 'f64' away for them, so keep the cached compiled pipeline
            # instead of needlessly dropping it (ADVICE r4)
            precision = None
        else:
            # the exact-f64 weighted tier runs a host decomposition and
            # returns float64 — it must take the uncached eager path,
            # where core.histogram handles it (same rule as the
            # wide-weight dtypes, which _device_safe already diverts
            # there)
            cacheable = False
    if cacheable and weights is None:
        # unweighted reductions of >= 2**31 elements per output row need the
        # eager int64 wide-count path — never trace them (core contract)
        import math as _math

        from ..core import _WIDE_LIMIT

        sizes = dict(_union_sizes(operands))
        reduce_dims = union if dim is None else (
            [dim] if isinstance(dim, str) else list(dim)
        )
        reduced = _math.prod(sizes.get(d, 1) for d in reduce_dims)
        cacheable = reduced < _WIDE_LIMIT
    edges_sig = _edges_signature(bins, n_inputs) if cacheable else None
    safe = [_device_safe(d) for d in raw] if edges_sig is not None else None

    if edges_sig is not None and all(s is not None for s in safe):
        # fast path: one jitted device call, edges as constants
        edges_np = [
            np.asarray(b)
            for b in _bins_mod.normalize_bins(bins, n_inputs)
        ]
        # inside jit the inputs are tracers, so core._prepare_device's
        # exact-host fallback for FTZ-unsafe (subnormal-threshold) edges
        # can't fire — such edge sets must take the uncached exact path.
        # Same shared policy function as core (ftz_exact_fallback).
        from ..core import ftz_exact_fallback

        if any(
            ftz_exact_fallback(s, e)
            for e, s in zip(edges_np, safe[:n_inputs])
        ):
            edges_sig = None

    if edges_sig is not None and all(s is not None for s in safe):
        key = (
            edges_sig,
            tuple((s.shape, str(s.dtype)) for s in safe),
            tuple(plans),
            axis,
            bool(density),
            block_size,
            method,
            weights is not None,
            precision,
        )
        run = _cached_pipeline(
            key, edges_np, plans, axis, density, block_size, method,
            weights is not None, precision,
        )
        h_data = run(*safe)
        edges = edges_np
    else:
        # exact path: host prep (wide-dtype remaps, data-dependent bin
        # resolution) happens inside core.histogram
        laid_out = [_apply_plan(d, p) for d, p in zip(raw, plans)]
        w_data = laid_out.pop() if weights is not None else None
        h_data, edges = _positional_histogram(
            *laid_out,
            bins=bins,
            range=range,
            axis=axis,
            weights=w_data,
            density=density,
            block_size=block_size,
            method=method,
            precision=precision,
        )

    return _relabel(
        h_data, edges, inputs, kept_dims, keep_coords, bin_dim_suffix
    )


def _relabel(h_data, edges, inputs, kept_dims, keep_coords, bin_dim_suffix):
    """Output labels (reference xarray.py:174-199): kept dims first, one
    ``<name><suffix>`` bin dim per input with bin-center coords carrying the
    input's attrs; kept-dim coords (and, under ``keep_coords``, any other
    first-input coord whose dims survive) come along."""
    bin_dims = [str(a.name) + bin_dim_suffix for a in inputs]
    out_dims = list(kept_dims) + bin_dims

    coords = {}
    first = inputs[0]
    for d in kept_dims:
        if d in first.coords:
            coords[d] = first.coords[d]
    for bdim, e, a in zip(bin_dims, edges, inputs):
        coords[bdim] = ((bdim,), _bins_mod.bin_centers(e), dict(a.attrs))
    if keep_coords:
        for cname, cval in first.coords.items():
            if cname not in coords and set(cval.dims).issubset(out_dims):
                coords[cname] = cval

    name = "_".join(["histogram"] + [str(a.name) for a in inputs])
    return NamedArray(h_data, out_dims, coords=coords, name=name)
