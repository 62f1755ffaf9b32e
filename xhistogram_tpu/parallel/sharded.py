"""Multi-chip histograms: sharded partial counts + mesh collectives.

This module replaces the reference's entire distributed backend — dask
``blockwise`` partial histograms tree-summed by the scheduler (reference
core.py:403-439) — with the design from SURVEY.md §2.2/§2.3:

  1. each device computes the histogram of its local shard with the same
     single-device kernel (embarrassingly parallel partials);
  2. partial counts are combined with ``jax.lax.psum`` over the mesh axes
     that shard *reduced* data axes (the tree-sum equivalent, riding the
     device interconnect — NCCL over NVLink between GPUs — instead of host
     TCP);
  3. *kept* (bystander) data axes may stay sharded — the output inherits
     their sharding, no gather needed.

Two usage modes:
  - implicit: call ``xhistogram_tpu.core.histogram`` on mesh-sharded
    arrays. EAGER calls auto-delegate here (core._infer_mesh_sharding →
    ``histogram_sharded``), so the per-shard kernel + psum structure is
    guaranteed. Calls traced inside a USER jit partition through GSPMD,
    which partitions the XLA pipeline natively (collectives in the HLO,
    pinned by tests).
  - explicit (this module): ``histogram_sharded`` wraps the pipeline in
    ``shard_map`` so the per-device kernel and the single ``psum`` are
    guaranteed, independent of partitioner heuristics — and the exact
    wide-int/f64 weight tiers (host decompositions) live here only.

Density normalization must happen *after* the psum (per-row totals are
global) — handled here by deferring the density step to post-reduction,
mirroring where the reference normalizes after the dask tree-sum
(core.py:439-462).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import bins as _bins_mod
from ..core import (
    _coerce_host,
    _histogram_impl,
    _prepare_device,
    _uniform_operands,
    check_options,
    device_view,
)
from ..utils.axes import normalize_axis

__all__ = ["histogram_sharded", "reduce_spec"]

# `range` is a histogram keyword (reference API, core.py:19-20 does the same)
_builtin_range = range


def reduce_spec(spec: P, axis, ndim):
    """Split an input PartitionSpec into (kept-axes out spec, psum axis names).

    Mesh axes appearing on *reduced* data axes become psum axes; mesh axes on
    kept data axes survive into the output spec (bin axes are replicated).
    """
    axis = normalize_axis(axis, ndim)
    entries = list(spec) + [None] * (ndim - len(spec))
    psum_axes = []
    out_entries = []
    for i, entry in enumerate(entries):
        if axis is None or i in axis:
            if entry is not None:
                names = entry if isinstance(entry, tuple) else (entry,)
                psum_axes.extend(names)
        else:
            out_entries.append(entry)
    return P(*out_entries), tuple(psum_axes)


def histogram_sharded(
    *args,
    mesh: Mesh,
    in_spec: P,
    bins=None,
    range=None,
    axis=None,
    weights=None,
    density=False,
    block_size="auto",
    method="auto",
    precision=None,
):
    """Explicitly sharded histogram over a device mesh.

    Inputs and weights are broadcast against each other (the reference's
    ``broadcast_arrays``, core.py:366); ``in_spec`` lays out the BROADCAST
    shape over ``mesh``. Each device histograms its local shard; a single
    ``psum`` over the mesh axes that shard reduced data axes combines the
    partials. Kept axes keep their sharding in the output. ``method`` and
    ``precision`` are those of ``core.histogram``.
    Note an eager ``broadcast_to`` of a lower-rank operand materializes the
    full shape on the default device before resharding — pre-broadcast and
    pre-shard giant operands yourself if that matters.

    Returns ``(hist, bin_edges_list)`` like the core API.
    """
    if not args:
        raise ValueError("histogram_sharded() requires at least one input array")
    check_options(method, precision)

    args = [_coerce_host(a) for a in args]
    if weights is not None:
        weights = _coerce_host(weights)
    edges_np = _bins_mod.resolve_bin_edges(args, bins, range, weights)
    nbins = tuple(int(e.shape[0]) - 1 for e in edges_np)

    # Weight-side exact-device policy (same as core.histogram): lossless
    # int32 views narrow; integer weights beyond it take the exact digit
    # path below (their int64/uint64 sums cannot ride a single int32 psum).
    wide_weights = None
    if (
        weights is not None
        and isinstance(weights, np.ndarray)
        and weights.dtype.kind in "iu"
    ):
        wv = device_view(weights)
        if wv is None:
            wide_weights = weights
            weights = None  # resolved below, after shapes/axes are known
        else:
            weights = wv

    # precision='f64' with float weights: the exact sharded tier (r5,
    # VERDICT r4 #3) — host exponent-group decomposition + per-digit
    # int32-psummed device passes + double-double host combine. The host
    # decomposition needs concrete float64 values, so traced callers raise.
    f64_weights = None
    if (
        precision == "f64"
        and weights is not None
        and np.dtype(weights.dtype).kind == "f"
    ):
        if _bins_mod.is_traced(weights) or any(
            _bins_mod.is_traced(a) for a in args
        ):
            raise ValueError(
                "precision='f64' runs the exact host decomposition, which "
                "cannot run under tracing; call histogram_sharded eagerly "
                "or use the default precision."
            )
        f64_weights = np.asarray(weights, np.float64)
        weights = None  # handled by the exact digit path below

    # Exact device representation (wide-numpy remap + comparison-form edges;
    # same host prep as the core path).
    args, edges_dev, n_hi_clip, uniform = _prepare_device(args, edges_np)
    arrays = [jnp.asarray(a) for a in args]
    # Broadcast parity with core.histogram / the reference (core.py:366):
    # lower-rank/length-1 inputs broadcast against each other and the
    # weights; ``in_spec`` lays out the BROADCAST shape (VERDICT r3 #8 —
    # inputs previously had to be pre-broadcast while weights were not).
    to_b = list(arrays) + (
        [jnp.asarray(weights)] if weights is not None else []
    )
    shape = np.broadcast_shapes(
        *[a.shape for a in to_b],
        *([] if wide_weights is None else [wide_weights.shape]),
        *([] if f64_weights is None else [f64_weights.shape]),
    )
    arrays = [jnp.broadcast_to(a, shape) for a in arrays]
    if weights is not None:
        weights = jnp.broadcast_to(jnp.asarray(weights), shape)

    ndim = len(shape)
    axis_t = normalize_axis(axis, ndim)
    out_spec, psum_axes = reduce_spec(in_spec, axis_t, ndim)
    n_inputs = len(arrays)

    full_out_spec = P(*(list(out_spec) + [None] * len(nbins)))

    # Per-shard shape (the local pipeline chunks wide rows on it).
    entries = list(in_spec) + [None] * (ndim - len(in_spec))
    local_shape = []
    for i, entry in enumerate(entries):
        size = shape[i]
        if entry is not None:
            names = entry if isinstance(entry, tuple) else (entry,)
            for nm in names:
                size //= mesh.shape[nm]
        local_shape.append(size)

    if wide_weights is not None or f64_weights is not None:
        # Exact wide-integer / float64 weight tiers (mirror of core's
        # engine, distributed): weights decompose host-side into signed
        # base-2**32 WORDS (ops/intweights.host_words); each word rides
        # ONE per-digit-output device pass — one shared digitize, <= 5
        # digit counts, per-digit int32 slot sums psummed over the mesh
        # (exact while 128 * reduced <= 2**30 < 2**31, hence the loud
        # guard), 64-bit / double-double host combine after the gather.
        from ..core import _INTW_CHUNK, _dd_add, _f64_weight_groups
        from ..ops import intweights as _intw

        tier = (
            "integer weights beyond int32 range"
            if wide_weights is not None
            else "precision='f64'"
        )
        reduced = int(
            np.prod([shape[a] for a in axis_t])
            if axis_t is not None
            else np.prod(shape)
        )
        if reduced > _INTW_CHUNK:
            raise ValueError(
                f"one output row reduces {reduced} elements with {tier}: "
                f"per-digit int32 psums would overflow. Stream reduce-axis "
                f"chunks of <= {_INTW_CHUNK} elements through "
                f"xhistogram_tpu.StreamingHistogram (its per-chunk results "
                f"accumulate exactly on the host), or call core.histogram "
                f"eagerly on the gathered data."
            )
        if any(_bins_mod.is_traced(a) for a in arrays):
            raise ValueError(
                f"{tier} needs the host digit path, which cannot run "
                "under tracing; call histogram_sharded eagerly"
            )
        kept = (
            [i for i in _builtin_range(ndim) if i not in axis_t]
            if axis_t is not None
            else []
        )
        kshape = tuple(shape[i] for i in kept)
        dig_out_spec = P(*([None] + list(out_spec) + [None] * len(nbins)))

        def _digit_sums(w_int):
            """Global per-base-256-digit-position int64 slot sums of one
            integer weight array (the sharded mirror of
            core._wide_int_digit_sums): one device pass per word, psummed
            per digit, accumulated by position on the host (a word's 5th
            digit lands additively on the next word's position — the
            combine is linear, so the overlap is exact)."""
            words = _intw.host_words(np.broadcast_to(w_int, shape))
            n_digs = [
                _intw.digits_for_bounds(
                    wd.min(), wd.max(), max_digits=_intw.WORD_MAX_DIGITS
                )
                if wd.size
                else 1
                for wd in words
            ]
            n_pos = max(4 * wi + nd for wi, nd in enumerate(n_digs))
            sums = [
                np.zeros(kshape + nbins, np.int64)
                for _ in _builtin_range(n_pos)
            ]
            uni, uni_vals = _uniform_operands(uniform, n_hi_clip)
            for wi, wd in enumerate(words):
                out = _sharded_impl(
                    tuple(arrays),
                    jnp.asarray(wd),
                    edges_dev,
                    uni_vals,
                    mesh=mesh,
                    in_spec=in_spec,
                    out_spec=dig_out_spec,
                    axis=axis_t,
                    nbins=nbins,
                    method=method,
                    block_size=block_size,
                    has_weights=True,
                    psum_axes=psum_axes,
                    n_hi_clip=n_hi_clip,
                    uniform=uni,
                    digit_outputs=n_digs[wi],
                )
                part = np.asarray(out).astype(np.int64)
                for k in _builtin_range(n_digs[wi]):
                    sums[4 * wi + k] += part[k]
            return sums

        if wide_weights is not None:
            h = _intw.combine_digit_sums(
                _digit_sums(wide_weights),
                unsigned=wide_weights.dtype.kind == "u",
            ).reshape(kshape + nbins)
        else:
            # exact f64 tier: exponent groups → exact int64 digit sums →
            # double-double combine (correctly-rounded slot sums; one f32
            # pass adds nonfinite weights IEEE-faithfully at the end)
            w64 = np.broadcast_to(f64_weights, shape)
            finite = np.isfinite(w64)
            nonfinite_part = None
            if not finite.all():
                wnf = np.where(finite, 0.0, w64).astype(np.float32)
                p, _ = histogram_sharded(
                    *arrays,
                    mesh=mesh,
                    in_spec=in_spec,
                    bins=[e for e in edges_np],
                    axis=axis,
                    weights=wnf,
                    density=False,
                    block_size=block_size,
                    method=method,
                )
                nonfinite_part = np.asarray(p, np.float64)
            wf = np.where(finite, w64, 0.0)
            hi = np.zeros(kshape + nbins, np.float64)
            lo = np.zeros_like(hi)
            for s, K in _f64_weight_groups(wf):
                for j, ds in enumerate(_digit_sums(K)):
                    with np.errstate(over="ignore", invalid="ignore"):
                        hi, lo = _dd_add(
                            hi, lo,
                            np.ldexp(ds.astype(np.float64), s + 8 * j),
                        )
            h = np.where(np.isinf(hi), hi, hi + lo)
            if nonfinite_part is not None:
                h = h + nonfinite_part
        if density:
            bin_axes = tuple(_builtin_range(-n_inputs, 0))
            totals = h.sum(axis=bin_axes, keepdims=True)
            h = h / _bins_mod.bin_areas(edges_np) / totals
        return h, edges_np

    # int64 wide-count contract (reference core.py:363, core._WIDE_LIMIT):
    # when one GLOBAL output row reduces >= 2**31 elements, int32 partials
    # (+ psum) could overflow. Run the uint32-pair path per shard instead
    # (the LOCAL pipeline chunks only if the local rows are themselves
    # wide), psum the pair as overflow-proof 16-bit halves, and combine to
    # exact numpy int64 host-side — the sharded mirror of core's contract.
    wide = False
    local_wide_limit = None
    pair_bits = 32
    if weights is None:
        from ..core import _PAIR_BITS, _WIDE_LIMIT

        reduced = int(
            np.prod([shape[a] for a in axis_t])
            if axis_t is not None
            else np.prod(shape)
        )
        if reduced >= _WIDE_LIMIT:
            if any(_bins_mod.is_traced(a) for a in arrays):
                raise ValueError(
                    f"one output row reduces {reduced} elements (>= "
                    f"2**31): exact counts need 64-bit accumulation, "
                    f"which cannot be returned to a traced caller. Call "
                    f"histogram_sharded eagerly (returns numpy int64) or "
                    f"stream shards through "
                    f"xhistogram_tpu.StreamingHistogram."
                )
            wide = True
            pair_bits = _PAIR_BITS
            local_reduced = int(
                np.prod([local_shape[a] for a in axis_t])
                if axis_t is not None
                else np.prod(local_shape)
            )
            if local_reduced >= _WIDE_LIMIT:
                local_wide_limit = _WIDE_LIMIT
    uniform, uniform_vals = _uniform_operands(uniform, n_hi_clip)

    h = _sharded_impl(
        tuple(arrays),
        weights if weights is not None else jnp.zeros((), jnp.float32),
        edges_dev,
        uniform_vals,
        mesh=mesh,
        in_spec=in_spec,
        out_spec=full_out_spec,
        axis=axis_t,
        nbins=nbins,
        method=method,
        block_size=block_size,
        has_weights=weights is not None,
        psum_axes=psum_axes,
        n_hi_clip=n_hi_clip,
        uniform=uniform,
        wide=wide,
        local_wide_limit=local_wide_limit,
        pair_bits=pair_bits,
    )

    if wide:
        # combine the psummed (hi, lo-halves) into exact numpy int64 (the
        # same host combine as core.histogram's wide path)
        hi, lo_hi, lo_lo = h
        half = (pair_bits + 1) // 2
        lo64 = (np.asarray(lo_hi).astype(np.int64) << half) + np.asarray(
            lo_lo
        ).astype(np.int64)
        h = (np.asarray(hi).astype(np.int64) << pair_bits) + lo64
        if density:
            bin_axes = tuple(_builtin_range(-n_inputs, 0))
            totals = h.sum(axis=bin_axes, keepdims=True)
            h = h / _bins_mod.bin_areas(edges_np) / totals
        return h, edges_np

    if density:
        # areas from the *original* edges (edges_dev are the transformed
        # comparison form); normalize after the global psum so per-row totals
        # are global (reference normalizes after the tree-sum, core.py:439+)
        area = jnp.asarray(_bins_mod.bin_areas(edges_np), jnp.float32)
        # NB: `range` here is the histogram kwarg (reference API name)
        bin_axes = tuple(_builtin_range(-n_inputs, 0))
        totals = h.sum(axis=bin_axes, keepdims=True)
        h = h / area / totals

    return h, edges_np


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "in_spec",
        "out_spec",
        "axis",
        "nbins",
        "method",
        "block_size",
        "has_weights",
        "psum_axes",
        "n_hi_clip",
        "uniform",
        "wide",
        "local_wide_limit",
        "pair_bits",
        "digit_outputs",
    ),
)
def _sharded_impl(
    arrays,
    weights,
    edges,
    uniform_vals,
    *,
    mesh,
    in_spec,
    out_spec,
    axis,
    nbins,
    method,
    block_size,
    has_weights,
    psum_axes,
    n_hi_clip=None,
    uniform=None,
    wide=False,
    local_wide_limit=None,
    pair_bits=32,
    digit_outputs=None,
):
    """Module-level jitted shard_map program (cached across calls; Mesh and
    PartitionSpec are hashable statics). Local reduced-axis ids are unchanged
    under shard_map — shapes shrink, positions don't — so ``axis`` is reused
    as-is on the local shard."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            tuple(in_spec for _ in arrays),
            in_spec if has_weights else P(),
            tuple(P() for _ in edges),
            P(),  # certificate values, replicated
        ),
        out_specs=(out_spec, out_spec, out_spec) if wide else out_spec,
    )
    def _local(arrays_l, weights_l, edges_l, uniform_vals_l):
        counts = _histogram_impl(
            arrays_l,
            weights_l if has_weights else None,
            edges_l,
            uniform_vals=uniform_vals_l,
            axis=axis,
            nbins=nbins,
            density=False,  # normalize only after the global reduction
            method=method,
            block_size=block_size,
            has_weights=has_weights,
            n_hi_clip=n_hi_clip,
            uniform=uniform,
            wide_limit=local_wide_limit,
            pair_bits=pair_bits,
            digit_outputs=digit_outputs,
        )
        if not wide:
            if psum_axes:
                counts = jax.lax.psum(counts, psum_axes)
            return counts
        # uint32-pair partials, made psum-overflow-proof: split lo into
        # halves (each half sums to < n_shards * 2**ceil(pair_bits/2) —
        # far below 2**32 for any real mesh); hi sums stay < 2**32 up to
        # 2**(32 + pair_bits) total elements.
        if local_wide_limit is not None:
            hi, lo = counts  # the local pipeline already chunked wide rows
        else:
            # local rows fit int32 exactly; promote to a (hi, lo) pair
            c_u = counts.astype(jnp.uint32)
            if pair_bits >= 32:
                hi = jnp.zeros_like(c_u)
                lo = c_u
            else:
                hi = c_u >> pair_bits
                lo = c_u & jnp.uint32((1 << pair_bits) - 1)
        half = (pair_bits + 1) // 2
        parts = (hi, lo >> half, lo & jnp.uint32((1 << half) - 1))
        if psum_axes:
            # one pytree psum = one fused all-reduce (three separate psums
            # would pay the per-collective latency three times)
            parts = jax.lax.psum(parts, psum_axes)
        return parts

    return _local(arrays, weights, edges, uniform_vals)
