"""Out-of-core histograms: stream host-resident chunks through the device.

The reference scales beyond memory with dask: ``blockwise`` maps the kernel
over chunks and the scheduler tree-sums the partial histograms (reference
core.py:403-439). On one host with one device (or a mesh of them), the same
decomposition is a plain loop — histograms commute with concatenation along
*reduced* axes — so ``StreamingHistogram`` computes each chunk's partial on
device and accumulates on the host in wide dtypes (int64 counts / f64
weighted sums: the reference's int64 contract, with no int32 overflow cap
however many chunks stream through), deferring density normalization to
the end (exactly where the reference normalizes: after the tree-sum,
core.py:439-462).

    acc = StreamingHistogram(bins=[t_edges, s_edges], axis=1)
    for T_chunk, S_chunk, w_chunk in loader:          # e.g. zarr/netCDF reads
        acc.update(T_chunk, S_chunk, weights=w_chunk)
    h, edges = acc.result(density=True)

Chunks may tile the *kept* (bystander) axes too — the reference's blockwise
path handles chunked kept dims natively (kept axes become singleton blocks
that concatenate, reference core.py:418,429-437). Pass ``kept_offset`` to
``update()`` with the chunk's starting index along each kept axis of the
output; chunks sharing an offset accumulate (reduced-axis streaming), and
``result()`` stitches the kept-axis blocks back together, validating that
they tile the output exactly (no gaps, no overlaps-by-misalignment).

Like the traced/dask bins guard (reference core.py:377-381), int/str bin
specs are rejected: resolving them needs global data the stream cannot see.
"""

from __future__ import annotations

import numpy as np

from . import bins as _bins_mod
from .core import check_options, histogram

__all__ = ["StreamingHistogram"]


class StreamingHistogram:
    """Accumulate an axis-selective joint histogram over data chunks.

    Parameters mirror ``core.histogram`` (reference core.py:250-258) except
    ``bins`` must be explicit edge arrays (one per input) and ``density``
    moves to ``result()``.
    """

    def __init__(self, bins, *, range=None, axis=None, method="auto",
                 block_size="auto", precision=None):
        bins_list = bins if isinstance(bins, (list, tuple)) else [bins]
        # Accept anything that IS a 1-D sequence of edges (ndarray, or a
        # flat list of floats); reject int/str specs, which need global
        # data the stream cannot see (the streaming analog of the
        # reference's dask guard, reference core.py:377-381). A flat list
        # of INTS is ambiguous (per-input int bin-count specs vs one
        # input's integer edges) — refuse with guidance rather than guess.
        if isinstance(bins, (list, tuple)) and bins and np.isscalar(bins[0]):
            if all(isinstance(b, (int, np.integer)) for b in bins):
                raise TypeError(
                    "ambiguous flat list of ints for bins: int bin-COUNT "
                    "specs need global data the stream cannot see "
                    "(reference core.py:377-381); for integer bin EDGES "
                    "of a single input pass np.asarray(edges) or "
                    "[edges_list]"
                )
            bins_list = [bins]  # a single flat list of (float) edge values
        for b in bins_list:
            if isinstance(b, (int, str)) or np.ndim(b) != 1:
                raise TypeError(
                    "StreamingHistogram requires explicit 1-D bin-edge "
                    "arrays (int/str specs need global data the stream "
                    "cannot see — same contract as the reference's dask "
                    "guard, reference core.py:377-381)"
                )
            _bins_mod.validate_edges(b)  # monotonic/NaN/width: fail at
            # construction, not at the first update (r5 edge validation)
        self._bins = [np.asarray(b) for b in bins_list]
        self._n_inputs = len(self._bins)
        if range is not None:
            raise TypeError(
                "range= is meaningless with explicit edge arrays; bake the "
                "range into the edges"
            )
        self._axis = axis
        self._method = method
        self._block_size = block_size
        check_options(method, precision)  # at init, not the 1st update
        self._precision = precision
        self._blocks = None  # {kept_offset tuple: host accumulator array}
        # precision='f64' cross-chunk contract: each update()'s eager
        # core.histogram call returns correctly-rounded float64 chunk
        # partials, and the accumulator below carries a DOUBLE-DOUBLE
        # compensation term per block (``_blocks_lo``), so the chunk
        # partials add EXACTLY across the whole stream — cross-chunk
        # cancellation is preserved (1e16 in one chunk, -1e16 in another,
        # 1.0 in a third gives exactly 1.0). The only error left is the
        # per-chunk final rounding (<= 0.5 ulp of each chunk's own slot
        # sums), which no cross-chunk scheme can recover (the info is
        # rounded away before the accumulator sees it); see doc/usage.md.
        self._blocks_lo = None  # {kept_offset: dd compensation} (f64 only)
        self._edges = None
        self._weighted = None  # pinned by the first update()

    def update(self, *args, weights=None, kept_offset=None):
        """Add one chunk (N input arrays [+ weights]).

        ``kept_offset`` — starting index of this chunk along each *kept*
        axis of the output (one int per kept axis, in kept-axes order);
        omit it (or pass zeros) when chunks tile only the reduced axes.
        Chunks with the same offset accumulate; ``result()`` stitches the
        distinct kept-axis blocks (the reference's chunked-bystander-dim
        blockwise semantics, reference core.py:418,429-437)."""
        if len(args) != self._n_inputs:
            raise ValueError(
                f"expected {self._n_inputs} input arrays (one per bins "
                f"entry), got {len(args)}"
            )
        weighted = weights is not None
        if self._weighted is not None and self._weighted != weighted:
            raise ValueError(
                "cannot mix weighted and unweighted chunks in one "
                "accumulator (counts and weighted sums are different "
                "quantities); pass weights of ones if that mix is intended"
            )
        h, edges = histogram(
            *args,
            bins=self._bins,
            axis=self._axis,
            weights=weights,
            density=False,
            method=self._method,
            block_size=self._block_size,
            precision=self._precision,
        )
        # pin weighted-ness only once the chunk was actually accepted (a
        # failed first update must not poison the accumulator's mode)
        self._weighted = weighted
        # Host-side accumulation in wide dtypes: int64 counts (no int32
        # overflow however many chunks stream through — the reference's
        # int64 contract; uint64 weighted sums keep their unsignedness) /
        # f64 weighted sums. The per-chunk transfer is noise next to
        # reading the chunk itself.
        h = np.asarray(h)
        if h.dtype.kind == "u":
            h = h.astype(np.uint64)
        elif h.dtype.kind == "i":
            h = h.astype(np.int64)
        else:
            h = h.astype(np.float64)
        n_kept = h.ndim - self._n_inputs
        if kept_offset is None:
            kept_offset = (0,) * n_kept
        else:
            kept_offset = tuple(int(o) for o in kept_offset)
            if len(kept_offset) != n_kept:
                raise ValueError(
                    f"kept_offset has {len(kept_offset)} entries but this "
                    f"chunk keeps {n_kept} axes (one offset per kept axis, "
                    "in kept-axes order)"
                )
        dd = (
            self._precision == "f64" and weighted and h.dtype.kind == "f"
        )
        if self._blocks is None:
            self._blocks = {kept_offset: h}
            if dd:
                self._blocks_lo = {kept_offset: np.zeros_like(h)}
            self._edges = edges
        else:
            n_kept_acc = len(next(iter(self._blocks)))
            if n_kept != n_kept_acc:
                raise ValueError(
                    f"chunk keeps {n_kept} axes but the accumulator was "
                    f"started with {n_kept_acc} kept axes: chunks may only "
                    "vary along reduced (and offset kept) axes"
                )
            prev = self._blocks.get(kept_offset)
            if prev is None:
                self._blocks[kept_offset] = h
                if self._blocks_lo is not None:
                    self._blocks_lo[kept_offset] = np.zeros_like(h)
            else:
                if h.shape != prev.shape:
                    raise ValueError(
                        f"chunk produced kept-axes/bin shape {h.shape}, "
                        f"accumulator at kept_offset {kept_offset} holds "
                        f"{prev.shape}: chunks at one offset may only vary "
                        "along reduced axes"
                    )
                if self._blocks_lo is not None:
                    # double-double accumulation: the correctly-rounded
                    # chunk partials add EXACTLY across chunks (cross-chunk
                    # cancellation preserved; precision='f64' contract)
                    from .core import _dd_add

                    # overflowing slots produce ±inf in s and NaN in lo —
                    # masked at combine time (same guard as the eager tier)
                    with np.errstate(over="ignore", invalid="ignore"):
                        s, lo = _dd_add(
                            prev,
                            self._blocks_lo[kept_offset],
                            h.astype(prev.dtype, copy=False),
                        )
                    self._blocks[kept_offset] = s
                    self._blocks_lo[kept_offset] = lo
                else:
                    # pin the accumulator dtype from the first chunk: numpy
                    # would silently promote mixed uint64+int64 adds to
                    # float64
                    self._blocks[kept_offset] = prev + h.astype(
                        prev.dtype, copy=False
                    )
        return self

    def _combined_blocks(self):
        """The per-offset block VALUES: the plain accumulators, or — under
        the precision='f64' double-double accumulation — hi + lo with the
        overflow guard (a slot whose exact sum overflowed has hi = ±inf
        and a NaN-poisoned lo; IEEE summation returns ±inf there)."""
        if self._blocks_lo is None:
            return self._blocks
        return {
            off: np.where(np.isinf(hi), hi, hi + self._blocks_lo[off])
            for off, hi in self._blocks.items()
        }

    def _stitched(self):
        """Concatenate the kept-offset blocks into the full output array,
        validating that the offsets+shapes tile the kept space exactly."""
        blocks = self._combined_blocks()
        n_kept = len(next(iter(blocks)))
        # the single-block shortcut applies only to the zero offset: one
        # block at a nonzero kept_offset does NOT tile the output (rec()
        # below raises the gap error for it)
        if n_kept == 0 or set(blocks) == {(0,) * n_kept}:
            (only,) = blocks.values()
            return only

        def rec(sub, axis):
            if axis == n_kept:
                (only,) = sub.values()
                return only
            groups = {}
            for off, arr in sub.items():
                groups.setdefault(off[axis], {})[off] = arr
            parts, expect = [], 0
            for o in sorted(groups):
                if o != expect:
                    raise ValueError(
                        f"kept-axis {axis} blocks do not tile the output: "
                        f"expected a block starting at {expect}, found "
                        f"offset {o} (gap or overlap)"
                    )
                part = rec(groups[o], axis + 1)
                parts.append(part)
                expect = o + part.shape[axis]
            return np.concatenate(parts, axis=axis)

        return rec(blocks, 0)

    @property
    def blocks(self):
        """Per-kept-offset accumulated host blocks (dict: offset tuple →
        read-only int64/float64 array view), or None before any update.
        Always available mid-stream — use this for progress monitoring or
        checkpointing while the streamed kept-axis blocks do not yet tile
        the output (``counts`` raises in that state). Views are read-only:
        the live accumulators back them, so in-place edits would corrupt
        every subsequent result."""
        if self._blocks is None:
            return None
        out = {}
        for off, arr in self._combined_blocks().items():
            v = arr.view()
            v.flags.writeable = False
            out[off] = v
        return out

    @property
    def counts(self):
        """Accumulated counts so far (host array: int64 counts / float64
        weighted sums — no int32 overflow cap), stitched over any kept-axis
        blocks; None before any update. Raises ValueError while kept-offset
        blocks streamed so far leave gaps (they cannot be stitched into one
        array yet) — poll ``blocks`` for mid-stream state instead."""
        if self._blocks is None:
            return None
        return self._stitched()

    def result(self, density=False):
        """(hist, bin_edges) over everything seen so far.

        ``density=True`` normalizes per bystander row over the *global*
        counts (reference core.py:444-462 semantics — NaN rows normalize
        independently), which is why density cannot be computed per chunk.
        """
        if self._blocks is None:
            raise ValueError("result() before any update()")
        h = self._stitched()
        if density:
            n_inputs = self._n_inputs
            bin_axes = tuple(range(-n_inputs, 0))
            area = np.asarray(_bins_mod.bin_areas(self._edges))
            totals = h.sum(axis=bin_axes, keepdims=True)
            h = h / area / totals
        return h, self._edges
