"""Row-vectorized bincount strategies (pure-XLA implementations).

The innermost reduction of the whole library: given a canonical 2-D layout of
flat joint-bin indices ``g`` with shape ``(M rows, C cols)`` and optional
weights, produce per-row counts ``(M, n_slots)``. This is the XLA equivalent
of the reference's offset-bincount trick (reference core.py:73-83), in three
reformulations, auto-selected by shape:

  - ``scatter``: XLA scatter-add (``.at[].add``). Exactly the reference
    algorithm's semantics. On a GPU it lowers to atomic adds.
  - ``onehot``: one-hot compare + contraction, streamed over column blocks so
    the ``(M, block, n_slots)`` one-hot stays small (the analog of the
    reference's ``block_size`` memory bound, core.py:86-134). Work grows
    with ``n_slots`` per element.
  - ``sort``: per-row sort + bucket boundaries via searchsorted (weighted:
    a segmented scan over each slot's run of sorted weights). O(C log C)
    but fully vectorized.

All strategies return bit-identical integer counts (unweighted) and are
oracle-tested against ``np.bincount``/``np.histogramdd``. Integer counts are
exact and independent of summation order. Weighted float sums accumulate in
f32 and depend on the order of the additions: ``scatter`` on a GPU adds
atomically in an order that can change from run to run (results agree
within f32 rounding); ``onehot`` and ``sort`` sum in a fixed order and
repeat bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import nonfinite as _nonfinite

__all__ = [
    "bincount2d",
    "bincount2d_scatter",
    "bincount2d_onehot",
    "bincount2d_sort",
    "auto_method",
    "gpu_method",
    "METHODS",
]

# Soft cap on the (M, block, n_slots) one-hot temp, in elements. Plays the
# role of the reference's _MAX_CHUNK_SIZE heuristic (core.py:114) but bounds
# a device intermediate instead of a host temp array.
_ONEHOT_BUDGET = 4_000_000

# Cap on the sort strategy's transient (rows, n_slots + 1) bucket-boundary
# array, in elements (2^24 int32 = 64 MB): huge-slot reductions scan over
# chunk-row blocks instead of batching every chunk row at once.
_SORT_POS_BUDGET = 1 << 24

# Above this m × n_slots, the scatter strategy's fused row-offset index
# would overflow int32; it switches to 2-D (row, slot) scatter indices.
_SCATTER_FLAT_LIMIT = 2**31

_HIGHEST = jax.lax.Precision.HIGHEST


def _counts_dtype(weights):
    return jnp.int32 if weights is None else weights.dtype


def _zeros_varying_like(shape, dtype, ref):
    """Zeros for a scan carry that varies over the same shard_map mesh axes
    as ``ref`` (a carry must keep its varying-axes type across the scan)."""
    zeros = jnp.zeros(shape, dtype)
    vma = tuple(getattr(jax.typeof(ref), "vma", ()))
    return jax.lax.pcast(zeros, vma, to="varying") if vma else zeros


def bincount2d_scatter(g, weights, n_slots):
    """Scatter-add strategy: zeros(M*n_slots).at[offset-index].add(w).

    Semantically the reference's ``_bincount_2d`` (core.py:73-83) with the row
    offset fused; indices are in-bounds by construction.
    """
    m, c = g.shape
    if m * n_slots < _SCATTER_FLAT_LIMIT:
        offset = g + (n_slots * jnp.arange(m, dtype=g.dtype))[:, None]
        flat = offset.reshape(-1)
        if weights is None:
            out = jnp.zeros((m * n_slots,), jnp.int32).at[flat].add(
                1, mode="promise_in_bounds"
            )
        else:
            out = jnp.zeros((m * n_slots,), weights.dtype).at[flat].add(
                weights.reshape(-1), mode="promise_in_bounds"
            )
        return out.reshape(m, n_slots)
    # m * n_slots would overflow the int32 flat offset — scatter per row
    # instead (2-D indices, each component < 2**31 by construction)
    rows = jnp.broadcast_to(jnp.arange(m, dtype=g.dtype)[:, None], (m, c))
    if weights is None:
        return jnp.zeros((m, n_slots), jnp.int32).at[rows, g].add(
            1, mode="promise_in_bounds"
        )
    return jnp.zeros((m, n_slots), weights.dtype).at[rows, g].add(
        weights, mode="promise_in_bounds"
    )


def _auto_block(m, c, n_slots, block_size):
    if isinstance(block_size, int):
        return max(1, min(block_size, c))
    # 'auto' / None → bound the one-hot temp
    return max(1, min(c, _ONEHOT_BUDGET // max(1, m * n_slots)))


def bincount2d_onehot(g, weights, n_slots, block_size="auto"):
    """One-hot contraction strategy, streamed over column blocks.

    For each block of columns: ``onehot[m, b, n] = (g[m, b] == n)`` and
    ``counts[m, n] += sum_b w[m, b] * onehot[m, b, n]``. Unweighted counts
    accumulate in int32 (exact). The weighted contraction runs at
    ``Precision.HIGHEST``: the one-hot operand is exact at any precision,
    but a GPU's default f32 dot may round the weights to TF32 (10 mantissa
    bits).
    """
    m, c = g.shape
    block = _auto_block(m, c, n_slots, block_size)
    pad = (-c) % block
    if pad:
        # Padding elements are routed to a temporary extra slot and dropped.
        g = jnp.pad(g, ((0, 0), (0, pad)), constant_values=n_slots)
        if weights is not None:
            weights = jnp.pad(weights, ((0, 0), (0, pad)))
        n_internal = n_slots + 1
    else:
        n_internal = n_slots
    n_blocks = (c + pad) // block
    dtype = _counts_dtype(weights)
    faithful = _nonfinite.faithful_mode(weights)

    slots = jnp.arange(n_internal, dtype=g.dtype)

    def step(acc, args):
        if weights is None:
            (gb,) = args
            oh = (gb[:, :, None] == slots).astype(jnp.int32)
            return acc + oh.sum(axis=1), None
        gb, wb = args
        oh = gb[:, :, None] == slots
        ohw = oh.astype(wb.dtype)
        if not faithful:
            fin = acc + jnp.einsum(
                "mb,mbn->mn", wb, ohw, preferred_element_type=wb.dtype,
                precision=_HIGHEST,
            )
            return fin, None
        # sanitize + per-slot nonfinite indicator counts (ops/nonfinite.py)
        flags = _nonfinite.weight_flags(wb)
        wbf = _nonfinite.sanitize(wb, flags)
        fin = acc[0] + jnp.einsum(
            "mb,mbn->mn", wbf, ohw, preferred_element_type=wb.dtype,
            precision=_HIGHEST,
        )
        oh_i = oh.astype(jnp.int32)
        chans = tuple(
            a + jnp.einsum("mb,mbn->mn", fl.astype(jnp.int32), oh_i)
            for a, fl in zip(acc[1:], flags)
        )
        return (fin,) + chans, None

    g_blocks = g.reshape(m, n_blocks, block).transpose(1, 0, 2)
    xs = (g_blocks,)
    if weights is not None:
        xs = (g_blocks, weights.reshape(m, n_blocks, block).transpose(1, 0, 2))
    acc0 = _zeros_varying_like((m, n_internal), dtype, g)
    if faithful:
        acc0 = (acc0,) + tuple(
            _zeros_varying_like((m, n_internal), jnp.int32, g)
            for _ in range(3)
        )
    acc, _ = jax.lax.scan(step, acc0, xs)
    if faithful:
        counts = _nonfinite.resolve(acc[0], acc[1:])
        return counts[:, :n_slots]
    return acc[:, :n_slots]


def bincount2d_sort(g, weights, n_slots):
    """Sort-based strategy: per-row sort, then bucket boundaries.

    ``counts[m, n] = pos(n+1) - pos(n)`` where ``pos(k)`` is the insertion
    point of ``k`` in the sorted row (weighted: the last value of a
    segmented sum over each slot's run). Deterministic and O(C log C).

    Histograms are additive, so a single huge row is first split into chunk
    rows that sort independently (XLA parallelizes across rows, not within
    one), and the chunk partials are summed.
    """
    m, c = g.shape
    _CHUNK = 1 << 20
    if m == 1 and c > 2 * _CHUNK:
        k = -(-c // _CHUNK)
        # Bound the transient memory: the bucket-boundary positions are
        # (rows, n_slots + 1) int32 per sorted row batch — batching ALL k
        # chunk rows at huge n_slots allocates rows × slots (2^24 slots ×
        # 256 chunk rows ≈ 17 GB). Scan over row blocks whose positions
        # stay ≤ _SORT_POS_BUDGET elements instead.
        rows_per_step = min(k, max(1, _SORT_POS_BUDGET // (n_slots + 1)))
        steps = -(-k // rows_per_step)
        k_pad = steps * rows_per_step
        pad = k_pad * _CHUNK - c
        # pad with the trash slot (n_slots - 1); subtract the padding from it
        gp = jnp.pad(g.reshape(-1), (0, pad), constant_values=n_slots - 1)
        wp = (
            jnp.pad(weights.reshape(-1), (0, pad))
            if weights is not None
            else None
        )
        if steps == 1:
            parts = bincount2d_sort(
                gp.reshape(k_pad, _CHUNK),
                wp.reshape(k_pad, _CHUNK) if wp is not None else None,
                n_slots,
            )
            total = parts.sum(axis=0, keepdims=True)
        else:
            xs = (gp.reshape(steps, rows_per_step, _CHUNK),)
            if wp is not None:
                xs += (wp.reshape(steps, rows_per_step, _CHUNK),)

            def step(acc, args):
                gb = args[0]
                wb = args[1] if wp is not None else None
                part = bincount2d_sort(gb, wb, n_slots)
                return acc + part.sum(axis=0, keepdims=True), None

            acc0 = _zeros_varying_like((1, n_slots), _counts_dtype(weights), g)
            total, _ = jax.lax.scan(step, acc0, xs)
        if weights is None and pad:
            total = total.at[0, n_slots - 1].add(-pad)
        return total
    slots = jnp.arange(n_slots + 1, dtype=g.dtype)
    if weights is None:
        gs = jnp.sort(g, axis=1)
        pos = jax.vmap(lambda row: jnp.searchsorted(row, slots, side="left"))(gs)
        return jnp.diff(pos, axis=1).astype(jnp.int32)
    if c == 0:
        return jnp.zeros((m, n_slots), weights.dtype)
    gs, ws = jax.lax.sort_key_val(g, weights, dimension=1)
    # Segmented inclusive sum over the sorted row, restarting at the first
    # element of each slot: a slot's sum involves only its own weights (no
    # global prefix sum to difference and cancel), and a NaN/inf weight
    # stays in its own slot, exactly as in a scatter-add. The scan's tree
    # order is fixed by the shape, so results repeat bit for bit.
    head = jnp.concatenate(
        [jnp.ones((m, 1), bool), gs[:, 1:] != gs[:, :-1]], axis=1
    )

    def combine(a, b):
        return jnp.where(b[1], b[0], a[0] + b[0]), a[1] | b[1]

    seg, _ = jax.lax.associative_scan(combine, (ws, head), axis=1)
    pos = jax.vmap(lambda row: jnp.searchsorted(row, slots, side="left"))(gs)
    last = jnp.clip(pos[:, 1:] - 1, 0, c - 1)
    sums = jnp.take_along_axis(seg, last, axis=1)
    return jnp.where(pos[:, 1:] > pos[:, :-1], sums, jnp.zeros((), ws.dtype))


METHODS = ("scatter", "onehot", "sort")


# ``auto`` off the CPU: sort where rows x slots is small, scatter otherwise.
# Scatter's atomic adds contend on few hot slots; sort's per-row bucket
# search grows with rows x slots. Whole histogram calls on an NVIDIA H100
# 80GB HBM3 at 400 W, ms (unweighted / weighted; certified-uniform
# digitize):
#
#   rows x cols        slots   scatter      sort         onehot
#   1 x 2**26             51   22.7 / 25.7  12.8 / 15.5  18.4 / 29.1
#   1 x 2**26           1025   15.5 / 15.6   7.5 / 10.6  258  / 268
#   1 x 2**26           4097    7.0 /  7.0   7.8 / 11.0     —
#   1000 x 100000         51   17.8 / 18.7  13.8 / 17.4  28.0 / 42.2
#   1000 x 100000        256    7.3 /  7.4   6.1 / 10.4  87.2 / 113
#   16384 x 4096          51    7.9 /  8.2  12.0 / 14.7  16.4 / 23.9
#   2**20 x 64            81    3.0 /  3.8  11.7 / 15.0  20.9 / 74.6
#   1 x 2**30 (T-S)    95201  308.9         346.8           —
#   1036800 x 365         81    6.2         36.4         90.3
#
# One row of 2**30 elements, 50 bins (H100 at 700 W): sort 116 / 148 ms,
# scatter 333 / 380 ms; the compiled programs hold 18.3 / 22.5 GB
# (sort) and 26.8 / 26.8 GB (scatter) of temporaries.
#
# onehot does O(slots) work per element and never wins by enough to keep a
# third branch.
_SORT_MAX_SLOTS = 1025
_SORT_MAX_ROW_SLOTS = 1 << 16


def auto_method(m, n_slots):
    """The strategy ``method='auto'`` runs for ``m`` rows of ``n_slots``
    slots (trash slot included)."""
    if jax.default_backend() == "cpu":
        return "scatter"  # XLA:CPU scatter is fast at every slot count
    return gpu_method(m, n_slots)


def gpu_method(m, n_slots):
    """The GPU side of ``auto_method``."""
    if n_slots <= _SORT_MAX_SLOTS and m * n_slots <= _SORT_MAX_ROW_SLOTS:
        return "sort"
    return "scatter"


def bincount2d(g, weights, n_slots, method="auto", block_size="auto"):
    """Dispatch over bincount strategies (cf. reference ``_dispatch_bincount``,
    core.py:126-134 — but dispatching on algorithm, not just blocking).
    ``method='auto'`` picks by shape (``auto_method``)."""
    if method == "auto":
        method = auto_method(g.shape[0], n_slots)
    if method == "scatter":
        return bincount2d_scatter(g, weights, n_slots)
    if method == "onehot":
        return bincount2d_onehot(g, weights, n_slots, block_size=block_size)
    if method == "sort":
        return bincount2d_sort(g, weights, n_slots)
    raise ValueError(
        f"method={method!r}: valid values are auto|{'|'.join(METHODS)}"
    )
