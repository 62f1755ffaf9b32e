"""Faithful nonfinite-weight handling, shared by all counting strategies.

The reference's inner kernel is ``np.bincount(idx, weights=w)`` (reference
core.py:81) — a scatter-add, where a NaN/±inf weight lands in *its element's
bin only*. Every matmul/einsum/cumsum reformulation of bincount instead
multiplies each weight by zero one-hot entries (NaN·0 = NaN) or subtracts
prefix sums (inf - inf = NaN), poisoning whole rows. The faithful scheme used
across this package:

  1. sanitize: nonfinite weights are replaced by 0 in the value computation;
  2. count three indicator channels per slot (NaN, +inf, -inf occurrences)
     with the *same* counting structure (so routing/trim semantics match);
  3. resolve per-slot IEEE sum semantics: any NaN → NaN, both infinities →
     NaN, one sign of infinity → that infinity, else the finite sum.

``XHIST_ASSUME_FINITE_WEIGHTS=1`` skips steps 1-3
entirely; integer weights always skip them (they cannot be nonfinite).
"""

from __future__ import annotations

import os

import jax.numpy as jnp

ASSUME_FINITE = os.environ.get("XHIST_ASSUME_FINITE_WEIGHTS", "0") == "1"


def weight_flags(w):
    """(isnan, isposinf, isneginf) boolean masks (``w != w`` is the NaN
    test)."""
    isnan = w != w
    ispos = w == jnp.asarray(jnp.inf, w.dtype)
    isneg = w == jnp.asarray(-jnp.inf, w.dtype)
    return isnan, ispos, isneg


def sanitize(w, flags):
    """Zero out nonfinite weights (their slots are fixed up by resolve)."""
    isnan, ispos, isneg = flags
    return jnp.where(isnan | ispos | isneg, jnp.asarray(0, w.dtype), w)


def resolve(counts, channels):
    """Apply per-slot IEEE sum semantics from the finite part + indicator
    counts. ``channels`` is None (no-op) or a (nan_c, pos_c, neg_c) triple of
    arrays shaped like ``counts``; only their sign matters."""
    if channels is None:
        return counts
    nan_c, pos_c, neg_c = channels
    dt = counts.dtype
    inf = jnp.asarray(jnp.inf, dt)
    out = jnp.where(pos_c > 0, inf, counts)
    out = jnp.where(neg_c > 0, -inf, out)
    bad = (nan_c > 0) | ((pos_c > 0) & (neg_c > 0))
    return jnp.where(bad, jnp.asarray(jnp.nan, dt), out)


def faithful_mode(weights):
    """Whether faithful handling applies: floating weights, opt-out unset."""
    return (
        weights is not None
        and not ASSUME_FINITE
        and jnp.issubdtype(jnp.asarray(weights).dtype, jnp.floating)
    )
