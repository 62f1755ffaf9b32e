"""Flush-to-zero exactness fix for the digitize (ops/digitize.py).

One definition, so every digitize form applies the same rewrite.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["fix_neg_subnormals"]


def fix_neg_subnormals(x):
    """FTZ exactness fix (f32 only). XLA:CPU flushes subnormal compare
    operands to ±0, so a negative-subnormal data value would land on the
    wrong side of a t == 0.0 threshold — the one representable threshold
    between it and its flushed value (thresholds strictly inside
    (-tiny, 0) are subnormal themselves and already take the exact host
    path, core.ftz_exact_fallback). XLA:GPU does not flush them (measured
    on an NVIDIA H100; tests/test_chip.py checks it), so there the rewrite
    changes no result. Rewrite negative subnormals to -tiny_normal via
    BITWISE detection (integer ops don't flush): every comparison against
    every representable non-subnormal threshold is unchanged. NaN/±inf/-0.0
    untouched. A few integer ops per element, fused into the digitize."""
    if x.dtype != jnp.float32:
        return x
    xi = jax.lax.bitcast_convert_type(x, jnp.int32)
    mag = xi & jnp.int32(0x7FFFFFFF)
    neg_subn = (xi < 0) & (mag != 0) & (mag < jnp.int32(0x00800000))
    return jnp.where(neg_subn, jnp.float32(-1.1754943508222875e-38), x)
