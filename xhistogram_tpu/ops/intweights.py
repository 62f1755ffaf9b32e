"""Exact integer-weight support: signed base-256 digit decomposition.

The reference passes weights straight into ``np.bincount``, which sums them
in float64 (reference core.py:81) — exact for integer weights up to 2**53.
This framework does better: integer weights stay INTEGRAL end-to-end.

In-range (int32/uint32) weights accumulate in int32 on the device —
bit-exact modulo 2**32, which IS the int32/uint32 output contract
(two's-complement wrap, the same result a C int32 accumulator gives).
The digit algebra defined here serves the wider weights:

  - the wide paths (numpy int64/uint64 weights beyond a lossless int32
    view) decompose HOST-side into int32 digit arrays, run one int32-weight
    histogram per digit over reduce-chunks small enough that every per-slot
    digit sum is exactly representable in int32 (|digit| ≤ 128, chunk ≤
    2**23 ⇒ |sum| ≤ 2**30), and recombine in 64-bit host arithmetic —
    exact int64/uint64 results wherever the true sums fit the dtype
    (beyond, they wrap mod 2**64 exactly like the dtype's own arithmetic;
    the reference's float64 path loses exactness already at 2**53).

Digit representation: w = Σ_j d_j·256**j with every d_j ∈ [-128, 127].
n digits span [-128·S_n, 127·S_n], S_n = (256**n - 1)/255 — so full int32
needs 5 digits.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "WORD_MAX_DIGITS",
    "digit_span",
    "digits_for_bounds",
    "host_digits",
    "host_words",
    "combine_digit_sums",
]

#: host-side digit cap: 9 signed base-256 digits span ±0.498·2**72, covering
#: every int64/uint64 value (via the two's-complement int64 view)
HOST_MAX_DIGITS = 9

#: digit cap of one int32 WORD under the per-digit-output device pass: 4 signed digits span ±128·S₄ ≈ ±0.502·2**32, which misses the
#: top of int32 ((2139062144, 2**31) needs a 5th digit worth a multiple of
#: 2**32 — the extraction's remainder lands in {-1, 0, 1}), so 5 digits
#: cover every int32 exactly (d₄ ∈ {-1, 0, 1})
WORD_MAX_DIGITS = 5


def digit_span(n_digits):
    """Inclusive (lo, hi) value range representable by ``n_digits`` signed
    base-256 digits, each in [-128, 127]."""
    s = (256**n_digits - 1) // 255
    return -128 * s, 127 * s


def digits_for_bounds(lo, hi, max_digits=HOST_MAX_DIGITS):
    """Minimal digit count whose span covers [lo, hi] (python ints)."""
    lo, hi = int(lo), int(hi)
    for n in range(1, max_digits + 1):
        dlo, dhi = digit_span(n)
        if dlo <= lo and hi <= dhi:
            return n
    raise ValueError(
        f"integer weights in [{lo}, {hi}] exceed {max_digits} signed "
        f"base-256 digits"
    )


def _extract_digit(rem):
    """One overflow-safe extraction step: returns ``(digit, rem')`` with
    digit ∈ [-128, 127], rem' = (rem - digit)/256 exactly. Works for numpy
    int64 arrays at the full dtype range (the naive ``((rem+128)&255)-128``
    wraps at the top of the dtype)."""
    hi = rem >> 8  # floor division by 256 (arithmetic shift)
    low = rem - (hi << 8)  # in [0, 255]
    adj = (low >= 128).astype(rem.dtype)
    digit = low - adj * 256
    return digit, hi + adj


def host_digits(w, n_digits):
    """Signed base-256 digit arrays (int32 each) of an integer numpy array.

    uint64 inputs are decomposed through their two's-complement int64 view —
    the digits reconstruct the value mod 2**64, which the uint64 combine
    (also mod 2**64) makes exact.
    """
    if w.dtype == np.uint64:
        rem = w.view(np.int64)
    else:
        rem = w.astype(np.int64, copy=False)
    digits = []
    for _ in range(n_digits - 1):
        d, rem = _extract_digit(rem)
        digits.append(d.astype(np.int32))
    digits.append(rem.astype(np.int32))
    # the host chose n_digits from min/max, so the top limb must be in
    # digit range — anything else is a decomposition bug, not bad input
    assert int(digits[-1].min(initial=0)) >= -128
    assert int(digits[-1].max(initial=0)) <= 127
    return digits


def host_words(w):
    """Signed base-2**32 WORD arrays (int32 each) of an integer numpy
    array: ``w == Σ_j words[j]·2**(32j)`` exactly (uint64 decomposes
    through its two's-complement int64 view; the uint64 combine mod 2**64
    makes that exact, as with ``host_digits``).

    This is the single-pass multi-digit engine's host packing: each word
    rides ONE per-digit-output device pass (one shared digitize, one
    count per digit), so full-range int64 weights cost 2-3 digitizes
    instead of host_digits' 8-9. The extraction mirrors
    ``_extract_digit`` at base 2**32: low ∈ [0, 2**32) with values ≥ 2**31
    borrowing from the next word, so every word is exactly representable
    in int32 and word j of the extreme int64s lands in {-1, 0, 1} at
    j == 2 (at most 3 words ever).
    """
    if w.dtype == np.uint64:
        rem = w.view(np.int64)
    else:
        rem = w.astype(np.int64, copy=False)
    # Sparse fast path: the exact-f64 tier feeds one K array per exponent
    # group, zero outside the group's members — extraction on the nonzero
    # subset + a scatter back is O(group size), not O(n) per group
    # (doc/perf_model.md headroom: host-side f64 prep). Dense inputs
    # (the wide-int path) skip this on the nnz check.
    if rem.size >= (1 << 18):
        flat = np.ascontiguousarray(rem).reshape(-1)
        idx = np.flatnonzero(flat)
        if idx.size * 4 < flat.size:
            out = []
            for sw in host_words(flat[idx]):
                full = np.zeros(rem.size, np.int32)
                full[idx] = sw
                out.append(full.reshape(w.shape))
            return out
    words = [np.zeros(w.shape, np.int32)] if rem.size == 0 else []
    while rem.size:
        low = rem & np.int64(0xFFFFFFFF)  # [0, 2**32)
        adj = (low >= np.int64(1) << 31).astype(np.int64)
        word = low - (adj << 32)  # [-2**31, 2**31)
        rem = (rem >> 32) + adj  # arithmetic shift: exact floor(rem/2**32)
        words.append(word.astype(np.int32))
        if not rem.any():
            break
    return words


def combine_digit_sums(parts, unsigned):
    """Σ_j parts[j]·256**j in exact mod-2**64 arithmetic.

    ``parts`` — per-digit int64-exact slot sums (numpy, any shape).
    Accumulates in uint64 (numpy unsigned arithmetic wraps mod 2**64 by
    definition); signed results are the int64 two's-complement view.
    """
    total = np.zeros(np.broadcast_shapes(*[p.shape for p in parts]), np.uint64)
    for j, p in enumerate(parts):
        mult = np.uint64((256**j) % (1 << 64))
        total = total + p.astype(np.int64).astype(np.uint64) * mult
    return total if unsigned else total.view(np.int64)
