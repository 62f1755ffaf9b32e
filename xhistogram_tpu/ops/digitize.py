"""Digitize + joint-bin indexing (jnp reference implementations).

Semantics contract (identical to reference core.py:157-192, verified by the
oracle tests against numpy):

  ``digitize_edges(a, edges)`` returns, per element, an index in
  ``[0, len(edges)]`` with numpy-``searchsorted(side="right")`` semantics plus
  the histogram right-edge fixup:

    - 0              → a <  edges[0]            (below range)
    - i              → edges[i-1] <= a < edges[i]
    - len(edges)-1   → edges[-2]  <= a <= edges[-1]  (last bin closed)
    - len(edges)     → a >  edges[-1] or NaN    (above range; trimmed later)

  NaN routing is explicit: numpy's sort order places NaN last, so
  ``np.searchsorted`` sends NaN to the overflow slot; a naive branchless
  compare-sum would send it to 0 instead (SURVEY.md §7 "hard parts"), so we
  ``where(isnan, overflow, ...)``.

  ``joint_bin_index`` fuses the reference's out-of-range trim
  (core.py:189-192) into the index computation: instead of counting into
  ``prod(len(edges_i)+1)`` slots and slicing ``[1:-1]`` per axis afterwards, a
  single trailing *trash slot* receives every element that is out of range (or
  NaN) on any input, and the trash column is dropped after counting. The
  surviving slot space is exactly the trimmed histogram, bit-identical to the
  reference's trim.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from .. import bins as _bins
from .ftz import fix_neg_subnormals

__all__ = ["digitize_edges", "digitize_uniform", "joint_bin_index"]

# Digitize form selection. Two forms give identical indices:
# ``jnp.searchsorted`` (a binary search per element) and the O(1)
# certified-uniform digitize (``digitize_uniform``, only for inputs whose
# edges carry a host-verified uniform-spacing certificate). Measured on
# (1000, 100000) f32 on an NVIDIA H100 80GB HBM3 at 700 W, ms per call,
# certificate values as traced operands:
#
#   edges   searchsorted  uniform (tier)
#      11       5.48        0.68 (arith)
#      51       8.02         —   (no certificate)
#      65       9.05        0.67 (arith)
#      81       9.19        1.33 (double-single)
#     281      11.41        1.44 (double-single)
#     341      11.29        1.23 (double-single)
#   16385      18.67        0.60 (arith)
#
# So the certified-uniform form runs wherever a certificate exists, and
# searchsorted everywhere else.
UNIFORM_DIGITIZE = True  # off: every input takes searchsorted (tests)


def uniform_wanted(form, n_hi_clip):
    """Whether the digitize consumes this input's uniform certificate."""
    if form is None or not UNIFORM_DIGITIZE:
        return False
    return not n_hi_clip  # the top-value clip needs the edge compares


def uniform_operands(form):
    """Split a uniform certificate (bins.uniform_form) into its static
    structure and its values.

    The structure (the tier; for the double-single tier, the exception
    count rounded up to a power of two) keys the compiled program. The
    values enter it as one float32 operand vector, so same-shaped calls
    over different grids share one compile. Every certified value is a
    float32 (or, for D <= 2**22, an integer) exactly, so the vector holds
    it without rounding; the arith tier's 1/d is rounded to float32, as
    the digitize has always used it.
    """
    if isinstance(form[0], str):
        _, t0, t0l, inv, D, b1, b2, bl1, bl2, t_last, exc = form
        n_exc = 1 << (len(exc) - 1).bit_length() if exc else 0
        # a padding entry (0, 0, not strict) adds [x >= 0] - [x >= 0] = 0
        exc = list(exc) + [(0.0, 0.0, False)] * (n_exc - len(exc))
        vals = [t0, t0l, inv, D, b1, b2, bl1, bl2, t_last]
        vals += [t for t, _, _ in exc] + [f for _, f, _ in exc]
        vals += [float(s) for _, _, s in exc]
        return ("ds", n_exc), np.asarray(vals, np.float32)
    t0, d, t_last = form
    return ("arith",), np.asarray([t0, d, 1.0 / d, t_last], np.float32)


def digitize_edges(a, edges, dtype=jnp.int32, n_hi_clip=0):
    """Vectorized searchsorted-right against *half-open comparison edges*.

    ``edges`` must be sorted ascending and already in the half-open
    comparison form produced by ``bins.compare_form`` (the closed last
    bin is encoded as an open upper bound, so no equality fixup is needed —
    same final semantics as reference core.py:163-174). Works elementwise on
    any-shaped ``a``; returns ``dtype`` indices in ``[0, len(edges)]``.

    ``n_hi_clip`` (static, from ``bins.compare_form``): number of thresholds
    whose true value lies *above* the dtype's top value (int max / +inf) and
    were clamped to it. Such a threshold is never really ≤ any value, but the
    clamped edge compares ≤ the top value itself — so elements equal to the
    top value subtract the count. This keeps e.g. ``a == iinfo.max`` in the
    closed last bin when the last edge is at or beyond the dtype max (exact
    numpy parity at the dtype boundary).
    """
    edges = jnp.asarray(edges)
    n_edges = edges.shape[0]
    # FTZ exactness fix (ops/ftz.py): keeps a negative-subnormal value on
    # the correct side of a t == 0.0 threshold on a device that flushes
    # subnormal compare operands.
    a = fix_neg_subnormals(a)
    idx = jnp.searchsorted(edges, a, side="right").astype(dtype)
    if n_hi_clip:
        if jnp.issubdtype(a.dtype, jnp.floating):
            top = jnp.asarray(jnp.inf, a.dtype)
        else:
            top = jnp.asarray(jnp.iinfo(a.dtype).max, a.dtype)
        idx = idx - jnp.asarray(n_hi_clip, dtype) * (a == top).astype(dtype)
    if jnp.issubdtype(a.dtype, jnp.floating):
        # numpy sorts NaN after +inf → overflow slot (reference behavior:
        # NaNs digitize to the top slot then get trimmed, SURVEY.md §2.1).
        idx = jnp.where(jnp.isnan(a), jnp.asarray(n_edges, dtype), idx)
    return idx


def _digitize_uniform_arith(a, vals, ne):
    """O(1)-in-edge-count digitize for HOST-VERIFIED uniform thresholds
    (bins.uniform_arith_form): arithmetic candidate index + a ±2 window of
    exactly-recomputed thresholds + one scalar compare against the
    (half-open-nudged) last threshold. Bit-identical to ``searchsorted``
    against the comparison-form thresholds under the host contract:

      - T[k] == f32(k*d + t0) for k < ne-1 with k*d exact in f32 (so the
        recompute is FMA-contraction-independent);
      - ulp(max|T|) <= d/4, so the candidate+threshold rounding error is
        < 1.3 index units and the ±2 window provably brackets the true
        count;
      - integer data only when |T| < 2^23 (the int→f32 cast cannot cross
        a threshold).

    ``vals`` is ``[t0, d, f32(1/d), t_last]`` (``uniform_operands``).
    About 25 elementwise ops per element, whatever the edge count.
    """
    x = fix_neg_subnormals(a.astype(jnp.float32))
    nu = ne - 1  # uniform thresholds; T[ne-1] handled separately
    t0f, df, inv, t_last = vals[0], vals[1], vals[2], vals[3]
    # clamp in the FLOAT domain before the int cast: f32->s32 conversion of
    # values beyond int32 range (|x - t0| >= 2^31 * d, or +-inf) is
    # backend-defined (saturate vs wrap); the clamp makes the candidate
    # well-defined everywhere for one extra op (NaN still propagates —
    # the final x == x select discards it)
    y = jnp.clip((x - t0f) * inv, jnp.float32(0.0), jnp.float32(nu))
    kc = jnp.floor(y).astype(jnp.int32)
    if nu >= 5:
        # clamp the candidate so the ±2 window is always in-bounds: the
        # out-of-range cases are decided entirely by the window compares
        # (below range → all False; above → all True), so the per-j bounds
        # guards disappear (2 int ops x 5 steps saved per element)
        kc = jnp.clip(kc, 2, nu - 3)
        idx = kc - 2  # thresholds below the window: all <= x
        for j in range(5):
            kj = kc - 2 + j
            tj = t0f + kj.astype(jnp.float32) * df
            idx = idx + (x >= tj).astype(jnp.int32)
    else:
        kc = jnp.clip(kc, 0, nu - 1)
        idx = jnp.clip(kc - 2, 0, nu)
        for j in range(5):
            kj = kc - 2 + j
            tj = t0f + kj.astype(jnp.float32) * df
            cnt = (x >= tj) & (kj >= 0) & (kj < nu)
            idx = idx + cnt.astype(jnp.int32)
    idx = idx + (x >= t_last).astype(jnp.int32)
    # NaN: every compare is False but the candidate arithmetic is garbage —
    # return 0 (below range), which joint_bin_index routes to the trash slot
    return jnp.where(x == x, idx, 0)


def _digitize_uniform_ds(a, vals, n_exc, ne):
    """O(1)-in-edge-count digitize for GENERIC uniform float32 threshold
    grids (bins.uniform_ds_form — e.g. np.linspace(-4, 4, 91)-scale grids
    whose spacing is not exactly representable, which the exact form
    above rejects). Same candidate + clamped ±2 window structure, but each
    window threshold is recomputed in double-single arithmetic:

      k = khi + klo (12/12 bit split) makes khi*b1, khi*b2, klo*b1, klo*b2
      all EXACT f32 products (b1/b2 are the host's 12-bit split of the
      f32 spacing; bl1/bl2 the same split of its f64 residual — EVERY
      product in the model is exact, so XLA-CPU FMA contraction cannot
      change a bit; a barrier-protected rounding product is not an
      option, XLA strips bitcast round-trips); t0 is itself a hi+lo pair
      carrying the ORIGINAL f64 first edge (the thresholds' own f32
      rounding would inject ~1-ulp slope error — the model must anchor to
      the f64 edges); an exact TwoSum against t0 absorbs cancellation at
      the grid's zero crossing, with t0l folded into the tail. Accuracy
      before the final rounding is ~2^-45 relative. compare_form
      thresholds are the ROUNDUP of the f64 edge, so the decision is
      ``[x >= F0] - [x == F0 and rho > 0]`` where rho is the Fast2Sum
      residual of the final rounding (effective threshold nextup(F0) when
      the true edge lies above the reconstruction) — no nextafter needed
      on the device. The host certified the effective threshold equals the
      true one at EVERY k except the exception list ((T_k, F0_k,
      strict_k) triples, ``n_exc`` of them after padding), corrected per
      entry with
      ``[x >= T_k] - model_k(x)`` — a global fixup: in-window occurrences
      cancel the model term exactly, and certified bracketing makes
      out-of-window model compares equal their assumed constants.

    About 150 elementwise ops per element, whatever the edge count.
    Bit-exactness is certified by construction: the
    host emulated THIS op sequence (bins._ds_window_model/_ds_candidate)
    against every threshold, with FTZ-flush and candidate-slack guards.
    """
    x = fix_neg_subnormals(a.astype(jnp.float32))
    nu = ne - 1
    t0f, t0lf, invf, b1f, b2f, bl1f, bl2f, t_last = (
        vals[i] for i in (0, 1, 2, 4, 5, 6, 7, 8)
    )
    D = vals[3].astype(jnp.int32)  # an integer <= 2**22: exact in f32
    # the t0l correction the candidate needs on far-offset grids
    # (|t0| >> span) is applied as an INTEGER subtraction: in float, XLA
    # constant-folds (x - t0) - t0l to x - fl(t0 + t0l) == x - t0 and the
    # correction vanishes (bins._ds_candidate mirrors this op sequence)
    y = jnp.clip(
        (x - t0f) * invf, jnp.float32(0.0),
        jnp.float32(float(_bins._DS_CAND_CLIP))
    )
    kc = jnp.clip(
        jnp.floor(y).astype(jnp.int32) - D, 2, nu - 3
    )
    idx = kc - 2  # thresholds below the window: all <= x (certified)
    for j in range(5):
        kj = kc - 2 + j
        khi = (kj & jnp.int32(~0xFFF)).astype(jnp.float32)
        klo = (kj & jnp.int32(0xFFF)).astype(jnp.float32)
        p1 = khi * b1f  # ALL products exact -> FMA-stable by construction
        c1 = khi * b2f
        c2 = klo * b1f
        p3 = klo * b2f
        q1 = khi * bl1f
        q2 = khi * bl2f
        q3 = klo * bl1f
        q4 = klo * bl2f
        # error-free Fast2Sum chain over the exact products (ordering
        # certified host-side; bins._ds_window_model mirrors every op)
        s1 = p1 + c2
        r1 = c2 - (s1 - p1)
        s2 = s1 + c1
        r2 = c1 - (s2 - s1)
        s3 = s2 + p3
        r3 = p3 - (s3 - s2)
        s4 = s3 + t0f  # TwoSum(s3, t0h): branch-free, no ordering needed
        bb = s4 - s3
        r4 = (s3 - (s4 - bb)) + (t0f - bb)
        tail = ((((((((r1 + r2) + r3) + r4) + q1) + q2) + q3) + q4)
                + t0lf)
        f0 = s4 + tail
        rho = tail - (f0 - s4)  # Fast2Sum residual: sign directs rounding
        cnt = (x >= f0) & ~((x == f0) & (rho > jnp.float32(0.0)))
        idx = idx + cnt.astype(jnp.int32)
    exc = vals[9:].reshape(3, n_exc)  # T_k, F0_k, strict_k rows
    for i in range(n_exc):
        fm = exc[1, i]
        mc = (x >= fm) & ~((x == fm) & (exc[2, i] > 0))
        idx = idx + (
            (x >= exc[0, i]).astype(jnp.int32) - mc.astype(jnp.int32)
        )
    idx = idx + (x >= t_last).astype(jnp.int32)
    return jnp.where(x == x, idx, 0)


def digitize_uniform(a, key, vals, ne):
    """Digitize against a uniform-spacing certificate split by
    ``uniform_operands`` into its structure ``key`` and values ``vals``:
    ``("arith",)`` -> exact arithmetic digitize; ``("ds", n_exc)`` ->
    double-single digitize for generic grids."""
    vals = jnp.asarray(vals, jnp.float32)
    if key[0] == "ds":
        return _digitize_uniform_ds(a, vals, key[1], ne)
    return _digitize_uniform_arith(a, vals, ne)


def joint_bin_index(indices, nbins):
    """Combine per-input digitize indices into a flat *trimmed* joint index.

    Parameters
    ----------
    indices : list of equally-shaped integer arrays in ``[0, len(edges_i)]``
        (raw digitize output, per input).
    nbins : list of int — number of *real* bins per input,
        ``len(edges_i) - 1``.

    Returns
    -------
    g : flat joint index in ``[0, n_slots)``, where the last slot
        (``n_slots - 1``) is the trash slot for any out-of-range/NaN element.
    n_slots : ``prod(nbins) + 1`` (static int).
    """
    assert len(indices) == len(nbins) and len(indices) >= 1
    g = None
    valid = None
    for idx, nb in zip(indices, nbins):
        t = idx - 1  # slot 1..nb maps to bin 0..nb-1
        ok = (t >= 0) & (t <= nb - 1)
        valid = ok if valid is None else (valid & ok)
        t = jnp.clip(t, 0, nb - 1)
        g = t if g is None else g * nb + t
    n_real = math.prod(int(nb) for nb in nbins)
    if n_real + 1 > jnp.iinfo(jnp.int32).max:
        raise ValueError(
            f"joint histogram has {n_real} bins, which overflows int32 indexing"
        )
    g = jnp.where(valid, g, n_real)
    return g.astype(jnp.int32), n_real + 1
