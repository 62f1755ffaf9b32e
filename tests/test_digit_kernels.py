"""Per-digit-output device passes — the single-pass multi-digit engine.

The exact wide-integer / f64 weight engine decomposes weights into signed
base-2**32 WORDS host-side (intweights.host_words) and runs ONE device
pass per word: the pipeline extracts up to 5 signed base-256 digits behind
a single digitize and emits each digit's per-slot int32 sums as its own
output (no shift-combine). These tests run every counting strategy over
one- to two-input shapes, with a per-digit numpy oracle.
"""

import numpy as np
import pytest

from xhistogram_tpu.core import _histogram_digits, histogram
from xhistogram_tpu.ops import intweights as iw


def _np_joint_per_row(arrays2d, edges_list, w2d):
    """(m, *nbins) weighted joint histogram oracle."""
    m = arrays2d[0].shape[0]
    rows = []
    for r in range(m):
        h, _ = np.histogramdd(
            np.stack([a[r].astype("f8") for a in arrays2d], axis=-1),
            bins=edges_list,
            weights=w2d[r].astype("f8"),
        )
        rows.append(h)
    return np.stack(rows)


CASES = [
    # (label, n_inputs, m, c, nbins)
    ("one_input", 1, 1, 3000, (12,)),
    ("joint2", 2, 1, 3000, (9, 11)),
    ("many_bins", 1, 1, 3000, (1500,)),
    ("joint2_rows", 2, 4, 512, (9, 11)),
    ("joint2_rows_narrow", 2, 4, 64, (20, 20)),
    ("large_grid_rows", 2, 6, 64, (150, 90)),
]


@pytest.mark.parametrize("family,n_inputs,m,c,nbins", CASES)
@pytest.mark.parametrize("n_dig", [1, 3, 5])
@pytest.mark.parametrize("method", ["scatter", "onehot", "sort"])
def test_dig_kernels_per_family(family, n_inputs, m, c, nbins, n_dig,
                                method):
    rng = np.random.RandomState(sum(map(ord, family)) * 7 + n_dig)
    arrays = [rng.rand(m, c).astype("f4") for _ in range(n_inputs)]
    edges = [np.linspace(0.0, 1.0, nb + 1) for nb in nbins]
    span = iw.digit_span(n_dig)
    lo = max(span[0], -(2**31)) + 1
    hi = min(span[1], 2**31 - 1)
    word = rng.randint(lo, hi + 1, size=(m, c)).astype(np.int32)
    out = np.asarray(
        _histogram_digits(
            arrays, edges, word, n_dig, block_size="auto",
            method=method,
        )
    )
    assert out.dtype == np.int32
    assert out.shape == (n_dig, m) + nbins
    digits = iw.host_digits(word.astype(np.int64), n_dig)
    for k in range(n_dig):
        want = _np_joint_per_row(arrays, edges, digits[k])
        np.testing.assert_array_equal(out[k], want.astype(np.int64))


@pytest.mark.parametrize("method", ["auto", "scatter", "onehot", "sort"])
def test_wide_engine_all_methods_exact(method):
    """The full wide-int64 engine (words + per-digit passes) is exact under
    every counting method."""
    rng = np.random.RandomState(7)
    a = rng.rand(2, 600).astype("f4")
    edges = np.linspace(0.0, 1.0, 7)
    w = rng.randint(-(2**62), 2**62, size=(2, 600)).astype(np.int64)
    h, _ = histogram(a, bins=[edges], axis=1, weights=w, method=method)
    assert h.dtype == np.int64
    # python-int oracle, compared mod 2**64 (600 weights of ~2**62 can
    # overflow int64 — the engine's contract is the dtype's own wrap)
    for r in range(2):
        idx = np.searchsorted(edges, a[r].astype("f8"), side="right") - 1
        idx[a[r].astype("f8") == edges[-1]] = len(edges) - 2
        want = [0] * 6
        for i, wv in zip(idx, w[r]):
            if 0 <= i < 6:
                want[i] += int(wv)
        assert [int(x) % 2**64 for x in h[r]] == [v % 2**64 for v in want]


def test_wide_engine_extreme_int64_three_words():
    """Full-range int64 weights need a third word (the signed base-2**32
    extraction's top carry) — exactness at the dtype extremes."""
    a = np.array([0.25, 0.25, 0.75], "f4")
    w = np.array([2**63 - 1, 1, -(2**63)], np.int64)
    h, _ = histogram(a, bins=[np.array([0.0, 0.5, 1.0])], weights=w)
    # 2**63 - 1 + 1 wraps to -2**63 in int64 (the dtype's own contract)
    assert list(h) == [-(2**63), -(2**63)]
    w = np.array([2**64 - 1, 1, 2**63], np.uint64)
    h, _ = histogram(a, bins=[np.array([0.0, 0.5, 1.0])], weights=w)
    assert h.dtype == np.uint64
    assert list(h) == [0, 2**63]  # mod-2**64 wrap, exact


def test_host_words_reconstruction():
    rng = np.random.RandomState(11)
    vals = np.concatenate([
        rng.randint(-(2**62), 2**62, 500),
        np.array([2**63 - 1, -(2**63), -1, 0, 1, 2**31, -(2**31),
                  2**31 - 1, 2139062143, 2139062144], np.int64),
    ]).astype(np.int64)
    words = iw.host_words(vals)
    assert all(w.dtype == np.int32 for w in words)
    recon = np.zeros(len(vals), object)
    for j, w in enumerate(words):
        recon += w.astype(object) * (2**(32 * j))
    assert all(int(r) == int(v) for r, v in zip(recon, vals))


@pytest.mark.parametrize(
    "bad", ["int2", "dig3", "split", "highest", "i8", "i8x3", ""]
)
def test_public_precision_rejects_removed_and_internal_modes(bad):
    """Only None and 'f64' are accepted; the error names them."""
    a = np.array([0.1, 0.6], "f4")
    e = np.array([0.0, 0.5, 1.0])
    w = np.array([1.0, 2.0], "f4")
    with pytest.raises(ValueError, match="valid values are None .* 'f64'"):
        histogram(a, bins=[e], weights=w, precision=bad)
