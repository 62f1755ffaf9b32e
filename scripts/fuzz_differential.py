"""Randomized differential fuzz: every method vs the numpy oracle over
random shapes/axes/dtypes/bins/weights/density configs. Standalone hunter
(run long with --n); tests/test_fuzz_differential.py runs a seeded slice.

Usage: PYTHONPATH=/root/repo JAX_PLATFORMS=cpu python scripts/fuzz_differential.py [--n 300]
"""

import argparse
import sys

import numpy as np


def oracle(arrays, edges, axis, weights, density):
    a0 = arrays[0]
    if axis is None:
        flat = [a.ravel() for a in arrays]
        w = weights.ravel() if weights is not None else None
        h, _ = np.histogramdd(np.stack(flat, -1), bins=edges, weights=w,
                              density=density)
        return h
    kept = [i for i in range(a0.ndim) if i not in axis]
    kshape = [a0.shape[i] for i in kept]
    a2 = [np.moveaxis(a, axis, tuple(range(-len(axis), 0))).reshape(
        int(np.prod(kshape)) if kshape else 1, -1) for a in arrays]
    w2 = (np.moveaxis(weights, axis, tuple(range(-len(axis), 0))).reshape(
        a2[0].shape) if weights is not None else None)
    outs = []
    for r in range(a2[0].shape[0]):
        h, _ = np.histogramdd(
            np.stack([a[r] for a in a2], -1), bins=edges,
            weights=w2[r] if w2 is not None else None, density=density,
        )
        outs.append(h)
    out = np.stack(outs)
    return out.reshape(kshape + list(out.shape[1:])) if kshape else out[0]


def one_case(rng, case_idx, methods):
    from xhistogram_tpu.core import histogram

    ndim = rng.randint(1, 4)
    shape = tuple(rng.randint(1, 7) for _ in range(ndim))
    # mostly 1-2 inputs; occasionally 3 (the factored joint route)
    n_inputs = 1 + int(rng.rand() < 0.4) + int(rng.rand() < 0.15)
    dtype = rng.choice(["f4", "f8", "i4", "i8"])
    if dtype in ("f4", "f8"):
        arrays = [
            (rng.randn(*shape) * rng.uniform(0.1, 10)).astype(dtype)
            for _ in range(n_inputs)
        ]
        if rng.rand() < 0.3:
            for a in arrays:
                a.flat[rng.randint(0, a.size)] = rng.choice(
                    [np.nan, np.inf, -np.inf]
                )
    else:
        arrays = [
            rng.randint(-50, 50, shape).astype(dtype)
            for _ in range(n_inputs)
        ]
    edges = []
    for a in arrays:
        ne = rng.randint(2, 7)
        r = rng.rand()
        if r < 0.35:
            e = np.sort(rng.uniform(-15, 15, ne))
        elif r < 0.7:
            e = np.sort(rng.randint(-20, 20, ne)).astype("i8")
        else:
            # uniform (often certifiable) grid — exercises the arithmetic/
            # DS digitize tiers (and, with them switched off, searchsorted)
            ne = rng.randint(2, 260)
            e = np.linspace(
                rng.uniform(-20, 0), rng.uniform(0.5, 20), ne
            )
        while len(np.unique(e)) < 2:
            e = np.sort(rng.uniform(-15, 15, ne))
        edges.append(e)
    axis = None
    if rng.rand() < 0.6 and ndim > 0:
        k = rng.randint(1, ndim + 1)
        axis = tuple(sorted(rng.choice(ndim, size=k, replace=False).tolist()))
        if len(axis) == ndim and rng.rand() < 0.5:
            axis = None
    weights = None
    int_w = False
    if rng.rand() < 0.5:
        r = rng.rand()
        if r < 0.6:
            weights = rng.rand(*shape).astype("f4") * 3
        elif r < 0.85:
            # integer weights, totals well inside int32 (exact everywhere,
            # fused digit kernels vs scatter vs the f64 oracle)
            weights = rng.randint(-(10**6), 10**6, shape).astype(
                rng.choice(["i1", "i2", "i4"])
            )
            int_w = True
        else:
            # wide int64 weights (the exact host digit path); magnitudes
            # kept < 2**50 so the f64 oracle itself stays exact
            weights = rng.randint(-(2**12), 2**12, shape).astype(
                "i8"
            ) * np.int64(2**38) + rng.randint(-100, 100, shape)
            int_w = True
    density = rng.rand() < 0.3 and weights is None
    # per-call weighted precision: f32 sums (None) or the exact-f64 tier
    precision = None
    f64_w = False
    if weights is not None and not int_w and rng.rand() < 0.3:
        # exact-f64 tier: wide-exponent POSITIVE float64 weights (no
        # cancellation, so the f64 oracle itself stays well-conditioned
        # and a tight tolerance is meaningful; exactness incl.
        # cancellation is pinned by tests/test_f64_weights.py's
        # rational oracle)
        weights = np.abs(rng.randn(*shape)) * 10.0 ** rng.uniform(
            -15, 15, shape
        )
        precision = "f64"
        f64_w = True

    exp = oracle(arrays, edges, axis, weights, density)
    fails = []
    for method in methods:
        try:
            h, _ = histogram(
                *arrays, bins=edges, axis=axis, weights=weights,
                density=density, method=method, precision=precision,
            )
        except NotImplementedError:
            continue
        got = np.asarray(h)
        if (weights is None or int_w) and not density:
            # integer results are exact; the f64 oracle is exact at the
            # drawn magnitudes, so equality must be bitwise
            ok = np.array_equal(got.astype("f8"), exp)
        elif f64_w:
            # our result is correctly rounded; the oracle's own error is
            # O(n·eps64) on these well-conditioned positive sums
            ok = np.allclose(got, exp, rtol=1e-12, atol=0, equal_nan=True)
        else:
            ok = np.allclose(got, exp, rtol=2e-4, atol=1e-5, equal_nan=True)
        if not ok:
            fails.append((method, got, exp))
    if fails:
        print(f"FAIL case {case_idx}: shape={shape} n={n_inputs} "
              f"dtype={dtype} axis={axis} w={weights is not None} "
              f"d={density} prec={precision} edges={[list(e) for e in edges]}")
        for method, got, exp2 in fails:
            print(f"  {method}: got {got.ravel()[:10]} exp {exp2.ravel()[:10]}")
        return False
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.RandomState(args.seed)
    methods = ["auto", "scatter", "onehot", "sort"]
    bad = 0
    for i in range(args.n):
        if not one_case(rng, i, methods):
            bad += 1
        if (i + 1) % 20 == 0:
            # every config is a fresh trace; unbounded compilation caches
            # OOM the LLVM JIT after a few hundred cases
            import jax

            jax.clear_caches()
            print(f"... {i+1}/{args.n} ({bad} failures)", flush=True)
    print(f"done: {args.n} cases, {bad} failures", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
