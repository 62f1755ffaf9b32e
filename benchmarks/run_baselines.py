"""The five BASELINE.md benchmark configs, end to end.

Measures the JAX build against the reference algorithm's numpy path (the
exact searchsorted + ravel_multi_index + bincount pipeline of the
reference's core.py:73-186), printing one JSON line per config, each naming
its device. Scale with --scale (default 1.0; bench.py runs config 3 at the
full 2**30-pair scale separately).

Usage: python benchmarks/run_baselines.py [--scale S] [--method M]
"""

import argparse
import json
import sys
import time

import numpy as np


def _time(f, reps=3):
    import jax

    jax.block_until_ready(f())  # compile + settle
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _time_np(f, reps=2):
    f()
    t0 = time.perf_counter()
    for _ in range(reps):
        f()
    return (time.perf_counter() - t0) / reps


def reference_numpy(arrays, edges_list, axis=None, weights=None, density=False):
    """Reference algorithm on numpy (cited: reference core.py:73-186,
    244-246, 444-462), used as the measured baseline."""
    from functools import reduce

    a0 = arrays[0]
    if axis is None:
        arrs = [a.reshape(1, -1) for a in arrays]
        w2 = weights.reshape(1, -1) if weights is not None else None
        kept = ()
    else:
        axis = tuple(axis)
        kept_axes = [i for i in range(a0.ndim) if i not in axis]
        kept = tuple(a0.shape[i] for i in kept_axes)

        def c2d(a):
            c = np.moveaxis(a, axis, tuple(range(-len(axis), 0)))
            return c.reshape(int(np.prod(kept or (1,))), -1)

        arrs = [c2d(a) for a in arrays]
        w2 = c2d(weights) if weights is not None else None

    hist_shapes = [len(e) + 1 for e in edges_list]
    idxs = []
    for a, e in zip(arrs, edges_list):
        idx = np.searchsorted(e, a, side="right")
        idx[a == e[-1]] -= 1
        idxs.append(idx)
    if len(idxs) > 1:
        flat = np.ravel_multi_index(idxs, hist_shapes)
    else:
        flat = idxs[0]
    n = reduce(lambda x, y: x * y, hist_shapes)
    m = flat.shape[0]
    off = (flat + n * np.arange(m)[:, None]).ravel()
    bc = np.bincount(
        off, weights=None if w2 is None else w2.ravel(), minlength=n * m
    )
    counts = bc.reshape((m,) + tuple(hist_shapes))
    sl = (slice(None),) + len(arrays) * (slice(1, -1),)
    counts = counts[sl].reshape(kept + tuple(len(e) - 1 for e in edges_list))
    if density:
        widths = [np.diff(e) for e in edges_list]
        area = reduce(lambda x, y: np.multiply.outer(x, y), widths)
        bin_axes = tuple(range(-len(arrays), 0))
        tot = counts.sum(axis=bin_axes, keepdims=True)
        counts = counts / area / tot
    return counts


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--method", default="auto")
    args = p.parse_args()

    import os

    import jax
    import jax.numpy as jnp

    from xhistogram_tpu.core import histogram
    from xhistogram_tpu.labeled import NamedArray
    from xhistogram_tpu.labeled import histogram as lhistogram
    from xhistogram_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    backend = jax.default_backend()
    device_kind = jax.devices()[0].device_kind
    s = args.scale
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(0)
    results = []

    def report(config, dt_dev, dt_np, nbytes, parity):
        row = {
            "config": config,
            "backend": backend,
            "device_kind": device_kind,
            "device_ms": dt_dev * 1e3,
            "numpy_ms": dt_np * 1e3,
            "GBps": nbytes / dt_dev / 1e9,
            "speedup_vs_numpy": dt_np / dt_dev,
            "parity": bool(parity),
        }
        results.append(row)
        print(json.dumps(row))

    # -- config 1: 1-D histogram of (1000, 100000) f32, reduce all ----------
    nrows, ncols = 1000, int(100_000 * s)
    x = jax.random.normal(key, (nrows, ncols), jnp.float32)
    e = np.linspace(-4, 4, 51)
    f = lambda: histogram(x, bins=e, method=args.method)[0]
    dt = _time(f)
    x_np = np.asarray(x)
    dt_np = _time_np(lambda: reference_numpy([x_np], [e]))
    parity = np.array_equal(np.asarray(f()), reference_numpy([x_np], [e]))
    report("1_1d_reduce_all_(1000,100000)", dt, dt_np, x.size * 4, parity)

    # -- config 2: weighted + density, keep leading axis ---------------------
    w = jax.random.uniform(jax.random.PRNGKey(1), (nrows, ncols), jnp.float32)
    f = lambda: histogram(
        x, bins=e, axis=(1,), weights=w, density=True, method=args.method
    )[0]
    dt = _time(f)
    w_np = np.asarray(w)
    dt_np = _time_np(
        lambda: reference_numpy([x_np], [e], axis=(1,), weights=w_np, density=True)
    )
    expected = reference_numpy([x_np], [e], axis=(1,), weights=w_np, density=True)
    parity = np.allclose(np.asarray(f()), expected, rtol=2e-4, atol=1e-9)
    report("2_weighted_density_keep_rows", dt, dt_np, x.size * 8, parity)

    # -- config 3: 2-D joint T-S watermass diagram ---------------------------
    n3 = int(50_000_000 * s)
    T = 14.0 + 8.0 * jax.random.normal(jax.random.PRNGKey(2), (n3,), jnp.float32)
    S = 35.0 + 1.5 * jax.random.normal(jax.random.PRNGKey(3), (n3,), jnp.float32)
    te = np.linspace(-2, 30, 281)
    se = np.linspace(30, 40, 341)
    f = lambda: histogram(T, S, bins=[te, se], method=args.method)[0]
    dt = _time(f)
    T_np, S_np = np.asarray(T), np.asarray(S)
    sub = slice(0, min(n3, 10_000_000))
    dt_np = _time_np(lambda: reference_numpy([T_np[sub], S_np[sub]], [te, se]))
    dt_np *= n3 / (sub.stop or n3)  # linear extrapolation
    parity = np.array_equal(
        np.asarray(histogram(T[sub], S[sub], bins=[te, se], method=args.method)[0]),
        reference_numpy([T_np[sub], S_np[sub]], [te, se]),
    )
    report("3_joint_TS_280x340", dt, dt_np, n3 * 8, parity)

    # -- config 4: labeled wrapper, dim='time', keep lat/lon -----------------
    nt, nlat, nlon = int(100 * max(s, 0.1)), 45, 90
    sst = NamedArray(
        20 + 5 * np.asarray(
            jax.random.normal(jax.random.PRNGKey(4), (nt, nlat, nlon), jnp.float32)
        ),
        ("time", "lat", "lon"),
        coords={"lat": np.linspace(-88, 88, nlat), "lon": np.linspace(2, 358, nlon)},
        name="sst",
    )
    e4 = np.linspace(0, 40, 81)
    f = lambda: lhistogram(sst, bins=[e4], dim=["time"], method=args.method).data
    dt = _time(f)
    sst_np = sst.values
    dt_np = _time_np(lambda: reference_numpy([sst_np], [e4], axis=(0,)))
    got = lhistogram(sst, bins=[e4], dim=["time"], method=args.method)
    parity = (
        np.array_equal(got.values, reference_numpy([sst_np], [e4], axis=(0,)))
        and got.dims == ("lat", "lon", "sst_bin")
        and "lat" in got.coords
    )
    report("4_labeled_dim_time_keep_latlon", dt, dt_np, sst.size * 4, parity)

    # -- config 5: sharded multi-chip histogram ------------------------------
    from jax.sharding import Mesh, PartitionSpec as P

    from xhistogram_tpu.parallel import histogram_sharded

    ndev = len(jax.devices())
    mesh = Mesh(np.array(jax.devices()).reshape(ndev), ("dp",))
    n5 = int(10_000_000 * s) * ndev
    X5 = jax.random.normal(jax.random.PRNGKey(5), (ndev * 8, n5 // (ndev * 8)),
                           jnp.float32)
    f = lambda: histogram_sharded(
        X5, mesh=mesh, in_spec=P("dp", None), bins=e, method=args.method
    )[0]
    dt = _time(f)
    X5_np = np.asarray(X5)
    dt_np = _time_np(lambda: reference_numpy([X5_np], [e]))
    parity = np.array_equal(np.asarray(f()), reference_numpy([X5_np], [e]))
    report("5_sharded_psum_dask_parity", dt, dt_np, X5.size * 4, parity)

    print(
        json.dumps(
            {
                "summary": "all_configs",
                "all_parity": all(r["parity"] for r in results),
                "geomean_speedup": round(
                    float(
                        np.exp(
                            np.mean(
                                [np.log(max(r["speedup_vs_numpy"], 1e-9))
                                 for r in results]
                            )
                        )
                    ),
                    1,
                ),
            }
        )
    )


if __name__ == "__main__":
    sys.path.insert(0, ".")
    main()
