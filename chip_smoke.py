"""Drive the histogram pipeline once on one NVIDIA GPU, through its public
entry points, at the sizes its users run, and check every result against
numpy.

    python chip_smoke.py [--seed N]            # phases A-E on one GPU
    python chip_smoke.py --four [--seed N]     # the sharded phase, 4 GPUs
    python chip_smoke.py --probe [SECTIONS]    # timings behind the auto rules
    python chip_smoke.py --rehearse [--four]   # tiny sizes on the CPU

Phases (BASELINE.md configurations):
  A  joint T-S watermass histogram, 2**30 f32 pairs, 280 x 340 bins (config 3)
  B  weighted + density, kept rows, (1000, 100000) f32, 50 bins (config 2)
  C  per-grid-point labeled histogram over time, 365 x 720 x 1440 (config 4)
  D  StreamingHistogram over 8 host chunks of 2**26 pairs
  E  exact tiers and edge numerics, 2**22 elements, every counting method
  four  histogram_sharded / auto-delegation / user jit on 4 GPUs (config 5)

All data comes from ``--seed``. Before JAX starts in this process, the
chip-marked tests run in a child process (one JAX process on the card at a
time). Each phase prints one JSON line; any failure exits non-zero. The last
line of a passing run is ``{"ok": true, "device": {...}}``. ``--rehearse``
is the only mode that runs off the GPU, and it never prints that line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), the roof a histogram's
#: single read of its input is measured against
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

FULL = {
    "a_rows": 1024, "a_cols": 1 << 20, "a_check_rows": 16,
    "b_shape": (1000, 100_000),
    "c_shape": (365, 720, 1440), "c_samples": 64,
    "d_chunks": 8, "d_chunk": 1 << 26,
    "e_n": 1 << 22,
    "four_rows": 1024, "four_cols": 1 << 20, "four_jit_cols": 1 << 18,
}
TINY = {
    "a_rows": 16, "a_cols": 1 << 12, "a_check_rows": 4,
    "b_shape": (10, 1000),
    "c_shape": (5, 8, 16), "c_samples": 8,
    "d_chunks": 3, "d_chunk": 1 << 12,
    "e_n": 1 << 12,
    "four_rows": 8, "four_cols": 1 << 10, "four_jit_cols": 1 << 8,
}

T_EDGES = np.linspace(-2.0, 30.0, 281).astype(np.float32)
S_EDGES = np.linspace(30.0, 40.0, 341).astype(np.float32)
X_EDGES = np.linspace(-4.0, 4.0, 51)
SST_EDGES = np.linspace(0.0, 40.0, 81)
# same shape and certificate tier, other values: must reuse the compile
SST_EDGES_2 = np.linspace(-2.0, 38.0, 81)
METHODS = ("scatter", "onehot", "sort")


def card_info():
    """``name, power.limit`` of GPU 0 from nvidia-smi (a child that does not
    import JAX), or None when there is no NVIDIA GPU."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        return None
    return lines[0].strip()


def run_chip_tests():
    """Run the chip-marked tests in a child, before this process takes the
    card. Returns the child's exit code."""
    env = dict(os.environ, XHIST_TEST_PLATFORM="gpu")
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "chip",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests", "test_chip.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = res.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(f"# chip tests: rc={res.returncode} {tail[0]}", flush=True)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-8000:] + res.stderr[-4000:])
    return res.returncode


class Smoke:
    """Shared state of one run: device facts, sizes and the phase results."""

    def __init__(self, jax, sizes, seed, card, rehearse):
        self.jax = jax
        self.sizes = sizes
        self.seed = seed
        self.card = card
        self.rehearse = rehearse
        self.dev = jax.devices()[0]
        self.failed = []

    def key(self, i):
        return self.jax.random.fold_in(self.jax.random.PRNGKey(self.seed), i)

    def timed(self, fn, reps=3):
        """First call (compile + run, reported as set-up), then ``reps``
        timed calls, each ending in ``block_until_ready``."""
        jax = self.jax
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        setup = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times.append(time.perf_counter() - t0)
        return out, setup, times

    def peak_bytes(self, dev=None):
        stats = (dev or self.dev).memory_stats() or {}
        return stats.get("peak_bytes_in_use")

    def report(self, phase, ok, **fields):
        row = {
            "phase": phase,
            "ok": bool(ok),
            "device_kind": self.dev.device_kind,
            "card": self.card,
        }
        row.update(fields)
        row.setdefault("peak_bytes_in_use", self.peak_bytes())
        print(json.dumps(row, default=_jsonable), flush=True)
        if not ok:
            self.failed.append(phase)

    def run(self, name, fn):
        try:
            fn(self)
        except Exception:  # a failed phase is reported; the run exits 1
            traceback.print_exc()
            self.report(name, False, error=traceback.format_exc(limit=3))


def _jsonable(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (np.bool_,)):
        return bool(x)
    return str(x)


def _rate(smoke, n_bytes, seconds):
    """GB/s of input read once, and its share of the card's HBM roof."""
    gbps = n_bytes / seconds / 1e9
    roof = HBM_BYTES_PER_S.get(smoke.dev.device_kind)
    share = gbps * 1e9 / roof if roof else "not measured"
    return gbps, share


# ---------------------------------------------------------------------------
# references


def np_digitize(x, edges):
    """numpy bin index per element (-1 / len(edges)-1 when out of range or
    NaN), last bin closed — the reference's searchsorted + fixup."""
    x = np.asarray(x, np.float64)
    e = np.asarray(edges, np.float64)
    idx = np.searchsorted(e, x, side="right") - 1
    idx[x == e[-1]] = len(e) - 2
    bad = (idx < 0) | (idx > len(e) - 2) | np.isnan(x)
    idx[bad] = -1
    return idx


# ---------------------------------------------------------------------------
# phases


def phase_a(smoke):
    """Joint T-S watermass histogram (config 3), method auto."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    import xhistogram_tpu as xh
    from bench import reference_numpy_ts

    z = smoke.sizes
    rows, cols = z["a_rows"], z["a_cols"]
    kt, ks = jax.random.split(smoke.key(1))
    T = 14.0 + 8.0 * jax.random.normal(kt, (rows, cols), jnp.float32)
    S = 35.0 + 1.5 * jax.random.normal(ks, (rows, cols), jnp.float32)
    h, setup, times = smoke.timed(
        lambda: xh.histogram(T, S, bins=[T_EDGES, S_EDGES])[0]
    )
    n = rows * cols
    med = float(np.median(times))
    gbps, share = _rate(smoke, 8 * n, med)

    k = z["a_check_rows"]
    t_np, s_np = np.asarray(T[:k]), np.asarray(S[:k])
    got = np.asarray(xh.histogram(T[:k], S[:k], bins=[T_EDGES, S_EDGES])[0])
    exp = reference_numpy_ts(t_np, s_np, T_EDGES, S_EDGES)
    in_range = int(np.sum(
        (np_digitize(t_np.ravel(), T_EDGES) >= 0)
        & (np_digitize(s_np.ravel(), S_EDGES) >= 0)
    ))
    parity = bool(np.array_equal(got, exp)) and int(got.sum()) == in_range
    full_ok = (
        h.shape == (280, 340) and h.dtype == np.int32
        and 0 < int(np.asarray(h).sum()) <= n
    )
    smoke.report(
        "A_joint_TS_2^30", parity and full_ok, pairs=n, setup_s=setup,
        median_s=med, times_s=times, input_GBps=gbps, hbm_roof_share=share,
        parity=parity, parity_slice_pairs=k * cols, in_range_slice=in_range,
    )


def phase_b(smoke):
    """Weighted + density-normalised histogram with kept rows (config 2)."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    import xhistogram_tpu as xh
    from benchmarks.run_baselines import reference_numpy

    shape = smoke.sizes["b_shape"]
    x = jax.random.normal(smoke.key(2), shape, jnp.float32)
    w = jax.random.uniform(smoke.key(3), shape, jnp.float32)
    h, setup, times = smoke.timed(
        lambda: xh.histogram(
            x, bins=X_EDGES, axis=(1,), weights=w, density=True
        )[0]
    )
    exp = reference_numpy(
        [np.asarray(x)], [X_EDGES], axis=(1,),
        weights=np.asarray(w, np.float64), density=True,
    )
    # f32 sums of ~2000 uniform weights per bin (100000 per row): the
    # worst-case sequential bound is n * 2**-24 ~ 1.2e-4 of a bin, and
    # GPU atomics add in any order, so bins agree to 2e-4 relative.
    got = np.asarray(h)
    rel = float(np.max(np.abs(got - exp) / np.maximum(np.abs(exp), 1e-30)))
    parity = bool(np.allclose(got, exp, rtol=2e-4, atol=1e-9))
    med = float(np.median(times))
    gbps, share = _rate(smoke, 8 * math.prod(shape), med)
    smoke.report(
        "B_weighted_density_rows", parity, shape=shape, setup_s=setup,
        median_s=med, times_s=times, input_GBps=gbps, hbm_roof_share=share,
        parity=parity, max_rel_err=rel, tolerance="rtol 2e-4 (f32 sums)",
    )


def phase_c(smoke):
    """Per-grid-point labeled histogram over time (config 4)."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    import xhistogram_tpu as xh
    from xhistogram_tpu import bins as bins_mod
    from xhistogram_tpu.labeled import NamedArray
    from xhistogram_tpu.labeled import histogram as lhist

    nt, nlat, nlon = smoke.sizes["c_shape"]
    data = 20.0 + 6.0 * jax.random.normal(
        smoke.key(4), (nt, nlat, nlon), jnp.float32
    )
    sst = NamedArray(
        data, ("time", "lat", "lon"),
        coords={
            "lat": np.linspace(-89.875, 89.875, nlat),
            "lon": np.linspace(0.125, 359.875, nlon),
        },
        name="sst",
    )
    out, setup, times = smoke.timed(
        lambda: lhist(sst, bins=[SST_EDGES], dim=["time"]).data
    )
    h = lhist(sst, bins=[SST_EDGES], dim=["time"])
    labels_ok = (
        h.dims == ("lat", "lon", "sst_bin")
        and h.name == "histogram_sst"
        and np.array_equal(
            h.coords["sst_bin"].values, bins_mod.bin_centers(SST_EDGES)
        )
        and np.array_equal(h.coords["lat"].values, sst.coords["lat"].values)
    )
    rng = np.random.default_rng(smoke.seed)
    ii = rng.integers(0, nlat, smoke.sizes["c_samples"])
    jj = rng.integers(0, nlon, smoke.sizes["c_samples"])
    cols = np.asarray(data[:, ii, jj])  # (time, samples)
    got = np.asarray(out)[ii, jj]
    exp = np.stack([np.histogram(cols[:, s], SST_EDGES)[0]
                    for s in range(len(ii))])
    # first calls over a second grid of the same shape and certificate
    # tier: the array API compiles nothing for it; the labeled pipeline
    # cache compiles each new edge set
    first = {}
    for name, e in (("array_grid1", SST_EDGES), ("array_grid2", SST_EDGES_2)):
        out2, first[name], _ = smoke.timed(
            lambda e=e: xh.histogram(data, bins=e, axis=(0,))[0], reps=0
        )
    _, first["labeled_grid2"], _ = smoke.timed(
        lambda: lhist(sst, bins=[SST_EDGES_2], dim=["time"]).data, reps=0
    )
    exp2 = np.stack([np.histogram(cols[:, s], SST_EDGES_2)[0]
                     for s in range(len(ii))])
    parity = bool(np.array_equal(got, exp)) and bool(
        np.array_equal(np.asarray(out2)[ii, jj], exp2)
    )
    med = float(np.median(times))
    gbps, share = _rate(smoke, 4 * nt * nlat * nlon, med)
    smoke.report(
        "C_labeled_per_gridpoint", parity and labels_ok,
        shape=(nt, nlat, nlon), out_slots=int(out.size), setup_s=setup,
        first_call_s=first, median_s=med, times_s=times, input_GBps=gbps, hbm_roof_share=share,
        parity=parity, labels_ok=bool(labels_ok),
    )


def phase_d(smoke):
    """StreamingHistogram over host chunks vs the one-shot histogram."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    import xhistogram_tpu as xh

    n_chunks, n = smoke.sizes["d_chunks"], smoke.sizes["d_chunk"]
    chunks = []
    for c in range(n_chunks):
        kt, ks = jax.random.split(smoke.key(100 + c))
        t = 14.0 + 8.0 * jax.random.normal(kt, (n,), jnp.float32)
        s = 35.0 + 1.5 * jax.random.normal(ks, (n,), jnp.float32)
        chunks.append((np.asarray(t), np.asarray(s)))

    def stream():
        acc = xh.StreamingHistogram(bins=[T_EDGES, S_EDGES])
        for t, s in chunks:
            acc.update(t, s)
        return acc.result()[0]

    got, setup, times = smoke.timed(stream)
    one = xh.histogram(
        jnp.asarray(np.concatenate([c[0] for c in chunks])),
        jnp.asarray(np.concatenate([c[1] for c in chunks])),
        bins=[T_EDGES, S_EDGES],
    )[0]
    parity = bool(np.array_equal(np.asarray(got), np.asarray(one)))
    med = float(np.median(times))
    gbps, _ = _rate(smoke, 8 * n * n_chunks, med)
    smoke.report(
        "D_streaming_host_chunks", parity, chunks=n_chunks, chunk_pairs=n,
        setup_s=setup, median_s=med, times_s=times, input_GBps=gbps,
        hbm_roof_share="not applicable (host-to-device bound)",
        parity=parity,
    )


def phase_e(smoke):
    """Exact tiers and edge numerics through every counting method."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    import xhistogram_tpu as xh

    n = smoke.sizes["e_n"]
    rng = np.random.default_rng(smoke.seed)
    x = np.asarray(jax.random.normal(smoke.key(5), (n,), jnp.float32))
    idx = np_digitize(x, X_EDGES)
    nb = len(X_EDGES) - 1
    ok_idx = idx >= 0
    checks = {}

    # precision='f64': exact float64 sums; oracle math.fsum per slot
    # (correctly rounded, as a Fraction sum rounded once would be)
    w64 = rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)
    order = np.argsort(idx, kind="stable")
    bounds = np.searchsorted(idx[order], np.arange(-1, nb + 1))
    exp64 = np.array([
        math.fsum(w64[order[bounds[b + 1]:bounds[b + 2]]]) for b in range(nb)
    ])
    # wide integer weights beyond 2**32: exact int64 oracle (no overflow:
    # 2**40 * 2**22 < 2**63)
    wint = rng.integers(0, 1 << 40, n, dtype=np.int64)
    expint = np.zeros(nb, np.int64)
    np.add.at(expint, idx[ok_idx], wint[ok_idx])
    # NaN / +-inf weights among exactly representable small integers: the
    # finite part is exact in f32, so the comparison is bit for bit
    wnf = rng.integers(0, 4, n).astype(np.float32)
    for b, kind in ((3, "nan"), (7, "pinf"), (11, "ninf"), (13, "both")):
        members = np.flatnonzero(idx == b)[:2]
        if kind == "nan":
            wnf[members[:1]] = np.nan
        if kind in ("pinf", "both"):
            wnf[members[:1]] = np.inf
        if kind == "ninf":
            wnf[members[:1]] = -np.inf
        if kind == "both":
            wnf[members[1:2]] = -np.inf
    expnf = np.zeros(nb, np.float64)
    with np.errstate(invalid="ignore"):  # inf + -inf -> NaN is the point
        np.add.at(expnf, idx[ok_idx], wnf[ok_idx].astype(np.float64))
    # a negative subnormal against a 0.0 edge (and its positive twin)
    tiny = np.array([-1e-40, 1e-40, -0.0, 0.0, -1.0, 1.0], np.float32)
    ftz_edges = np.array([-1.0, 0.0, 1.0], np.float32)
    expftz = np.histogram(tiny.astype(np.float64), ftz_edges)[0]

    for m in METHODS:
        h64 = xh.histogram(x, bins=X_EDGES, weights=w64, precision="f64",
                           method=m)[0]
        checks[f"f64_{m}"] = bool(
            h64.dtype == np.float64
            and np.all(np.abs(h64 - exp64) <= np.spacing(np.abs(exp64)))
        )
        hi = xh.histogram(x, bins=X_EDGES, weights=wint, method=m)[0]
        checks[f"int64_{m}"] = bool(
            hi.dtype == np.int64 and np.array_equal(hi, expint)
        )
        hn = np.asarray(
            xh.histogram(x, bins=X_EDGES, weights=wnf, method=m)[0]
        ).astype(np.float64)
        checks[f"nonfinite_{m}"] = bool(
            np.array_equal(hn, expnf, equal_nan=True)
        )
        hf = np.asarray(xh.histogram(tiny, bins=ftz_edges, method=m)[0])
        checks[f"neg_subnormal_{m}"] = bool(np.array_equal(hf, expftz))

    _, setup, times = smoke.timed(
        lambda: xh.histogram(x, bins=X_EDGES, weights=w64, precision="f64")[0]
    )
    parity = all(checks.values())
    smoke.report(
        "E_exact_tiers_edge_numerics", parity, n=n, setup_s=setup,
        median_s=float(np.median(times)), times_s=times,
        timed="precision='f64' call, method auto", parity=parity,
        checks=checks,
    )


def phase_four(smoke, trace_dir):
    """Config 5 on four GPUs: each card generates its own 2**30 pairs."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    from jax.sharding import Mesh, PartitionSpec as P

    import xhistogram_tpu as xh
    from bench import reference_numpy_ts
    from xhistogram_tpu.parallel import histogram_sharded

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devices)}")
    mesh = Mesh(np.array(devices), ("dp",))
    spec = P("dp", None)
    rows, cols = smoke.sizes["four_rows"], smoke.sizes["four_cols"]

    def local(key):
        k = jax.random.fold_in(key, jax.lax.axis_index("dp"))
        kt, ks = jax.random.split(k)
        return (
            14.0 + 8.0 * jax.random.normal(kt, (rows, cols), jnp.float32),
            35.0 + 1.5 * jax.random.normal(ks, (rows, cols), jnp.float32),
        )

    gen = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(), out_specs=(spec, spec)
    ))
    T, S = jax.block_until_ready(gen(smoke.key(7)))
    bins = [T_EDGES, S_EDGES]

    # per-card single-device histograms of the same shards, summed on host
    shards = sorted(
        zip(T.addressable_shards, S.addressable_shards),
        key=lambda p: p[0].index[0].start,
    )
    per_card = [
        np.asarray(xh.histogram(ts.data, ss.data, bins=bins)[0]).astype(
            np.int64
        )
        for ts, ss in shards
    ]
    exp_full = sum(per_card)
    per_card_rows = np.concatenate([
        np.asarray(xh.histogram(ts.data, bins=T_EDGES, axis=(1,))[0])
        for ts, _ in shards
    ])
    jc = smoke.sizes["four_jit_cols"]
    exp_jit = sum(
        np.asarray(
            xh.histogram(ts.data[:, :jc], ss.data[:, :jc], bins=bins)[0]
        ).astype(np.int64)
        for ts, ss in shards
    )
    t0, s0 = shards[0][0].data, shards[0][1].data
    k = smoke.sizes["a_check_rows"]
    slice_ok = bool(np.array_equal(
        np.asarray(xh.histogram(t0[:k], s0[:k], bins=bins)[0]),
        reference_numpy_ts(np.asarray(t0[:k]), np.asarray(s0[:k]),
                           T_EDGES, S_EDGES),
    ))

    calls = {
        "1_sharded_reduce_psum": lambda: histogram_sharded(
            T, S, mesh=mesh, in_spec=spec, bins=bins)[0],
        "2_sharded_kept_axis": lambda: histogram_sharded(
            T, mesh=mesh, in_spec=spec, bins=T_EDGES, axis=(1,))[0],
        "3_eager_auto_delegation": lambda: xh.histogram(T, S, bins=bins)[0],
    }
    jitted = jax.jit(
        lambda t, s: xh.histogram(t[:, :jc], s[:, :jc], bins=bins)[0]
    )
    calls["4_user_jit_gspmd"] = lambda: jitted(T, S)
    expected = {
        "1_sharded_reduce_psum": exp_full,
        "2_sharded_kept_axis": per_card_rows,
        "3_eager_auto_delegation": exp_full,
        "4_user_jit_gspmd": exp_jit,
    }
    n_total = 4 * rows * cols
    results = {}
    for name, fn in calls.items():
        out, setup, times = smoke.timed(fn)
        parity = bool(np.array_equal(
            np.asarray(out).astype(np.int64), expected[name]
        ))
        entry = {"setup_s": setup, "median_s": float(np.median(times)),
                 "times_s": times, "parity": parity}
        if name == "2_sharded_kept_axis":
            entry["out_spec"] = str(out.sharding.spec)
            entry["stays_sharded"] = out.sharding.spec[0] == "dp"
        results[name] = entry
    med1 = results["1_sharded_reduce_psum"]["median_s"]
    psum_share = collective_share(jax, trace_dir, calls["1_sharded_reduce_psum"])
    # every card holds its own shards and runs its own share: no card's
    # peak memory may be far above another's
    peaks = [smoke.peak_bytes(d) for d in devices]
    balanced = (
        min(peaks) > 0.5 * max(peaks) if all(peaks) else "not measured"
    )
    ok = (
        slice_ok and balanced is not False
        and all(r["parity"] for r in results.values())
        and results["2_sharded_kept_axis"]["stays_sharded"]
    )
    gbps, share = _rate(smoke, 8 * n_total, med1)
    smoke.report(
        "four_gpu_sharded", ok, count=len(devices), pairs=n_total,
        calls=results, slice_vs_numpy=slice_ok,
        call1_input_GBps=gbps, call1_hbm_roof_share_of_4=share / 4
        if isinstance(share, float) else share,
        psum_share_of_call1=psum_share, peak_bytes_per_device=peaks,
        work_balanced=balanced,
    )


def collective_share(jax, trace_dir, fn):
    """Share of each GPU's device time spent in NCCL collectives during one
    call of ``fn``, read from a profiler trace (a list, one per GPU), or
    "not measured" when the trace shows no GPU plane."""
    import glob

    jax.block_until_ready(fn())
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn())
    files = sorted(glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    ), key=os.path.getmtime)
    if not files:
        return "not measured"
    return trace_collective_share(jax, files[-1])


def trace_collective_share(jax, xplane_path):
    """Per-GPU share of device event time in NCCL kernels, from one
    ``.xplane.pb`` (GPU planes are ``/device:GPU:<n>``; their lines are
    streams, their events kernels)."""
    data = jax.profiler.ProfileData.from_file(xplane_path)
    shares = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        total = coll = 0
        for line in plane.lines:
            for ev in line.events:
                total += ev.duration_ns
                if "nccl" in ev.name.lower():
                    coll += ev.duration_ns
        if total:
            shares.append(coll / total)
    return shares or "not measured"


# ---------------------------------------------------------------------------
# probe: the timings behind the digitize and bincount auto rules


class Probe:
    """Helpers shared by the probe sections."""

    def __init__(self, smoke):
        self.smoke = smoke

    def med(self, fn, reps=5):
        _, _, times = self.smoke.timed(fn, reps)
        return float(np.median(times))

    def line(self, kind, **kw):
        smoke = self.smoke
        print(json.dumps({"probe": kind, "device_kind": smoke.dev.device_kind,
                          "card": smoke.card, **kw}, default=_jsonable),
              flush=True)


def probe_digitize(smoke, pr):
    """searchsorted against the certified-uniform digitize."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    from xhistogram_tpu import bins as bins_mod
    from xhistogram_tpu.ops import digitize as dg

    shape = smoke.sizes["b_shape"]
    x = jax.random.normal(smoke.key(20), shape, jnp.float32) * 3.0
    # digitize forms, each reduced to one number so only the form is timed
    grids = [np.arange(-5.0, 6.0), np.linspace(-4.0, 4.0, 65)] + [
        np.linspace(-4.0, 4.0, n) for n in (51, 81, 281, 341, 16385)
    ]
    for e64 in grids:
        n_edges = e64.size
        ce = bins_mod.compare_form(e64, np.dtype(np.float32))
        e_dev = jnp.asarray(ce.edges)
        form = bins_mod.uniform_form(np.asarray(ce.edges), e64)
        forms = {
            "searchsorted": jax.jit(lambda a: jnp.searchsorted(
                e_dev, a, side="right").astype(jnp.int32).sum()),
        }
        if form is not None:
            key, vals = dg.uniform_operands(form)
            forms["uniform"] = jax.jit(lambda a, v, key=key: dg.digitize_uniform(
                a, key, v, n_edges).sum())
        res = {k: pr.med(lambda k=k, f=f: f(x) if k == "searchsorted"
                         else f(x, vals)) for k, f in forms.items()}
        same = len({int(f(x) if k == "searchsorted" else f(x, vals))
                    for k, f in forms.items()}) == 1
        pr.line("digitize_forms", shape=shape, n_edges=n_edges,
                uniform_form=None if form is None else key[0],
                median_s=res, same_result=same)


def probe_bincount(smoke, pr):
    """Counting strategies by slot count and rows, and on phases A-C."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    import xhistogram_tpu as xh
    from xhistogram_tpu.ops import nonfinite

    med, line = pr.med, pr.line
    shape = smoke.sizes["b_shape"]
    # bincount strategies by slot count and rows
    sweep = (
        ((1, 1 << 26), (16, 50, 255, 1024, 4096)),
        ((1000, 100_000), (16, 50, 255, 1024)),
        ((1 << 20, 64), (16, 80, 255)),
        ((16384, 4096), (50, 255)),
    )
    for (rows, cols), bin_counts in sweep:
        if smoke.rehearse:
            rows, cols = min(rows, 64), min(cols, 256)
        xs = jax.random.normal(smoke.key(21), (rows, cols), jnp.float32)
        ws = jax.random.uniform(smoke.key(22), (rows, cols), jnp.float32)
        for n_bins in bin_counts:
            e = np.linspace(-4.0, 4.0, n_bins + 1)
            axis = None if rows == 1 else (1,)
            for weighted in (False, True):
                res = {}
                for m in METHODS:
                    if m == "onehot" and n_bins > (1024 if rows == 1 else 255):
                        continue
                    res[m] = med(lambda m=m: xh.histogram(
                        xs, bins=e, axis=axis, method=m,
                        weights=ws if weighted else None)[0], reps=3)
                line("bincount", rows=rows, cols=cols, n_bins=n_bins,
                     weighted=weighted, median_s=res)

    # phase shapes: A (scatter vs sort; onehot is O(slots) per element),
    # C (all three)
    kt, ks = jax.random.split(smoke.key(1))
    z = smoke.sizes
    T = 14.0 + 8.0 * jax.random.normal(kt, (z["a_rows"], z["a_cols"]))
    S = 35.0 + 1.5 * jax.random.normal(ks, (z["a_rows"], z["a_cols"]))
    line("phase_A_methods", median_s={m: med(lambda m=m: xh.histogram(
        T, S, bins=[T_EDGES, S_EDGES], method=m)[0], reps=3)
        for m in ("scatter", "sort")})
    del T, S
    sst = 20.0 + 6.0 * jax.random.normal(smoke.key(4), z["c_shape"])
    line("phase_C_methods", median_s={m: med(lambda m=m: xh.histogram(
        sst, bins=SST_EDGES, axis=(0,), method=m)[0], reps=3)
        for m in METHODS})
    del sst

    # phase B: the faithful-nonfinite int32 einsum channels of onehot
    xb = jax.random.normal(smoke.key(2), shape, jnp.float32)
    wb = jax.random.uniform(smoke.key(3), shape, jnp.float32)
    tb = {}
    for m in METHODS:
        tb[m] = med(lambda m=m: xh.histogram(
            xb, bins=X_EDGES, axis=(1,), weights=wb, density=True,
            method=m)[0], reps=3)
    nonfinite.ASSUME_FINITE = True
    jax.clear_caches()
    try:
        tb["onehot_without_int32_channels"] = med(lambda: xh.histogram(
            xb, bins=X_EDGES, axis=(1,), weights=wb, density=True,
            method="onehot")[0], reps=3)
    finally:
        nonfinite.ASSUME_FINITE = False
        jax.clear_caches()
    line("phase_B_methods", median_s=tb)


def probe_single_row(smoke, pr):
    """One weighted row of 2**30 elements, 50 bins: sort (every chunk row
    in one batch, and in steps of 64 chunk rows) against scatter, with the
    compiled program's temporary memory."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    import xhistogram_tpu as xh
    from xhistogram_tpu.ops import bincount as bc

    n = smoke.sizes["a_rows"] * smoke.sizes["a_cols"]
    x = jax.random.normal(smoke.key(30), (n,), jnp.float32)
    w = jax.random.uniform(smoke.key(31), (n,), jnp.float32)
    default_budget = bc._SORT_POS_BUDGET
    variants = (("scatter", None), ("sort", None),
                ("sort", 64 * (len(X_EDGES) + 1)))
    for weighted in (True, False):
        res = {}
        for method, budget in variants:
            bc._SORT_POS_BUDGET = budget or default_budget
            try:
                f = jax.jit(lambda a, b, m=method: xh.histogram(
                    a, bins=X_EDGES, method=m,
                    weights=b if weighted else None)[0])
                mem = f.lower(x, w).compile().memory_analysis()
                name = method if budget is None else f"{method}_steps64"
                res[name] = {
                    "median_s": pr.med(lambda: f(x, w), reps=3),
                    "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
                }
            finally:
                bc._SORT_POS_BUDGET = default_budget
                jax.clear_caches()
        pr.line("single_row_2^30", n=n, n_bins=len(X_EDGES) - 1,
                weighted=weighted, results=res)


def probe_numerics(smoke, pr):
    """FTZ and TF32 behaviour of the card."""
    jax, jnp = smoke.jax, smoke.jax.numpy
    from xhistogram_tpu.ops.ftz import fix_neg_subnormals

    line = pr.line
    # FTZ: does the device flush a negative subnormal compare operand?
    v = jnp.asarray(np.array([-1e-40, 1e-40], np.float32))
    e0 = jnp.asarray(np.array([-1.0, 0.0, 1.0], np.float32))
    raw = np.asarray(jax.jit(
        lambda a: jnp.searchsorted(e0, a, side="right"))(v)).tolist()
    fixed = np.asarray(jax.jit(
        lambda a: jnp.searchsorted(e0, fix_neg_subnormals(a),
                                   side="right"))(v)).tolist()
    lt0 = np.asarray(jax.jit(lambda a: a < 0)(v)).tolist()
    line("ftz", searchsorted_raw=raw, searchsorted_fixed=fixed,
         less_than_zero=lt0, numpy=np.searchsorted(
             np.array([-1.0, 0.0, 1.0], np.float32),
             np.array([-1e-40, 1e-40], np.float32), side="right").tolist())

    # TF32: does a default-precision f32 contraction round 24-bit weights?
    # (one weight per output slot, so an exact dot returns the weights).
    # The onehot strategy's batched "mb,mbn->mn" form, and a plain GEMM as
    # the control that shows whether default precision uses TF32 at all.
    for spec, m_rows, k in (("mb,mbn->mn", 1000, 64), ("mb,mbn->mn", 1, 2048),
                            ("mb,mbn->mn", 256, 512),
                            ("mb,mbn->mn", 4096, 128),
                            ("mb,bn->mn", 512, 2048)):
        wt = (1.0 + np.arange(m_rows * k, dtype=np.float64) % 4096
              * 2.0**-23).astype(np.float32).reshape(m_rows, k)
        eye = jnp.eye(k, dtype=jnp.float32)
        ohd = eye if spec == "mb,bn->mn" else jnp.broadcast_to(
            eye, (m_rows, k, k))
        res = {}
        for name, prec in (("default", None),
                           ("highest", jax.lax.Precision.HIGHEST)):
            r = jax.jit(lambda a, b, p=prec, spec=spec: jnp.einsum(
                spec, a, b, precision=p,
                preferred_element_type=jnp.float32))(jnp.asarray(wt), ohd)
            res[name] = bool(np.array_equal(np.asarray(r), wt))
        line("tf32_bit_exact", einsum=spec, rows=m_rows, k=k, **res)


PROBES = {
    "digitize": probe_digitize,
    "bincount": probe_bincount,
    "single_row": probe_single_row,
    "numerics": probe_numerics,
}


def probe(smoke, sections):
    pr = Probe(smoke)
    for name in sections:
        PROBES[name](smoke, pr)


# ---------------------------------------------------------------------------


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU sharded phase")
    p.add_argument("--probe", nargs="?", const=",".join(PROBES),
                   metavar="SECTIONS",
                   help="run only the timings behind the auto rules: a "
                   f"comma list of {','.join(PROBES)} (default: all)")
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on the CPU; never prints the result line")
    args = p.parse_args(argv)

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            )
        card = "rehearsal on the CPU (no card)"
    else:
        card = card_info()
        if card is None:
            print("chip_smoke: no NVIDIA GPU found (nvidia-smi reports no "
                  "device); this script runs only on a GPU "
                  "(--rehearse runs it on the CPU at tiny sizes)",
                  file=sys.stderr)
            return 2
    print(f"card: {card}", flush=True)

    chip_tests_rc = 0
    if not args.four and not args.probe:
        chip_tests_rc = run_chip_tests()

    sys.path.insert(0, ROOT)
    import jax

    from xhistogram_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache(ROOT)
    dev = jax.devices()[0]
    if not args.rehearse and dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    print(f"# jax {jax.__version__}, {len(jax.devices())} x "
          f"{dev.device_kind}, compile cache {cache}", flush=True)

    smoke = Smoke(jax, TINY if args.rehearse else FULL, args.seed, card,
                  args.rehearse)
    if chip_tests_rc != 0:
        smoke.failed.append("chip_tests")
    if args.probe:
        sections = args.probe.split(",")
        unknown = set(sections) - set(PROBES)
        if unknown:
            p.error(f"unknown probe sections {sorted(unknown)}")
        smoke.run("probe", lambda s: probe(s, sections))
    elif args.four:
        trace_dir = os.path.join(ROOT, "chiprun_out", "four_trace")
        smoke.run("four_gpu_sharded", lambda s: phase_four(s, trace_dir))
    else:
        for name, fn in (("A", phase_a), ("B", phase_b), ("C", phase_c),
                         ("D", phase_d), ("E", phase_e)):
            smoke.run(name, fn)

    if smoke.failed:
        print(f"chip_smoke: FAILED {smoke.failed}", file=sys.stderr)
        return 1
    if args.rehearse or args.probe:
        print("# rehearsal passed" if args.rehearse else "# probe done")
        return 0
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
