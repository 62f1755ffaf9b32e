"""Watermass T-S diagram — the canonical xhistogram use case, on JAX.

Builds a synthetic ocean state (temperature/salinity with depth structure),
then computes a volume-weighted joint T-S histogram per depth level with the
labeled API, reducing over (time, lat, lon) and keeping depth — the workload
the reference library was built for (its docs' ocean examples), here running
as one jit-compiled XLA program.

Run: `python examples/watermass_diagram.py` (CPU or GPU).
"""

import numpy as np

import jax
import jax.numpy as jnp

from xhistogram_tpu.labeled import NamedArray, histogram

# --- synthetic ocean state --------------------------------------------------
NT, NZ, NY, NX = 12, 8, 32, 64  # months, depth levels, lat, lon
rng = np.random.RandomState(0)

depth = np.array([5, 25, 60, 120, 250, 500, 1000, 2000.0])
lat = np.linspace(-80, 80, NY)
lon = np.linspace(0, 357.5, NX)

# temperature: warm surface / cold deep + latitudinal gradient + noise
t_profile = 22 * np.exp(-depth / 400)[None, :, None, None]
t_lat = -12 * (np.abs(lat) / 80)[None, None, :, None]
T = t_profile + t_lat + 1.5 * rng.randn(NT, NZ, NY, NX)
# salinity: fresher at the poles, saltier subtropics
S = 35 + 1.0 * np.cos(np.radians(lat))[None, None, :, None] + 0.3 * rng.randn(
    NT, NZ, NY, NX
)
# cell volume weights: area shrinks with |lat|, layer thickness grows w/depth
dz = np.gradient(depth)
vol = (np.cos(np.radians(lat))[None, None, :, None]
       * dz[None, :, None, None]
       * np.ones((NT, NZ, NY, NX)))

dims = ("time", "depth", "lat", "lon")
coords = {"depth": depth, "lat": lat, "lon": lon}
da_T = NamedArray(T.astype("f4"), dims, coords=coords, name="theta",
                  attrs={"units": "degC"})
da_S = NamedArray(S.astype("f4"), dims, coords=coords, name="salt",
                  attrs={"units": "psu"})
da_V = NamedArray(vol.astype("f4"), dims, coords=coords, name="vol")

# --- volume-weighted joint T-S histogram per depth level ---------------------
t_edges = np.linspace(-2, 30, 65)
s_edges = np.linspace(33, 37, 41)

h = histogram(
    da_T, da_S,
    bins=[t_edges, s_edges],
    dim=["time", "lat", "lon"],   # keep depth
    weights=da_V,
)

print(f"result: {h.name}  dims={h.dims}  shape={h.shape}")
print(f"bin-center coords: theta_bin[{h.coords['theta_bin'].values[0]:.2f}"
      f"..{h.coords['theta_bin'].values[-1]:.2f}] "
      f"{h.coords['theta_bin'].attrs}")

vals = h.values  # (depth, theta_bin, salt_bin)
for k in range(NZ):
    i, j = np.unravel_index(np.argmax(vals[k]), vals[k].shape)
    tc = h.coords["theta_bin"].values[i]
    sc = h.coords["salt_bin"].values[j]
    print(f"depth {depth[k]:6.0f} m: modal watermass T={tc:5.2f} degC, "
          f"S={sc:5.2f} psu  (volume {vals[k, i, j]:.1f})")

# exact volume accounting (publication-grade sums): precision='f64' rounds
# each bin's exact float64 sum once (host digit engine, eager only)
h_kw = {
    "bins": [t_edges, s_edges],
    "dim": ["time", "lat", "lon"],
    "weights": da_V,
    "method": "auto",
}
h_f32 = histogram(da_T, da_S, **h_kw)
h_exact = histogram(da_T, da_S, precision="f64", **h_kw)
drift = float(
    np.abs(h_exact.values.astype("f8") - h_f32.values.astype("f8")).max()
)
print(f"\nprecision='f64' vs default f32 sums: max per-bin delta {drift:.3e}")

# the same computation distributes over a device mesh unchanged:
if len(jax.devices()) > 1:
    from jax.sharding import Mesh, PartitionSpec as P
    from xhistogram_tpu.parallel import histogram_sharded

    n = len(jax.devices())
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    hs, _ = histogram_sharded(
        jnp.asarray(T.reshape(NT * NZ, -1), jnp.float32),
        jnp.asarray(S.reshape(NT * NZ, -1), jnp.float32),
        mesh=mesh,
        in_spec=P("dp", None),
        bins=[t_edges, s_edges],
        weights=jnp.asarray(vol.reshape(NT * NZ, -1), jnp.float32),
    )
    total = np.asarray(hs).sum()
    print(f"\nsharded over {n} devices: total volume {total:.1f} "
          f"(single-device {vals.sum():.1f})")
