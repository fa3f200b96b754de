"""Multi-device sharded compression (reference: pmdr-x MPI pattern).

Run on any mesh; for a CPU demo:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python multi_device.py
"""
import jax
import numpy as np

import mgard_tpu
from mgard_tpu.parallel import compress_sharded, make_subdomain_mesh

mesh = make_subdomain_mesh()
n_dev = mesh.devices.size
v = np.random.default_rng(4).standard_normal((n_dev * 16, 33, 33)).astype(np.float32)
blob, st = compress_sharded(v, tol=1e-2, mesh=mesh)
out, _ = mgard_tpu.decompress(blob)
print(f"{n_dev} devices: blob {len(blob)} bytes, "
      f"Linf {np.max(np.abs(out - v)):.2e} <= 1e-2")
