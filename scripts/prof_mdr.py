"""MDR refactor/reconstruct throughput at 384^3 f32 on one GPU (device
refactor time: best of a few jitted calls ended by jax.block_until_ready;
MDRefactor / MDReconstruct: wall time including the host stages). Fails
when JAX finds no GPU."""

import os
import sys
import time

import numpy as np

# the repository root, for mgard_tpu and chip_smoke
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n=384):
    import jax
    import jax.numpy as jnp

    import mgard_tpu
    from mgard_tpu import mdr
    from mgard_tpu.hierarchy import get_hierarchy
    from mgard_tpu.mdr.api import _refactor_device

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"prof_mdr: JAX found {dev.platform}, not a GPU")
    from chip_smoke import _nvidia_smi, field

    print(f"# {dev.device_kind}: {_nvidia_smi()}")
    cfg = mgard_tpu.Config()
    B = 24
    cfg.total_num_bitplanes = B
    v = field((n, n, n))
    nbytes = v.nbytes
    hier = get_hierarchy(v.shape, v.dtype, None, cfg)
    vj = jnp.asarray(v)

    fn = _refactor_device(hier, B, False, True)
    jax.block_until_ready(fn(vj))
    best = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(vj))
        best = min(best, time.perf_counter() - t0)
    t = best
    print(f"refactor device  {t*1e3:8.2f} ms  {nbytes/t/1e9:6.2f} GB/s")

    # full MDRefactor wall (incl. host level compression)
    t0 = time.perf_counter()
    meta, data = mdr.MDRefactor(v, cfg)
    t_full = time.perf_counter() - t0
    print(f"MDRefactor wall  {t_full*1e3:8.2f} ms  {nbytes/t_full/1e9:6.2f} GB/s")

    # reconstruct at tol
    counts = mdr.MDRequest(meta, 1e-3)
    t0 = time.perf_counter()
    rec = mdr.MDReconstruct(meta, data, counts)
    t_rec = time.perf_counter() - t0
    err = float(np.max(np.abs(rec.data - v)))
    print(f"MDReconstruct    {t_rec*1e3:8.2f} ms  {nbytes/t_rec/1e9:6.2f} GB/s  "
          f"Linf {err:.2e} ok={err <= 1e-3}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 384)
