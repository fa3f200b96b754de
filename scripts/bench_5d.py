"""5D XGC-like bench line (BASELINE config "XGC 5D with QoI, sharded").

Synthetic ion distribution f(t, phi, node, vx, vy) at 5D, f32, eb=1e-3:
device pipeline GB/s (MultiDim decompose -> quantize -> BFP pack and the
inverse), bound check, plus the density-QoI factor. The sharded variant
of the same pipeline is exercised by dryrun_multichip / tests on the
8-device mesh; this records the single-card 5D throughput line. Device
times are the best of a few jitted calls, each ended by
jax.block_until_ready; fails when JAX finds no GPU.
"""

import os
import sys
import time

import numpy as np

# the repository root, for mgard_tpu and chip_smoke
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_xgc5d(t=12, planes=8, nodes=96, nvx=33, nvy=33, seed=3):
    rng = np.random.default_rng(seed)
    vx = np.linspace(-3, 3, nvx)
    vy = np.linspace(-3, 3, nvy)
    VX, VY = np.meshgrid(vx, vy, indexing="ij")
    temp = 1.0 + 0.3 * np.sin(np.linspace(0, 3, nodes))[:, None, None]
    maxw = np.exp(-(VX**2 + VY**2)[None] / (2 * temp))  # (nodes, nvx, nvy)
    f = np.empty((t, planes, nodes, nvx, nvy), np.float32)
    for ti in range(t):
        for p in range(planes):
            turb = 1.0 + 0.05 * np.sin(
                2 * np.pi * (3 * ti / t + 2 * p / planes)
                + np.linspace(0, 6, nodes)
            )[:, None, None]
            f[ti, p] = (maxw * turb).astype(np.float32)
    f += rng.normal(0, 1e-3, f.shape).astype(np.float32)
    return f


def main():
    import jax
    import jax.numpy as jnp

    import mgard_tpu
    import mgard_tpu.highlevel as H
    from mgard_tpu.dtypes import decomposition_type, error_bound_type
    from mgard_tpu.hierarchy import get_hierarchy
    from mgard_tpu.lossless import bfp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_5d: JAX found {dev.platform}, not a GPU")
    from chip_smoke import _nvidia_smi

    print(f"# {dev.device_kind}: {_nvidia_smi()}")
    tol = 1e-3
    v = make_xgc5d()
    shape = v.shape
    nbytes = v.nbytes
    print(f"# 5D {shape} f32 ({nbytes/1e6:.0f} MB), eb={tol}, backend "
          f"{jax.default_backend()}")
    cfg = mgard_tpu.Config()
    hier = get_hierarchy(shape, np.float32, None, cfg)
    # hierarchical s=inf fast path, exactly what compress() uses
    # (infer_orthogonal_projection(inf) -> False): quantizer 2*tol/(L+1)
    # instead of the orthogonal-projection constant with its 1+3^D = 244
    # divisor at D=5, which over-delivered the bound ~250x at ratio 2.18
    q = hier.quantizers(tol, float("inf"), 0.0, error_bound_type.ABS,
                        decomposition_type.MultiDim, False)
    quant = jnp.asarray(q)
    vj = jnp.asarray(v)
    N = int(np.prod(shape))
    sb = bfp._choose_sb(N)
    npad = bfp._pad_to(N, sb)
    NB = npad // 32
    # production parameter selection (encode_device's logic): K from the
    # chunk-max width histogram, exception bucket sized from it
    E = bfp.E_DEFAULT
    sym0 = H._compress_core_sym(vj, quant, hier, False, True).ravel()
    sym0 = jnp.concatenate([sym0, jnp.zeros(npad - N, jnp.int32)])
    hcw = np.asarray(bfp._width_hist(sym0))
    K = bfp.choose_K(hcw, E)
    exc0 = int(hcw[K + E + 1:].sum())
    exc_cap = bfp._exc_bucket(exc0, NB // bfp.CHUNK)
    print(f"# K={K} E={E} sb={sb} exc~{exc0} cap {exc_cap}")

    @jax.jit
    def comp(vj, quant):
        sym = H._compress_core_sym(vj, quant, hier, False, True).ravel()
        if npad != N:
            sym = jnp.concatenate([sym, jnp.zeros(npad - N, jnp.int32)])
        return bfp.encode_core(sym, K, E, sb, exc_cap)

    @jax.jit
    def decomp(base, crl, resid2d, exc_ids, exc_blocks, quant):
        sym = bfp.decode_core(base, crl, resid2d, exc_ids, exc_blocks,
                              K, E, sb, NB)[:N]
        return H._decompress_core_sym(sym.reshape(shape), quant, hier, False, True)

    def timed(fn, *a, reps=4):
        jax.block_until_ready(fn(*a))
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            best = min(best, time.perf_counter() - t0)
        return best

    out = comp(vj, quant)
    t_c = timed(comp, vj, quant)
    assert int(out[6]) <= exc_cap, "exception bucket overflow in bench"
    rec = decomp(out[0], out[1], out[2], out[4], out[5], quant)
    t_d = timed(decomp, out[0], out[1], out[2], out[4], out[5], quant)
    err = float(jnp.max(jnp.abs(rec - vj)))
    # compacted wire words (serialize strips band row padding): each chunk
    # ships one word per band (CHUNK) per active residual plane (crl)
    resid_w = bfp.CHUNK * int(np.asarray(out[1], np.int64).sum())
    wpb = (resid_w + K * NB + NB / 8) / NB
    print(f"5D compress {nbytes/t_c/1e9:.2f} GB/s, decompress "
          f"{nbytes/t_d/1e9:.2f} GB/s, combined "
          f"{2*nbytes/(t_c+t_d)/1e9:.2f} GB/s, ratio~{32/wpb:.2f}, "
          f"Linf {err:.2e} bound_ok={err <= tol}")

    # density QoI factor (CalcSnormDensity counterpart) on the velocity box
    from mgard_tpu.qoi import TensorQuantityOfInterest

    w = np.ones((v.shape[3], v.shape[4]), np.float64) / (v.shape[3] * v.shape[4])
    qoi = TensorQuantityOfInterest(w)
    factor = qoi.multilevel_factor((v.shape[3], v.shape[4]), float("inf"))
    print(f"density QoI multilevel factor {factor:.3e} "
          f"(data tol for qoi_tol=1e-3: {1e-3/factor:.3e})")


if __name__ == "__main__":
    main()
