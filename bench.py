"""Benchmark: end-to-end device compression+decompression throughput on
one GPU.

Config: 512^3 float32 smooth field, abs eb=1e-3, s=inf, Hybrid transform
(blockwise 8^3 local levels + global remainder; reference
HybridHierarchyCompressor), BFP lossless (the width-sorted prefix codec,
lossless/bfp.py), v2 front-end (hybrid front-end flag 1).
Matches the reference's own throughput-timer semantics (Timer around
Compressor::Compress/Decompress, device arrays in and out —
reference: CompressionLowLevel/Compressor.hpp:205-289): the timed region is
the full device pipeline (decompose -> levelwise quantize -> BFP pack, and
BFP unpack -> dequantize -> recompose); host<->device staging and the
host-side serialization are excluded. Each timing is the best of
``reps`` jitted calls, each ended by jax.block_until_ready.

Prints the card and its power limit on stderr, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "device": {...}, ...}
Fails when JAX finds no GPU.
"""

import json
import sys
import time

import numpy as np


def make_field(n: int):
    """Smooth multi-mode 3D field, generated on device."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen():
        x = jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)
        X = x[:, None, None]
        Y = x[None, :, None]
        Z = x[None, None, :]
        rng = np.random.default_rng(42)
        v = jnp.zeros((n, n, n), jnp.float32)
        for _ in range(6):
            kx, ky, kz = rng.integers(1, 9, 3)
            amp = float(rng.uniform(0.3, 1.0))
            ph = float(rng.uniform(0, 2 * np.pi))
            v = v + amp * jnp.sin(2 * np.pi * (kx * X + ky * Y + kz * Z) + ph)
        return v

    return gen()


def run(n: int = 512, tol: float = 1e-3, reps: int = 8, chunk: int = 0,
        sb: int = 0):
    import jax
    import jax.numpy as jnp

    import mgard_tpu
    import mgard_tpu.highlevel as H
    from mgard_tpu.hierarchy import get_hierarchy
    from mgard_tpu.lossless import bfp
    from mgard_tpu.ops.hybrid import hybrid_l_total, pad_to8, remainder_shape

    shape = (n, n, n)
    nl = 3
    padded = pad_to8(shape)
    cfg = mgard_tpu.Config()
    rem_hier = get_hierarchy(remainder_shape(padded, nl), np.float32, None, cfg)
    q = H._hybrid_quantizer(tol, hybrid_l_total(padded, nl, rem_hier))
    v = make_field(n)
    nbytes = n * n * n * 4
    N = n * n * n
    n_rem = int(np.prod(rem_hier.shape))
    C = chunk or H._pick_v2_chunk(padded, cfg)  # production pick (16 at 512^3)
    E = bfp.E_DEFAULT
    sb = sb or bfp.SB_BLOCKS
    assert H._hybrid_v2_ok(padded, np.float32, cfg), "v2 gate must pass at 512^3"
    NB = N // 32
    NC = NB // C
    # rem stream rides the generic BFP path, padded to its own superblocks
    rem_pad = bfp._pad_to(n_rem, sb)
    NBr = rem_pad // 32
    rem_exc_cap = 8192

    quant = jnp.asarray(q, jnp.float32)

    # K from the first stream's chunk-width histogram (production logic)
    pay0, cw0, rem0 = H._compress_core_hybrid_v2(v, quant, padded, nl, rem_hier, C)
    hist = np.bincount(np.clip(np.asarray(cw0), 0, 32), minlength=33)
    K = bfp.choose_K(hist, E, C)
    hr = np.asarray(bfp._width_hist(
        jnp.concatenate([rem0, jnp.zeros(rem_pad - n_rem, jnp.int32)])))
    Kr = bfp.choose_K(hr, E)
    print(f"# v2 path: C={C} K={K} (rem K={Kr}) cw_max={int(np.asarray(cw0).max())}",
          file=sys.stderr)
    assert K + E <= 16 and int(np.asarray(cw0).max()) <= K + E

    @jax.jit
    def compress_fn(v, quant):
        pay, cw, rem_sym = H._compress_core_hybrid_v2(
            v, quant, padded, nl, rem_hier, C
        )
        crl = jnp.clip(cw - K, 0, E)
        cf = bfp.encode_core_zz(pay.reshape(-1, C * 32), crl, K, E, sb, C)
        rs = jnp.concatenate([rem_sym, jnp.zeros(rem_pad - n_rem, jnp.int32)])
        rem = bfp.encode_core(rs, Kr, E, sb, rem_exc_cap)
        return cf + (crl,) + rem

    @jax.jit
    def decompress_fn(base, resid2d, crl, rbase, rcrl, rresid2d, rexc_ids,
                      rexc_blocks, quant):
        zz_rows = bfp.decode_core_zz(base, crl, resid2d, K, E, sb, NB, C)
        rem_sym = bfp.decode_core(rbase, rcrl, rresid2d, rexc_ids,
                                  rexc_blocks, Kr, E, sb, NBr)[:n_rem]
        return H._decompress_core_hybrid_v2(
            zz_rows, rem_sym, quant, shape, padded, nl, rem_hier, C
        )

    # ---- compile + correctness
    t0 = time.time()
    out = compress_fn(v, quant)
    base, resid2d, resid_rows, crl = out[0], out[1], out[2], out[3]
    rbase, rcrl, rresid2d, rresid_rows = out[4], out[5], out[6], out[7]
    rexc_ids, rexc_blocks, rexc_count = out[8], out[9], out[10]
    # compacted wire words (what serialize writes): each chunk ships one
    # word per band (C) per active residual plane (crl), no row padding
    total_i = C * int(np.asarray(crl, np.int64).sum())
    rtotal_i = bfp.CHUNK * int(np.asarray(rcrl, np.int64).sum())
    tc_compile = time.time() - t0
    print(f"# compile+first compress: {tc_compile:.1f}s", file=sys.stderr)

    t0 = time.time()
    rec = decompress_fn(base, resid2d, crl, rbase, rcrl, rresid2d,
                        rexc_ids, rexc_blocks, quant)
    err = float(jax.jit(lambda a, b: jnp.max(jnp.abs(a - b)))(rec, v))
    td_compile = time.time() - t0
    print(f"# compile+first decompress: {td_compile:.1f}s", file=sys.stderr)

    ok = err <= tol
    import struct as _struct

    # rem stream rides encode_core with the codec's own CHUNK, not the v2
    # chunk C — its nibble sidecar and exception blocks size accordingly
    comp_bytes = (
        total_i * 4 + K * NB * 4 + NC // 2          # cf stream
        + rtotal_i * 4 + Kr * NBr * 4 + (NBr // bfp.CHUNK) // 2  # rem stream
        + int(rexc_count) * (4 + bfp.CHUNK * 32 * 4)
        + 2 * _struct.calcsize(bfp._HDR)
    )
    ratio = nbytes / comp_bytes
    print(f"# n={n} err={err:.3e} bound_ok={ok} ratio={ratio:.2f}",
          file=sys.stderr)

    # ---- timed: best of reps, each call ended by block_until_ready
    def timed(fn, *args):
        jax.block_until_ready(fn(*args))  # warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        return best

    t_c = timed(compress_fn, v, quant)
    t_d = timed(decompress_fn, base, resid2d, crl, rbase, rcrl, rresid2d,
                rexc_ids, rexc_blocks, quant)
    print(
        f"# compress {t_c*1e3:.3f} ms ({nbytes/t_c/1e9:.2f} GB/s), "
        f"decompress {t_d*1e3:.3f} ms ({nbytes/t_d/1e9:.2f} GB/s)",
        file=sys.stderr,
    )

    value = 2 * nbytes / (t_c + t_d) / 1e9
    dev = jax.devices()[0]
    result = {
        "metric": f"device compress+decompress throughput, {n}^3 f32, eb=1e-3, Hybrid+BFP",
        "value": value,
        "unit": "GB/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "compress_GBps": nbytes / t_c / 1e9,
        "decompress_GBps": nbytes / t_d / 1e9,
        "ratio": ratio,
        "error_bound_ok": bool(ok),
        "compile_s": tc_compile + td_compile,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    n = 512
    chunk = 0
    sb = 0
    for a in sys.argv[1:]:
        if a.startswith("--n="):
            n = int(a.split("=")[1])
        if a.startswith("--chunk="):
            chunk = int(a.split("=")[1])
        if a.startswith("--sb="):
            sb = int(a.split("=")[1])
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench: JAX found {jax.devices()[0].platform}, not a GPU")
    from chip_smoke import _nvidia_smi

    print(f"# {jax.devices()[0].device_kind}: {_nvidia_smi()}",
          file=sys.stderr)
    run(n, chunk=chunk, sb=sb)
