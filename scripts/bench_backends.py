"""Backend x {enc GB/s, dec GB/s, ratio} on one GPU at 512^3.

Device-phase timing (best of a few jitted calls, each ended by
jax.block_until_ready); ratio from the real serialized blob, measured
once. Backends whose pipeline is host-bound (zstd stage, rANS host
packaging) are timed end to end, with the host stage reported in the note.

Usage: python scripts/bench_backends.py [n] [backends...]
(fails when JAX finds no GPU)
"""

import os
import sys
import time

import numpy as np

# the repository root, for mgard_tpu and chip_smoke
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n=512, only=None):
    import jax
    import jax.numpy as jnp

    import mgard_tpu
    import mgard_tpu.highlevel as H
    from mgard_tpu.hierarchy import get_hierarchy
    from mgard_tpu.ops.hybrid import hybrid_l_total, pad_to8, remainder_shape
    from chip_smoke import _nvidia_smi, field

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_backends: JAX found {dev.platform}, not a GPU")
    print(f"# {dev.device_kind}: {_nvidia_smi()}")
    shape = (n, n, n)
    nl = 3
    padded = pad_to8(shape)
    cfg = mgard_tpu.Config()
    rem_hier = get_hierarchy(remainder_shape(padded, nl), np.float32, None, cfg)
    q = H._hybrid_quantizer(1e-3, hybrid_l_total(padded, nl, rem_hier))
    quant = jnp.asarray(q, jnp.float32)
    v = jnp.asarray(field(shape))
    nbytes = n**3 * 4

    sym = jax.jit(lambda v, q: H._compress_core_hybrid(
        v, q, padded, nl, rem_hier, zgroup=True))(v, quant)
    sym_h = np.asarray(sym)
    Ntot = sym_h.size
    print(f"# {n}^3 f32, {Ntot} symbols, backend {jax.default_backend()}")

    def timed(fn, *args, reps=4):
        out = jax.block_until_ready(fn(*args))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        return out, best

    results = []

    def record(name, t_e, t_d, blob_len, ok, note=""):
        results.append((name, nbytes / t_e / 1e9, nbytes / t_d / 1e9,
                        nbytes / blob_len, ok, note))
        print(f"{name:14s} enc {nbytes/t_e/1e9:6.2f} GB/s  "
              f"dec {nbytes/t_d/1e9:6.2f} GB/s  ratio {nbytes/blob_len:5.2f}"
              f"  ok={ok} {note}")

    def want(name):
        return only is None or name in only

    # ---- BFX (device cores)
    if want("BFX"):
        from mgard_tpu.lossless import bfx

        sb = bfx._choose_sb(Ntot)
        npad = (Ntot + sb * 32 - 1) // (sb * 32) * (sb * 32)
        symp = jnp.concatenate([sym, jnp.zeros(npad - Ntot, jnp.int32)])
        enc = jax.jit(lambda s: bfx.encode_core(s, sb))
        out, t_e = timed(enc, symp)
        flat2d, widths, total = out
        dec = jax.jit(lambda f, w: bfx.decode_core(f, w, sb))
        dout, t_d = timed(dec, flat2d, widths)
        ok = bool(jnp.all(dout[:Ntot] == sym))
        blob = bfx.serialize_device(("bfx", Ntot, sb, 1) + tuple(out))
        record("BFX", t_e, t_d, len(blob), ok)

    # ---- BFP (device cores)
    if want("BFP"):
        from mgard_tpu.lossless import bfp

        sb = bfp._choose_sb(Ntot)
        K, E = 6, bfp.E_DEFAULT
        npad = bfp._pad_to(Ntot, sb)
        symp = jnp.concatenate([sym, jnp.zeros(npad - Ntot, jnp.int32)])
        NB = npad // 32
        enc = jax.jit(lambda s: bfp.encode_core(s, K, E, sb, 8192))
        out, t_e = timed(enc, symp)
        dec = jax.jit(lambda b, c, r, i, x: bfp.decode_core(
            b, c, r, i, x, K, E, sb, NB))
        dout, t_d = timed(dec, out[0], out[1], out[2], out[4], out[5])
        ok = bool(jnp.all(dout[:Ntot] == sym))
        blob = bfp.serialize_device(
            ("bfp", Ntot, K, E, sb, 8192, symp, out, bfp.CHUNK))
        record("BFP", t_e, t_d, len(blob), ok)
        if want("BFP_Zstd"):
            from mgard_tpu.lossless import host

            t0 = time.perf_counter()
            z = host.zstd_compress(blob, 3)
            tz = time.perf_counter() - t0
            record("BFP_Zstd", t_e, t_d, len(z), ok,
                   f"(+host zstd {tz*1e3:.0f} ms, {len(blob)/tz/1e9:.2f} GB/s)")

    # ---- HUF2 (device kernels; host packaging excluded)
    if want("HUF2"):
        from mgard_tpu.lossless import huffman_mono as hm

        dict_size = 1 << 14
        half = dict_size // 2
        # HUF2 consumes dictionary-shifted symbols in [0, dict)
        clipped = np.clip(sym_h, -half, half - 1) + half
        try:
            hist = np.bincount(
                np.asarray(hm._zigzag(jnp.asarray(clipped, jnp.int32))),
                minlength=dict_size,
            )[:dict_size] + 1
            cb, _ = hm.rank_codebook_from_hist(hist)
            fr_base = jnp.asarray(np.concatenate(
                [cb.first_rank.astype(np.int64), cb.base_code.astype(np.int64)]))
            end_rank = jnp.asarray(cb.len_of_rank_bp.astype(np.int64))
            K = 1024
            npad = (Ntot + K - 1) // K * K
            C = npad // K
            symp = jnp.concatenate(
                [jnp.asarray(clipped, jnp.int32),
                 jnp.full((npad - Ntot,), dict_size // 2, jnp.int32)])
            enc = jax.jit(lambda s: hm.encode_kernel(s, end_rank, fr_base,
                                                     K, dict_size))
            out, t_e = timed(enc, symp)
            words, chunk_bits, total = out
            blob = hm.encode(np.asarray(symp), dict_size, K)
            wcount = (np.asarray(chunk_bits) + 31) >> 5
            starts = jnp.asarray(np.concatenate([[0], np.cumsum(wcount)[:-1]])
                                 .astype(np.int32))
            thr = jnp.asarray(cb.thresholds16.astype(np.int64))
            dec = jax.jit(lambda w, cs: hm.decode_kernel(
                w, cs, thr, fr_base, K, C, dict_size))
            dout, t_d = timed(dec, words, starts)
            ok = bool(jnp.all(dout[:Ntot] == jnp.asarray(clipped)))
            record("HUF2", t_e, t_d, len(blob), ok, "(device kernels)")
        except Exception as e:
            print(f"HUF2 FAILED {type(e).__name__}: {str(e)[:120]}",
                  file=sys.stderr)

    # ---- SymbolRans / ZeroRLE (host-coupled; full encode/decode, 1 rep)
    for name, mod in (("SymbolRans", "symbol_rans"), ("ZeroRLE", "rle_rans")):
        if not want(name):
            continue
        try:
            import importlib

            m = importlib.import_module(f"mgard_tpu.lossless.{mod}")
            shifted = sym_h + cfg.huff_dict_size // 2  # production dict shift
            t0 = time.perf_counter()
            blob = m.encode(shifted, cfg)
            t_e = time.perf_counter() - t0
            t0 = time.perf_counter()
            dout = m.decode(blob)
            t_d = time.perf_counter() - t0
            ok = np.array_equal(np.asarray(dout).ravel()[:Ntot], shifted)
            record(name, t_e, t_d, len(blob), ok, "(incl. host)")
        except Exception as e:
            print(f"{name} FAILED {type(e).__name__}: {str(e)[:120]}",
                  file=sys.stderr)

    print("\n| backend | enc GB/s | dec GB/s | ratio | note |")
    print("|---|---|---|---|---|")
    for name, e, d, r, ok, note in results:
        print(f"| {name} | {e:.2f} | {d:.2f} | {r:.2f} | {note}"
              f"{'' if ok else ' BAD'} |")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    only = set(sys.argv[2:]) or None
    main(n, only)
