"""Throughput/bound lines for the remaining BASELINE.md benchmark
configs (the 512^3 flagship lives in bench.py, 5D in bench_5d.py, MDR in
prof_mdr.py), on one GPU:

  1. 1D 2^20 f64 sinusoid, s=0, eb=1e-3 (ABS, L2 bound) — device
     pipeline GB/s.
  2. 3D non-uniform (stretched grids on every axis) 256^3 f32, s=inf,
     eb=1e-3 — device pipeline GB/s.
  3. 3D + ROI: compress_roi at 128^3 with a centered box ROI — verifies
     the tightened in-ROI bound and reports the size cost vs plain
     compression (functional line, no GB/s).

Device times are the best of a few jitted calls, each ended by
jax.block_until_ready. Run: python scripts/bench_baseline.py (fails when
JAX finds no GPU).
"""

import math
import os
import sys
import time

import numpy as np

# the repository root, for mgard_tpu and chip_smoke
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timed(fn, args, reps=4):
    import jax

    jax.block_until_ready(fn(*args))
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


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
        sys.exit(f"bench_baseline: JAX found {dev.platform}, not a GPU")
    from chip_smoke import _nvidia_smi

    print(f"# {dev.device_kind}: {_nvidia_smi()}", file=sys.stderr)
    cfg = mgard_tpu.Config()

    def device_line(tag, v, hier, s, tol):
        s_inf = math.isinf(s)
        orthogonal = H.infer_orthogonal_projection(s)
        q = hier.quantizers(tol, s, 0.0, error_bound_type.ABS,
                            decomposition_type.MultiDim, orthogonal)
        quant = jnp.asarray(q)
        vj = jnp.asarray(v)
        N = int(np.prod(v.shape))
        sb = bfp._choose_sb(N)
        npad = bfp._pad_to(N, sb)
        NB = npad // 32
        E = bfp.E_DEFAULT
        sym0 = H._compress_core_sym(vj, quant, hier, orthogonal,
                                    s_inf).ravel()
        sym0 = jnp.concatenate([sym0, jnp.zeros(npad - N, jnp.int32)])
        K = bfp.choose_K(np.asarray(bfp._width_hist(sym0)), E)
        exc0 = int(np.asarray(bfp._width_hist(sym0))[K + E + 1:].sum())
        cap = bfp._exc_bucket(exc0, NB // bfp.CHUNK)

        def comp(vj, quant):
            sym = H._compress_core_sym(vj, quant, hier, orthogonal,
                                       s_inf).ravel()
            sym = jnp.concatenate([sym, jnp.zeros(npad - N, jnp.int32)])
            return bfp.encode_core(sym, K, E, sb, cap)

        out = jax.jit(comp)(vj, quant)

        def decomp(base, crl, resid2d, exc_ids, exc_blocks, quant):
            sym = bfp.decode_core(base, crl, resid2d, exc_ids, exc_blocks,
                                  K, E, sb, NB)[:N]
            return H._decompress_core_sym(sym.reshape(v.shape), quant,
                                          hier, orthogonal, s_inf)

        rec = jax.jit(decomp)(out[0], out[1], out[2], out[4], out[5], quant)
        t_c = _timed(jax.jit(comp), (vj, quant))
        t_d = _timed(jax.jit(decomp),
                     (out[0], out[1], out[2], out[4], out[5], quant))
        nbytes = v.nbytes
        resid_w = bfp.CHUNK * int(np.asarray(out[1], np.int64).sum())
        wpb = (resid_w + K * NB + NB / 8) / NB
        ratio = v.dtype.itemsize * 8 / wpb
        err_inf = float(jnp.max(jnp.abs(jnp.asarray(rec) - vj)))
        if s_inf:
            ok = err_inf <= tol
            errtxt = f"Linf {err_inf:.2e}"
        else:
            e = np.asarray(rec, np.float64) - np.asarray(v, np.float64)
            from mgard_tpu.ops.norms import norm_hier
            l2 = float(norm_hier(e, hier, 0.0))
            ok = l2 <= tol
            errtxt = f"s0-norm {l2:.2e}"
        print(f"{tag}: compress {nbytes/t_c/1e9:.2f} GB/s, decompress "
              f"{nbytes/t_d/1e9:.2f} GB/s, ratio~{ratio:.2f}, {errtxt} "
              f"bound_ok={ok}")

    # ---- 1. 1D 2^20 f64 sinusoid, s=0 ----
    n1 = 1 << 20
    x = np.linspace(0, 1, n1)
    v1 = (np.sin(8 * np.pi * x) + 0.4 * np.sin(37 * np.pi * x)).astype(
        np.float64)
    hier1 = get_hierarchy((n1,), np.float64, None, cfg)
    device_line("1D 2^20 f64 s=0 eb=1e-3", v1, hier1, 0.0, 1e-3)

    # ---- 2. 3D non-uniform 256^3 f32, s=inf ----
    n3 = 256
    coords = [np.cumsum(1.0 + 0.8 * np.sin(np.linspace(0, 9 + d, n3)))
              for d in range(3)]
    coords = [c / c[-1] for c in coords]
    X = coords[0][:, None, None]
    Y = coords[1][None, :, None]
    Z = coords[2][None, None, :]
    v3 = (np.sin(6 * X) * np.cos(5 * Y) + np.exp(-3 * Z)).astype(np.float32)
    hier3 = get_hierarchy((n3,) * 3, np.float32, coords, cfg)
    device_line("3D 256^3 f32 non-uniform s=inf eb=1e-3", v3, hier3,
                math.inf, 1e-3)

    # ---- 4. 3D 256^3 f64, s=inf (demoted fast path) ----
    # the production double pipeline: exact f64->f32 cast-error pass +
    # hybrid v2 + BFP in f32, final cast back to f64 — all on device,
    # throughput in f64 bytes (the user's data)
    from mgard_tpu.ops.hybrid import hybrid_l_total, pad_to8, remainder_shape

    nf = 256
    fshape = (nf,) * 3
    tolf = 1e-3
    xg = jnp.linspace(0.0, 1.0, nf, dtype=jnp.float64)
    v64 = jax.jit(lambda x: (
        jnp.sin(4 * jnp.pi * x)[:, None, None]
        * jnp.cos(3 * jnp.pi * x)[None, :, None]
        + jnp.exp(x)[None, None, :] * 0.3
    ))(xg)
    padded = pad_to8(fshape)
    nl = 3
    rem_hier = get_hierarchy(remainder_shape(padded, nl), np.float32, None, cfg)
    ec0 = float(jnp.max(jnp.abs(
        v64 - v64.astype(jnp.float32).astype(jnp.float64))))
    rtol = tolf - ec0 * (1.0 + 1e-9)
    qv = H._hybrid_quantizer(rtol, hybrid_l_total(padded, nl, rem_hier))
    quantf = jnp.asarray(qv, jnp.float32)
    C = H._pick_v2_chunk(padded, cfg)
    E = bfp.E_DEFAULT
    sbf = bfp.SB_BLOCKS
    Nf = nf ** 3
    NBf = Nf // 32
    n_remf = int(np.prod(rem_hier.shape))
    rem_padf = bfp._pad_to(n_remf, sbf)
    NBrf = rem_padf // 32
    if H._hybrid_v2_ok(padded, np.float32, cfg):
        pay0, cw0, rem0 = H._compress_core_hybrid_v2(
            v64.astype(jnp.float32), quantf, padded, nl, rem_hier, C)
        hist = np.bincount(np.clip(np.asarray(cw0), 0, 32), minlength=33)
        Kf = bfp.choose_K(hist, E, C)
        hr = np.asarray(bfp._width_hist(jnp.concatenate(
            [rem0, jnp.zeros(rem_padf - n_remf, jnp.int32)])))
        Krf = bfp.choose_K(hr, E)

        def comp64(v64, quantf):
            u32 = v64.astype(jnp.float32)
            ec = jnp.max(jnp.abs(v64 - u32.astype(jnp.float64)))
            pay, cw, rem_sym = H._compress_core_hybrid_v2(
                u32, quantf, padded, nl, rem_hier, C)
            crl_ = jnp.clip(cw - Kf, 0, E)
            cf = bfp.encode_core_zz(
                pay.reshape(-1, C * 32), crl_, Kf, E, sbf, C)
            rs = jnp.concatenate(
                [rem_sym, jnp.zeros(rem_padf - n_remf, jnp.int32)])
            rem = bfp.encode_core(rs, Krf, E, sbf, 8192)
            return cf + (crl_, ec.astype(jnp.float32)) + rem

        o = jax.jit(comp64)(v64, quantf)
        basef, resid2df, crlf = o[0], o[1], o[3]
        rbasef, rcrlf, rresid2df = o[5], o[6], o[7]
        rexc_idsf, rexc_blocksf = o[9], o[10]

        def dec64(basef, resid2df, crlf, rbasef, rcrlf, rresid2df,
                  rexc_idsf, rexc_blocksf, quantf):
            zz = bfp.decode_core_zz(basef, crlf, resid2df, Kf, E, sbf,
                                    NBf, C)
            rem_sym = bfp.decode_core(rbasef, rcrlf, rresid2df, rexc_idsf,
                                      rexc_blocksf, Krf, E, sbf,
                                      NBrf)[:n_remf]
            rec32 = H._decompress_core_hybrid_v2(
                zz, rem_sym, quantf, fshape, padded, nl, rem_hier, C)
            return rec32.astype(jnp.float64)

        dargs = (basef, resid2df, crlf, rbasef, rcrlf, rresid2df,
                 rexc_idsf, rexc_blocksf, quantf)
        rec64 = jax.jit(dec64)(*dargs)
        errf = float(jnp.max(jnp.abs(rec64 - v64)))
        t_c = _timed(jax.jit(comp64), (v64, quantf))
        t_d = _timed(jax.jit(dec64), dargs)
        nb64 = Nf * 8
        resid_w = C * int(np.asarray(crlf, np.int64).sum())
        wpb = (resid_w + Kf * NBf + NBf / C / 2) / NBf
        ratio64 = 64.0 / wpb
        print(f"3D 256^3 f64 s=inf eb=1e-3 (demoted): compress "
              f"{nb64/t_c/1e9:.2f} GB/s, decompress {nb64/t_d/1e9:.2f} "
              f"GB/s, cf-ratio~{ratio64:.1f}, Linf {errf:.2e} "
              f"bound_ok={errf <= tolf} (cast err {ec0:.2e})")
    else:
        print("3D 256^3 f64 demoted: v2 gate failed (unexpected)")

    # ---- 3. ROI line (functional) ----
    nr = 128
    xr = np.linspace(0, 1, nr, dtype=np.float32)
    vr = (np.sin(4 * np.pi * xr)[:, None, None]
          * np.cos(3 * np.pi * xr)[None, :, None]
          + xr[None, None, :] ** 2).astype(np.float32)
    mask = np.zeros(vr.shape, bool)
    mask[32:96, 32:96, 32:96] = True
    tol, factor = 1e-2, 16.0
    blob_roi, st = mgard_tpu.compress_roi(vr, tol, mask, roi_factor=factor)
    blob_pl, st2 = mgard_tpu.compress(vr, tol / factor, s=math.inf,
                                      mode=error_bound_type.ABS)
    out_roi, st3 = mgard_tpu.decompress(blob_roi)
    err_in = float(np.max(np.abs((out_roi - vr)[mask])))
    err_out = float(np.max(np.abs((out_roi - vr)[~mask])))
    print(f"3D 128^3 ROI (tol {tol}, factor {factor}): in-ROI Linf "
          f"{err_in:.2e} (<= {tol/factor:.0e}: {err_in <= tol/factor}), "
          f"out Linf {err_out:.2e} (<= {tol:.0e}: {err_out <= tol}), "
          f"roi-blob {len(blob_roi)} B vs uniform-fine {len(blob_pl)} B "
          f"({len(blob_pl)/len(blob_roi):.2f}x larger)")


if __name__ == "__main__":
    main()
