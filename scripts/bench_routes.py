"""Route and format-knob timings of the flagship path on one GPU.

    python scripts/bench_routes.py [--n=512] [--reps=3] [--tune-n=16777216]
                                   [--out=chiprun_out/routes.jsonl]

One process, one card. Prints one JSON line per measurement (and appends
them to --out):
  * "route": warm compress / decompress wall seconds of the default
    (flag-1, v2 front-end) route and of the flag-0 route at n^3 f32,
    tol=1e-3 ABS, s=inf, through mgard_tpu.compress / decompress, in the
    order v2, flag0, flag0, v2;
  * "bfp_sb": the same round trip with Config.bfp_sb_blocks set to each
    autotuner candidate (utils/autotuner.BFP_SB_CANDIDATES);
  * "stage": device time (block_until_ready) of each jitted stage of the
    v2 route — front-end, cf pack, cf unpack, inverse — with the bytes
    each must move and that figure over 3.35 TB/s (H100 SXM HBM, NVIDIA's
    data sheet);
  * "tune_bfp": the autotuner's generic BFP (sb, chunk) sweep on a
    --tune-n symbol stream.
Fails when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np

# the repository root, for mgard_tpu and chip_smoke
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def _emit(rec, out):
    line = json.dumps(rec, default=float)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def _roundtrip(v, tol, cfg, reps):
    import mgard_tpu

    best_c = best_d = float("inf")
    for i in range(reps + 1):  # the first pass compiles
        t0 = time.perf_counter()
        blob, st = mgard_tpu.compress(v, tol, config=cfg)
        t1 = time.perf_counter()
        out, st2 = mgard_tpu.decompress(blob)
        t2 = time.perf_counter()
        assert int(st) == 0 and int(st2) == 0
        if i:
            best_c, best_d = min(best_c, t1 - t0), min(best_d, t2 - t1)
    err = float(np.max(np.abs(out - v)))
    assert err <= tol, err
    return blob, best_c, best_d, err


def _device_time(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv):
    n, reps, tune_n, out = 512, 3, 1 << 24, "chiprun_out/routes.jsonl"
    for a in argv:
        if a.startswith("--n="):
            n = int(a.split("=")[1])
        elif a.startswith("--reps="):
            reps = int(a.split("=")[1])
        elif a.startswith("--tune-n="):
            tune_n = int(a.split("=")[1])
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_routes: JAX found {dev.platform}, not a GPU",
              file=sys.stderr)
        return 2
    import chip_smoke

    _emit({"card": {"device_kind": dev.device_kind,
                    "nvidia_smi": chip_smoke._nvidia_smi()}}, out)
    import mgard_tpu
    import mgard_tpu.highlevel as H
    from mgard_tpu.hierarchy import get_hierarchy
    from mgard_tpu.lossless import bfp
    from mgard_tpu.ops import hybrid as Hy
    from mgard_tpu.utils import autotuner

    tol = 1e-3
    v = chip_smoke.field((n, n, n))
    nbytes = v.nbytes

    # ---- v2 route vs flag-0 route, in turns
    v2_ok = H._hybrid_v2_ok
    for route in ("v2", "flag0", "flag0", "v2"):
        H._hybrid_v2_ok = v2_ok if route == "v2" else (lambda *a, **k: False)
        try:
            blob, t_c, t_d, err = _roundtrip(v, tol, mgard_tpu.Config(), reps)
        finally:
            H._hybrid_v2_ok = v2_ok
        _emit({"route": route, "n": n, "flag": chip_smoke._hybrid_flag(blob),
               "ratio": nbytes / len(blob), "linf": err, "compress_s": t_c,
               "decompress_s": t_d}, out)

    # ---- BFP superblock candidates through the flagship route
    for sb in autotuner.BFP_SB_CANDIDATES:
        cfg = mgard_tpu.Config()
        cfg.bfp_sb_blocks = sb
        blob, t_c, t_d, err = _roundtrip(v, tol, cfg, reps)
        _emit({"bfp_sb": sb, "n": n, "ratio": nbytes / len(blob),
               "compress_s": t_c, "decompress_s": t_d}, out)

    # ---- stage device times of the v2 route
    cfg = mgard_tpu.Config()
    nl = 3
    padded = Hy.pad_to8(v.shape)
    rem_hier = get_hierarchy(Hy.remainder_shape(padded, nl), np.float32,
                             None, cfg)
    q = H._hybrid_quantizer(tol, Hy.hybrid_l_total(padded, nl, rem_hier))
    C = H._pick_v2_chunk(padded, cfg)
    E = bfp.E_DEFAULT
    sb = H._v2_sb(cfg, int(np.prod(padded)), C)
    vd = jnp.asarray(v)
    qd = jnp.asarray(q, jnp.float32)
    front = jax.jit(lambda x: Hy.local_transform_v2_xla(x, 1.0 / qd, nl, C))
    pay, cw, rem = front(vd)
    cw_h = np.asarray(cw)
    K = bfp.choose_K(np.bincount(np.clip(cw_h, 0, 32), minlength=33), E, C)
    crl = jnp.clip(cw - K, 0, E)
    rows = pay.reshape(-1, C * 32)
    enc = jax.jit(lambda r, c: bfp.encode_core_zz(r, c, K, E, sb, C))
    base, resid2d, resid_rows = enc(rows, crl)
    packed_bytes = base.size * 4 + int(resid_rows) * bfp.LANES * 4
    NB = v.size // 32
    dec = jax.jit(lambda b, c, r: bfp.decode_core_zz(b, c, r, K, E, sb, NB, C))
    zz = dec(base, crl, resid2d)
    inv = jax.jit(lambda p, r: Hy.local_inverse_v2_xla(
        p.reshape(padded), r, qd, nl, jnp.float32))
    pay_bytes = 2 * v.size
    # bytes each stage must move at least: its inputs read once and its
    # outputs written once
    stages = {
        # f32 field in; u16 payload + widths + f32 remainder out
        "front_end": (_device_time(front, vd),
                      nbytes + pay_bytes + rem.size * 4 + cw.size * 4),
        # u16 rows + widths in; base and valid residual planes out
        "cf_pack": (_device_time(enc, rows, crl),
                    pay_bytes + crl.size * 4 + packed_bytes),
        "cf_unpack": (_device_time(dec, base, crl, resid2d),
                      packed_bytes + crl.size * 4 + pay_bytes),
        "inverse": (_device_time(inv, zz, rem), pay_bytes + rem.size * 4
                    + nbytes),
    }
    for name, (t, b) in stages.items():
        _emit({"stage": name, "n": n, "seconds": t, "bytes": int(b),
               "hbm_bound_s": b / HBM_BYTES_PER_S,
               "roofline_share": b / HBM_BYTES_PER_S / t}, out)

    # ---- the autotuner's generic BFP sweep
    _emit({"tune_bfp": autotuner.tune_bfp(tune_n, verbose=False)}, out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
