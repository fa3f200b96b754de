"""On-card smoke run: the main paths of mgard_tpu once, at real sizes, on
an NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded path only

Phases (one card): the 512^3 f32 flagship through compress/decompress,
the f64 demoted and native routes, a non-uniform grid and a finite-s
(s=0, REL) bound, MDR refactor + two progressive retrievals at 384^3, and
parity of the translated parts against their plain references (transform
round trip and NumPy oracle, v2 front-end and BFP bytes against the CPU
device, a GPU-written stream decoded on the CPU device). Every phase
asserts its error bound. ``--multi`` runs compress_sharded /
decompress_sharded / MDRefactorSharded on a 1-D mesh of four cards and the
same field through single-card compress for comparison.

Each phase prints one ``phase <name> {json}`` line. The last line of
standard output is ``{"ok": true, "device": {...}}``, printed only when
every phase passed; without a GPU the script exits non-zero before any
phase. One process drives every card it uses.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def field(shape, dtype=np.float32, seed=42):
    """Smooth seeded multi-mode field on a 3D grid: six plane waves
    amp * sin(2 pi (kx x + ky y + kz z) + ph) with integer wave numbers in
    [1, 8]. Each wave is split by the angle-addition rule into tables over
    x and over (y, z), so a large field costs two multiply-adds per element
    and wave, built one leading-axis slab at a time."""
    rng = np.random.default_rng(seed)
    modes = []
    for _ in range(6):
        k = rng.integers(1, 9, 3)
        amp = float(rng.uniform(0.3, 1.0))
        ph = float(rng.uniform(0, 2 * np.pi))
        modes.append((k, amp, ph))
    x, y, z = (np.linspace(0.0, 1.0, n) for n in shape)
    tables = []
    for k, amp, ph in modes:
        a = 2 * np.pi * k[0] * x + ph
        b = 2 * np.pi * (k[1] * y[:, None] + k[2] * z[None, :])
        tables.append(((amp * np.sin(a)).astype(dtype),
                       (amp * np.cos(a)).astype(dtype),
                       np.cos(b).astype(dtype), np.sin(b).astype(dtype)))
    out = np.empty(shape, dtype)
    step = max(1, (1 << 24) // max(1, shape[1] * shape[2]))
    for x0 in range(0, shape[0], step):
        sl = slice(x0, x0 + step)
        acc = out[sl]
        acc[...] = 0
        for sa, ca, cb, sb in tables:
            acc += sa[sl, None, None] * cb
            acc += ca[sl, None, None] * sb
    return out


def _check(ok, msg):
    """A phase check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(msg)


def _linf(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _peak_bytes(dev=None):
    import jax

    stats = (dev or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _twice(fn, *args, **kw):
    """Call fn twice; returns (second result, first-call seconds — compile
    included — and second-call seconds)."""
    _, cold = _timed(fn, *args, **kw)
    out, warm = _timed(fn, *args, **kw)
    return out, cold, warm


def _hybrid_flag(blob: bytes):
    """Front-end flag byte of the first subdomain section of a Hybrid
    stream (None for other decompositions)."""
    import mgard_tpu.highlevel as H
    from mgard_tpu.dtypes import decomposition_type
    from mgard_tpu.formats.metadata import Metadata

    meta, off = Metadata.deserialize(blob)
    if meta.decomposition != decomposition_type.Hybrid:
        return None
    return int(blob[off + 8 + len(H._empty_outliers())])


def _roundtrip(v, tol, s=math.inf, mode=None, **kw):
    """compress + decompress, each twice; returns (blob, out, times) with
    the warm (second-call) and cold (compile included) wall seconds."""
    import mgard_tpu

    mode = mode if mode is not None else mgard_tpu.error_bound_type.ABS
    (blob, st), c_cold, c_warm = _twice(mgard_tpu.compress, v, tol, s, mode,
                                        **kw)
    _check(int(st) == 0, f"compress failed: {st}")
    (out, st2), d_cold, d_warm = _twice(mgard_tpu.decompress, blob)
    _check(int(st2) == 0, f"decompress failed: {st2}")
    return blob, out, {"compress_s": c_warm, "decompress_s": d_warm,
                       "compress_cold_s": c_cold, "decompress_cold_s": d_cold}


def _report(name, **fields):
    print(f"phase {name} " + json.dumps(fields, default=float), flush=True)


# ----------------------------------------------------------------------
# one-card phases
# ----------------------------------------------------------------------
def phase_flagship(n=512, tol=1e-3):
    """Default Config (Hybrid + BFP), ABS tol, s=inf. Returns (blob, v)
    for the parity phase's cross-device decode."""
    v = field((n, n, n))
    blob, out, times = _roundtrip(v, tol)
    err = _linf(out, v)
    _check(err <= tol, f"flagship L-inf {err} > {tol}")
    _report("flagship", shape=[n] * 3, tol=tol, linf=err,
            ratio=v.nbytes / len(blob), hybrid_flag=_hybrid_flag(blob),
            **times, peak_bytes_in_use=_peak_bytes())
    return blob, v


def phase_f64(n_demoted=256, n_native=128, tol=1e-3):
    """f64 at 1e-3 takes the demoted (f32) route; f64 at its own cast
    error takes the native double transform. Both hold the bound."""
    from mgard_tpu.formats.metadata import Metadata

    v = field((n_demoted,) * 3, np.float64)
    blob, out, times = _roundtrip(v, tol)
    meta, _ = Metadata.deserialize(blob)
    _check(meta.demoted, "f64 at 1e-3 must take the demoted route")
    _check(out.dtype == np.float64, "demoted f64 must decode to float64")
    err = _linf(out, v)
    _check(err <= tol, f"demoted f64 L-inf {err} > {tol}")
    v2 = field((n_native,) * 3, np.float64, seed=7)
    cast = float(np.max(np.abs(v2 - v2.astype(np.float32).astype(np.float64))))
    tol2 = max(cast, 1e-12)
    blob2, out2, times2 = _roundtrip(v2, tol2)
    meta2, _ = Metadata.deserialize(blob2)
    _check(not meta2.demoted, "f64 at the cast error must stay native")
    err2 = _linf(out2, v2)
    _check(err2 <= tol2, f"native f64 L-inf {err2} > {tol2}")
    _report("f64", demoted={"shape": [n_demoted] * 3, "tol": tol,
                            "linf": err, "ratio": v.nbytes / len(blob),
                            **times},
            native={"shape": [n_native] * 3, "tol": tol2, "linf": err2,
                    "ratio": v2.nbytes / len(blob2), **times2})


def phase_nonuniform(n=256, tol=1e-3):
    """Sorted random coordinates (end points pinned), ABS tol, s=inf."""
    shape = (n,) * 3
    rng = np.random.default_rng(2)
    coords = [np.sort(rng.uniform(0, 1, k)) for k in shape]
    for c in coords:
        c[0], c[-1] = 0.0, 1.0
    v = field(shape, seed=3)
    blob, out, times = _roundtrip(v, tol, coords=coords)
    err = _linf(out, v)
    _check(err <= tol, f"non-uniform L-inf {err} > {tol}")
    _report("nonuniform", shape=list(shape), tol=tol, linf=err,
            ratio=v.nbytes / len(blob), **times)


def phase_finite_s(n=256, tol=1e-3):
    """s=0, REL tol: the RMS error stays within tol times the RMS value."""
    import mgard_tpu

    v = field((n,) * 3, seed=4)
    blob, out, times = _roundtrip(v, tol, 0.0,
                                  mgard_tpu.error_bound_type.REL)
    d = np.asarray(out, np.float64) - v
    l2 = float(np.sqrt(np.mean(d * d)))
    l2v = float(np.sqrt(np.mean(v.astype(np.float64) ** 2)))
    _check(l2 <= tol * l2v, f"s=0 REL: RMS error {l2} > {tol} * {l2v}")
    _report("finite_s", shape=[n] * 3, tol=tol, s=0.0, rms_err=l2,
            rms_bound=tol * l2v, ratio=v.nbytes / len(blob), **times)


def phase_mdr(n=384, tols=(1e-2, 1e-4)):
    """MDRefactor, then MDRequest + MDReconstruct at each tolerance."""
    from mgard_tpu.mdr.api import MDReconstruct, MDRefactor, MDRequest

    v = field((n,) * 3, seed=5)
    (meta, data), r_cold, r_warm = _twice(MDRefactor, v)
    rounds = []
    for tol in tols:
        counts = MDRequest(meta, tol)
        rec, q_cold, q_warm = _twice(MDReconstruct, meta, data, counts)
        err = _linf(rec.data, v)
        _check(err <= tol, f"MDR at {tol}: L-inf {err}")
        rounds.append({"tol": tol, "linf": err, "planes": list(counts),
                       "reconstruct_s": q_warm, "reconstruct_cold_s": q_cold})
    _report("mdr", shape=[n] * 3, refactor_s=r_warm, refactor_cold_s=r_cold,
            rounds=rounds)


def phase_parity(n=512, n_oracle=128, blob=None, v=None, tol=1e-3):
    """Translated parts on the default device against their plain
    references, at stated tolerances:
      transform round trip (orthogonal decompose -> recompose) <= 1e-5
        relative (every dense operator runs at Precision.HIGHEST);
      f64 decompose against the NumPy oracle (ops/_be.py) <= 1e-6 relative;
      v2 front-end against the CPU device: cw equal, payload differs only
        by one-step .5-tie flips on < 1e-4 of the elements;
      the BFP cf stream serialized from the same symbols on both devices
        is byte-identical;
      a stream written on the default device decodes on the CPU device
        within its bound."""
    import jax
    import jax.numpy as jnp

    import mgard_tpu
    import mgard_tpu.highlevel as H
    from mgard_tpu.hierarchy import get_hierarchy
    from mgard_tpu.lossless import bfp
    from mgard_tpu.ops import hybrid as Hy
    from mgard_tpu.ops.refactor import decompose, recompose
    from mgard_tpu.utils.bytesink import join

    cpu = jax.devices("cpu")[0]
    res = {}
    shape = (n,) * 3
    if v is None:
        v = field(shape)

    # transform round trip
    hier = get_hierarchy(shape, np.float32)
    rt = jax.jit(lambda x: recompose(decompose(x, hier, True), hier, True))
    rec = np.asarray(rt(jnp.asarray(v)))
    rel = _linf(rec, v) / float(np.max(np.abs(v)))
    _check(rel <= 1e-5, f"transform round trip {rel} > 1e-5 relative")
    res["transform_roundtrip_rel"] = rel

    # f64 decompose against the NumPy oracle
    v64 = field((n_oracle,) * 3, np.float64, seed=6)
    h64 = get_hierarchy(v64.shape, np.float64)
    d_dev = np.asarray(jax.jit(lambda x: decompose(x, h64, True))(
        jnp.asarray(v64)))
    d_np = np.asarray(decompose(v64, h64, True))
    rel = _linf(d_dev, d_np) / float(np.max(np.abs(d_np)))
    _check(rel <= 1e-6, f"f64 decompose vs NumPy oracle {rel} > 1e-6")
    res["decompose_vs_numpy_rel"] = rel

    # v2 front-end: default device vs CPU device
    cfg = mgard_tpu.Config()
    nl = 3
    padded = Hy.pad_to8(shape)
    rem_hier = get_hierarchy(Hy.remainder_shape(padded, nl), np.float32,
                             None, cfg)
    q = H._hybrid_quantizer(tol, Hy.hybrid_l_total(padded, nl, rem_hier))
    inv_q = np.float32(1.0 / q)
    C = H._pick_v2_chunk(padded, cfg)
    front = jax.jit(lambda x: Hy.local_transform_v2_xla(x, inv_q, nl, C))
    pay_g, cw_g, rem_g = front(jnp.asarray(v))
    pay_c, cw_c, rem_c = front(jax.device_put(v, cpu))
    np.testing.assert_array_equal(np.asarray(cw_g), np.asarray(cw_c))
    pg = np.asarray(pay_g).astype(np.int64)
    pc = np.asarray(pay_c).astype(np.int64)
    mism = pg != pc
    frac = float(mism.mean())
    _check(frac < 1e-4, f"v2 payload mismatch fraction {frac}")
    _check(int(np.abs(pg - pc)[mism].max(initial=0)) <= 2,
           "v2 payload differs by more than one step")
    rem_rel = _linf(rem_g, rem_c) / max(float(np.max(np.abs(
        np.asarray(rem_c)))), 1e-30)
    _check(rem_rel <= 1e-5, f"v2 remainder {rem_rel} relative")
    res["v2_payload_mismatch_fraction"] = frac
    res["v2_rem_rel"] = rem_rel

    # BFP cf stream bytes from the same symbols on both devices
    n_cf = int(np.prod(padded))
    sb = H._v2_sb(cfg, n_cf, C)
    if n_cf % (sb * 32):
        sb = bfp.SB_BLOCKS_SMALL
    cw_h = np.asarray(cw_g)
    K = bfp.choose_K(np.bincount(np.clip(cw_h, 0, 32), minlength=33),
                     bfp.E_DEFAULT, C)
    E = bfp.E_DEFAULT
    _check(int(cw_h.max()) <= K + E <= 16, "parity field must fit flag 1")
    crl = np.clip(cw_h - K, 0, E).astype(np.int32)
    rows = np.asarray(pay_g).reshape(-1, C * 32)

    def cf_bytes(dev):
        out = bfp.encode_core_zz(jax.device_put(rows, dev),
                                 jax.device_put(crl, dev), K, E, sb, C)
        return join(bfp.serialize_prepared_parts(n_cf, K, E, sb, C, crl,
                                                 *out))

    b_dev = cf_bytes(jax.devices()[0])
    b_cpu = cf_bytes(cpu)
    _check(b_dev == b_cpu, "BFP cf stream differs between devices")
    res["bfp_cf_bytes"] = len(b_dev)

    # a stream written on the default device decodes on the CPU device
    if blob is None:
        blob, st = mgard_tpu.compress(v, tol)
        _check(int(st) == 0, "compress failed")
    with jax.default_device(cpu):
        (out, st), t_d = _timed(mgard_tpu.decompress, blob)
    _check(int(st) == 0, "CPU-device decode failed")
    err = _linf(out, v)
    _check(err <= tol, f"cross-device decode L-inf {err} > {tol}")
    res["cross_device_linf"] = err
    res["cpu_decompress_s"] = t_d
    _report("parity", shape=list(shape), **res)


def run_single(sizes=None):
    """Every one-card phase; ``sizes`` maps a phase name to its keyword
    arguments (the CPU test runs them small)."""
    sizes = sizes or {}
    t = {}

    def go(name, fn, **kw):
        t0 = time.perf_counter()
        out = fn(**{**kw, **sizes.get(name, {})})
        t[name] = time.perf_counter() - t0
        return out

    blob, v = go("flagship", phase_flagship)
    go("f64", phase_f64)
    go("nonuniform", phase_nonuniform)
    go("finite_s", phase_finite_s)
    go("mdr", phase_mdr)
    n = sizes.get("flagship", {}).get("n", 512)
    go("parity", phase_parity, n=n, blob=blob, v=v)
    _report("seconds", **t)


# ----------------------------------------------------------------------
# four-card sharded path
# ----------------------------------------------------------------------
def run_multi(shape=(2048, 512, 512), n_dev=4, tol=1e-3):
    """compress_sharded / decompress_sharded / MDRefactorSharded on a 1-D
    mesh of n_dev devices, and single-device compress of the same field."""
    import jax

    import mgard_tpu
    from mgard_tpu.mdr import MDRequestDecomposed
    from mgard_tpu.parallel import (
        MDReconstructSharded,
        MDRefactorSharded,
        compress_sharded,
        decompress_sharded,
        make_subdomain_mesh,
    )

    devs = jax.devices()[:n_dev]
    _check(len(devs) == n_dev, f"need {n_dev} devices, have {len(devs)}")
    mesh = make_subdomain_mesh(n_dev)
    v = field(shape)
    res = {"shape": list(shape), "devices": n_dev}

    # ABS, s=inf
    (blob, st), c_cold, t_c = _twice(compress_sharded, v, tol, math.inf,
                                     mesh=mesh)
    _check(int(st) == 0, "compress_sharded ABS failed")
    (out, st), d_cold, t_d = _twice(decompress_sharded, blob, mesh=mesh)
    _check(int(st) == 0, "decompress_sharded ABS failed")
    err = _linf(out, v)
    _check(err <= tol, f"sharded ABS L-inf {err} > {tol}")
    out2, st = mgard_tpu.decompress(blob)
    _check(int(st) == 0, "plain decompress of the sharded blob failed")
    err2 = _linf(out2, v)
    _check(err2 <= tol, f"sharded blob, plain decompress: {err2} > {tol}")
    res["abs_inf"] = {"tol": tol, "linf": err, "linf_plain_decompress": err2,
                      "ratio": v.nbytes / len(blob), "compress_s": t_c,
                      "decompress_s": t_d, "compress_cold_s": c_cold,
                      "decompress_cold_s": d_cold}

    # REL, s=0
    (blob, st), c_cold, t_c = _twice(compress_sharded, v, tol, 0.0,
                                     mgard_tpu.error_bound_type.REL,
                                     mesh=mesh)
    _check(int(st) == 0, "compress_sharded REL failed")
    (out, st), d_cold, t_d = _twice(decompress_sharded, blob, mesh=mesh)
    _check(int(st) == 0, "decompress_sharded REL failed")
    d = np.asarray(out, np.float64) - v
    l2 = float(np.sqrt(np.mean(d * d)))
    l2v = float(np.sqrt(np.mean(v.astype(np.float64) ** 2)))
    _check(l2 <= tol * l2v, f"sharded REL s=0: {l2} > {tol} * {l2v}")
    res["rel_s0"] = {"tol": tol, "rms_err": l2, "rms_bound": tol * l2v,
                     "ratio": v.nbytes / len(blob), "compress_s": t_c,
                     "decompress_s": t_d, "compress_cold_s": c_cold,
                     "decompress_cold_s": d_cold}

    # sharded MDR at 1e-2
    # cold: the first call includes compilation
    (dmdr, (gmin, gmax)), t_r = _timed(MDRefactorSharded, v, mesh=mesh)
    _check(abs(gmin - float(v.min())) < 1e-6, "sharded MDR global min")
    _check(abs(gmax - float(v.max())) < 1e-6, "sharded MDR global max")
    plans = MDRequestDecomposed(dmdr, 1e-2)
    shared = [max(p[l] for p in plans) for l in range(len(plans[0]))]
    outm, t_q = _timed(MDReconstructSharded, dmdr, shared, mesh=mesh)
    errm = _linf(outm, v)
    _check(errm <= 1e-2, f"sharded MDR L-inf {errm} > 1e-2")
    res["mdr"] = {"tol": 1e-2, "linf": errm, "refactor_cold_s": t_r,
                  "reconstruct_cold_s": t_q}
    res["peak_bytes_in_use_per_device"] = [_peak_bytes(d) for d in devs]

    # the same field through single-device compress, for comparison
    blob, out, times = _roundtrip(v, tol)
    err = _linf(out, v)
    _check(err <= tol, f"single-device L-inf {err} > {tol}")
    res["single_device"] = {"tol": tol, "linf": err,
                            "ratio": v.nbytes / len(blob),
                            "hybrid_flag": _hybrid_flag(blob), **times,
                            "peak_bytes_in_use": _peak_bytes(devs[0])}
    _report("multi", **res)


# ----------------------------------------------------------------------
def _nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    # the parity phase compares against the CPU device: keep that backend
    # available where JAX_PLATFORMS names only the accelerator
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(",") and plats != "cpu":
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found {devs[0].platform} devices, not a GPU",
              file=sys.stderr)
        return 2
    n_need = 4 if args.multi else 1
    if len(devs) < n_need:
        print(f"chip_smoke: need {n_need} GPUs, JAX found {len(devs)}",
              file=sys.stderr)
        return 2
    print(f"device: {devs[0].device_kind} x{len(devs)}", flush=True)
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)

    import mgard_tpu  # noqa: F401  (x64 + compile cache)

    if args.multi:
        run_multi()
    else:
        run_single()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
