"""Randomized compress/decompress property sweep (CPU).

The error-bound contract is the framework's core oracle (reference:
tests/test_compress.cpp randomized grids): for every sampled
(shape, dtype, s, mode, tol, backend, decomposition, coords) combination,
compress -> decompress must hold the certified bound:
  s=inf        : max|u - u~| <= tol (REL: <= tol * ||u||_inf)
  finite s     : ||u - u~||_s <= tol (REL: <= tol * ||u||_s), checked in
                 the exact-geometry multilevel s-norm (ops/norms) on
                 small shapes, plus the L2 surrogate everywhere
Run: env JAX_PLATFORMS=cpu python scripts/property_sweep.py [--cases=N] [--seed=S]
Prints one line per failure and a final tally; exit 1 on any failure.
"""

import math
import sys
import time

import numpy as np


def field(rng, shape, dtype):
    axes = [np.linspace(0, 1, n) for n in shape]
    v = np.zeros(shape)
    for _ in range(4):
        ks = rng.integers(1, 5, len(shape))
        ph = rng.uniform(0, 2 * np.pi)
        w = np.ones(shape)
        for d, (k, x) in enumerate(zip(ks, axes)):
            s = [1] * len(shape)
            s[d] = shape[d]
            w = w * np.sin(2 * np.pi * k * x + ph).reshape(s)
        v = v + rng.uniform(0.2, 1.0) * w
    v = v + 0.05 * rng.standard_normal(shape)
    return np.ascontiguousarray(v, dtype)


def main():
    import mgard_tpu
    from mgard_tpu.dtypes import (decomposition_type, error_bound_type,
                                  lossless_type)
    from mgard_tpu.ops.norms import norm as snorm

    cases = 60
    seed = int(time.time()) % 100000
    for a in sys.argv[1:]:
        if a.startswith("--cases="):
            cases = int(a.split("=")[1])
        if a.startswith("--seed="):
            seed = int(a.split("=")[1])
    rng = np.random.default_rng(seed)
    print(f"# property sweep: {cases} cases, seed {seed}")

    shapes = [(17,), (33,), (64,), (9, 17), (12, 13), (16, 16), (33, 21),
              (9, 9, 17), (15, 16, 17), (8, 8, 8), (17, 33), (5, 9, 17),
              (6, 7, 8, 9), (5, 4, 6, 7, 8)]
    backends = [lossless_type.BFX, lossless_type.BFP, lossless_type.Huffman,
                lossless_type.CPU_Lossless, lossless_type.BlockDelta,
                lossless_type.ZeroRLE_Rans]
    fails = 0
    for i in range(cases):
        shape = shapes[rng.integers(len(shapes))]
        dtype = np.float32 if rng.random() < 0.6 else np.float64
        s = float(rng.choice([math.inf, math.inf, 0.0, 1.0, 0.5, -0.5, -1.0]))
        mode = (error_bound_type.REL if rng.random() < 0.4
                else error_bound_type.ABS)
        tol = float(10.0 ** rng.uniform(-4, -1))
        dec = (decomposition_type.SingleDim if rng.random() < 0.25
               else decomposition_type.MultiDim if rng.random() < 0.6
               else decomposition_type.Hybrid)
        back = backends[rng.integers(len(backends))]
        coords = None
        if rng.random() < 0.25 and not math.isinf(s):
            coords = [np.sort(rng.uniform(size=n)) for n in shape]
            for c in coords:
                c[0], c[-1] = 0.0, 1.0
        v = field(rng, shape, dtype)
        cfg = mgard_tpu.Config()
        cfg.decomposition = dec
        cfg.lossless = back
        tag = (f"[{i}] {shape} {np.dtype(dtype).name} s={s:g} "
               f"{mode.name} tol={tol:.1e} {dec.name} {back.name}"
               f"{' coords' if coords is not None else ''}")
        try:
            blob, st = mgard_tpu.compress(v, tol=tol, s=s, mode=mode,
                                          config=cfg, coords=coords)
            assert int(st) == 0, f"compress status {st}"
            out, st2 = mgard_tpu.decompress(blob)
            assert int(st2) == 0, f"decompress status {st2}"
            d = out.astype(np.float64) - v.astype(np.float64)
            if math.isinf(s):
                err = float(np.max(np.abs(d)))
                lim = tol * (float(np.max(np.abs(v))) if mode ==
                             error_bound_type.REL else 1.0)
            else:
                err = snorm(d, s, coords=coords)
                # REL finite-s converts via the (normalized) L2 norm —
                # the reference NormCalculator's convention, not the
                # s-norm (highlevel.calculate_norm)
                lim = tol * (float(np.sqrt(np.mean(
                    v.astype(np.float64) ** 2))) if mode ==
                    error_bound_type.REL else 1.0)
            if err > lim * (1 + 1e-9):
                fails += 1
                print(f"FAIL {tag}: err {err:.4e} > {lim:.4e} "
                      f"(frac {err/lim:.2f})")
            else:
                print(f"ok   {tag}: frac {err/max(lim,1e-300):.3f} "
                      f"ratio {v.nbytes/len(blob):.2f}")
        except Exception as exc:  # noqa: BLE001 - report and continue
            fails += 1
            print(f"CRASH {tag}: {type(exc).__name__}: {exc}")
    print(f"# done: {cases - fails}/{cases} passed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
