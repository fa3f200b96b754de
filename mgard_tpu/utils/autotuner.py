"""Per-shape kernel auto-tuning with a persistent table.

An analogue of the reference AutoTuner (reference:
include/mgard-x/RuntimeX/AutoTuners/AutoTuner.h:46-118 and the
mgard-x-autotuner executable, src/mgard-x/Executables/mgard-x-autotuner.cpp):
the reference profiles every kernel across block-size candidates and writes
the winners back into per-backend header tables; here the tunable knobs are
the BFX superblock size and the Huffman chunk size, the profiler times the
jitted pipelines on the live device, and the winners persist in a JSON
table keyed by (platform, dtype, size bucket) under
~/.cache/mgard_tpu_autotune.json. Config.apply_autotune() consults the
table; `python -m mgard_tpu.utils.autotuner` runs the sweep (the
autotuner-executable parity point).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Optional

import numpy as np

_TABLE_PATH = os.environ.get(
    "MGARD_TPU_AUTOTUNE_TABLE",
    os.path.expanduser("~/.cache/mgard_tpu_autotune.json"),
)

# candidate spaces (format parameters recorded in each blob, so any choice
# decodes everywhere)
SB_CANDIDATES = (1024, 2048, 4096, 8192)
HUFF_BLOCK_CANDIDATES = (512, 1024, 4096)
# BFP (the deployed default backend) superblock candidates — covers the
# production default bfp.SB_BLOCKS
BFP_SB_CANDIDATES = (8192, 16384, 32768)


def _size_bucket(n: int) -> int:
    """Nearest-log2 bucket of the element count."""
    return max(16, int(round(math.log2(max(n, 1)))))


def _key(platform: str, dtype, n: int) -> str:
    return f"{platform}/{np.dtype(dtype).name}/2^{_size_bucket(n)}"


def load_table() -> dict:
    try:
        with open(_TABLE_PATH) as f:
            return json.load(f)
    except Exception:
        return {}


def save_table(table: dict) -> None:
    os.makedirs(os.path.dirname(_TABLE_PATH), exist_ok=True)
    tmp = _TABLE_PATH + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    os.replace(tmp, _TABLE_PATH)


def lookup(dtype, n: int) -> Optional[dict]:
    import jax

    return load_table().get(_key(jax.default_backend(), dtype, n))


def apply_autotune(config, shape, dtype) -> None:
    """Overwrite tunable Config knobs from the persistent table (no-op when
    the shape/platform was never profiled)."""
    entry = lookup(dtype, int(np.prod(shape)))
    if not entry:
        return
    # explicitly-set knobs always win over the table
    if "bfx_sb_blocks" in entry and config.bfx_sb_blocks is None:
        config.bfx_sb_blocks = int(entry["bfx_sb_blocks"])
    # explicitly-set knobs always win: huff_block_size has a non-None
    # default, so "still at the dataclass default" is the untouched signal
    if ("huff_block_size" in entry
            and config.huff_block_size == type(config).huff_block_size):
        config.huff_block_size = int(entry["huff_block_size"])
    if "bfp_sb_blocks" in entry and config.bfp_sb_blocks is None:
        config.bfp_sb_blocks = int(entry["bfp_sb_blocks"])
    if "bfp_chunk" in entry and not config.bfp_chunk:
        config.bfp_chunk = int(entry["bfp_chunk"])
    if "bfp_base_planes" in entry and not config.bfp_base_planes:
        config.bfp_base_planes = int(entry["bfp_base_planes"])
    if "bfp_resid_planes" in entry and not config.bfp_resid_planes:
        config.bfp_resid_planes = int(entry["bfp_resid_planes"])


def _time_device(fn, *args, reps: int = 3) -> float:
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        leaf = jax.tree_util.tree_leaves(out)[0]
        _ = np.asarray(leaf.ravel()[:1])
        best = min(best, time.perf_counter() - t0)
    return best


def tune_bfx(n: int, dtype=np.int32, verbose: bool = True) -> dict:
    """Profile BFX encode+decode across superblock sizes for an n-symbol
    stream; returns {'bfx_sb_blocks': winner, ...timings}."""
    import jax
    import jax.numpy as jnp

    from ..lossless import bfx

    rng = np.random.default_rng(0)
    sym = jnp.asarray((rng.standard_normal(n) * 20).astype(np.int32))
    results = {}
    for sb in SB_CANDIDATES:
        if n < sb * 32:
            continue
        npad = (n + sb * 32 - 1) // (sb * 32) * (sb * 32)
        s = sym
        if npad != n:
            s = jnp.concatenate([s, jnp.zeros(npad - n, jnp.int32)])
        try:
            t_enc = _time_device(
                lambda s=s, sb=sb: bfx.encode_core(s, sb)
            )
            flat, w, _tot = bfx.encode_core(s, sb)
            t_dec = _time_device(
                lambda flat=flat, w=w, sb=sb: bfx.decode_core(flat, w, sb)
            )
        except Exception as e:  # candidate not lowerable on this platform
            if verbose:
                print(f"  sb={sb}: failed ({type(e).__name__})")
            continue
        results[sb] = t_enc + t_dec
        if verbose:
            print(f"  sb={sb}: enc {t_enc*1e3:.1f} ms dec {t_dec*1e3:.1f} ms")
    if not results:
        return {}
    best = min(results, key=results.get)
    return {"bfx_sb_blocks": best,
            "bfx_timings_ms": {str(k): round(v * 1e3, 2) for k, v in results.items()}}


def tune_bfp(n: int, verbose: bool = True) -> dict:
    """Profile the BFP codec (the deployed default backend) for an
    n-symbol stream: superblock size over BFP_SB_CANDIDATES by encode+
    decode time, then K refined +-1 around the histogram pick (and E in
    {6, 8, 10}) by measured words/block at fixed time tolerance."""
    import jax
    import jax.numpy as jnp

    from ..lossless import bfp

    rng = np.random.default_rng(0)
    # width-heterogeneous stream (mixture of scales) so the sort/ratio
    # machinery is exercised like real coefficient data
    mag = np.exp(rng.uniform(0, 6, n))
    sym = jnp.asarray((rng.standard_normal(n) * mag).astype(np.int32))
    E0 = bfp.E_DEFAULT
    hcw = np.asarray(bfp._width_hist(sym))
    K0 = bfp.choose_K(hcw, E0)
    results = {}
    # sweep (sb, chunk): sb trades superblock count against per-superblock
    # work, chunk trades the sort-gather row width against chunk-max ratio
    for sb in BFP_SB_CANDIDATES:
        if n < sb * 32:
            continue
        npad = bfp._pad_to(n, sb)
        s = sym
        if npad != n:
            s = jnp.concatenate([s, jnp.zeros(npad - n, jnp.int32)])
        NB = npad // 32
        for C in (4, 8, 16):
            exc_cap = bfp._exc_bucket(
                int(hcw[K0 + E0 + 1:].sum()), NB // C
            )
            try:
                t_enc = _time_device(
                    lambda s=s, sb=sb, cap=exc_cap, C=C: bfp.encode_core(
                        s, K0, E0, sb, cap, C)
                )
                out = bfp.encode_core(s, K0, E0, sb, exc_cap, C)
                t_dec = _time_device(
                    lambda o=out, sb=sb, NB=NB, C=C: bfp.decode_core(
                        o[0], o[1], o[2], o[4], o[5], K0, E0, sb, NB, C)
                )
            except Exception as e:  # candidate not lowerable here
                if verbose:
                    print(f"  bfp sb={sb} C={C}: failed ({type(e).__name__})")
                continue
            results[(sb, C)] = t_enc + t_dec
            if verbose:
                print(f"  bfp sb={sb} C={C}: enc {t_enc*1e3:.1f} ms "
                      f"dec {t_dec*1e3:.1f} ms")
    if not results:
        return {}
    best_sb, best_chunk = min(results, key=results.get)
    # K/E refinement by expected words/block from the real histogram
    # (choose_K's cost model), scanning K0-1..K0+1 and E in {6, 8, 10}
    best_ke, best_cost = (K0, E0), float("inf")
    w = np.arange(33)
    totc = max(int(hcw.sum()), 1)
    for E in (6, 8, 10):
        for K in range(max(K0 - 1, 0), K0 + 2):
            rlv = np.clip(w - K, 0, E)
            p_exc = hcw[K + E + 1:].sum() / totc
            cost = K + float((hcw * rlv).sum()) / totc + p_exc * (1 + 128) / 4
            if cost < best_cost:
                best_ke, best_cost = (K, E), cost
    entry = {
        "bfp_sb_blocks": best_sb,
        "bfp_chunk": int(best_chunk),
        "bfp_base_planes": int(best_ke[0]),
        "bfp_resid_planes": int(best_ke[1]),
        "bfp_timings_ms": {
            f"{k[0]}/{k[1]}": round(v * 1e3, 2) for k, v in results.items()
        },
    }
    if verbose:
        print(f"  bfp -> sb={best_sb} C={best_chunk} K={best_ke[0]} E={best_ke[1]}")
    return entry


def autotune(n: int = 1 << 24, dtype=np.float32, verbose: bool = True) -> dict:
    """Run the sweep for one size bucket and persist the winners."""
    import jax

    key = _key(jax.default_backend(), dtype, n)
    if verbose:
        print(f"autotuning {key} ...")
    entry = {}
    entry.update(tune_bfx(n, verbose=verbose))
    entry.update(tune_bfp(n, verbose=verbose))
    table = load_table()
    table[key] = entry
    save_table(table)
    if verbose:
        print(f"-> bfx sb {entry.get('bfx_sb_blocks')}, bfp sb "
              f"{entry.get('bfp_sb_blocks')} written to {_TABLE_PATH}")
    return entry


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    n = 1 << 24
    for a in argv:
        if a.startswith("--n="):
            n = int(a.split("=")[1])
    autotune(n)


if __name__ == "__main__":
    main()
