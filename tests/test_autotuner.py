"""AutoTuner analogue: persistent table, lookup wiring, CPU sweep smoke.

Reference parity: AutoTuner.h:46-118 profiles kernels across block-size
candidates and persists winners that later runs consult. Here the table is
JSON keyed by (platform, dtype, size bucket) and Config.apply_autotune /
compress(autotune_lookup=True) consult it.
"""

import numpy as np
import pytest

import mgard_tpu
from mgard_tpu.utils import autotuner as at


@pytest.fixture()
def table_path(tmp_path, monkeypatch):
    p = str(tmp_path / "autotune.json")
    monkeypatch.setattr(at, "_TABLE_PATH", p)
    return p


def test_table_persist_and_apply(table_path):
    import jax

    n = 1 << 20
    key = at._key(jax.default_backend(), np.float32, n)
    at.save_table({key: {"bfx_sb_blocks": 2048, "bfp_chunk": 8,
                         "huff_block_size": 4096}})
    assert at.load_table()[key]["bfx_sb_blocks"] == 2048

    cfg = mgard_tpu.Config()
    at.apply_autotune(cfg, (128, 128, 64), np.float32)
    assert cfg.bfx_sb_blocks == 2048
    assert cfg.bfp_chunk == 8
    assert cfg.huff_block_size == 4096

    # explicitly-set knobs must win over the table — including ones whose
    # default is a concrete value rather than None
    cfg2 = mgard_tpu.Config()
    cfg2.bfx_sb_blocks = 4096
    cfg2.huff_block_size = 512
    at.apply_autotune(cfg2, (128, 128, 64), np.float32)
    assert cfg2.bfx_sb_blocks == 4096
    assert cfg2.huff_block_size == 512


def test_compress_consults_table(table_path, monkeypatch):
    """compress() with the default Config must hit the autotuner lookup
    (the 'table entry visibly consulted' contract)."""
    calls = []
    real = at.lookup

    def spy(dtype, n):
        calls.append((np.dtype(dtype).name, int(n)))
        return real(dtype, n)

    monkeypatch.setattr(at, "lookup", spy)
    v = np.linspace(0, 1, 17 * 9 * 9, dtype=np.float32).reshape(17, 9, 9)
    blob, st = mgard_tpu.compress(v, tol=1e-3)
    assert int(st) == 0
    assert calls, "compress() never consulted the autotuner table"
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert float(np.max(np.abs(out - v))) <= 1e-3


def test_tune_bfx_sweep_cpu(table_path):
    """The sweep itself must run on the current platform and return a
    deployable winner from the candidate space."""
    res = at.tune_bfx(at.SB_CANDIDATES[0] * 32 * 2, verbose=False)
    assert res["bfx_sb_blocks"] in at.SB_CANDIDATES
    assert res["bfx_timings_ms"]
