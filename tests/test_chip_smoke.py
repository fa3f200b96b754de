"""chip_smoke.py's phases at tiny sizes on the CPU: the same code the card
runs (control flow, bounds, parity checks), and the script's refusal to
run without a GPU."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# phase name -> (function, tiny-size keyword arguments)
PHASES = {
    "flagship": (chip_smoke.phase_flagship, {"n": 64}),
    "f64": (chip_smoke.phase_f64, {"n_demoted": 32, "n_native": 16}),
    "nonuniform": (chip_smoke.phase_nonuniform, {"n": 24}),
    "finite_s": (chip_smoke.phase_finite_s, {"n": 24}),
    "mdr": (chip_smoke.phase_mdr, {"n": 24}),
    "parity": (chip_smoke.phase_parity, {"n": 64, "n_oracle": 16}),
    "multi": (chip_smoke.run_multi, {"shape": (36, 17, 9), "n_dev": 4}),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_tiny(name, capsys):
    fn, kw = PHASES[name]
    fn(**kw)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("phase ")]
    assert len(lines) == 1, lines
    tag, payload = lines[0][len("phase "):].split(" ", 1)
    assert tag == name
    assert isinstance(json.loads(payload), dict)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_field_is_seeded():
    a = chip_smoke.field((5, 7, 9))
    b = chip_smoke.field((5, 7, 9))
    assert a.dtype.name == "float32" and (a == b).all()
    assert (chip_smoke.field((5, 7, 9), seed=1) != a).any()
