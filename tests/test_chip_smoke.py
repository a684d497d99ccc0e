"""``chip_smoke.py`` on the CPU: its phase functions at tiny sizes against
the pinned oracles, its refusal to run without a GPU, and its last line.

The full-size phases run only on the card (``python chip_smoke.py``)."""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

import chip_smoke
from infiniteexamodels_jax import models as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase1_primitives_and_assembly_tiny():
    chip_smoke.phase1(quad_n=40, opf_n=100, reps=1)


def test_hovercraft41_solve_phase():
    r = chip_smoke.solve_phase(
        2, "hovercraft-41", lambda: M.hovercraft(num_supports=41),
        chip_smoke.ORACLES["hovercraft-41"])
    assert r.status == "first_order"


def test_mixed_precision_phase_hovercraft41():
    r = chip_smoke.solve_phase(
        4, "hovercraft-41", lambda: M.hovercraft(num_supports=41),
        chip_smoke.ORACLES["hovercraft-41"], factor_dtype="mixed")
    assert r.status == "first_order"


def test_parameter_update_phase():
    chip_smoke.phase5()


def test_solve_phase_rejects_wrong_oracle():
    with pytest.raises(AssertionError, match="objective off"):
        chip_smoke.solve_phase(
            2, "hovercraft-41", lambda: M.hovercraft(num_supports=41),
            chip_smoke.ORACLES["hovercraft-41"] + 1e-3)


def test_ok_line_format():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")] * 4
    line = chip_smoke.ok_line(devs)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 4}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100", "count": 4}}')


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_gpu():
    p = _run(ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr + p.stdout


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
