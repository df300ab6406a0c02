"""chip_smoke.py: its phases at tiny sizes on the CPU (the rehearsal of the
chip run), and its refusal to run anywhere but on a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY = dict(hidden=32, layers=2, num_pdfs=256, ivector_dim=8, ubm_gauss=8)


def _run_script(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            continue
    return False


def test_refuses_a_cpu_only_host(tmp_path):
    proc = _run_script(REPO / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout), proc.stdout
    assert "no GPU" in proc.stderr


def test_refuses_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_script(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout), proc.stdout


def test_phase_synthetic(tmp_path):
    chip_smoke.phase_synthetic(tmp_path, n_utts=4)


@pytest.fixture(scope="module")
def tiny_flagship(tmp_path_factory):
    return chip_smoke.build_flagship(tmp_path_factory.mktemp("fl"), **TINY)


def test_flagship_phases_tiny(tiny_flagship):
    fl = tiny_flagship
    assert fl.graph.num_states > 7000  # the committed grammar, not a toy
    t, pcms, decode_c, lp, lengths = chip_smoke.phase_flagship_batch(
        fl, "cpu", batch=2, seconds=1.0
    )
    results = chip_smoke.phase_flagship_stream(fl, "cpu", lanes=2, seconds=1.0)
    assert len(results) == 2
    errs = chip_smoke.phase_parity(fl, t, pcms, lp, n_sub=2)
    assert set(errs) == set(chip_smoke.TOL)
    chip_smoke.phase_determinism(decode_c, lp, lengths)
    chip_smoke.phase_compile_cache()


def test_phase_four_on_virtual_devices(tiny_flagship):
    chip_smoke.phase_four(
        tiny_flagship, "cpu", batch=4, lanes=4, seconds=1.0, n_devices=4
    )


def test_check_raises():
    with pytest.raises(chip_smoke.SmokeFailure, match="boom"):
        chip_smoke.check(False, "boom")
