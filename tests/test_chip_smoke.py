"""chip_smoke.py on the CPU: each phase at a tiny size, the multi-card
modes on four virtual devices, the refusal to run without a GPU, and an
import chain free of PyYAML and OpenCV."""

import os
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def odometry():
    return chip_smoke.phase_odometry(n=4096, n_frames=2, max_iter=300,
                                     chunk=1024, timed=False)


def test_phase_odometry_tiny(odometry):
    assert len(odometry["results"]) == 2
    assert odometry["errors"].max() < chip_smoke.POSE_ERR_MAX


def test_phase_parity_tiny(odometry):
    chip_smoke.phase_parity(odometry, rows=512, timed=False)


def test_phase_ba_tiny():
    out = chip_smoke.phase_ba(n=1024, timed=False)
    assert out["poses"].shape == (5, 3, 4)


def test_phase_frontend_tiny():
    chip_smoke.phase_frontend(width=620, height=188, fx=359.4, capacity=4096,
                              max_disp=64, timed=False)


def test_four_card_modes_on_virtual_devices():
    chip_smoke.four_card_modes(n=4096, max_iter=60, chunk=1024,
                               ba_points=1024)


def test_main_exits_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "no GPU" in str(exc.value.code)
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines())


def test_smoke_imports_without_yaml_or_cv2():
    """Everything chip_smoke imports loads, and a phase runs, with PyYAML
    and OpenCV unavailable (a None entry in sys.modules makes the import
    fail)."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['cv2'] = None\n"
        "import unified_cvo_tpu, chip_smoke\n"
        "chip_smoke.phase_ba(n=512, timed=False)\n"
        "print('imported without yaml/cv2')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported without yaml/cv2" in r.stdout


def test_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo the
    script fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
