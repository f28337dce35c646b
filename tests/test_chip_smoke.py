"""chip_smoke.py's contract, checked without a card: it refuses to run
without a GPU, ``--four`` selects only the mesh phase, the last line has
the exact result format, and nvidia-smi's output parses."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from lbm_tpu.utils import profiling

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = REPO / "chip_smoke.py"


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(script: pathlib.Path, *args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, str(script), *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [[], ["--four"]], ids=["one", "four"])
def test_refuses_to_run_without_a_gpu(tmp_path, args):
    out = _run(SCRIPT, *args, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_alone_without_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    out = _run(lone, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_four_selects_only_the_mesh_phase():
    mod = _load()
    assert mod.phases(True) == ("four",)
    assert mod.phases(False) == ("cases", "giant", "kernel")


def test_last_line_format():
    mod = _load()

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = mod.result_line([Dev(), Dev(), Dev(), Dev()])
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4},
    }
    assert "\n" not in line


def test_parses_nvidia_smi_output():
    text = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
            "NVIDIA H100 80GB HBM3, 400.00 W\n")
    assert profiling.parse_nvidia_smi(text) == [
        ("NVIDIA H100 80GB HBM3", "700.00 W"),
        ("NVIDIA H100 80GB HBM3", "400.00 W"),
    ]
    with pytest.raises(ValueError, match="nvidia-smi"):
        profiling.parse_nvidia_smi("garbage without a comma")


def test_device_report_reads_a_stubbed_nvidia_smi(tmp_path, monkeypatch):
    """On a GPU the report carries each card's name and power limit from
    nvidia-smi (here a stub on PATH); elsewhere it does not call it."""
    stub = tmp_path / "nvidia-smi"
    stub.write_text('#!/bin/sh\necho "NVIDIA H100 80GB HBM3, 700.00 W"\n')
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(profiling.jax, "devices", lambda: [Dev()])
    report = profiling.device_report()
    assert report == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "cards": [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}],
    }
    monkeypatch.setattr(profiling.jax, "devices",
                        lambda: [type("D", (), {"platform": "cpu",
                                                "device_kind": "cpu"})()])
    assert "cards" not in profiling.device_report()
