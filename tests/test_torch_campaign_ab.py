"""``campaign_ab.py``, the campaign A/B script, checked on the CPU: its
sign test, and a short run of this tree against itself (the script's
``--device cpu`` mode, the kernel's plain version)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import campaign_ab  # noqa: E402


@pytest.mark.parametrize("slower,n,want", [
    (0, 10, 2 / 1024), (10, 10, 2 / 1024), (5, 10, 1.0),
    (2, 10, 2 * (1 + 10 + 45) / 1024), (1, 2, 1.0)])
def test_sign_test_p(slower, n, want):
    assert campaign_ab._sign_p(slower, n) == pytest.approx(want)


def test_runs_on_cpu_against_itself(tmp_path):
    out = tmp_path / "runs.jsonl"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "campaign_ab.py"), "--base", str(ROOT),
         "--pairs", "2", "--jobs", "20", "--device", "cpu", "--out",
         str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["pairs"] == 2
    change = summary["summary"]["change"]["ms_per_step"]
    assert change["pairs"] == 2 and len(change["diffs_vs_base"]) == 2
    assert change["diff_vs_base_ci95"] >= 0
    runs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["variant"] for r in runs] == ["base", "change", "change",
                                            "base"]
    assert len({r["digest"] for r in runs}) == 1
    again = subprocess.run(
        [sys.executable, str(ROOT / "campaign_ab.py"), "--summarize",
         str(out)], capture_output=True, text=True, timeout=60)
    assert again.returncode == 0, again.stderr
    assert json.loads(again.stdout) == summary
