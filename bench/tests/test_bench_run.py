"""The command's contract off the card: no result without a CUDA card,
none where JAX or the JAX package was loaded (top-level names compared
whole), and the result line's keys."""

import json
import subprocess
import sys
import time

import torch

from bench import harness, run

ROOT = run.ROOT


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, torch; "
         "torch.cuda.is_available = lambda: False; "
         "sys.argv = ['run.py', '--workload', 'deepseek-v2-236b-l8.longdoc', "
         "'--seed', '2147483999', '--seconds', '1', '--trace', '0']; "
         f"sys.path.insert(0, {str(ROOT)!r}); "
         "from bench import run; sys.exit(run.main())"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_no_result_outside_a_checkout(tmp_path):
    """With only BENCHMARK.json and bench/ (no program), no result."""
    import shutil

    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "deepseek-v2-236b-l8.longdoc", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.serve", "reprox", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.serve", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "repro"]


def test_result_line_keys(tiny):
    r = harness.run("mixtral-8x7b-l16.tiny", 9, 3.0, False, time.monotonic(),
                    device="cpu", bench=tiny)
    keys = [k for k in r if not k.startswith("_")]
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert r["checks"]["logit_gap_mean"]["limit"] is not None
    json.dumps({k: r[k] for k in keys})
