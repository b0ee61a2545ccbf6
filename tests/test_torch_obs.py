"""The port's plan-vs-actual report and its two command lines.

* ``repro_torch.obs.plan_vs_actual`` and ``format_report`` give the JAX
  package's rows and lines on the same plan object and registry (the
  port's plan, after a paged + radix run that publishes prefix pages);
  outside the band both append a calibration warning, the port's naming
  no module it lacks.
* ``python -m repro_torch.obs.cli report --device cpu`` and ``python -m
  repro_torch.launch.serve --device cpu`` exit 0; the report exits 1 when
  the pool peak passes the plan's pages; the cluster's options exit with
  a message.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from repro.obs.planview import format_report as ref_format_report
from repro.obs.planview import plan_vs_actual as ref_plan_vs_actual
from repro_torch.configs import get_model_config
from repro_torch.hw import h100_spec
from repro_torch.obs import DEFAULT_BAND, format_report, plan_vs_actual
from repro_torch.obs import cli
from repro_torch.serve import ServeEngine, ServePolicy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engine():
    """A reduced llama3.2-1b paged + radix engine after a run whose
    requests share two pages of prefix."""
    cfg = get_model_config("llama3.2-1b").reduced()
    eng = ServeEngine(cfg, ServePolicy(max_new_tokens=3, max_len=128,
                                       max_slots=2, prefix_cache="radix"),
                      spec=h100_spec(smem_bytes=16 << 10), device="cpu")
    t = eng.page.page_tokens
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 256, 2 * t, dtype=np.int32)
    eng.generate([np.concatenate([shared, rng.integers(0, 256, 5 + i,
                                                       dtype=np.int32)])
                  for i in range(3)])
    assert eng.metrics["prefix_resident_bytes"] > 0
    return eng


@pytest.mark.parametrize("band", [DEFAULT_BAND, (0.0, 1e-6)])
def test_report_matches_reference(engine, band):
    rows = plan_vs_actual(engine.plan, engine.obs, band=band)
    ref_rows = ref_plan_vs_actual(engine.plan, engine.obs, band=band)
    assert rows == ref_rows
    assert [(r["level"], r["kind"], r["metric"]) for r in rows] == [
        ("NVLINK", "mesh", "hbm_prefix_leftover"),
        ("L2", "container", "budget"),
        ("SMEM", "page", "pool_pages"),
        ("SMEM", "page", "vmem_working_set"),
        ("REG", "leaf", "leaf_partition")]
    by = {r["metric"]: r for r in rows}
    assert by["hbm_prefix_leftover"]["predicted"] == \
        engine.plan.prefix_budget()
    assert by["hbm_prefix_leftover"]["observed"] == \
        engine.obs.value("prefix_peak_resident_bytes")
    assert by["pool_pages"]["observed"] == engine.metrics["peak_pages"]
    assert by["pool_pages"]["within_band"] == (band == DEFAULT_BAND)
    lines = format_report(rows, band=band)
    ref_lines = ref_format_report(ref_rows, band=band)
    warned = any(r["ratio"] is not None and not r["within_band"]
                 for r in rows)
    assert warned or band == DEFAULT_BAND
    assert lines[:len(rows) + 1] == ref_lines[:len(rows) + 1]
    assert len(lines) == len(ref_lines) == len(rows) + 1 + warned
    if warned:
        assert lines[-1].startswith("WARNING: plan-vs-actual residual "
                                    "outside band")
        # The hint names the port's own calibration, never the JAX
        # package's (whose artifact holds TPU measurements).
        assert "python -m repro_torch.launch.dryrun --calibrate" in lines[-1]
        assert "repro.launch" not in lines[-1]


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)


def test_obs_cli_report_exits_0_on_the_cpu(tmp_path):
    trace = tmp_path / "trace.json"
    out = _run("repro_torch.obs.cli", "report", "--device", "cpu",
               "--trace", str(trace))
    assert out.returncode == 0, out.stderr
    assert "pool_pages" in out.stdout and "on cpu" in out.stdout
    # The shared prefix spans a page: the tree holds it, and the HBM
    # prefix row observes its bytes.
    row = [ln for ln in out.stdout.splitlines()
           if " hbm_prefix_leftover " in ln]
    assert len(row) == 1 and int(row[0].split()[4]) > 0, row
    assert trace.stat().st_size > 0


def test_obs_cli_report_exits_1_past_the_planned_pool(monkeypatch, capsys):
    real = cli.plan_vs_actual

    def inflated(plan, registry, band=DEFAULT_BAND):
        rows = real(plan, registry, band=band)
        for r in rows:
            if r["metric"] == "pool_pages":
                r["observed"] = r["predicted"] + 1
        return rows

    monkeypatch.setattr(cli, "plan_vs_actual", inflated)
    assert cli.main(["report", "--device", "cpu", "--prompts", "1",
                     "--new", "1"]) == 1
    assert "exceeds" in capsys.readouterr().err


def test_launch_serve_exits_0_on_the_cpu():
    out = _run("repro_torch.launch.serve", "--arch", "llama3.2-1b",
               "--prefix", "radix", "--tokens", "8", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "32 tokens in" in out.stdout
    assert "[serve] prefix: hits=" in out.stdout


@pytest.mark.parametrize("flag", [["--cluster", "2"], ["--disagg", "1:1"],
                                  ["--serve", "1"]])
def test_launch_serve_refuses_the_cluster(flag, capsys):
    """The cluster is ported: ``--cluster 2`` serves through two replicas.
    What the command line still refuses is a fleet it cannot run: a
    disaggregated one whose default 64-token prompt fits inside one
    planned page (no completed page to transfer), and the HTTP front end
    without a cluster behind it."""
    from repro_torch.launch import serve

    args = flag + ["--device", "cpu"]
    if flag[0] == "--cluster":
        assert serve.main(args + ["--tokens", "2", "--batch", "2"]) == 0
        assert "replicas=2 (DCN np=2)" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit,
                       match="planned page" if flag[0] == "--disagg"
                       else "cluster"):
        serve.main(args)
