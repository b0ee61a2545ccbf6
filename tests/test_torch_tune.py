"""The port's tuning artifact and sweeps, mirroring ``tests/test_tune.py``.

Precedence is analytic < tuned: a measured winner in the port's artifact
overrides the analytic block exactly when ``(kernel, arch, bucket,
fingerprint)`` matches, and every tuned block re-passes the planner's own
shared-memory (and register) filter.  Tests write artifacts through the
``REPRO_TORCH_TUNING`` override; the autouse fixture points it at a path
that does not exist, so the suite never sees a machine's own artifact.
"""

import json
import os

import pytest

from repro.tune.cache import TuningEntry as JaxTuningEntry
from repro.tune.cache import record_tuned as jax_record_tuned
from repro_torch.core.autotile import (_attn_smem_bytes, _matmul_smem_bytes,
                                       plan_attention, plan_matmul)
from repro_torch.core.plan import PAGE_BUFFERING, PlanPolicy, Workload, \
    plan_run
from repro_torch.hw import h100_spec
from repro_torch.models.mamba2 import choose_chunk
from repro_torch.tune.cache import (
    TUNING_ENV,
    TuningEntry,
    bucket_attention,
    bucket_matmul,
    bucket_paged,
    bucket_ssd,
    hw_fingerprint,
    load_tuning,
    lookup_tuned,
    record_tuned,
    tuning_path,
)
from repro_torch.tune.sweep import (run_sweeps, sweep_attention,
                                    sweep_matmul, sweep_paged)

SPEC = h100_spec()
SMEM = SPEC.smem_bytes


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv(TUNING_ENV, str(tmp_path / "absent.json"))


@pytest.fixture
def tune_path(tmp_path, monkeypatch):
    p = tmp_path / "tuning_torch.json"
    monkeypatch.setenv(TUNING_ENV, str(p))
    return p


def _write(path, *entries):
    record_tuned(list(entries), path=str(path))
    return str(path)


def _entry(kernel, bucket, block, analytic_block, fingerprint=None,
           speedup=1.5):
    return TuningEntry(
        kernel=kernel, arch=SPEC.name, bucket=bucket,
        fingerprint=fingerprint or hw_fingerprint(), block=block,
        analytic_block=analytic_block, median_us=100.0,
        analytic_us=100.0 * speedup, speedup=speedup)


class TestCacheRoundTrip:
    def test_record_load_lookup(self, tune_path):
        e = _entry("flash_attention", "q128kv128d64b4",
                   {"block_q": 64, "block_kv": 128},
                   {"block_q": 128, "block_kv": 128})
        _write(tune_path, e)
        assert e.key in load_tuning()
        got = lookup_tuned("flash_attention", SPEC.name, "q128kv128d64b4")
        assert got["block"] == {"block_q": 64, "block_kv": 128}
        assert got["speedup"] == 1.5

    def test_merge_preserves_other_keys(self, tune_path):
        _write(tune_path, _entry("matmul_cc", "m512k512n512b4",
                                 {"bm": 128, "bk": 512, "bn": 512},
                                 {"bm": 512, "bk": 512, "bn": 512}))
        _write(tune_path, _entry("flash_attention", "q128kv128d64b4",
                                 {"block_q": 64, "block_kv": 128}, {}))
        assert len(load_tuning()) == 2

    def test_corrupt_artifact_is_empty_never_raises(self, tune_path):
        tune_path.write_text("{not json")
        assert load_tuning() == {}
        assert lookup_tuned("matmul_cc", SPEC.name, "m1k1n1b2") is None

    def test_stat_keyed_reload(self, tune_path):
        _write(tune_path, _entry("matmul_cc", "b1",
                                 {"bm": 8, "bk": 8, "bn": 8}, {}))
        assert len(load_tuning()) == 1
        data = json.loads(tune_path.read_text())
        data["entries"] = {}
        tune_path.write_text(json.dumps(data))
        assert load_tuning() == {}

    def test_jax_written_entry_is_read_by_the_port(self, tune_path):
        """One schema: an entry the JAX package's record_tuned writes under
        the port's fingerprint and arch is the port's tuned block."""
        analytic = plan_attention(128, 128, 64, dtype_bytes=4,
                                  use_tuned=False)
        block = {"block_q": analytic.block_q // 2,
                 "block_kv": analytic.block_kv}
        jax_record_tuned([JaxTuningEntry(
            kernel="flash_attention", arch=SPEC.name,
            bucket=bucket_attention(128, 128, 64, 4),
            fingerprint=hw_fingerprint(), block=block,
            analytic_block={"block_q": analytic.block_q,
                            "block_kv": analytic.block_kv},
            median_us=10.0, analytic_us=20.0, speedup=2.0)],
            path=str(tune_path))
        p = plan_attention(128, 128, 64, dtype_bytes=4)
        assert p.source == "tuned"
        assert (p.block_q, p.block_kv) == (block["block_q"],
                                           block["block_kv"])

    def test_default_path_is_the_ports_own(self, monkeypatch):
        monkeypatch.delenv(TUNING_ENV)
        path = tuning_path()
        assert os.path.basename(path) == "tuning_torch.json"
        assert os.path.basename(os.path.dirname(path)) == "experiments"
        assert not path.endswith(os.path.join("experiments", "tuning.json"))

    def test_cpu_fingerprint_never_names_a_card(self):
        assert hw_fingerprint("cpu").startswith("cpu:")


class TestPlannerConsultsTuned:
    def test_attention_returns_tuned_block(self, tune_path):
        analytic = plan_attention(128, 128, 64, dtype_bytes=4,
                                  use_tuned=False)
        tuned_block = {"block_q": max(8, analytic.block_q // 2),
                       "block_kv": analytic.block_kv}
        assert tuned_block["block_q"] != analytic.block_q
        _write(tune_path, _entry(
            "flash_attention", bucket_attention(128, 128, 64, 4),
            tuned_block,
            {"block_q": analytic.block_q, "block_kv": analytic.block_kv},
            speedup=1.25))
        p = plan_attention(128, 128, 64, dtype_bytes=4)
        assert p.source == "tuned"
        assert p.block_q == tuned_block["block_q"]
        assert p.est_vmem_bytes == _attn_smem_bytes(p.block_kv, 64, 4)

    def test_matmul_tile_level_returns_tuned_with_provenance(self,
                                                             tune_path):
        analytic = plan_matmul(512, 512, 512, dtype_bytes=4)
        tuned_block = {"bm": max(8, analytic.bm // 2), "bk": analytic.bk,
                       "bn": analytic.bn}
        assert tuned_block["bm"] != analytic.bm
        _write(tune_path, _entry(
            "matmul_cc", bucket_matmul(512, 512, 512, 4), tuned_block,
            {"bm": analytic.bm, "bk": analytic.bk, "bn": analytic.bn},
            speedup=1.4))
        hp = plan_run(SPEC.hierarchy(),
                      Workload(matmul=(512, 512, 512), dtype_bytes=4),
                      PlanPolicy(spec=SPEC))
        tile = hp.tile_plan()
        assert tile.source == "tuned"
        assert (tile.bm, tile.bk, tile.bn) == (
            tuned_block["bm"], tuned_block["bk"], tuned_block["bn"])
        smem = hp.level("SMEM")
        assert smem.kind == "tile"
        assert smem.detail["tuning"]["speedup"] == 1.4

    def test_tuned_block_clamped_to_smaller_problem(self, tune_path):
        # Bucket m1024... covers m=513..1024: a winner measured at 1024
        # clamps to the smaller problem's rounded-up dims.
        _write(tune_path, _entry(
            "matmul_cc", bucket_matmul(600, 600, 600, 2),
            {"bm": 64, "bk": 1024, "bn": 64}, {}))
        p = plan_matmul(600, 600, 600, dtype_bytes=2)
        assert p.source == "tuned"
        assert p.bk == 608                 # 600 in whole 16-value steps
        assert _matmul_smem_bytes(p.bm, p.bk, p.bn, 2) <= SMEM

    def test_page_level_returns_tuned_page(self, tune_path):
        tok_bytes = 2 * 2 * 16 * 4          # K+V x n_kv x d x f32, 1 layer
        wl = Workload(kv_bytes_per_token=tok_bytes, kv_layers=1,
                      kv_heads=2, max_tokens=64)
        hp0 = plan_run(SPEC.hierarchy(), wl,
                       PlanPolicy(spec=SPEC, use_tuned=False))
        analytic_pt = hp0.page_plan()["page_tokens"]
        tuned_pt = max(8, analytic_pt // 2)
        assert tuned_pt != analytic_pt
        _write(tune_path, _entry(
            "paged_attention", bucket_paged(tok_bytes, 64),
            {"page_tokens": tuned_pt}, {"page_tokens": analytic_pt},
            speedup=2.0))
        hp = plan_run(SPEC.hierarchy(), wl, PlanPolicy(spec=SPEC))
        page = hp.page_plan()
        assert page["page_tokens"] == tuned_pt
        assert page["source"] == "tuned"
        assert PAGE_BUFFERING * page["page_bytes"] <= SMEM
        assert hp.level("SMEM").detail["tuning"]["speedup"] == 2.0

    def test_ssd_chunk_returns_tuned(self, tune_path):
        analytic = choose_chunk(256, 2, 32, 32, dtype_bytes=4,
                                use_tuned=False)
        tuned = max(16, analytic // 2)
        assert tuned != analytic
        _write(tune_path, _entry(
            "ssd_scan", bucket_ssd(256, 2, 32, 32, 4), {"chunk": tuned},
            {"chunk": analytic}))
        assert choose_chunk(256, 2, 32, 32, dtype_bytes=4) == tuned


class TestFallbackToAnalytic:
    def test_fingerprint_mismatch_falls_back(self, tune_path):
        analytic = plan_attention(128, 128, 64, dtype_bytes=4,
                                  use_tuned=False)
        _write(tune_path, _entry(
            "flash_attention", bucket_attention(128, 128, 64, 4),
            {"block_q": max(8, analytic.block_q // 2),
             "block_kv": analytic.block_kv}, {},
            fingerprint="cuda:NVIDIA H100 80GB HBM3"))   # another device
        if hw_fingerprint() == "cuda:NVIDIA H100 80GB HBM3":
            pytest.skip("this machine is the device the entry names")
        p = plan_attention(128, 128, 64, dtype_bytes=4)
        assert p.source == "analytic"
        assert p.block_q == analytic.block_q

    def test_missing_artifact_falls_back(self):
        assert plan_attention(128, 128, 64, dtype_bytes=4).source == \
            "analytic"
        assert plan_matmul(512, 512, 512, dtype_bytes=4).source == \
            "analytic"

    def test_over_budget_tuned_entries_rejected(self, tune_path):
        _write(tune_path,
               _entry("flash_attention",
                      bucket_attention(65536, 65536, 256, 4),
                      {"block_q": 65536, "block_kv": 65536}, {}),
               # fits shared memory, but not the REG level
               _entry("matmul_cc", bucket_matmul(4096, 4096, 4096, 2),
                      {"bm": 512, "bk": 16, "bn": 512}, {}),
               _entry("ssd_scan", bucket_ssd(4096, 64, 64, 64, 2),
                      {"chunk": 512}, {}),
               _entry("paged_attention", bucket_paged(2048, 4096),
                      {"page_tokens": 512}, {}))
        p = plan_attention(65536, 65536, 256, dtype_bytes=4)
        assert p.source == "analytic"
        assert plan_matmul(4096, 4096, 4096, dtype_bytes=2).source == \
            "analytic"
        assert choose_chunk(4096, 64, 64, 64, dtype_bytes=2) == \
            choose_chunk(4096, 64, 64, 64, dtype_bytes=2, use_tuned=False)
        hp = plan_run(SPEC.hierarchy(),
                      Workload(kv_bytes_per_token=2048, kv_layers=1,
                               kv_heads=8, max_tokens=4096),
                      PlanPolicy(spec=SPEC))
        assert hp.page_plan()["source"] == "analytic"

    def test_misaligned_tuned_entry_rejected(self, tune_path):
        _write(tune_path, _entry(
            "matmul_cc", bucket_matmul(512, 512, 512, 4),
            {"bm": 100, "bk": 512, "bn": 512}, {}))   # not 8-aligned
        assert plan_matmul(512, 512, 512, dtype_bytes=4).source == \
            "analytic"


class TestSweepFilter:
    """No swept candidate exceeds a block's shared memory or registers."""

    @pytest.mark.parametrize("m,k,n,db", [(8, 8, 8, 4), (4096, 8, 4096, 2),
                                          (100, 3000, 70, 4),
                                          (4096, 4096, 4096, 2),
                                          (8, 4096, 8, 1)])
    def test_matmul_candidates_fit(self, m, k, n, db):
        r = sweep_matmul(m, k, n, dtype_bytes=db, dry=True)
        assert r.center in [c.block for c in r.candidates]
        for c in r.candidates:
            assert c.est_vmem_bytes <= r.budget_bytes
            assert c.est_vmem_bytes == _matmul_smem_bytes(
                c.block["bm"], c.block["bk"], c.block["bn"], db)

    @pytest.mark.parametrize("q,kv,d", [(8, 8, 64), (16384, 16384, 256),
                                        (100, 5000, 128), (4096, 4096, 64)])
    def test_attention_candidates_fit(self, q, kv, d):
        r = sweep_attention(q, kv, d, dtype_bytes=2, dry=True)
        assert r.center in [c.block for c in r.candidates]
        for c in r.candidates:
            assert c.est_vmem_bytes <= r.budget_bytes
            assert c.block["block_q"] % 8 == 0
            assert c.block["block_kv"] % 8 == 0

    def test_dry_run_all_kernels(self, tune_path):
        results = run_sweeps(dry=True, quick=True)
        assert [r.kernel for r in results] == [
            "matmul_cc", "flash_attention", "paged_attention", "ssd_scan"]
        for r in results:
            assert r.candidates
            assert all(c.est_vmem_bytes <= r.budget_bytes
                       for c in r.candidates)
        assert not tune_path.exists()       # dry mode writes nothing

    def test_launch_dry_runs_on_the_cpu(self, capsys, tune_path):
        from repro_torch.launch.tune import main

        assert main(["--dry", "--quick"]) == 0
        out = capsys.readouterr().out
        assert "all_candidates_fit_smem=True" in out
        assert "<- analytic" in out
        assert not tune_path.exists()


class TestEndToEndSweep:
    """One real (timed) sweep on the CPU: the winner lands in the artifact
    under the CPU fingerprint and the planner reads it back."""

    def test_paged_sweep_records_and_planner_consults(self, tune_path):
        r = sweep_paged(max_tokens=64, n_kv=2, group=2, head_dim=16,
                        slots=2, dtype_bytes=4, warmup=1, iters=2,
                        device="cpu")
        assert r.entry is not None
        assert r.entry.median_us > 0
        assert r.entry.speedup >= 1.0     # the winner is never slower
        assert r.entry.fingerprint == hw_fingerprint("cpu")
        record_tuned([r.entry], path=str(tune_path))
        wl = Workload(kv_bytes_per_token=r.workload["tok_bytes"],
                      kv_layers=1, kv_heads=2, max_tokens=64)
        hp = plan_run(SPEC.hierarchy(), wl, PlanPolicy(spec=SPEC))
        assert hp.page_plan()["page_tokens"] == r.entry.block["page_tokens"]
        assert hp.page_plan()["source"] == "tuned"

    def test_run_sweeps_on_cpu_writes_every_kernel(self, tune_path):
        results = run_sweeps(kernels=["matmul_cc", "ssd_scan"], quick=True,
                             warmup=0, iters=1, device="cpu")
        assert all(r.entry is not None for r in results)
        keys = load_tuning()
        assert {k.split("|")[0] for k in keys} == {"matmul_cc", "ssd_scan"}
        assert all(k.endswith("|" + hw_fingerprint("cpu")) for k in keys)
