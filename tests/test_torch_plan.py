"""The port's decode walk against the JAX package's ``plan_decode`` on equal
sizes, and the page level on the H100 hierarchy."""

import pytest

from repro.configs import get_model_config as ref_config
from repro.hw.tpu import chip_spec
from repro.launch.mesh import make_host_mesh
from repro.serve.engine import plan_decode as ref_plan_decode
from repro_torch.configs import get_model_config
from repro_torch.hw import h100_spec
from repro_torch.serve.engine import plan_decode



@pytest.fixture(autouse=True)
def _no_tuning_artifact(monkeypatch, tmp_path):
    """Pages here are the analytic ones, whatever tuning artifact the
    machine holds."""
    monkeypatch.setenv("REPRO_TORCH_TUNING", str(tmp_path / "absent.json"))

@pytest.mark.parametrize("arch,reduced", [("llama3.2-1b", True),
                                          ("llama3.2-1b", False),
                                          ("qwen2-0.5b", True),
                                          ("qwen2-0.5b", False)])
@pytest.mark.parametrize("leaf_bytes,max_len,slots,dtype_bytes", [
    (16 << 10, 64, 2, 4),          # the serving tests' tiny page
    (232_448, 4096, 8, 2),         # Hopper's shared memory, bf16
    (96 << 20, 2048, 4, 2),        # one big leaf: a single page per slot
    (1 << 10, 512, 3, 4),          # leaf below one aligned page: no fit
])
def test_page_walk_matches_reference(arch, reduced, leaf_bytes, max_len,
                                     slots, dtype_bytes):
    cfg = get_model_config(arch)
    rcfg = ref_config(arch)
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    hbm = 16 << 30
    mine = plan_decode(cfg, max_len=max_len, batch=slots,
                       dtype_bytes=dtype_bytes,
                       spec=h100_spec(smem_bytes=leaf_bytes, hbm_bytes=hbm))
    ref = ref_plan_decode(rcfg, make_host_mesh(), max_len=max_len,
                          batch=slots, dtype_bytes=dtype_bytes,
                          spec=chip_spec(vmem_bytes=leaf_bytes,
                                         vmem_reserved_bytes=0,
                                         hbm_bytes=hbm))
    for key in ("page_tokens", "page_bytes", "tok_bytes", "kv_shard"):
        assert mine.page_plan()[key] == ref.page_plan()[key], key
    for key in ("pages_per_slot", "pages_total", "slots_bound"):
        assert mine.page_table()[key] == ref.page_table()[key], key
    assert mine.chunk_tokens() == ref.chunk_tokens()
    assert mine.kv_shard() == ref.kv_shard() == 1


def test_h100_page_level_is_shared_memory():
    """On the H100 tree the page fits one block's shared memory
    double-buffered -- not the 50 MB L2, which the reference's level names
    would pick."""
    cfg = get_model_config("llama3.2-1b")
    plan = plan_decode(cfg, max_len=4096, batch=8, dtype_bytes=2)
    kinds = {lp.level: lp.kind for lp in plan.levels()}
    assert kinds == {"NVLINK": "mesh", "L2": "container", "SMEM": "page",
                     "REG": "leaf"}
    page = plan.page_plan()
    assert plan.level("SMEM").budget_bytes == 232_448
    assert 2 * page["page_bytes"] <= 232_448
    assert page["tok_bytes"] == 2 * 8 * 64 * 2      # K+V, 8 heads, bf16
    # Algorithm 1's largest aligned page: 56 tokens (not a power of two).
    assert page["page_tokens"] == 56
    ptab = plan.page_table()
    assert ptab["pages_per_slot"] == -(-4096 // 56)
    free = 80 * 10**9 - plan.level("NVLINK").detail["replicated_bytes"]
    assert ptab["pages_total"] == free // (56 * page["tok_bytes"] * 16)


def test_h100_spec_overrides():
    spec = h100_spec(smem_bytes=16 << 10)
    assert spec.smem_bytes == 16 << 10
    assert spec.hierarchy().find("SMEM").size == 16 << 10
    assert h100_spec().hierarchy().find("HBM").size == 80 * 10**9
    assert h100_spec().hierarchy().find("L2").size == 50 * 10**6
