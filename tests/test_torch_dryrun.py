"""The port's dry run (``repro_torch.launch.dryrun``), production mesh
and calibration artifact, against the JAX package's where there is a
counterpart.

  * The five calibration tests of ``tests/test_calibration.py`` on the
    port's own artifact (``REPRO_TORCH_CALIBRATION`` pointed at a
    temporary file).
  * ``skip_reason`` equals the reference's for every registered arch x the
    four shapes, and ``print_plan_tree``'s mesh-level lines equal the
    reference's on an equal HBM (80 GB a card, no calibration artifact) on
    both production meshes, the interconnect level named NVLINK for ICI
    (the reference in a subprocess: its module forces 512 host devices).
  * In a subprocess over a 4-rank fake world, ``lower_cell`` on the
    reduced llama at (2, 2): status ok; the per-rank FLOPs between 1x and
    1.55x ``model_flops / 4`` (1.51x traced: remat "full" recomputes the
    forward and 6ND leaves attention's products out; the row-parallel
    products' backward runs on local shards -- at full width on every
    "model" rank it traced 1.63x; the bound sits just above the traced
    figure so that any redundant work fails); a peak at
    least the local parameters and moments; and a world of another size
    refused by ``make_production_mesh``.
  * ``python -m repro_torch.launch.dryrun --calibrate`` on full-width
    llama3.2-1b x train_4k on 16 x 16, into a temporary
    ``--calibration-out``, writes an artifact ``calibration_overhead``
    reads back; ``--plan-tree`` prints without tracing.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

from repro_torch.configs import get_model_config, get_shape, list_archs
from repro_torch.configs.base import (CALIBRATION_ENV, calibration_act_scale,
                                      calibration_overhead)
from repro_torch.launch import dryrun
from repro_torch.launch.specs import activation_footprint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

_REF = textwrap.dedent("""
    import io, json, contextlib, sys
    import repro.launch.dryrun as D          # forces 512 host devices
    import repro.dist.sharding as S
    from repro.configs import list_archs
    from repro.hw.tpu import chip_spec

    orig = S.mesh_hierarchy
    S.mesh_hierarchy = lambda mesh, spec=None: orig(
        mesh, chip_spec(hbm_bytes=80 * 10 ** 9))
    out = {"skip": {}, "tree": {}}
    for arch in list_archs():
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            out["skip"][f"{arch}/{shape}"] = D.skip_reason(arch, shape)
        for multi in (False, True):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                D.print_plan_tree(arch, multi)
            out["tree"][f"{arch}/{int(multi)}"] = buf.getvalue().splitlines()
    print(json.dumps(out))
""")

_LOWER = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import Model
    from repro_torch.roofline.report import model_flops

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_model_config("llama3.2-1b").reduced()
    out = {}
    for name, shape in (("train", ShapeConfig("train_4k", 64, 8, "train")),
                        ("decode", ShapeConfig("decode_32k", 64, 8,
                                               "decode"))):
        rep = lower_cell("llama3.2-1b", shape.name, False, mesh=mesh,
                         cfg=cfg, shape=shape)
        rep["model_flops"] = model_flops(cfg, shape)
        out[name] = rep
    out["n_params"] = Model(cfg).n_params()
    try:
        make_production_mesh()
        out["refused"] = False
    except RuntimeError as e:
        out["refused"] = "256" in str(e)
    print(json.dumps(out))
""")


def _env(tmp_path):
    return {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
            "REPRO_CALIBRATION": str(tmp_path / "none.json"),
            CALIBRATION_ENV: str(tmp_path / "none_torch.json")}


def _start(code_or_args, tmp_path, module: bool = False):
    args = ([sys.executable, "-m", "repro_torch.launch.dryrun"]
            + list(code_or_args)) if module else \
        [sys.executable, "-c", code_or_args]
    env = _env(tmp_path)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _done(proc, timeout=600) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's cells and trees, the reduced lower_cell, and the
    full-width calibration: all started at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    cal = tmp / "cal_out.json"
    procs = {
        "ref": _start(_REF, tmp),
        "lower": _start(_LOWER, tmp),
        "calibrate": _start(["--calibrate", "--arch", "llama3.2-1b",
                             "--shape", "train_4k", "--mesh", "single",
                             "--calibration-out", str(cal)], tmp,
                            module=True),
    }
    out = {k: _done(p) for k, p in procs.items()}
    return {"ref": json.loads(out["ref"].strip().splitlines()[-1]),
            "lower": json.loads(out["lower"].strip().splitlines()[-1]),
            "calibrate": out["calibrate"], "cal_path": cal}


@pytest.fixture
def cal_env(tmp_path, monkeypatch):
    path = tmp_path / "calibration_torch.json"
    monkeypatch.setenv(CALIBRATION_ENV, str(path))
    yield path


# ---------------------------------------------------------------------------
# The calibration artifact (tests/test_calibration.py's five, on the port's)
# ---------------------------------------------------------------------------


def test_write_calibration_folds_worst_cell(cal_env):
    records = [
        {"arch": "llama3.2-1b", "shape": "train_4k", "mesh": "16x16",
         "calibration_ratio": 0.8, "overhead": 1.0},
        {"arch": "llama3.2-1b", "shape": "decode_32k", "mesh": "16x16",
         "calibration_ratio": 0.5, "overhead": 1.0},
    ]
    dryrun.write_calibration(records, path=str(cal_env))
    data = json.loads(cal_env.read_text())
    assert data["llama3.2-1b"]["overhead"] == pytest.approx(2.0)
    assert data["llama3.2-1b"]["worst_cell"] == "decode_32k@16x16"
    dryrun.write_calibration(
        [{"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16",
          "calibration_ratio": 0.9, "overhead": 1.0}], path=str(cal_env))
    data = json.loads(cal_env.read_text())
    assert set(data) >= {"llama3.2-1b", "qwen2-0.5b"}


def test_act_scale_folds_and_applies(cal_env):
    cfg = get_model_config("llama3.2-1b")
    shape = get_shape("train_4k")
    base = activation_footprint(cfg, shape, "full")
    dryrun.write_calibration([
        {"arch": "llama3.2-1b", "shape": "train_4k", "mesh": "16x16",
         "calibration_ratio": 1.0, "overhead": 1.0,
         "act_ratio": 0.5, "act_scale": 1.0},
    ], path=str(cal_env))
    data = json.loads(cal_env.read_text())
    assert data["llama3.2-1b"]["act_scale"] == pytest.approx(2.0)
    assert activation_footprint(cfg, shape, "full") == \
        pytest.approx(2.0 * base, rel=0.01)
    dryrun.write_calibration([
        {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16",
         "calibration_ratio": 1.0, "overhead": 1.0,
         "act_ratio": 3.0, "act_scale": 1.0},
    ], path=str(cal_env))
    assert json.loads(cal_env.read_text())["qwen2-0.5b"]["act_scale"] == 1.0
    dryrun.write_calibration([
        {"arch": "llama3.2-1b", "shape": "decode_32k", "mesh": "16x16",
         "calibration_ratio": 0.9, "overhead": 1.0},
    ], path=str(cal_env))
    data = json.loads(cal_env.read_text())
    assert data["llama3.2-1b"]["act_scale"] == pytest.approx(2.0)


def test_model_config_defaults_overhead_from_artifact(cal_env):
    cal_env.write_text(json.dumps({
        "llama3.2-1b": {"overhead": 1.7},
        "mixtral-8x7b": {"overhead": 3.0},
    }))
    assert get_model_config("llama3.2-1b").overhead == 1.7
    # An explicitly registered overhead wins.
    assert get_model_config("mixtral-8x7b").overhead == 1.25


def test_missing_or_broken_artifact_is_harmless(cal_env):
    assert get_model_config("llama3.2-1b").overhead == 1.0
    cal_env.write_text("{not json")
    assert get_model_config("llama3.2-1b").overhead == 1.0
    assert calibration_act_scale("llama3.2-1b") is None


def test_artifact_rewrite_is_picked_up_in_process(cal_env):
    assert get_model_config("llama3.2-1b").overhead == 1.0
    cal_env.write_text(json.dumps({"llama3.2-1b": {"overhead": 1.5}}))
    assert get_model_config("llama3.2-1b").overhead == 1.5


def test_port_never_reads_the_tpu_artifact(monkeypatch):
    """Unset, the port's artifact is its own file, never the JAX
    package's ``experiments/calibration.json`` of TPU measurements."""
    from repro_torch.configs.base import calibration_path

    monkeypatch.delenv(CALIBRATION_ENV, raising=False)
    assert calibration_path().endswith(
        os.path.join("experiments", "calibration_torch.json"))


# ---------------------------------------------------------------------------
# Cells, plan trees and the traced steps
# ---------------------------------------------------------------------------


def test_skip_reason_matches_reference(runs):
    ref = runs["ref"]["skip"]
    for arch in list_archs():
        for shape in SHAPES:
            assert dryrun.skip_reason(arch, shape) == ref[f"{arch}/{shape}"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_plan_tree_mesh_levels_match_reference(runs, multi_pod, monkeypatch,
                                               tmp_path):
    monkeypatch.setenv(CALIBRATION_ENV, str(tmp_path / "none.json"))

    def mesh_lines(lines):
        return [ln.strip().replace("NVLINK[", "ICI[") for ln in lines
                if "[mesh]" in ln or ln.startswith("[plan]")]

    for arch in list_archs():
        mine = dryrun.print_plan_tree(arch, multi_pod)
        ref = runs["ref"]["tree"][f"{arch}/{int(multi_pod)}"]
        assert mesh_lines(mine) == mesh_lines(ref), arch


def test_lower_cell_reduced_on_2x2(runs):
    low = runs["lower"]
    train = low["train"]
    assert train["status"] == "ok" and train["step"] == "train_step"
    assert train["mesh"] == "2x2"
    per_rank = train["model_flops"] / 4
    assert per_rank <= train["flops"] <= 1.55 * per_rank
    assert train["collective_bytes"]["all-reduce"] > 0
    # Parameters and both AdamW moments, a quarter or more each a rank.
    assert train["memory"]["peak_bytes"] >= \
        train["memory"]["argument_bytes"] >= 3 * 4 * low["n_params"] / 4
    dec = low["decode"]
    assert dec["status"] == "ok" and dec["step"] == "serve_step"
    assert dec["flops"] > 0 and dec["memory"]["peak_bytes"] > 0
    assert low["refused"]


def test_calibrate_cli_full_width(runs, monkeypatch):
    out = runs["calibrate"]
    assert "[cal] llama3.2-1b x train_4k (16x16)" in out
    data = json.loads(runs["cal_path"].read_text())
    assert data["llama3.2-1b"]["overhead"] >= 1.0
    assert data["llama3.2-1b"]["worst_cell"] == "train_4k@16x16"
    monkeypatch.setenv(CALIBRATION_ENV, str(runs["cal_path"]))
    assert calibration_overhead("llama3.2-1b") == \
        data["llama3.2-1b"]["overhead"]


def test_plan_tree_cli_and_default_out(tmp_path):
    out = _done(_start(["--plan-tree", "--arch", "qwen2-0.5b"], tmp_path,
                       module=True), timeout=120)
    assert "[plan] qwen2-0.5b on 16x16:" in out
    assert "[plan] qwen2-0.5b on 2x16x16:" in out
    assert "DCN[mesh]" in out
    assert dryrun.results_dir().startswith(tempfile.gettempdir())
