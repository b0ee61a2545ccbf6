"""The port's mesh paths hold what the meshless ones compute, without
redundant work: the row-parallel product, the vocab-parallel loss, the
dry run's sampled loops, the cells DTensor could not propagate, and the
``ssd_scan`` wrapper's refusal of a DTensor.

  * On 4 gloo ranks at (2, 2) (``launch.mesh.spawn_world``; rank functions
    in ``tests/torch_dist_workers.py``):
      - ``layers.tp_matmul(x, w, "row")`` under gspmd rules gives the
        meshless product and gradients at 1e-5 (float32), its output
        replicated over "model", and its backward's ``mm`` FLOPs a rank are
        half the meshless ones with the batch replicated over "data" and a
        quarter with it sharded (``roofline.ops.analyze_ops``): no operand
        is gathered at full width;
      - ``layers.cross_entropy_loss`` on logits whose vocab shards over
        "model" gives the meshless loss and logits' gradient at 1e-5
        relative, with and without z-loss, and asks for no all-gather;
      - one training step of reduced deepseek-v2 (MLA on local shards,
        expert parallelism), zamba2 (the SSD scan on local shards) and
        mixtral (the router on local shards) equals the meshless step:
        loss, gradient norm and both moments at 1e-4 relative.
  * In a subprocess over a 4-rank fake world (``FakeTensorMode``), the
    dry run's ``lower_cell``:
      - on reduced llama3.2-1b x train_4k at (2, 2): no all-gather with
        the logits' vocab width, and a lower traced peak than the loss that
        gathered the vocab whole (the parent's form, defined here);
      - counts the loops it samples past ``MAX_BLOCK_TRIPS`` (set to 0
        here: three trips a loop, the second counted for every middle
        one) as the whole trace counts
        them, on reduced cells small enough to trace whole: blockwise
        attention in llama's prefill, the xLSTM's tokens and chunks in its
        prefill and its training step -- FLOPs and collective bytes equal,
        HBM bytes within 1 %; and, meshless, each sampled loop's forward
        and backward (blockwise attention, the mLSTM's chunks, the
        sLSTM's tokens) likewise;
      - lowers a reduced cell of each cell DTensor refused on the
        production meshes: deepseek-v2 x train_4k and x decode_32k,
        zamba2 x train_4k and mixtral x train_4k, on (2, 2) and, for the
        first three, on a (2, 1, 2) pod mesh.
  * ``kernels.ssd_scan.ssd_scan`` raises ``TypeError`` on a DTensor.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import torch_dist_workers as W
import torch_mesh_parity as M
from repro_torch.configs import TrainConfig, get_model_config
from repro_torch.launch.mesh import spawn_world
from repro_torch.launch.trainer import make_train_step
from repro_torch.models.layers import blockwise_attention, cross_entropy_loss
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy
from repro_torch.models.xlstm import mlstm_chunkwise, slstm_scan
from repro_torch.optim import adamw_init
from repro_torch.roofline.ops import analyze_ops, sampling_loops
from repro_torch.tree import tree_flatten_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_ARCHS = ["deepseek-v2-236b", "zamba2-1.2b", "mixtral-8x7b"]
TOL = dict(rtol=1e-5, atol=1e-5)

_FAKE = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import (constrain, local_rows_heads,
                                           rows_heads_roles)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models import layers as L

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    pods = sys.argv[1] == "pods"
    # A pod axis pipelines the step (the slowest lowerings): the multi-pod
    # cells run in a process of their own.
    mesh = init_device_mesh("cpu", (2, 1, 2) if pods else (2, 2),
                            mesh_dim_names=(("pod",) if pods else ())
                            + ("data", "model"))
    mesh_name = "x".join(str(n) for n in mesh.shape)
    train = ShapeConfig("train_4k", 64, 8, "train")
    decode = ShapeConfig("decode_32k", 64, 8, "decode")
    out = {}

    def cell(arch, shape, cfg=None):
        r = lower_cell(arch, shape.name, False, mesh=mesh,
                       cfg=cfg or get_model_config(arch).reduced(),
                       shape=shape)
        return {k: r[k] for k in ("status", "flops", "hbm_bytes",
                                  "collective_bytes", "collective_shapes",
                                  "counted", "memory")}

    def gathered(logits, labels, z_loss=1e-4):
        # The parent's loss: the vocab gathered whole, terms on local rows.
        logits = constrain(logits.float(), ("batch", "seq", None))
        if not isinstance(labels, DTensor):
            labels = DTensor.from_local(
                labels, logits.device_mesh,
                [Replicate()] * logits.device_mesh.ndim, run_check=False)

        def terms(lg, lb):
            lse = torch.logsumexp(lg, dim=-1)
            ll = lg.gather(-1, lb.long()[..., None])[..., 0]
            return torch.stack([lse - ll, lse.square()], dim=-1)

        t = local_rows_heads(terms, [(logits, 0, None), (labels, 0, None)],
                             [(0, None)], rows_heads_roles(logits, 0, None))
        return t[..., 0].mean() + z_loss * t[..., 1].mean()

    if not pods:
        out["loss/new"] = cell("llama3.2-1b", train)
        L.cross_entropy_loss, keep = gathered, L.cross_entropy_loss
        out["loss/gathered"] = cell("llama3.2-1b", train)
        L.cross_entropy_loss = keep
        llama = dataclasses.replace(
            get_model_config("llama3.2-1b").reduced(),
            attn_blockwise_threshold=1024)
        for name, arch, shape, cfg in (
                ("attention", "llama3.2-1b",
                 ShapeConfig("prefill_32k", 4096, 1, "prefill"), llama),
                ("xlstm_prefill", "xlstm-1.3b",
                 ShapeConfig("prefill_32k", 64, 4, "prefill"), None),
                ("xlstm_train", "xlstm-1.3b",
                 ShapeConfig("train_4k", 32, 4, "train"), None)):
            # Past MAX_BLOCK_TRIPS (0 here) the step samples its loops.
            for loops, budget in (("whole", D.MAX_BLOCK_TRIPS),
                                  ("sampled", 0)):
                D.MAX_BLOCK_TRIPS, keep = budget, D.MAX_BLOCK_TRIPS
                out[f"loops/{name}/{loops}"] = cell(arch, shape, cfg=cfg)
                D.MAX_BLOCK_TRIPS = keep
    for arch, shape in (("deepseek-v2-236b", train),
                        ("deepseek-v2-236b", decode),
                        ("zamba2-1.2b", train), ("mixtral-8x7b", train)):
        if pods and arch == "mixtral-8x7b":
            continue          # refused on the single-pod mesh only
        out[f"cells/{arch}/{shape.name}/{mesh_name}"] = cell(arch, shape)
    print(json.dumps(out))
""")


def _env():
    return {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
            "REPRO_CALIBRATION": os.devnull,
            "REPRO_TORCH_CALIBRATION": os.devnull}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The fake world's lowerings (a subprocess) and the gloo world's
    products, losses and steps, computed at the same time."""
    tmp = tmp_path_factory.mktemp("mesh_repairs")
    rng = np.random.default_rng(0)
    d = {"x": rng.standard_normal((4, 6, 16)).astype(np.float32),
         "w": rng.standard_normal((16, 12)).astype(np.float32),
         "seed": rng.standard_normal((4, 6, 12)).astype(np.float32),
         "logits": (3 * rng.standard_normal((4, 6, 32))).astype(np.float32),
         "labels": rng.integers(0, 32, (4, 6)).astype(np.int64)}
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **d)
    steps = str(tmp / "steps.npz")
    M._inputs(STEP_ARCHS, steps)
    procs = [subprocess.Popen([sys.executable, "-c", _FAKE, which],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env())
             for which in ("main", "pods")]
    try:
        ranks = spawn_world(
            W.repairs_world, 4, str(tmp / "store"),
            args=(inputs, steps, STEP_ARCHS, M.SHAPE.seq_len,
                  M.SHAPE.global_batch), timeout_s=400)
    finally:
        outs = [p.communicate(timeout=600) for p in procs]
    fake = {}
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-2000:] + err[-4000:]
        fake.update(json.loads(out.strip().splitlines()[-1]))
    with np.load(steps) as z:
        step_inputs = {k: z[k] for k in z.files}
    return d, ranks, fake, step_inputs


@pytest.mark.parametrize("batch", ["sharded", "replicated"])
def test_row_parallel_product_matches_meshless(results, batch):
    d, ranks, _, _ = results
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    w = torch.from_numpy(d["w"]).requires_grad_(True)
    y = x @ w
    (y * torch.from_numpy(d["seed"])).sum().backward()
    for r in ranks:
        np.testing.assert_allclose(r[f"{batch}/y"], y.detach().numpy(), **TOL)
        np.testing.assert_allclose(r[f"{batch}/dx"], x.grad.numpy(), **TOL)
        np.testing.assert_allclose(r[f"{batch}/dw"], w.grad.numpy(), **TOL)
        want = Shard(0) if batch == "sharded" else Replicate()
        assert list(r[f"{batch}/placements"]) == [str(want),
                                                  str(Replicate())]


@pytest.mark.parametrize("batch,parts", [("sharded", 4), ("replicated", 2)])
def test_row_parallel_backward_runs_on_local_shards(results, batch, parts):
    """dX = dY W^T and dW = X^T dY on local shards: the backward's FLOPs a
    rank are the meshless backward's over the ranks that split its work
    (2 "model" ranks, times 2 "data" ranks when the batch shards)."""
    d, ranks, _, _ = results
    b, s, k = d["x"].shape
    meshless = 2 * (2 * b * s * k * d["w"].shape[1])
    for r in ranks:
        assert float(r[f"{batch}/mm_flops"]) == meshless / parts


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_vocab_parallel_loss_matches_meshless(results, z_loss):
    d, ranks, _, _ = results
    lg = torch.from_numpy(d["logits"]).requires_grad_(True)
    loss = cross_entropy_loss(lg, torch.from_numpy(d["labels"]),
                              z_loss=z_loss)
    loss.backward()
    for r in ranks:
        np.testing.assert_allclose(r[f"{z_loss}/loss"], loss.item(),
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(r[f"{z_loss}/grad"], lg.grad.numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert r[f"{z_loss}/gathers"].size == 0


def test_vocab_parallel_loss_in_the_dry_run(results):
    """The reduced llama's step at (2, 2): no all-gather of the logits'
    vocab shard (the gathered form shows one), and a lower peak."""
    fake = results[2]
    cfg = get_model_config("llama3.2-1b").reduced()
    v_local = Model(cfg).param_specs()["embedding"].shape[0] // 2

    def vocab_gathers(rep):
        return [s for k, s in rep["collective_shapes"]
                if k == "all-gather" and len(s) == 3 and s[-1] == v_local]

    new, old = fake["loss/new"], fake["loss/gathered"]
    assert new["status"] == old["status"] == "ok"
    assert vocab_gathers(old) and not vocab_gathers(new)
    assert new["memory"]["peak_bytes"] < old["memory"]["peak_bytes"]


@pytest.mark.parametrize("cell", ["attention", "xlstm_prefill",
                                  "xlstm_train"])
def test_sampled_loops_count_as_the_whole_trace(results, cell):
    fake = results[2]
    whole = fake[f"loops/{cell}/whole"]
    sampled = fake[f"loops/{cell}/sampled"]
    assert whole["counted"]["loops"] == "whole step"
    assert sampled["counted"]["loops"] == "sampled loops"
    assert sampled["counted"]["trips"] == whole["counted"]["trips"] > 3
    assert sampled["flops"] == whole["flops"]
    assert sampled["collective_bytes"] == whole["collective_bytes"]
    assert abs(sampled["hbm_bytes"] / whole["hbm_bytes"] - 1) <= 0.01


def _loop_case(name):
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).requires_grad_(True)

    if name == "blockwise":
        q, k, v = rand(2, 40, 2, 8), rand(2, 40, 2, 8), rand(2, 40, 2, 8)
        pos = torch.arange(40)
        return (lambda: blockwise_attention(q, k, v, pos, pos, 8, 8)), \
            (q, k, v)
    if name == "mlstm":
        q, k, v = rand(2, 40, 2, 4), rand(2, 40, 2, 4), rand(2, 40, 2, 4)
        i, f = rand(2, 40, 2), rand(2, 40, 2)
        return (lambda: mlstm_chunkwise(q, k, v, i, f, 8)[0]), \
            (q, k, v, i, f)
    gx, r = rand(2, 12, 2, 4, 4), rand(2, 4, 4, 4)
    z = torch.zeros(2, 2, 4)
    return (lambda: slstm_scan(gx, r, (z, z, z, z - 1e30))[0]), (gx, r)


@pytest.mark.parametrize("name", ["blockwise", "mlstm", "slstm"])
def test_sampled_loops_count_forward_and_backward(name):
    """Each sampled loop -- blockwise attention's query and key blocks,
    the mLSTM's chunks, the sLSTM's tokens -- counts its forward and
    backward as the whole loop does: FLOPs equal, HBM bytes within 1 %."""
    counts = {}
    for sample in (False, True):
        fn, leaves = _loop_case(name)

        def step():
            fn().float().square().sum().backward()

        with sampling_loops(sample):
            counts[sample] = analyze_ops(step)
        assert all(t.grad is not None for t in leaves)
    whole, sampled = counts[False], counts[True]
    assert sampled.flops == whole.flops > 0
    assert abs(sampled.hbm_bytes / whole.hbm_bytes - 1) <= 0.01
    assert sampled.n_ops < whole.n_ops


@pytest.mark.parametrize("cell", [
    "deepseek-v2-236b/train_4k/2x2", "deepseek-v2-236b/train_4k/2x1x2",
    "deepseek-v2-236b/decode_32k/2x2", "deepseek-v2-236b/decode_32k/2x1x2",
    "zamba2-1.2b/train_4k/2x2", "zamba2-1.2b/train_4k/2x1x2",
    "mixtral-8x7b/train_4k/2x2"])
def test_cells_dtensor_refused_now_lower(results, cell):
    rep = results[2][f"cells/{cell}"]
    assert rep["status"] == "ok" and rep["flops"] > 0
    assert rep["memory"]["peak_bytes"] > 0


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_meshed_step_equals_meshless(results, arch):
    """The products moved onto local shards give the meshless step: the
    metrics and both AdamW moments (the gradients) at 1e-4 relative."""
    _, ranks, _, d = results
    cfg = get_model_config(arch).reduced()
    train = TrainConfig(dtype="float32", remat="none", warmup_steps=2,
                        total_steps=10)
    ts = make_train_step(cfg, M.SHAPE, None, train, device="cpu")
    params = params_from_numpy(W._sub(d, f"{arch}/p/"), cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             W._sub(d, f"{arch}/bt/").items()}
    _, opt, metrics = ts.fn(params, adamw_init(params), batch)
    want = {f"m/{k}": metrics[k].detach().numpy() for k in ("loss",
                                                           "grad_norm")}
    for name, tree in (("mu", opt.mu), ("nu", opt.nu)):
        for k, v in tree_flatten_with_paths(tree).items():
            want[f"{name}/{k}"] = v.detach().numpy()
    for r in ranks:
        for k, v in want.items():
            M._close(r[f"{arch}/step/{k}"], v, f"{arch} {k}")


def test_ssd_scan_refuses_a_dtensor(tmp_path):
    """The kernel wrapper takes local tensors only; on a mesh
    ``models.mamba2`` hands it each rank's shard."""
    out = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import torch, torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.kernels.ssd_scan import ssd_scan
        dist.init_process_group("gloo", init_method="file://%s",
                                rank=0, world_size=1)
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        x = torch.zeros(1, 8, 2, 4)
        dt, A = torch.ones(1, 8, 2), -torch.ones(2)
        B = torch.zeros(1, 8, 4)
        xd = DTensor.from_local(x, mesh, [Replicate()])
        try:
            ssd_scan(xd, dt, A, B, B)
        except TypeError as e:
            print("refused:", e)
        y = ssd_scan(x, dt, A, B, B)
        print("local:", tuple(y.shape))
        dist.destroy_process_group()
    """) % (tmp_path / "store")], capture_output=True, text=True,
        env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "refused: ssd_scan takes local tensors" in out.stdout
    assert "local: (1, 8, 2, 4)" in out.stdout
