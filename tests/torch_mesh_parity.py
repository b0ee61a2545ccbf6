"""The sharded training parity runs shared by ``tests/test_torch_train_mesh*.py``:
the port against the JAX package on 4 ranks in float32, on the same inputs.

The test process draws each arch's parameters (the port's seeded
``Model.init``) and batch (``launch.specs.make_batch``) into one npz.
Then, at the same time, a subprocess with 4 forced XLA host devices runs
the reference and a 4-rank gloo world of spawned processes
(``torch_dist_workers.family_world``, a ``FileStore`` under the test's
temporary directory) runs the port, each with a 240 s timeout:

  * the training forward on a (1, 4) mesh -- under gspmd, ring and
    serpentine rules on the port's side -- and the MoE load-balancing term;
  * one ``make_train_step`` step on a (2, 2) mesh from ``adamw_init``;
  * with ``fsdp``, that arch's step on (2, 2) under rules both packages plan
    against one shrunk HBM (carried into the reference through the JSON
    schema, its level names): FSDP, so ``collectives="auto"`` takes the
    serpentine rings.

The forward is held at 2e-4; the step under ``tests/test_torch_trainer.py``'s
rule: loss, ``grad_norm``, ``lr``, ``mu``, ``nu`` at ``1e-4 * (1 + |ref|)``,
the new parameters there where the first moment is live and within
``2 lr`` elsewhere (Adam's first step is a sign).
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

import torch_dist_workers as W
from repro_torch.configs import ShapeConfig, TrainConfig, get_model_config
from repro_torch.hw.h100 import h100_spec
from repro_torch.launch.mesh import spawn_world
from repro_torch.launch.specs import make_batch
from repro_torch.models.model import Model
from repro_torch.tree import tree_flatten_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = ShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")

_REF = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_model_config, TrainConfig
from repro.configs.base import ShapeConfig
from repro.core.hierarchy import MemoryLevel
from repro.dist.sharding import arch_rules
from repro.launch.trainer import make_train_step
from repro.models.model import build_model
from repro.optim import adamw_init

spec = json.loads(sys.argv[3])
with np.load(sys.argv[1]) as z:
    inputs = {k: z[k] for k in z.files}

def nested(pre):
    out = {}
    for key, v in inputs.items():
        if key.startswith(pre):
            node = out
            *path, leaf = key[len(pre):].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(v)
    return out

def flat(tree, prefix):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    out[prefix] = np.asarray(tree, dtype=np.float32)
    return out

shape = ShapeConfig("tiny", seq_len=spec["seq_len"],
                    global_batch=spec["batch"], kind="train")
# Automatic mesh axes (jax 0.9.0's explicit ones need jax.set_mesh).
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
train = TrainConfig(dtype="float32", remat="none", warmup_steps=2,
                    total_steps=10)
out = {}

def step(name, arch, cfg, train, rules=None):
    ts = make_train_step(cfg, shape, mesh, train, rules=rules)
    params = nested(f"{arch}/p/")
    new_p, new_o, m = ts.fn(params, adamw_init(params), nested(f"{arch}/bt/"))
    out.update(flat(new_p, f"{name}/ref/p"))
    out.update(flat(new_o.mu, f"{name}/ref/mu"))
    out.update(flat(new_o.nu, f"{name}/ref/nu"))
    for k in ("loss", "grad_norm", "lr", "nll", "aux"):
        out[f"{name}/ref/m/{k}"] = np.asarray(m[k], dtype=np.float32)

for arch in spec["archs"]:
    cfg = get_model_config(arch).reduced()
    model = build_model(cfg, remat="none")
    logits, aux = model.forward(nested(f"{arch}/p/"), nested(f"{arch}/bt/"),
                                dtype=jnp.float32)
    out[f"{arch}/ref/forward"] = np.asarray(logits)
    out[f"{arch}/ref/aux"] = np.asarray(aux)
    step(arch, arch, cfg, train)

f = spec["fsdp"]
if f is not None:
    cfg = dataclasses.replace(get_model_config(f["arch"]).reduced(),
                              overhead=f["overhead"])
    rules = arch_rules(cfg, mesh,
                       hierarchy=MemoryLevel.from_dict(f["hierarchy"]))
    out["fsdp/ref/fsdp"] = np.array(rules.meta["fsdp"])
    out["fsdp/ref/embed_rule"] = np.array(str(rules.param_rules["embed"]))
    step("fsdp", f["arch"], cfg, dataclasses.replace(train,
                                                     collectives="auto"),
         rules=rules)
np.savez(sys.argv[2], **out)
"""

_REF_NAMES = {"NVLINK": "ICI", "REG": "VREG"}


def fsdp_spec(arch: str) -> dict:
    """An HBM that holds the 2-way FSDP shard of reduced ``arch``'s
    training state but not its replica (2 model ranks), and that hierarchy
    in the reference's schema."""
    cfg = get_model_config(arch).reduced()
    replica = cfg.param_count() * 14 // 2
    hbm = replica * 3 // 4
    d = h100_spec(hbm_bytes=hbm).hierarchy(mesh_devices=4).to_dict()
    node = d
    while node is not None:
        node["name"] = _REF_NAMES.get(node["name"], node["name"])
        node = node["child"]
    return {"arch": arch, "hbm": hbm, "hierarchy": d,
            "overhead": cfg.overhead}


def _inputs(archs, path: str, shape: ShapeConfig = SHAPE) -> None:
    """Each arch's seeded parameters and batch of ``shape``, as the npz
    both sides read."""
    out = {}
    for i, arch in enumerate(archs):
        cfg = get_model_config(arch).reduced()
        for k, v in tree_flatten_with_paths(Model(cfg).init(i, device="cpu")).items():
            out[f"{arch}/p/{k}"] = v.numpy()
        batch = make_batch(cfg, shape, np.random.default_rng(i),
                           dtype=torch.float32, device="cpu")
        for k, v in batch.items():
            out[f"{arch}/bt/{k}"] = v.numpy()
    np.savez(path, **out)


def run(tmp, archs, fsdp=None):
    """The reference's results and the port's (one dict a rank) for
    ``archs``, and for the FSDP case of ``fsdp_spec(fsdp)`` if given
    (``fsdp`` must be one of ``archs``)."""
    spec = json.dumps({"archs": list(archs), "seq_len": SHAPE.seq_len,
                       "batch": SHAPE.global_batch,
                       "fsdp": fsdp_spec(fsdp) if fsdp else None})
    inputs, ref_path = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    _inputs(archs, inputs)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu"}
    with open(tmp / "ref.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", _REF, inputs,
                                 ref_path, spec], env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            ranks = spawn_world(W.family_world, 4, str(tmp / "store"),
                                (inputs, spec), timeout_s=240)
            proc.wait(timeout=240)
        finally:
            proc.kill()
    assert proc.returncode == 0, (tmp / "ref.log").read_text()
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    return ranks, ref


def same_forward(ranks, ref, arch: str, mode: str) -> None:
    """Every rank's forward (logits and the MoE term) at 2e-4."""
    for r in ranks:
        np.testing.assert_allclose(r[f"{arch}/forward/{mode}"],
                                   ref[f"{arch}/ref/forward"], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r[f"{arch}/aux/{mode}"],
                                   ref[f"{arch}/ref/aux"], rtol=2e-4,
                                   atol=2e-4)


def _close(got, want, what):
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= 1e-4, (what, float(err.max()))


def same_step(got: dict, ref: dict, name: str, part: str = "all") -> None:
    """The port's step ``name`` (an arch, or "fsdp") against the
    reference's: its ``part`` ("metrics", "moments", "params", or "all")."""
    if part in ("metrics", "all"):
        for k in ("loss", "grad_norm", "lr", "nll", "aux"):
            _close(got[f"{name}/step/m/{k}"], ref[f"{name}/ref/m/{k}"], k)
    pre = f"{name}/ref/p/"
    keys = sorted(k[len(pre):] for k in ref if k.startswith(pre))
    assert keys and all(f"{name}/step/p/{k}" in got for k in keys)
    if part in ("moments", "all"):
        for m in ("mu", "nu"):
            for k in keys:
                _close(got[f"{name}/step/{m}/{k}"], ref[f"{name}/ref/{m}/{k}"],
                       f"{m}.{k}")
    if part in ("params", "all"):
        lr = float(ref[f"{name}/ref/m/lr"])
        for k in keys:
            want, have = ref[f"{name}/ref/p/{k}"], got[f"{name}/step/p/{k}"]
            live = np.abs(ref[f"{name}/ref/mu/{k}"]) > \
                (1 - TrainConfig().b1) * 1e-6
            _close(have[live], want[live], f"params.{k}")
            assert np.all(np.abs(have - want) <= 2 * lr * 1.001 + 1e-6), k
