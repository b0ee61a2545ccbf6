"""The port's ring collective matmuls and GPipe pipeline
(``repro_torch.dist.overlap``, ``repro_torch.dist.pipeline``) against the
JAX package's, on 4 ranks.

One 4-rank gloo world of spawned processes (``launch.mesh.spawn_world``,
a ``FileStore`` under the test's temporary directory, a 240 s timeout)
runs every ring -- all-gather, reduce-scatter and the fused all-gather, in
``ring`` and ``serpentine`` mode -- forward and backward through its
``torch.autograd.Function``, the rings with the batch sharded on a (2, 2)
mesh, and the pipeline.  At the same time a subprocess with 4 forced XLA
host devices (as ``tests/test_dist.py`` runs the reference) runs the
reference's rings and ``jax.grad`` through them, and its pipeline, on the
same numpy inputs.  Each is held to ``x @ w`` (and its gradients), the
sequential stages, and the other package at 1e-5 (float32).

Without a world: the serpentine odd-size errors and ``overlap_matmul``'s
``None`` cases (they return or raise before the ring touches a process
group, so an ``AbstractMesh`` serves).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro_torch.dist.overlap import (make_ag_matmul, make_rs_matmul,
                                      overlap_matmul, overlap_matmul_fused)
from repro_torch.dist.sharding import (AbstractMesh, ShardingRules,
                                       use_mesh_rules, with_collectives)
from repro_torch.launch.mesh import spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)

_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.dist.overlap import (make_ag_matmul, make_ag_matmul_fused,
                                make_rs_matmul)
from repro.dist.pipeline import make_pipeline
d = dict(np.load(sys.argv[1]))
x, w, w2 = (jnp.asarray(d[k]) for k in ("x", "w", "w2"))
gy, gy2 = jnp.asarray(d["gy"]), jnp.asarray(d["gy2"])
# Automatic mesh axes: jax 0.9.0's explicit ones (jax.make_mesh) refuse
# jax.grad through the rings outside a jax.set_mesh context.
mesh = jax.sharding.Mesh(np.array(jax.devices()), ("model",))
out = {}
for mode in ("ring", "serpentine"):
    for name in ("ag", "rs"):
        make = make_ag_matmul if name == "ag" else make_rs_matmul
        fn = make(mesh, axis="model", mode=mode)
        out[f"{name}/{mode}/y0"] = fn(x, w)
        g = jax.grad(lambda a, b: jnp.sum(fn(a, b) * gy), argnums=(0, 1))(x, w)
        out[f"{name}/{mode}/g0"], out[f"{name}/{mode}/g1"] = g
    fn = make_ag_matmul_fused(mesh, axis="model", mode=mode, n_out=2)
    ys = fn(x, w, w2)
    out[f"agf/{mode}/y0"], out[f"agf/{mode}/y1"] = ys
    def tot(a, b, c):
        y0, y1 = fn(a, b, c)
        return jnp.sum(y0 * gy) + jnp.sum(y1 * gy2)
    g = jax.grad(tot, argnums=(0, 1, 2))(x, w, w2)
    for i in range(3):
        out[f"agf/{mode}/g{i}"] = g[i]
pod = jax.sharding.Mesh(np.array(jax.devices()), ("pod",))
pipe = make_pipeline(pod, lambda p, h: jnp.tanh(h @ p["w"]), axis="pod")
out["pipeline"] = pipe({"w": jnp.asarray(d["stages"])}, jnp.asarray(d["mbs"]))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    f32 = np.float32
    inputs = {
        "x": rng.standard_normal((64, 32)).astype(f32),
        "w": rng.standard_normal((32, 48)).astype(f32),
        "w2": rng.standard_normal((32, 16)).astype(f32),
        "gy": rng.standard_normal((64, 48)).astype(f32),
        "gy2": rng.standard_normal((64, 16)).astype(f32),
        "stages": (rng.standard_normal((4, 16, 16)) * 0.5).astype(f32),
        "mbs": rng.standard_normal((6, 8, 16)).astype(f32),
    }
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    ref_out = str(tmp / "ref.npz")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, path, ref_out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "JAX_PLATFORMS": "cpu"})
    try:
        ranks = spawn_world(W.ring_world, 4, str(tmp / "store"), (path,),
                            timeout_s=240)
        log, _ = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log
    with np.load(ref_out) as z:
        jax_out = {k: z[k] for k in z.files}
    return inputs, ranks, jax_out


_CASES = [(name, mode) for name in ("ag", "rs", "agf")
          for mode in ("ring", "serpentine")]


def _expected(inputs, name):
    """``x @ w`` and the gradients of ``<y, gy>`` by plain autograd."""
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    ws = [torch.from_numpy(inputs[k]).requires_grad_(True)
          for k in (("w", "w2") if name == "agf" else ("w",))]
    ys = [x @ w for w in ws]
    sum((y * torch.from_numpy(inputs[g])).sum()
        for y, g in zip(ys, ("gy", "gy2"))).backward()
    return ([y.detach().numpy() for y in ys],
            [x.grad.numpy()] + [w.grad.numpy() for w in ws])


@pytest.mark.parametrize("name,mode", _CASES)
def test_ring_forward_matches_matmul_and_reference(results, name, mode):
    inputs, ranks, ref = results
    want, _ = _expected(inputs, name)
    for i, y in enumerate(want):
        key = f"{name}/{mode}/y{i}"
        for r in ranks:                      # every rank holds the same
            np.testing.assert_allclose(r[key], y, **TOL, err_msg=key)
        np.testing.assert_allclose(ranks[0][key], ref[key], **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("name,mode", _CASES)
def test_ring_gradients_match_autograd_and_jax_grad(results, name, mode):
    inputs, ranks, ref = results
    _, want = _expected(inputs, name)
    for i, g in enumerate(want):
        key = f"{name}/{mode}/g{i}"
        np.testing.assert_allclose(ranks[0][key], g, **TOL, err_msg=key)
        np.testing.assert_allclose(ranks[0][key], ref[key], **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["ag", "rs"])
@pytest.mark.parametrize("mode", ["ring", "serpentine"])
def test_ring_with_sharded_batch(results, name, mode):
    """On a (2, 2) mesh with ``batch_axes=("data",)`` the weight's
    gradient sums over the data shards (a ``Partial`` placement)."""
    inputs, ranks, _ = results
    (y,), grads = _expected(inputs, name)
    key = f"{name}/{mode}/batch"
    np.testing.assert_allclose(ranks[0][f"{key}/y0"], y, **TOL)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(ranks[0][f"{key}/g{i}"], g, **TOL,
                                   err_msg=f"{key}/g{i}")


def test_pipeline_matches_sequential_and_reference(results):
    inputs, ranks, ref = results
    h = torch.from_numpy(inputs["mbs"])
    for s in range(4):
        h = torch.tanh(h @ torch.from_numpy(inputs["stages"][s]))
    for r in ranks:
        np.testing.assert_allclose(r["pipeline"], h.numpy(), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(ranks[0]["pipeline"], ref["pipeline"], **TOL)


# ---------------------------------------------------------------------------
# No world needed
# ---------------------------------------------------------------------------

MESH4 = AbstractMesh((4,), ("model",))


def test_serpentine_odd_size_error_messages():
    ag = make_ag_matmul(MESH4, axis="model", mode="serpentine")
    with pytest.raises(ValueError) as ei:
        ag(torch.zeros(8, 12), torch.zeros(12, 8))     # kb = 3, odd
    assert "serpentine" in str(ei.value) and "even" in str(ei.value)
    assert "mode='ring'" in str(ei.value)
    rs = make_rs_matmul(MESH4, axis="model", mode="serpentine")
    with pytest.raises(ValueError) as ei:
        rs(torch.zeros(8, 8), torch.zeros(8, 5))       # n = 5, odd
    assert "serpentine" in str(ei.value) and "even" in str(ei.value)
    with pytest.raises(ValueError, match="contraction mismatch"):
        make_ag_matmul(MESH4)(torch.zeros(8, 8), torch.zeros(12, 8))
    with pytest.raises(ValueError, match="must divide evenly"):
        make_rs_matmul(MESH4)(torch.zeros(6, 8), torch.zeros(8, 8))


def _rules(mode):
    r = ShardingRules({}, {"batch": "data"})
    return with_collectives(r, mode) if mode != "gspmd" else r


@pytest.mark.parametrize("mesh,mode,x_shape,w_shape,parallel", [
    (AbstractMesh((1, 4), ("data", "model")), "gspmd", (8, 16), (16, 8),
     "column"),                                    # gspmd rules
    (AbstractMesh((4, 1), ("data", "model")), "ring", (8, 16), (16, 8),
     "column"),                                    # a degenerate ring
    (AbstractMesh((1, 4), ("data", "model")), "ring", (8, 18), (18, 8),
     "column"),                                    # k % p
    (AbstractMesh((1, 4), ("data", "model")), "ring", (8, 16), (16, 6),
     "column"),                                    # n % p
    (AbstractMesh((1, 4), ("data", "model")), "serpentine", (8, 12),
     (12, 8), "column"),                           # odd k chunk
    (AbstractMesh((2, 2), ("data", "model")), "ring", (6, 16), (16, 8),
     "row"),                                       # m % (d * p)
    (AbstractMesh((1, 4), ("data", "model")), "serpentine", (8, 16),
     (16, 5), "row"),                              # odd n
    (AbstractMesh((1, 4), ("data", "model")), "ring", (8, 16), (12, 8),
     "row"),                                       # k != w rows
], ids=["gspmd", "axis1", "k", "n", "serp-k", "m", "serp-n", "mismatch"])
def test_overlap_matmul_none_cases(mesh, mode, x_shape, w_shape, parallel):
    x, w = torch.zeros(x_shape), torch.zeros(w_shape)
    assert overlap_matmul(x, w, parallel) is None       # no context
    with use_mesh_rules(mesh, _rules(mode)):
        assert overlap_matmul(x, w, parallel) is None
        if parallel == "column":
            assert overlap_matmul_fused(x, [w, w]) is None


def test_overlap_matmul_names_its_orientations():
    with use_mesh_rules(AbstractMesh((1, 4), ("data", "model")),
                        _rules("ring")):
        with pytest.raises(ValueError, match="parallel must be"):
            overlap_matmul(torch.zeros(8, 16), torch.zeros(16, 8),
                           "diagonal")
