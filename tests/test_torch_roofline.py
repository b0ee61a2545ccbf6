"""The port's roofline (``repro_torch.roofline``) against the JAX package's
(``repro.roofline``).

``kv_cache_bytes``, ``ideal_bytes`` and ``model_flops`` equal the
reference's for every registered arch x the four shapes, and
``roofline_terms`` on equal inputs and equal constants (the reference
given the H100's figures as a ``TPUSpec``) equals it field by field
(relative 1e-12: the same float arithmetic).

``analyze_ops`` on the reference's two test programs gives the numbers
``analyze_hlo`` gives on their compiled HLO (the reference in a
subprocess with 4 forced host devices; the port's sharded program in a
subprocess of its own over a 4-rank fake world, one process a world):
twelve steps of ``tanh(c @ w)`` with x's rows sharded over 4 and w
gathered once before the loop -- 12 * 2 * 64 * 256 * 256 FLOPs a rank and
an all-gather of 256 * 64 * 4 bytes, both exact -- and sixteen in-place
row updates of a 4,096 x 1,024 cache, each package under 5 % of sixteen
whole copies.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import get_model_config as ref_config
from repro.configs import get_shape as ref_shape
from repro.hw.tpu import TPUSpec
from repro.roofline import report as R
from repro_torch.configs import get_model_config, get_shape, list_archs
from repro_torch.hw import h100_spec
from repro_torch.roofline import analyze_ops, report as M
from repro_torch.roofline.ops import COLLECTIVES, OpSummary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
FLOPS = 12 * 2 * 64 * 256 * 256
GATHER = 256 * 64 * 4
WHOLE = 16 * 4096 * 1024 * 4

_REF = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.roofline.hlo import analyze_hlo

    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=12)
        return y

    mesh = jax.make_mesh((4,), ("m",))
    xs = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    c = jax.jit(f, in_shardings=(NamedSharding(mesh, P("m", None)),
                                 NamedSharding(mesh, P(None, "m")))
                ).lower(xs, xs).compile()
    s = analyze_hlo(c.as_text())

    def g(cache, upd):
        def body(c, i):
            return jax.lax.dynamic_update_slice_in_dim(c, upd, i,
                                                       axis=0), None
        out, _ = jax.lax.scan(body, cache, jnp.arange(16))
        return out

    d = jax.jit(g, donate_argnums=(0,)).lower(
        jax.ShapeDtypeStruct((4096, 1024), jnp.float32),
        jax.ShapeDtypeStruct((1, 1024), jnp.float32)).compile()
    u = analyze_hlo(d.as_text())
    print(json.dumps({"flops": s.flops, "coll": s.collective_bytes,
                      "dus_bytes": u.hbm_bytes}))
""")

_MINE = textwrap.dedent("""
    import json
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline import analyze_ops

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("m",))

    def f(x, w):
        w = w.redistribute(mesh, [Replicate()])   # gathered once
        c = x
        for _ in range(12):
            c = torch.tanh(c @ w)
        return c

    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(64, 256), mesh, [Shard(0)],
                               run_check=False)
        w = DTensor.from_local(torch.empty(256, 64), mesh, [Shard(1)],
                               run_check=False)
        s = analyze_ops(f, x, w)
        y = DTensor.from_local(torch.empty(16, 64), mesh, [Shard(0)],
                               run_check=False)
        a = analyze_ops(lambda t: t.redistribute(mesh, [Shard(1)]), y)
    print(json.dumps({"flops": s.flops, "coll": s.collective_bytes,
                      "a2a": a.collective_bytes}))
""")


def _start(code: str, jax_side: bool) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    if not jax_side:
        env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out + err
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def programs():
    """Both packages' analyses of the two programs, run at once."""
    ref, mine = _start(_REF, True), _start(_MINE, False)
    return _result(ref), _result(mine)


@pytest.fixture(autouse=True)
def _no_calibration(monkeypatch, tmp_path):
    """Both packages' configs as registered, whatever artifact the
    checkout holds."""
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "none.json"))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(tmp_path / "none.json"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", list_archs())
def test_model_terms_match_reference(arch, shape):
    cfg, rcfg = get_model_config(arch), ref_config(arch)
    s, rs = get_shape(shape), ref_shape(shape)
    assert M.kv_cache_bytes(cfg, s) == R.kv_cache_bytes(rcfg, rs)
    assert M.ideal_bytes(cfg, s) == R.ideal_bytes(rcfg, rs)
    assert M.model_flops(cfg, s) == R.model_flops(rcfg, rs)


@dataclasses.dataclass
class _HLOLike:
    flops: float
    hbm_bytes: float
    collective_bytes: dict

    @property
    def total_collective_bytes(self):
        return sum(self.collective_bytes.values())


@pytest.mark.parametrize("arch,shape,n", [
    ("llama3.2-1b", "train_4k", 256), ("mixtral-8x7b", "decode_32k", 256),
    ("deepseek-v2-236b", "prefill_32k", 512), ("xlstm-1.3b", "long_500k", 512),
])
def test_roofline_terms_match_reference(arch, shape, n):
    """Equal per-card counts and equal constants: the H100's figures given
    to the reference as a ``TPUSpec``."""
    spec = h100_spec()
    ref_spec = TPUSpec(name="h100", peak_bf16_flops=spec.peak_bf16_flops,
                       hbm_bytes=spec.hbm_bytes, hbm_bw=spec.hbm_bw,
                       vmem_bytes=spec.smem_bytes, vmem_reserved_bytes=0,
                       ici_bw_per_link=spec.nvlink_bw_per_link,
                       ici_links_per_axis=spec.nvlink_links, num_cores=1)
    coll = {k: float(i + 1) * 3e8 for i, k in enumerate(COLLECTIVES)}
    counts = dict(flops=4.2e14, hbm_bytes=7.5e11, collective_bytes=coll)
    mine = M.roofline_terms(get_model_config(arch), get_shape(shape),
                            "16x16", "step", OpSummary(**counts), n_chips=n)
    ref = R.roofline_terms(ref_config(arch), ref_shape(shape), "16x16",
                           "step", _HLOLike(**counts), n_chips=n,
                           spec=ref_spec)
    a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float):
            assert a[k] == pytest.approx(b[k], rel=1e-12), k
        else:
            assert a[k] == b[k], k
    assert mine.row() == ref.row()


def test_h100_interconnect_figures():
    """NVLink 4's data-sheet figures: 18 links, 25 GB/s a link and a
    direction -- 900 GB/s both directions together."""
    spec = h100_spec()
    assert spec.nvlink_links * spec.nvlink_bw_per_link * 2 == 900e9


def test_sharded_matmul_loop_matches_hlo_analysis(programs):
    """FLOPs a rank and the one all-gather: exact, and equal to the
    reference's counts of its compiled HLO."""
    ref, mine = programs
    assert ref["flops"] == mine["flops"] == FLOPS
    assert ref["coll"]["all-gather"] == mine["coll"]["all-gather"] == GATHER
    for k in COLLECTIVES:
        if k != "all-gather":
            assert mine["coll"][k] == 0.0, k


def test_all_to_all_is_booked_as_asked(programs):
    """A shard-dim change DTensor makes with an all-to-all is booked as
    one, although the CPU backend falls back to all-gather + chunk."""
    _, mine = programs
    assert mine["a2a"]["all-to-all"] == 16 * 64 * 4
    assert mine["a2a"]["all-gather"] == 0.0


def test_in_place_updates_cost_the_region(programs):
    """Sixteen row updates of a 4,096 x 1,024 float32 cache cost their
    rows, not sixteen whole copies (under 5 % of them), in both."""
    ref, _ = programs
    cache = torch.zeros(4096, 1024)
    upd = torch.ones(1, 1024)

    def f(cache, upd):
        for i in range(16):
            cache[i:i + 1].copy_(upd)
        return cache

    s = analyze_ops(f, cache, upd)
    assert s.hbm_bytes < 0.05 * WHOLE
    assert ref["dus_bytes"] < 0.05 * WHOLE
    # index_copy_ and index_put_ take the same rule.
    idx = torch.arange(16)
    rows = torch.ones(16, 1024)
    t = analyze_ops(lambda c: c.index_copy_(0, idx, rows), cache)
    u = analyze_ops(lambda c: c.index_put_((idx,), rows), cache)
    assert t.hbm_bytes < 0.05 * WHOLE and u.hbm_bytes < 0.05 * WHOLE
    assert torch.equal(cache[:16], rows)


def test_eager_ops_counted_once_at_local_size():
    """On plain tensors every op is counted once: a matmul's FLOPs, and
    its operand and output bytes; a view costs nothing."""
    a, b = torch.ones(32, 48), torch.ones(48, 16)
    s = analyze_ops(lambda a, b: (a @ b).T, a, b)
    assert s.flops == 2 * 32 * 48 * 16
    assert s.hbm_bytes == 4 * (32 * 48 + 48 * 16 + 32 * 16)
    assert s.total_collective_bytes == 0.0
