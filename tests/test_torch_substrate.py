"""The port's training substrate -- data pipeline, checkpoints, fault
tolerance (``repro_torch.data``, ``repro_torch.ckpt``, ``repro_torch.ft``)
-- against the JAX package's, and the reference's own substrate tests on
the port.

``SyntheticLMDataset.batch(i, b)`` gives the reference's arrays, bit for
bit.  Checkpoints cross between the packages both ways: a ``(params,
OptState)`` that the reference's ``save_checkpoint`` writes restores in the
port with equal tensors, and the port's restores in the reference's
``restore_checkpoint`` with equal arrays -- exactly in float32, and with
bfloat16 moments by their bits (numpy has no bfloat16: both packages
store it as ``|V2``).
"""

import os
import time

import numpy as np
import pytest
import torch

try:     # a machine with the card may lack jax
    import jax
    import jax.numpy as jnp
    from repro.ckpt import restore_checkpoint as ref_restore
    from repro.ckpt import save_checkpoint as ref_save
    from repro.configs import get_model_config as ref_config
    from repro.data import SyntheticLMDataset as RefDataset
    from repro.models.model import build_model
    from repro.optim import adamw_init as ref_adamw_init
except ImportError:
    jax = None
from repro_torch.ckpt import (CheckpointManager, latest_checkpoint,
                              restore_checkpoint, save_checkpoint, to_tensor)
from repro_torch.configs import get_model_config
from repro_torch.data import DataPipeline, SyntheticLMDataset
from repro_torch.ft import PreemptionHandler, StepWatchdog, StragglerPolicy
from repro_torch.models.model import Model
from repro_torch.models.params import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import OptState, adamw_init
from repro_torch.tree import (tree_flatten_with_paths, tree_leaves, tree_map,
                               tree_unflatten, tree_unzip)


def _need_jax():
    if jax is None:
        pytest.skip("needs jax: the JAX package is the reference")


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,seed,index,batch",
                         [(256, 64, 0, 0, 2), (128256, 4096, 0, 17, 3),
                          (1000, 33, 7, 5, 8)])
def test_dataset_batches_equal_the_reference(vocab, seq, seed, index, batch):
    _need_jax()
    got = SyntheticLMDataset(vocab, seq, seed).batch(index, batch)
    want = RefDataset(vocab, seq, seed).batch(index, batch)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _state(dtype_name):
    """The reference's reduced llama3.2-1b parameters and a non-trivial
    OptState (moments in ``dtype_name``), as JAX arrays."""
    cfg = ref_config("llama3.2-1b").reduced()
    params = build_model(cfg, remat="none").init(jax.random.PRNGKey(0))
    dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    opt = ref_adamw_init(params, dt)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       mu=jax.tree.map(lambda p: (0.1 * p).astype(dt),
                                       params),
                       nu=jax.tree.map(lambda p: (p * p).astype(dt), params))
    return params, opt


def _bits(x):
    """An array's bytes as a comparable array (bfloat16 as its bits)."""
    x = np.asarray(x.detach().cpu().view(torch.int16)
                   if isinstance(x, torch.Tensor) and x.dtype
                   == torch.bfloat16 else x)
    return x.view(np.int16) if x.dtype.itemsize == 2 and \
        x.dtype.kind not in "iuf" else x


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, moments):
    _need_jax()
    params, opt = _state(moments)
    ref_save(str(tmp_path), 7, (params, opt))
    cfg = get_model_config("llama3.2-1b").reduced()
    host = jax.tree.map(np.asarray, (params, opt))
    tp = params_from_numpy(host[0], cfg, "cpu")
    template = (tp, opt_state_from_numpy(host[1], tp, "cpu"))
    mgr = CheckpointManager(str(tmp_path))
    (rp, ro), manifest = mgr.restore_latest(
        template, reshard=lambda k, a: to_tensor(a))
    assert manifest["step"] == 7 and int(ro.step) == 7
    want = {"0": host[0], "1": host[1]}
    got = tree_flatten_with_paths((rp, ro))
    ref = tree_flatten_with_paths(host)
    assert got.keys() == ref.keys()
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moments]
    for k, v in ref.items():
        if k.startswith("1/mu") or k.startswith("1/nu"):
            assert got[k].dtype == tdt, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
    assert want  # the tree is (params, OptState)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, moments):
    _need_jax()
    params, opt = _state(moments)
    host = jax.tree.map(np.asarray, (params, opt))
    cfg = get_model_config("llama3.2-1b").reduced()
    tp = params_from_numpy(host[0], cfg, "cpu")
    to = opt_state_from_numpy(host[1], tp, "cpu")
    save_checkpoint(str(tmp_path), 7, (tp, to))
    path = latest_checkpoint(str(tmp_path))
    template = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                            (params, opt))
    rp, ro = ref_restore(path, template)
    assert int(ro.step) == 7
    for got, want in zip(jax.tree.leaves((rp, ro)), jax.tree.leaves(host)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # The layout is the reference's: the same npz keys.
    with np.load(os.path.join(path, "host_0", "arrays.npz")) as z:
        ours = sorted(z.files)
    ref_save(str(tmp_path / "ref"), 7, (params, opt))
    with np.load(os.path.join(str(tmp_path / "ref"), "step_00000007",
                              "host_0", "arrays.npz")) as z:
        assert ours == sorted(z.files)


def test_opt_state_from_numpy_checks_shapes():
    cfg = get_model_config("llama3.2-1b").reduced()
    params = Model(cfg).init(0, device="cpu")
    opt = adamw_init(params)
    host = OptState(np.int32(3), *[tree_map(lambda t: t.numpy(), tree)
                                   for tree in (opt.mu, opt.nu)])
    got = opt_state_from_numpy(host, params, "cpu")
    assert int(got.step) == 3
    host.mu["final_norm"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        opt_state_from_numpy(host, params, "cpu")


def test_tree_walk_gives_the_checkpoint_paths():
    """One walk over dicts, NamedTuples, tuples and lists: the paths are
    the checkpoint's keys, the leaves come in that order, and map,
    unflatten and unzip keep the structure."""
    params = {"w": torch.ones(2), "layers": {"ln": torch.zeros(3)}}
    opt = adamw_init(params)
    tree = (params, opt, [torch.full((1,), 5.0)])
    flat = tree_flatten_with_paths(tree)
    assert list(flat) == ["0/w", "0/layers/ln", "1/step", "1/mu/w",
                          "1/mu/layers/ln", "1/nu/w", "1/nu/layers/ln",
                          "2/0"]
    assert all(a is b for a, b in zip(tree_leaves(tree), flat.values()))
    doubled = tree_map(lambda t, u: t + u, tree, tree)
    assert isinstance(doubled[1], OptState) and isinstance(doubled[2], list)
    assert float(doubled[2][0]) == 10.0
    back = tree_unflatten(tree, list(range(8)))
    assert back[1].mu["layers"]["ln"] == 4 and back[2] == [7]
    a, b = tree_unzip(tree_map(lambda t: (t, -t), params), 2)
    assert a.keys() == b.keys() == params.keys()
    assert torch.equal(b["w"], -params["w"])


# ---------------------------------------------------------------------------
# The reference's substrate tests, on the port
# ---------------------------------------------------------------------------


class TestData:
    def test_deterministic_batches(self):
        ds = SyntheticLMDataset(vocab_size=1000, seq_len=64, seed=42)
        a = ds.batch(7, 16)
        b = ds.batch(7, 16)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        c = ds.batch(8, 16)
        assert not np.array_equal(a["tokens"], c["tokens"])

    def test_labels_are_shifted_tokens(self):
        ds = SyntheticLMDataset(vocab_size=1000, seq_len=64, seed=0)
        b = ds.batch(0, 4)
        assert b["tokens"].shape == (4, 64)
        assert b["labels"].shape == (4, 64)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharding_partitions_global_batch(self):
        ds = SyntheticLMDataset(vocab_size=100, seq_len=16, seed=1)
        full = ds.batch(3, 8)
        parts, pipes = [], []
        for h in range(4):
            p = DataPipeline(ds, global_batch=8, host_index=h, host_count=4,
                             start_step=3, prefetch=1)
            pipes.append(p)
            step, hb = next(p)
            assert step == 3
            parts.append(hb["tokens"])
        for p in pipes:
            p.close()
        np.testing.assert_array_equal(np.concatenate(parts), full["tokens"])

    def test_resume_from_step(self):
        ds = SyntheticLMDataset(vocab_size=100, seq_len=16, seed=1)
        p = DataPipeline(ds, global_batch=4, start_step=11, prefetch=1)
        step, hb = next(p)
        p.close()
        assert step == 11
        np.testing.assert_array_equal(hb["tokens"], ds.batch(11, 4)["tokens"])


class TestCkpt:
    def _tree(self, x=1.0):
        return {"a": torch.full((4, 4), x),
                "b": {"c": torch.arange(6).reshape(2, 3)}}

    def test_atomic_save_and_latest(self, tmp_path):
        d = str(tmp_path)
        save_checkpoint(d, 5, self._tree(1.0))
        save_checkpoint(d, 9, self._tree(2.0))
        assert latest_checkpoint(d).endswith("step_00000009")
        os.makedirs(os.path.join(d, "step_00000099.tmp"))
        assert latest_checkpoint(d).endswith("step_00000009")

    def test_keep_k_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, self._tree(float(s)), blocking=True)
        assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                                "step_00000004"]

    def test_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3)
        tree = self._tree(3.5)
        mgr.save(12, tree, blocking=True)
        restored, manifest = mgr.restore_latest(
            self._tree(0.0), reshard=lambda k, a: to_tensor(a))
        assert manifest["step"] == 12
        torch.testing.assert_close(restored["a"], tree["a"])
        torch.testing.assert_close(restored["b"]["c"], tree["b"]["c"])

    def test_restore_missing_leaf_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"a": torch.zeros(2)}, blocking=True)
        with pytest.raises(KeyError):
            mgr.restore_latest({"a": torch.zeros(2), "zz": torch.zeros(3)})

    def test_namedtuple_state_roundtrip(self, tmp_path):
        params = {"w": torch.ones((3, 3))}
        for dt in (torch.float32, torch.bfloat16):
            opt = adamw_init(params, dt)
            mgr = CheckpointManager(str(tmp_path / str(dt)))
            mgr.save(2, (params, opt), blocking=True)
            (rp, ro), m = mgr.restore_latest(
                (params, opt), reshard=lambda k, a: to_tensor(a))
            assert m["step"] == 2 and int(ro.step) == 0
            assert ro.mu["w"].dtype == dt
            torch.testing.assert_close(rp["w"], torch.ones((3, 3)))

    def test_save_does_not_wait_for_the_write(self, tmp_path):
        """The async save copies to the host and returns; ``wait`` joins
        the writer, and the file holds the values at the time of save."""
        mgr = CheckpointManager(str(tmp_path))
        t = {"a": torch.ones(1000)}
        mgr.save(1, t, blocking=False)
        t["a"].add_(1.0)
        mgr.wait()
        restored, _ = mgr.restore_latest({"a": torch.zeros(1000)})
        np.testing.assert_array_equal(restored["a"], np.ones(1000))


class TestFT:
    def test_preemption_flag(self):
        h = PreemptionHandler()
        assert not h.should_stop
        h.request_stop()
        assert h.should_stop

    def test_watchdog_fires_on_slow_step(self):
        fired = []
        wd = StepWatchdog(deadline_s=0.05,
                          on_timeout=lambda s, dt: fired.append((s, dt)))
        wd.start_step(3)
        time.sleep(0.15)
        wd.end_step()
        assert fired and fired[0][0] == 3

    def test_watchdog_quiet_on_fast_step(self):
        fired = []
        wd = StepWatchdog(deadline_s=0.5,
                          on_timeout=lambda s, dt: fired.append(s))
        wd.start_step(1)
        wd.end_step()
        time.sleep(0.05)
        assert not fired

    def test_straggler_detection(self):
        pol = StragglerPolicy(k=3.0, min_samples=4)
        for t in range(10):
            for host in range(8):
                pol.record(host, 1.0 + (3.0 if host == 5 else 0.0)
                           + 0.01 * t)
        assert pol.stragglers() == [5]
        assert pol.replacement_plan(spares=[100, 101]) == {5: 100}
