"""The port's train step and training loop (``repro_torch.launch.trainer``,
``repro_torch.launch.train``) against the JAX package's.

On the CPU, in float32 at reduced size (``SMOKE_SHAPES["train_4k"]``: 2
sequences of 64 tokens): one ``make_train_step`` step of reduced
llama3.2-1b and reduced zamba2-1.2b -- plain, with 2 microbatches and with
bf16 gradient compression -- is held against the reference's jitted step
on a one-device mesh, both fed the same parameters, ``OptState`` and
batch: loss, ``grad_norm``, ``lr``, ``mu``, ``nu`` and the new parameters.
Tolerance: ``|err| <= 1e-4 * (1 + |ref|)`` (``tests/test_kernels.py``).

Adam's first step is a sign: ``mhat / sqrt(vhat)`` is ``g / (|g| +
1e-8)``, so an element whose gradient is noise-sized can move by +-lr in
one package and -+lr in the other.  The new parameters are therefore held
to the tolerance where ``|g_ref| > 1e-6`` (read from ``mu_ref = (1 - b1)
g``), and elsewhere only to ``2 lr``; ``mu`` and ``nu`` are held to the
tolerance everywhere.

Then the loop: ``Trainer.fit`` drops the loss by more than 0.5 in 40 steps
(as the reference's mesh test does), 2 + 2 steps across a blocking save
and a fresh ``Trainer``'s restore give the losses of 4 straight steps, the
CLI returns 0, and ``int8_ef`` in a step raises in both packages (the
reference's step passes no error-feedback state).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

try:     # a machine with the card may lack jax
    import jax
    import jax.numpy as jnp
    from repro.configs import TrainConfig as RefTrain
    from repro.configs import get_model_config as ref_config
    from repro.launch.specs import make_batch as ref_batch
    from repro.launch.trainer import make_train_step as ref_make_step
    from repro.optim import adamw_init as ref_adamw_init
except ImportError:
    jax = None
from repro_torch.configs import (SMOKE_SHAPES, RunConfig, ShapeConfig,
                                 TrainConfig, get_model_config)
from repro_torch.launch.trainer import Trainer, make_train_step
from repro_torch.models.params import opt_state_from_numpy, params_from_numpy
from repro_torch.tree import tree_flatten_with_paths, tree_leaves

SHAPE = SMOKE_SHAPES["train_4k"]


def _need_jax():
    if jax is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _flat(tree):
    """``{path: float32 array}`` of a tensor or array tree."""
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v, dtype=np.float32)
            for k, v in tree_flatten_with_paths(tree).items()}


def _close(got, ref, what):
    err = np.abs(got - ref) / (1.0 + np.abs(ref))
    assert err.max() <= 1e-4, (what, float(err.max()))


def _ref_step(arch, train_kw, seed=0):
    """The reference's jitted step on a one-device mesh, from its own
    init; returns numpy copies of what went in and what came out."""
    cfg = ref_config(arch).reduced()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    train = RefTrain(**train_kw)
    ts = ref_make_step(cfg, SHAPE, mesh, train, jit=True)
    params = ts.model.init(jax.random.PRNGKey(seed))
    opt = ref_adamw_init(params)
    batch = ref_batch(cfg, SHAPE, np.random.default_rng(seed),
                      dtype=jnp.float32)
    host = jax.tree.map(np.asarray, (params, opt, batch))
    new_p, new_o, metrics = ts.fn(params, opt, batch)
    return host, jax.tree.map(np.asarray, (new_p, new_o, metrics))


TRAIN_KW = dict(dtype="float32", remat="none", warmup_steps=2,
                total_steps=10)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
@pytest.mark.parametrize("extra", [{}, {"microbatches": 2},
                                   {"grad_compression": "bf16"}],
                         ids=["plain", "microbatches2", "bf16"])
def test_train_step_matches_reference(arch, extra):
    _need_jax()
    kw = dict(TRAIN_KW, **extra)
    (params, opt, batch), (ref_p, ref_o, ref_m) = _ref_step(arch, kw)
    cfg = get_model_config(arch).reduced()
    ts = make_train_step(cfg, SHAPE, train=TrainConfig(**kw), device="cpu")
    tp = params_from_numpy(params, cfg, "cpu")
    to = opt_state_from_numpy(opt, tp, "cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    new_p, new_o, metrics = ts.fn(tp, to, tb)
    for k in ("loss", "grad_norm", "lr", "nll", "aux"):
        _close(np.float32(metrics[k]), np.float32(ref_m[k]), k)
    assert int(new_o.step) == int(ref_o.step) == 1
    mu_ref = _flat(ref_o.mu)
    for name, got, ref in (("mu", new_o.mu, ref_o.mu),
                           ("nu", new_o.nu, ref_o.nu)):
        g, r = _flat(got), _flat(ref)
        assert g.keys() == r.keys()
        for k in r:
            _close(g[k], r[k], f"{name}.{k}")
    lr = float(ref_m["lr"])
    got_p, want_p = _flat(new_p), _flat(ref_p)
    assert got_p.keys() == want_p.keys()
    for k, want in want_p.items():
        live = np.abs(mu_ref[k]) > (1 - TrainConfig().b1) * 1e-6
        _close(got_p[k][live], want[live], f"params.{k}")
        assert np.all(np.abs(got_p[k] - want) <= 2 * lr * 1.001 + 1e-6), k
    # The new parameters are leaves the next step differentiates.
    assert all(t.requires_grad and t.grad_fn is None
               for t in tree_leaves(new_p))


def test_int8_ef_step_raises_in_both_packages():
    _need_jax()
    kw = dict(TRAIN_KW, grad_compression="int8_ef")
    with pytest.raises(AssertionError):
        _ref_step("llama3.2-1b", kw)
    cfg = get_model_config("llama3.2-1b").reduced()
    ts = make_train_step(cfg, SHAPE, train=TrainConfig(**kw), device="cpu")
    from repro_torch.launch.trainer import init_train_state
    from repro_torch.launch.specs import make_batch

    params, opt = init_train_state(ts, 0, TrainConfig(**kw))
    batch = make_batch(cfg, SHAPE, np.random.default_rng(0), torch.float32,
                       device="cpu")
    with pytest.raises(ValueError, match="error-feedback"):
        ts.fn(params, opt, batch)


def test_train_step_rejects_other_collectives():
    """An unknown collectives value is refused; the reference's values
    (and "auto") are accepted, with nothing to schedule on one device."""
    cfg = get_model_config("llama3.2-1b").reduced()
    with pytest.raises(ValueError, match="unknown collectives"):
        make_train_step(cfg, SHAPE, train=TrainConfig(collectives="ring2"),
                        device="cpu")
    for mode in ("gspmd", "ring", "serpentine", "auto"):
        ts = make_train_step(cfg, SHAPE,
                             train=TrainConfig(collectives=mode),
                             device="cpu")
        assert ts.mesh is None and ts.rules is None


def _run(tmp_path, steps=60, **kw):
    cfg = get_model_config("llama3.2-1b").reduced()
    shape = ShapeConfig("tiny", seq_len=32, global_batch=8, kind="train")
    train = TrainConfig(learning_rate=3e-3, warmup_steps=5,
                        total_steps=steps, remat="none",
                        checkpoint_dir=str(tmp_path), **kw)
    return RunConfig(model=cfg, shape=shape, train=train)


def _fit(trainer, steps, start):
    from repro_torch.data import DataPipeline, SyntheticLMDataset

    run = trainer.run
    ds = SyntheticLMDataset(vocab_size=run.model.vocab_size,
                            seq_len=run.shape.seq_len, seed=run.train.seed)
    pipe = DataPipeline(ds, global_batch=run.shape.global_batch,
                        start_step=start, prefetch=1)
    try:
        return trainer.fit(steps, iter(pipe), log_every=0)["loss"]
    finally:
        pipe.close()


def test_trainer_fit_drops_the_loss(tmp_path):
    """The reference's mesh test on one device: reduced llama3.2-1b, seq
    32, batch 8, lr 3e-3, warmup 5: the loss falls by more than 0.5 in 40
    steps."""
    trainer = Trainer(_run(tmp_path), device="cpu")
    try:
        assert trainer.init_or_restore() == 0
        losses = _fit(trainer, 40, 0)
    finally:
        trainer.preempt.uninstall()
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, losses[::8]


def test_save_restore_resumes_the_same_run(tmp_path):
    """2 steps, a blocking save, a fresh Trainer that restores, 2 more
    steps: the losses of 4 straight steps, and the restored state equals
    the saved one."""
    straight = Trainer(_run(tmp_path / "a"), device="cpu")
    try:
        straight.init_or_restore()
        want = _fit(straight, 4, 0)
    finally:
        straight.preempt.uninstall()

    first = Trainer(_run(tmp_path / "b"), device="cpu")
    try:
        first.init_or_restore()
        got = _fit(first, 2, 0)
        first.ckpt.save(first.step, (first.params, first.opt),
                        blocking=True)
        saved = _flat(first.params)
    finally:
        first.preempt.uninstall()
    second = Trainer(_run(tmp_path / "b"), device="cpu")
    try:
        assert second.init_or_restore() == 2
        restored = _flat(second.params)
        assert restored.keys() == saved.keys()
        for k in saved:
            np.testing.assert_array_equal(restored[k], saved[k])
        assert int(second.opt.step) == 2
        got += _fit(second, 2, 2)
    finally:
        second.preempt.uninstall()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_checkpoint_every_saves_keep_k(tmp_path):
    trainer = Trainer(_run(tmp_path, checkpoint_every=2, keep_checkpoints=2),
                      device="cpu")
    try:
        trainer.init_or_restore()
        _fit(trainer, 6, 0)
    finally:
        trainer.preempt.uninstall()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000006"]


def test_preemption_drains_with_a_final_checkpoint(tmp_path):
    trainer = Trainer(_run(tmp_path), device="cpu")
    try:
        trainer.init_or_restore()
        _fit(trainer, 1, 0)
        trainer.preempt.request_stop()
        losses = _fit(trainer, 5, 1)
    finally:
        trainer.preempt.uninstall()
    assert losses == [] and trainer.step == 1
    assert os.listdir(tmp_path) == ["step_00000001"]


def test_train_cli_returns_zero(tmp_path, capsys):
    from repro_torch.launch.train import main

    assert main(["--device", "cpu", "--steps", "3", "--seq_len", "32",
                 "--train.checkpoint_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[train] arch=qwen2-0.5b" in out and "over 3 steps" in out


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    """A second run over the same checkpoint directory resumes at the
    first run's last saved step and trains only the remaining steps."""
    from repro_torch.launch.train import main

    args = ["--device", "cpu", "--seq_len", "32", "--batch", "4",
            "--train.checkpoint_every", "2",
            "--train.checkpoint_dir", str(tmp_path)]
    assert main(args + ["--steps", "2"]) == 0
    capsys.readouterr()
    assert main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[ckpt] resumed from step 2" in out and "over 1 steps" in out


def test_run_config_overrides_follow_the_reference_paths():
    """The fields the port shares with the reference take the same dotted
    overrides to the same values.  Only the checkpoint directory's default
    differs (the port's own), and the reference's ``param_dtype`` is left
    out (nothing reads it)."""
    _need_jax()
    from repro.configs import RunConfig as RefRun
    from repro.configs import apply_overrides as ref_apply
    from repro_torch.configs import apply_overrides

    over = {"train.learning_rate": "1e-3", "train.microbatches": "4",
            "train.remat": "dots", "mesh.shape": "(2,2)"}
    mine = apply_overrides(
        RunConfig(model=get_model_config("llama3.2-1b"), shape=SHAPE), over)
    ref = ref_apply(RefRun(model=ref_config("llama3.2-1b"),
                           shape=__import__("repro.configs", fromlist=["x"])
                           .SMOKE_SHAPES["train_4k"]), over)
    got = dataclasses.asdict(mine.train)
    want = dataclasses.asdict(ref.train)
    assert got.pop("checkpoint_dir") != want.pop("checkpoint_dir")
    want.pop("param_dtype")
    assert got == want
    assert dataclasses.asdict(mine.mesh) == dataclasses.asdict(ref.mesh)


def test_default_checkpoint_dir_is_the_ports_own():
    import tempfile

    d = TrainConfig().checkpoint_dir
    assert d.startswith(tempfile.gettempdir()) and "repro_torch" in d


@pytest.mark.parametrize("knob", ["use_pallas", "tcl", "schedule",
                                  "decomposition", "train.param_dtype",
                                  "train.nonesuch"])
def test_train_cli_refuses_knobs_it_does_not_read(tmp_path, knob):
    """The reference's runtime knobs and ``param_dtype`` are read by no
    training code: the CLI refuses them instead of ignoring them."""
    from repro_torch.launch.train import main

    with pytest.raises(KeyError, match=knob.split(".")[-1]):
        main(["--device", "cpu", "--steps", "1", "--seq_len", "32",
              "--train.checkpoint_dir", str(tmp_path), f"--{knob}", "x"])
    assert not os.listdir(tmp_path)


def test_restore_refuses_a_checkpoint_of_another_shape(tmp_path):
    """A directory that holds another run's checkpoint with the same keys
    but other shapes is refused by name, not restored."""
    first = Trainer(_run(tmp_path), device="cpu")
    try:
        first.init_or_restore()
        first.ckpt.save(1, (first.params, first.opt), blocking=True)
    finally:
        first.preempt.uninstall()
    run = _run(tmp_path)
    wider = dataclasses.replace(run, model=dataclasses.replace(
        run.model, d_ff=2 * run.model.d_ff))
    second = Trainer(wider, device="cpu")
    try:
        with pytest.raises(ValueError, match="has shape"):
            second.init_or_restore()
    finally:
        second.preempt.uninstall()
