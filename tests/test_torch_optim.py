"""The port's optimizer and gradient compression (``repro_torch.optim``)
against the JAX package's (``repro.optim``).

Each on the same numpy inputs, in float32: ``lr_schedule`` at every step
from 0 to ``total_steps + 5``; ``clip_by_global_norm`` (the norm and the
scaled gradients) below and above the clip; ``adamw_update`` on a small
tree for 3 steps with its moments in float32 and in bfloat16;
``compress_gradient``/``decompress_gradient`` in ``bf16`` and ``int8_ef``
(wire values, scales, residual).  Tolerance: ``|err| <= 1e-4 * (1 +
|ref|)`` (``tests/test_kernels.py``); bfloat16 moments within one
bfloat16 rounding.  Then the reference's own optimizer tests, ported:
AdamW minimises a quadratic, error feedback tracks the true sum.
"""

import numpy as np
import pytest
import torch

try:     # a machine with the card may lack jax
    import jax
    import jax.numpy as jnp
    from repro.configs import TrainConfig as RefTrain
    from repro.optim import adamw_init as ref_init
    from repro.optim import adamw_update as ref_update
    from repro.optim import clip_by_global_norm as ref_clip
    from repro.optim import compress_gradient as ref_compress
    from repro.optim import decompress_gradient as ref_decompress
    from repro.optim import ef_state_init as ref_ef_init
    from repro.optim import lr_schedule as ref_lr
except ImportError:
    jax = None
from repro_torch.configs import TrainConfig
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               clip_by_global_norm, compress_gradient,
                               decompress_gradient, ef_state_init,
                               lr_schedule)


def _need_jax():
    if jax is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _close(got, ref, what, tol=1e-4):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(np.asarray(ref).astype(np.float32))
    err = np.abs(got - ref) / (1.0 + np.abs(ref))
    assert err.max() <= tol, (what, float(err.max()))


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal((3,)) * scale).astype(np.float32),
                  "d": (rng.standard_normal((2, 2, 4)) * scale
                        ).astype(np.float32)}}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _pairs(got, ref, prefix=""):
    if isinstance(ref, dict):
        for k in ref:
            yield from _pairs(got[k], ref[k], f"{prefix}.{k}")
    else:
        yield prefix, got, ref


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 20), (5, 5)])
def test_lr_schedule_matches_reference(warmup, total):
    _need_jax()
    kw = dict(learning_rate=3e-3, warmup_steps=warmup, total_steps=total)
    fn, ref = lr_schedule(TrainConfig(**kw)), ref_lr(RefTrain(**kw))
    for step in range(total + 6):
        _close(fn(torch.tensor(step, dtype=torch.int32)),
               ref(jnp.asarray(step, jnp.int32)), f"step {step}")


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _need_jax()
    g = _tree(0, 3.0)
    got, gnorm = clip_by_global_norm(_torch(g), max_norm)
    want, wnorm = ref_clip(_jax(g), max_norm)
    _close(gnorm, wnorm, "norm")
    for k, a, b in _pairs(got, want):
        _close(a, b, k)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_three_steps_matches_reference(state_dtype):
    _need_jax()
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1, grad_clip=1.0)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[state_dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[state_dtype]
    p, rp = _torch(_tree(1)), _jax(_tree(1))
    opt, ropt = adamw_init(p, tdt), ref_init(rp, jdt)
    # One bfloat16 rounding of the moments (8 bits of mantissa).
    tol = 1e-4 if state_dtype == "float32" else 2 ** -7
    for step in range(3):
        g = _tree(10 + step, 0.5)
        p, opt, m = adamw_update(p, _torch(g), opt, TrainConfig(**kw))
        rp, ropt, rm = ref_update(rp, _jax(g), ropt, RefTrain(**kw))
        assert int(opt.step) == int(ropt.step) == step + 1
        _close(m["lr"], rm["lr"], "lr")
        _close(m["grad_norm"], rm["grad_norm"], "grad_norm")
        for name, got, want in (("mu", opt.mu, ropt.mu),
                                ("nu", opt.nu, ropt.nu)):
            for k, a, b in _pairs(got, want):
                assert a.dtype == tdt
                _close(a, b, f"{name}{k}", tol)
        for k, a, b in _pairs(p, rp):
            _close(a, b, f"params{k}")


def test_adamw_update_leaves_its_inputs_alone():
    p = _torch(_tree(2))
    opt = adamw_init(p)
    before = [t.clone() for _, t, _ in _pairs(p, p)]
    new_p, new_opt, _ = adamw_update(p, _torch(_tree(3)), opt, TrainConfig())
    for b, (_, t, _) in zip(before, _pairs(p, p)):
        torch.testing.assert_close(t, b, rtol=0, atol=0)
    assert int(opt.step) == 0 and int(new_opt.step) == 1
    assert isinstance(new_opt, OptState) and new_opt._fields == (
        "step", "mu", "nu")


def test_bf16_compression_matches_reference():
    _need_jax()
    g = _tree(4)
    wire, scales, ef = compress_gradient(_torch(g), "bf16")
    rwire, rscales, ref_ = ref_compress(_jax(g), "bf16")
    assert scales is None and ef is None and rscales is None
    for k, a, b in _pairs(wire, rwire):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b).astype(np.float32))
    out = decompress_gradient(wire, "bf16")
    for k, a, b in _pairs(out, ref_decompress(rwire, "bf16")):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int8_ef_compression_matches_reference():
    _need_jax()
    g = _tree(5, 0.01)
    ef, ref_ef = ef_state_init(_torch(g)), ref_ef_init(_jax(g))
    for step in range(3):
        wire, scales, ef = compress_gradient(_torch(g), "int8_ef", ef)
        rwire, rscales, ref_ef = ref_compress(_jax(g), "int8_ef", ref_ef)
        for k, a, b in _pairs(wire, rwire):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for k, a, b in _pairs(scales, rscales):
            _close(a, b, f"scale{k}")
        for k, a, b in _pairs(ef, ref_ef):
            assert a.dtype == torch.bfloat16
            _close(a, b, f"residual{k}", 1e-5)
        out = decompress_gradient(wire, "int8_ef", scales)
        for k, a, b in _pairs(out, ref_decompress(rwire, "int8_ef",
                                                  rscales)):
            _close(a, b, f"decompressed{k}")


def test_int8_ef_needs_its_state():
    g = _torch(_tree(6))
    with pytest.raises(ValueError):
        compress_gradient(g, "int8_ef")
    with pytest.raises(ValueError):
        compress_gradient(g, "fp4")


# ---------------------------------------------------------------------------
# The reference's optimizer tests, on the port
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    cfg = TrainConfig(learning_rate=0.1, warmup_steps=1, total_steps=200,
                      weight_decay=0.0, grad_clip=10.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-4)


def test_lr_schedule_warmup_and_decay():
    fn = lr_schedule(TrainConfig(learning_rate=1.0, warmup_steps=10,
                                 total_steps=100))
    assert float(fn(torch.tensor(0))) == pytest.approx(0.0, abs=1e-6)
    assert float(fn(torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(fn(torch.tensor(100))) < 0.11


def test_bf16_compression_roundtrip():
    g = {"w": torch.linspace(-1, 1, 64)}
    wire, scales, _ = compress_gradient(g, "bf16")
    assert wire["w"].dtype == torch.bfloat16
    out = decompress_gradient(wire, "bf16", scales)
    np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(), atol=1e-2)


def test_int8_ef_error_feedback_converges():
    """Error feedback: accumulated quantized gradients track the true sum
    (the residual is carried, not lost)."""
    g = {"w": torch.tensor([0.001, 0.5, -0.3])}
    ef = ef_state_init(g)
    total = torch.zeros(3)
    for _ in range(50):
        wire, scales, ef = compress_gradient(g, "int8_ef", ef)
        assert wire["w"].dtype == torch.int8
        total = total + decompress_gradient(wire, "int8_ef", scales)["w"]
    np.testing.assert_allclose(total.numpy(), g["w"].numpy() * 50,
                               rtol=0.02, atol=5e-3)
