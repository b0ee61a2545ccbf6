"""The port's training forward and loss (``repro_torch.models.model.Model.
forward``/``loss``) against the JAX package's, for every registered arch.

On the CPU, in float32 at reduced size (``.reduced()`` configs and
``SMOKE_SHAPES["train_4k"]``: 2 sequences of 64 tokens), with the batch
drawn by each package's ``make_batch`` from one numpy seed: the reference
side is ``build_model(cfg, remat="none").init(PRNGKey(0))`` and
``jax.value_and_grad(model.loss, has_aux=True)``; the port side is the same
parameters through ``params_from_numpy``, ``Model.loss`` and
``.backward()``.  ``loss``, ``nll``, ``aux`` and every gradient leaf agree
within ``|err| <= 1e-4 * (1 + |ref|)`` (``tests/test_kernels.py``), and
every port leaf whose reference gradient is non-zero has a gradient (a
silently detached block would leave it ``None``).

Also: the three remat modes give equal loss and gradients; ``make_batch``
draws the reference's batch; ``n_params`` and ``cross_entropy_loss``
match; the kernels' autograd guard raises, and on a card (``gpu``) each
wrapper refuses inputs that require grad while the zamba2 training
forward takes ``ssd_chunked`` and gives its Mamba2 weights gradients.
"""

import numpy as np
import pytest
import torch

try:     # a machine with the card may lack jax: there only the gpu cases run
    import jax
    import jax.numpy as jnp
    from repro.configs import SMOKE_SHAPES as REF_SHAPES
    from repro.configs import get_model_config as ref_config
    from repro.configs import list_archs
    from repro.launch.specs import make_batch as ref_batch
    from repro.models import layers as RL
    from repro.models.model import build_model
    ARCHS = list_archs()
except ImportError:
    jax = None
    ARCHS = []
from repro_torch.configs import SMOKE_SHAPES, get_model_config
from repro_torch.configs import list_archs as port_archs
from repro_torch.kernels import _build
from repro_torch.launch.specs import make_batch
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.models.params import params_from_numpy
from repro_torch.tree import tree_flatten_with_paths as _flat
from repro_torch.tree import tree_leaves

SHAPE = SMOKE_SHAPES["train_4k"]


def _need_jax():
    if jax is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref) / (1.0 + np.abs(ref))
    assert err.max() <= 1e-4, (what, float(err.max()))


def _reference(arch):
    """The reference's loss, metrics and gradients at its own init, with
    the parameters and batch as numpy."""
    cfg = ref_config(arch).reduced()
    model = build_model(cfg, remat="none")
    params = model.init(jax.random.PRNGKey(0))
    batch = ref_batch(cfg, REF_SHAPES["train_4k"], np.random.default_rng(0),
                      dtype=jnp.float32)
    (loss, metrics), grads = jax.value_and_grad(model.loss, has_aux=True)(
        params, batch, jnp.float32)
    return jax.tree.map(np.asarray, (params, batch, loss, metrics, grads))


def _port_loss(arch, params, batch, remat="none"):
    cfg = get_model_config(arch).reduced()
    tp = params_from_numpy(params, cfg, "cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, metrics = Model(cfg, remat=remat).loss(tp, tb, torch.float32)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tp


def test_every_registered_arch_is_covered():
    _need_jax()
    assert ARCHS == port_archs() and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    _need_jax()
    params, batch, loss, metrics, grads = _reference(arch)
    tl, tm, tp = _port_loss(arch, params, batch)
    _close(tl, loss, "loss")
    _close(tm["nll"], metrics["nll"], "nll")
    _close(tm["aux"], metrics["aux"], "aux")
    if get_model_config(arch).family in ("moe", "mla_moe"):
        assert float(tm["aux"]) > 0
    ref_g, port = _flat(grads), _flat(tp)
    assert ref_g.keys() == port.keys()
    for k, g in ref_g.items():
        t = port[k]
        if t.grad is None:
            assert not np.any(g), f"{k}: no gradient where the reference's " \
                "is non-zero"
            continue
        _close(t.grad.numpy(), g, k)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b",
                                  "mixtral-8x7b", "whisper-large-v3"])
def test_remat_modes_give_equal_numbers(arch, remat):
    cfg = get_model_config(arch).reduced()
    batch = make_batch(cfg, SHAPE, np.random.default_rng(1), torch.float32,
                       device="cpu")
    out = {}
    for mode in ("none", remat):
        model = Model(cfg, remat=mode)
        params = model.init(3, device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, _ = model.loss(params, batch, torch.float32)
        loss.backward()
        out[mode] = (loss.detach(), {k: v.grad for k, v in
                                     _flat(params).items()})
    torch.testing.assert_close(out[remat][0], out["none"][0], rtol=0, atol=0)
    for k, g in out["none"][1].items():
        torch.testing.assert_close(out[remat][1][k], g, rtol=1e-6,
                                   atol=1e-7, msg=k)


def test_dots_remat_keeps_only_unbatched_products():
    """Under ``"dots"`` the backward recomputes the batched products
    (attention's einsums) but not the unbatched weight products."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    cfg = get_model_config("llama3.2-1b").reduced()
    batch = make_batch(cfg, SHAPE, np.random.default_rng(0), torch.float32,
                       device="cpu")
    counts = {}
    for mode in ("none", "dots", "full"):
        model = Model(cfg, remat=mode)
        params = model.init(0, device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        with Count() as c:
            model.loss(params, batch, torch.float32)[0].backward()
        counts[mode] = c.ops
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert counts["dots"][mm] == counts["none"][mm] < counts["full"][mm]
    assert counts["none"][bmm] < counts["dots"][bmm] == counts["full"][bmm]


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_draws_the_reference_batch(arch):
    _need_jax()
    ref = ref_batch(ref_config(arch).reduced(), REF_SHAPES["train_4k"],
                    np.random.default_rng(5), dtype=jnp.float32)
    got = make_batch(get_model_config(arch).reduced(), SHAPE,
                     np.random.default_rng(5), torch.float32, device="cpu")
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].dtype == {np.dtype(np.int32): torch.int32,
                                np.dtype(np.float32): torch.float32}[
            np.asarray(v).dtype], k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    dec = make_batch(get_model_config(arch).reduced(), SHAPE,
                     np.random.default_rng(5), device="cpu", kind="decode")
    rdec = ref_batch(ref_config(arch).reduced(), REF_SHAPES["train_4k"],
                     np.random.default_rng(5), kind="decode")
    assert dec.keys() == rdec.keys()
    for k, v in rdec.items():
        np.testing.assert_array_equal(dec[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_matches_reference(arch):
    _need_jax()
    assert Model(get_model_config(arch)).n_params() == \
        build_model(ref_config(arch)).n_params()


def test_cross_entropy_matches_reference():
    _need_jax()
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, (2, 7)).astype(np.int32)
    for z in (1e-4, 0.0):
        want = RL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     z_loss=z)
        got = L.cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels), z_loss=z)
        _close(got, want, f"z_loss={z}")


def test_model_rejects_unknown_remat():
    with pytest.raises(ValueError):
        Model(get_model_config("llama3.2-1b").reduced(), remat="some")


def test_refuse_grad_guards_a_launch():
    """The kernels' guard: it raises when grad mode is on and an input
    requires grad, and lets the launch through otherwise (the serving
    steps run under ``torch.no_grad()``)."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan.*no backward"):
        _build.refuse_grad("ssd_scan", (torch.ones(3), x))
    with torch.no_grad():
        _build.refuse_grad("ssd_scan", (x,))
    _build.refuse_grad("ssd_scan", (torch.ones(3),))


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_cuda_wrappers_refuse_inputs_that_require_grad():
    _cuda_or_skip()
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_cc import matmul_cc
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    dev = "cuda"

    def leaf(*shape):
        return torch.randn(*shape, device=dev).requires_grad_(True)

    table = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    calls = {
        "matmul_cc": lambda: matmul_cc(leaf(64, 64), leaf(64, 64)),
        "flash_attention": lambda: flash_attention(
            leaf(1, 2, 64, 64), leaf(1, 2, 64, 64), leaf(1, 2, 64, 64)),
        "paged_attention": lambda: paged_attention(
            leaf(2, 4, 64), leaf(1, 16, 2, 64), leaf(1, 16, 2, 64), table,
            lengths),
        "ssd_scan": lambda: ssd_scan(
            leaf(1, 16, 2, 16), torch.rand(1, 16, 2, device=dev),
            -torch.rand(2, device=dev), leaf(1, 16, 16), leaf(1, 16, 16),
            chunk=16),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=name):
            call()


@pytest.mark.gpu
def test_cuda_zamba2_training_forward_takes_the_plain_scan():
    _cuda_or_skip()
    from repro_torch.kernels import ssd_scan as ssd_mod

    cfg = get_model_config("zamba2-1.2b").reduced()
    model = Model(cfg, remat="full")
    params = model.init(0, device="cuda")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = make_batch(cfg, SHAPE, np.random.default_rng(0), torch.float32,
                       device="cuda")
    before = ssd_mod.LAUNCHES
    model.loss(params, batch, torch.float32)[0].backward()
    assert ssd_mod.LAUNCHES == before
    mam = params["mamba_layers"]
    for k in ("wx", "wB", "wC", "wdt", "conv_w", "A_log", "dt_bias"):
        assert mam[k].grad is not None and mam[k].grad.abs().sum() > 0, k
