"""Model assembly for the dense and hybrid_ssm families (the port of the
paged paths of ``repro.models.model``).

``Model`` declares the parameter tree (same paths and shapes as the JAX
package) and runs the two serving steps over the paged KV pool:
``decode_step_paged`` (one token per slot) and ``prefill_chunk`` (one
prompt chunk of one slot).  Both run the one shared layer body
``_tf_layer`` with a mode-specific attention hook.  Layers run as a Python
loop over the stacked parameters; the pool and the per-slot state are
updated in place.

``hybrid_ssm`` (Zamba2) is a stack of Mamba2 mixers with ONE weight-shared
attention block (``_tf_layer`` over ``shared_attn``) applied before each
group of ``attn_every`` mixers; application ``app`` owns layer ``app`` of
the page pool, and each mixer owns its rows of ``state["mamba"]`` (conv
and SSM state per slot).  Other families raise ``NotImplementedError``
until their slice lands.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.params import ParamSpec, init_params

PyTree = Any

#: Families this port can run so far.
FAMILIES = ("dense", "hybrid_ssm")


def _norm_spec(cfg, layers: int = 0) -> ParamSpec:
    ls = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return ParamSpec(ls + (cfg.d_model,), la + ("embed",), init="ones")


def _layer_params(stack: PyTree, i: int) -> PyTree:
    """Layer ``i``'s slice of a stacked parameter tree (views, no copy)."""
    if isinstance(stack, dict):
        return {k: _layer_params(v, i) for k, v in stack.items()}
    return stack[i]


def _tf_layer(lp: dict, x: torch.Tensor, cfg,
              attn: Callable[[dict, torch.Tensor], torch.Tensor]
              ) -> torch.Tensor:
    """ONE decoder-layer body for every mode: pre-norm attention +
    residual, pre-norm SwiGLU FFN + residual.  ``attn(lp["attn"], h)`` is
    the mode's attention hook (paged decode or chunked prefill)."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn(lp["attn"], h)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.swiglu_ffn(lp["ffn"], h)


class Model:
    """The dense decoder and the Zamba2 hybrid; see the module
    docstring."""

    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"repro_torch serves families {FAMILIES} so far; "
                f"{cfg.arch!r} is {cfg.family!r}")
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def param_specs(self) -> dict:
        cfg = self.cfg
        specs = L.embed_param_specs(cfg)
        n = cfg.n_layers
        if cfg.family == "hybrid_ssm":
            specs["mamba_layers"] = M2.mamba2_param_specs(cfg, n)
            if cfg.ssm.attn_every:
                specs["shared_attn"] = {
                    "ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg),
                    "attn": L.attention_param_specs(cfg),
                    "ffn": L.ffn_param_specs(cfg),
                }
            return specs
        specs["layers"] = {
            "ln1": _norm_spec(cfg, n), "ln2": _norm_spec(cfg, n),
            "attn": L.attention_param_specs(cfg, n),
            "ffn": L.ffn_param_specs(cfg, layers=n),
        }
        return specs

    def init(self, seed: int = 0, device=None,
             dtype=torch.float32) -> PyTree:
        from repro_torch import resolve_device

        return init_params(self.param_specs(), seed, resolve_device(device),
                           dtype)

    # ------------------------------------------------------------- hybrid
    def _hybrid_stack(self, params: PyTree, x: torch.Tensor,
                      attn: Callable[[int], Callable],
                      state: Callable[[int], dict]) -> torch.Tensor:
        """Zamba2's stack: the shared block (``attn(app)``, its attention
        hook for application ``app``) before each group of ``attn_every``
        Mamba2 mixers.  Mixer ``i`` reads its cache rows ``state(i)``
        (views) and its new state is written back into them."""
        cfg = self.cfg
        per = cfg.ssm.attn_every or cfg.n_layers
        app = 0
        for start in range(0, cfg.n_layers, per):
            if cfg.ssm.attn_every:
                x = _tf_layer(params["shared_attn"], x, cfg, attn(app))
                app += 1
            for i in range(start, min(start + per, cfg.n_layers)):
                rows = state(i)
                x, new = M2.mamba2_block(
                    _layer_params(params["mamba_layers"], i), x, cfg, rows)
                rows["conv"].copy_(new["conv"])
                rows["ssm"].copy_(new["ssm"])
        return x

    # ------------------------------------------------------- paged decode
    def decode_step_paged(self, params: PyTree, cache: PyTree,
                          batch: Dict[str, torch.Tensor],
                          dtype=torch.bfloat16
                          ) -> Tuple[torch.Tensor, PyTree]:
        """One-token decode against the paged KV pool.

        ``cache`` is the pooled layout of ``serve.pages.init_paged_cache``:
        ``pool`` (``k``/``v``, each ``(L, P, T, KV, D)``), ``table`` (the
        ``(S, NP)`` int32 page table), ``pos`` (the per-slot position
        vector) and, for hybrid_ssm, ``state["mamba"]`` (``conv`` and
        ``ssm``, each with the slot on axis 1).  ``batch["tokens"]`` is
        ``(S, 1)``.  Every row carries its own RoPE offset and length
        mask, so slots at different depths decode as one batch; empty
        slots (``pos == 0``, null table row) decode garbage the engine
        ignores.  The pool and the state are
        written in place; returns ``(logits (S, V), cache)`` with
        ``cache["pos"]`` advanced.
        """
        cfg = self.cfg
        pos, table = cache["pos"], cache["table"]
        kp, vp = cache["pool"].get("k"), cache["pool"].get("v")
        x = L.embed_tokens(params, batch["tokens"], dtype)

        def attn(i):
            return lambda ap, h: L.paged_attention_block(
                ap, h, pos, cfg, kp, vp, i, table)

        if cfg.family == "hybrid_ssm":
            mc = cache["state"]["mamba"]
            x = self._hybrid_stack(
                params, x, attn,
                lambda i: {"conv": mc["conv"][i], "ssm": mc["ssm"][i]})
        else:
            for i in range(cfg.n_layers):
                x = _tf_layer(_layer_params(params["layers"], i), x, cfg,
                              attn(i))
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        logits = L.lm_logits(params, x, cfg)
        return logits[:, -1], new_cache

    # ----------------------------------------------------- chunked prefill
    def prefill_chunk(self, params: PyTree, cache: PyTree,
                      batch: Dict[str, Any], dtype=torch.bfloat16
                      ) -> Tuple[torch.Tensor, PyTree]:
        """One prompt CHUNK of one slot against the paged pool.

        ``batch``: ``tokens`` (1, C), ``pos0`` -- the chunk's first
        absolute position -- and ``slot``.  K/V rows go straight into the
        slot's pool pages through its table row (in place).  Returns the
        chunk's last-token logits ``(1, V)`` (meaningful on the final
        chunk) and the cache.  For hybrid_ssm the chunk's mixers start
        from the slot's state rows and leave the next chunk's there.
        """
        cfg = self.cfg
        slot, pos0 = int(batch["slot"]), int(batch["pos0"])
        kp, vp = cache["pool"].get("k"), cache["pool"].get("v")
        x = L.embed_tokens(params, batch["tokens"], dtype)
        c = x.shape[1]
        positions = pos0 + torch.arange(c, device=x.device)
        table_row = cache["table"][slot]

        def attn(i):
            return lambda ap, h: L.paged_prefill_block(
                ap, h, positions, cfg, kp, vp, i, table_row)

        if cfg.family == "hybrid_ssm":
            mc = cache["state"]["mamba"]
            x = self._hybrid_stack(
                params, x, attn,
                lambda i: {"conv": mc["conv"][i, slot:slot + 1],
                           "ssm": mc["ssm"][i, slot:slot + 1]})
        else:
            for i in range(cfg.n_layers):
                x = _tf_layer(_layer_params(params["layers"], i), x, cfg,
                              attn(i))
        logits = L.lm_logits(params, x[:, -1:], cfg)
        return logits[:, -1], dict(cache)
