"""Model assembly for the dense family (the port of the paged paths of
``repro.models.model``).

``Model`` declares the parameter tree (same paths and shapes as the JAX
package) and runs the two serving steps over the paged KV pool:
``decode_step_paged`` (one token per slot) and ``prefill_chunk`` (one
prompt chunk of one slot).  Both run the one shared layer body
``_tf_layer`` with a mode-specific attention hook.  Layers run as a Python
loop over the stacked parameters; the pool is updated in place.  Other
families raise ``NotImplementedError`` until their slice lands.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec, init_params

PyTree = Any

#: Families this port can run so far.
FAMILIES = ("dense",)


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
    """The dense decoder; see the module docstring."""

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

    # ------------------------------------------------------- paged decode
    def decode_step_paged(self, params: PyTree, cache: PyTree,
                          batch: Dict[str, torch.Tensor],
                          dtype=torch.bfloat16
                          ) -> Tuple[torch.Tensor, PyTree]:
        """One-token decode against the paged KV pool.

        ``cache`` is the pooled layout of ``serve.pages.init_paged_cache``:
        ``pool`` (``k``/``v``, each ``(L, P, T, KV, D)``), ``table`` (the
        ``(S, NP)`` int32 page table) and ``pos`` (the per-slot position
        vector).  ``batch["tokens"]`` is ``(S, 1)``.  Every row carries its
        own RoPE offset and length mask, so slots at different depths
        decode as one batch; empty slots (``pos == 0``, null table row)
        decode garbage the engine ignores.  The pool is written in place;
        returns ``(logits (S, V), cache)`` with ``cache["pos"]`` advanced.
        """
        cfg = self.cfg
        pos, table = cache["pos"], cache["table"]
        kp, vp = cache["pool"]["k"], cache["pool"]["v"]
        x = L.embed_tokens(params, batch["tokens"], dtype)
        for i in range(cfg.n_layers):
            def attn(ap, h, i=i):
                return L.paged_attention_block(ap, h, pos, cfg, kp, vp, i,
                                               table)
            x = _tf_layer(_layer_params(params["layers"], i), x, cfg, attn)
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
        chunk) and the cache.
        """
        cfg = self.cfg
        slot, pos0 = int(batch["slot"]), int(batch["pos0"])
        kp, vp = cache["pool"]["k"], cache["pool"]["v"]
        x = L.embed_tokens(params, batch["tokens"], dtype)
        c = x.shape[1]
        positions = pos0 + torch.arange(c, device=x.device)
        table_row = cache["table"][slot]
        for i in range(cfg.n_layers):
            def attn(ap, h, i=i):
                return L.paged_prefill_block(ap, h, positions, cfg, kp, vp,
                                             i, table_row)
            x = _tf_layer(_layer_params(params["layers"], i), x, cfg, attn)
        logits = L.lm_logits(params, x[:, -1:], cfg)
        return logits[:, -1], dict(cache)
