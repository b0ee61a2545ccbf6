"""Model assembly for the dense, moe, mla_moe, hybrid_ssm, xlstm and
enc_dec families (the port of the paged paths of ``repro.models.model``).

``Model`` declares the parameter tree (same paths and shapes as the JAX
package), the per-slot recurrent state (``init_state``, the state part of
the reference's ``init_cache``) and runs the two serving steps over the
paged cache: ``decode_step_paged`` (one token per slot) and
``prefill_chunk`` (one prompt chunk of one slot).  The transformer
families run the one shared layer body ``_tf_layer`` with a mode-specific
attention hook; its FFN is SwiGLU, or ``moe_ffn`` for ``moe`` (Mixtral).
``mla_moe`` (DeepSeek-V2) runs its ``first_k_dense`` leading layers
(``dense_layers``: MLA attention, SwiGLU at ``dense_d_ff``) and then its
MoE layers (``layers``: MLA attention, ``moe_ffn`` with shared experts)
through the same body, with the MLA hook over one latent pool ``lat``
(dense layers at pool indices ``[0, kd)``, MoE layer ``i`` at ``kd + i``).
Layers run as a Python loop over the stacked parameters; the pool and the
per-slot state are updated in place.

``hybrid_ssm`` (Zamba2) is a stack of Mamba2 mixers with ONE weight-shared
attention block (``_tf_layer`` over ``shared_attn``) applied before each
group of ``attn_every`` mixers; application ``app`` owns layer ``app`` of
the page pool, and each mixer owns its rows of ``state["mamba"]`` (conv
and SSM state per slot).  ``xlstm`` is token-free: periods of
``slstm_every - 1`` mLSTM blocks and one sLSTM block, whose per-slot
states (``state["mlstm"]``, ``state["slstm"]``) are its whole cache.

``enc_dec`` (Whisper) runs its bidirectional encoder once per request
(``encode_cross``: ``_tf_layer`` over ``enc_layers`` with a non-causal
hook, the final norm, then every decoder layer's cross K/V); the serving
steps run ``_dec_layer`` over ``dec_layers``: paged self-attention (pool
layer ``i`` for decoder layer ``i``), then cross-attention against the
slot's rows of ``state["cross_k"/"cross_v"]``, each row masked to its own
``state["enc_len"]``.  Its training forward waits for the cohort slice.
Other families (``vlm``) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as XL
from repro_torch.models.params import ParamSpec, init_params

PyTree = Any

#: Families this port can run so far.
FAMILIES = ("dense", "moe", "mla_moe", "hybrid_ssm", "xlstm", "enc_dec")

#: The MoE decode step's capacity factor (the reference ``Model``'s
#: default); prefill chunks dispatch dropless.
CAPACITY_FACTOR = 1.25


def _norm_spec(cfg, layers: int = 0) -> ParamSpec:
    ls = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return ParamSpec(ls + (cfg.d_model,), la + ("embed",), init="ones")


def _layer_params(stack: PyTree, i: int) -> PyTree:
    """Layer ``i``'s slice of a stacked parameter tree (views, no copy)."""
    if isinstance(stack, dict):
        return {k: _layer_params(v, i) for k, v in stack.items()}
    return stack[i]


def _tf_layer_specs(cfg, layers: int, kind: str) -> dict:
    specs = {"ln1": _norm_spec(cfg, layers), "ln2": _norm_spec(cfg, layers),
             "attn": (MLA.mla_param_specs(cfg, layers) if kind == "mla"
                      else L.attention_param_specs(cfg, layers))}
    if kind in ("moe", "mla"):
        specs["moe"] = MOE.moe_param_specs(cfg, layers)
    else:
        specs["ffn"] = L.ffn_param_specs(cfg, layers=layers)
    return specs


def _tf_layer(lp: dict, x: torch.Tensor, cfg,
              attn: Callable[[dict, torch.Tensor], torch.Tensor],
              kind: str = "dense",
              capacity_factor: Optional[float] = None) -> torch.Tensor:
    """ONE decoder-layer body for every mode: pre-norm attention +
    residual, pre-norm FFN + residual.  ``attn(lp["attn"], h)`` is the
    mode's attention hook (paged decode or chunked prefill, GQA or MLA);
    ``kind`` picks the FFN: "moe" and "mla" route through ``moe_ffn`` at
    ``capacity_factor`` (its aux loss is dropped: serving has no loss),
    anything else is SwiGLU."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn(lp["attn"], h)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if kind in ("moe", "mla"):
        return x + MOE.moe_ffn(lp["moe"], h, cfg.moe, capacity_factor)[0]
    return x + L.swiglu_ffn(lp["ffn"], h)


def _dec_layer(lp: dict, x: torch.Tensor, cfg,
               self_attn: Callable[[dict, torch.Tensor], torch.Tensor],
               cross_attn: Callable[[dict, torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """The enc-dec decoder-layer body of every serving mode: pre-norm
    self-attention (``self_attn(lp["attn"], h)``: the paged hook),
    pre-norm cross-attention (``cross_attn(lp["cross"], h)``) and pre-norm
    SwiGLU, each with a residual."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + self_attn(lp["attn"], h)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + cross_attn(lp["cross"], h)
    h = L.rms_norm(x, lp["ln3"], cfg.norm_eps)
    return x + L.swiglu_ffn(lp["ffn"], h)


class Model:
    """The dense, MoE and MLA-MoE decoders, the Zamba2 hybrid, xLSTM and
    the Whisper encoder-decoder; see the module docstring."""

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
        if cfg.family == "xlstm":
            n_s = n // cfg.xlstm.slstm_every
            specs["mlstm_layers"] = XL.mlstm_param_specs(cfg, n - n_s)
            specs["mlstm_ln"] = _norm_spec(cfg, n - n_s)
            specs["slstm_layers"] = XL.slstm_param_specs(cfg, n_s)
            specs["slstm_ln"] = _norm_spec(cfg, n_s)
            return specs
        if cfg.family == "enc_dec":
            ne, nd = cfg.enc_dec.n_encoder_layers, cfg.enc_dec.n_decoder_layers
            specs["enc_layers"] = _tf_layer_specs(cfg, ne, "dense")
            specs["dec_layers"] = {
                "ln1": _norm_spec(cfg, nd), "ln2": _norm_spec(cfg, nd),
                "ln3": _norm_spec(cfg, nd),
                "attn": L.attention_param_specs(cfg, nd),
                "cross": L.attention_param_specs(cfg, nd),
                "ffn": L.ffn_param_specs(cfg, layers=nd),
            }
            specs["enc_final_norm"] = _norm_spec(cfg)
            return specs
        if cfg.family == "mla_moe":
            kd = cfg.moe.first_k_dense
            if kd:
                specs["dense_layers"] = {
                    "ln1": _norm_spec(cfg, kd), "ln2": _norm_spec(cfg, kd),
                    "attn": MLA.mla_param_specs(cfg, kd),
                    "ffn": L.ffn_param_specs(cfg, d_ff=cfg.moe.dense_d_ff,
                                             layers=kd),
                }
            specs["layers"] = _tf_layer_specs(cfg, n - kd, "mla")
            return specs
        specs["layers"] = _tf_layer_specs(cfg, n, cfg.family)
        return specs

    def init(self, seed: int = 0, device=None,
             dtype=torch.float32) -> PyTree:
        from repro_torch import resolve_device

        return init_params(self.param_specs(), seed, resolve_device(device),
                           dtype)

    def init_state(self, n_slots: int, dtype, device) -> PyTree:
        """The per-slot recurrent state at its start, as the state part of
        the reference's ``init_cache`` lays it out (the slot on axis 1):
        hybrid_ssm ``{"mamba": {conv (L, S, W-1, C) in dtype, ssm (L, S,
        H, P, N) f32}}``; xlstm ``{"mlstm": {conv, C, n, m}, "slstm": {c,
        n, h, m}}``, all zeros except the stabilisers ``m`` at ``NEG``
        (the running max starts at its floor), conv in dtype, the rest
        f32.  Families without state: ``{}`` (enc_dec's cross K/V is sized
        by the trace's longest encoder: ``serve.pages.init_paged_cache``
        lays it out)."""
        cfg = self.cfg
        f32 = dict(dtype=torch.float32, device=device)
        if cfg.family == "hybrid_ssm":
            s = cfg.ssm
            d_inner = s.expand * cfg.d_model
            return {"mamba": {
                "conv": torch.zeros((cfg.n_layers, n_slots,
                                     s.conv_width - 1,
                                     d_inner + 2 * s.state_dim),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((cfg.n_layers, n_slots,
                                    d_inner // s.head_dim, s.head_dim,
                                    s.state_dim), **f32),
            }}
        if cfg.family == "xlstm":
            x = cfg.xlstm
            di = XL._round128(x.mlstm_proj_factor * cfg.d_model)
            h = cfg.n_heads
            dh, dhs = di // h, cfg.d_model // h
            n_s = cfg.n_layers // x.slstm_every
            n_m = cfg.n_layers - n_s
            return {
                "mlstm": {
                    "conv": torch.zeros((n_m, n_slots, x.conv_width - 1, di),
                                        dtype=dtype, device=device),
                    "C": torch.zeros((n_m, n_slots, h, dh, dh), **f32),
                    "n": torch.zeros((n_m, n_slots, h, dh), **f32),
                    "m": torch.full((n_m, n_slots, h), XL.NEG, **f32),
                },
                "slstm": {
                    "c": torch.zeros((n_s, n_slots, h, dhs), **f32),
                    "n": torch.zeros((n_s, n_slots, h, dhs), **f32),
                    "h": torch.zeros((n_s, n_slots, h, dhs), **f32),
                    "m": torch.full((n_s, n_slots, h, dhs), XL.NEG, **f32),
                },
            }
        return {}

    # ------------------------------------------------- recurrent stacks
    def _hybrid_stack(self, params: PyTree, x: torch.Tensor,
                      attn: Callable[[int], Callable],
                      rows: Callable[[str, int], dict]) -> torch.Tensor:
        """Zamba2's stack: the shared block (``attn(app)``, its attention
        hook for application ``app``) before each group of ``attn_every``
        Mamba2 mixers.  Mixer ``i`` reads its state rows ``rows("mamba",
        i)`` (views) and its new state is written back into them."""
        cfg = self.cfg
        per = cfg.ssm.attn_every or cfg.n_layers
        app = 0
        for start in range(0, cfg.n_layers, per):
            if cfg.ssm.attn_every:
                x = _tf_layer(params["shared_attn"], x, cfg, attn(app))
                app += 1
            for i in range(start, min(start + per, cfg.n_layers)):
                r = rows("mamba", i)
                x, new = M2.mamba2_block(
                    _layer_params(params["mamba_layers"], i), x, cfg, r)
                _write_back(r, new)
        return x

    def _xlstm_stack(self, params: PyTree, x: torch.Tensor,
                     rows: Callable[[str, int], dict]) -> torch.Tensor:
        """xLSTM's stack: periods of ``slstm_every - 1`` pre-norm mLSTM
        blocks and one pre-norm sLSTM block, each with a residual.  Block
        ``i`` of group "mlstm" or "slstm" reads its state rows ``rows(group,
        i)`` (views) and its new state is written back into them."""
        cfg = self.cfg
        per = cfg.xlstm.slstm_every
        m_per = per - 1
        chunk = min(cfg.ssm.chunk if cfg.ssm else 256, max(16, x.shape[1]))
        for p in range(cfg.n_layers // per):
            for i in range(p * m_per, (p + 1) * m_per):
                r = rows("mlstm", i)
                h = L.rms_norm(x, params["mlstm_ln"][i], cfg.norm_eps)
                y, new = XL.mlstm_block(
                    _layer_params(params["mlstm_layers"], i), h, cfg, r,
                    chunk)
                x = x + y
                _write_back(r, new)
            r = rows("slstm", p)
            h = L.rms_norm(x, params["slstm_ln"][p], cfg.norm_eps)
            y, new = XL.slstm_block(_layer_params(params["slstm_layers"], p),
                                    h, cfg, r)
            x = x + y
            _write_back(r, new)
        return x

    def _layers(self, params: PyTree, x: torch.Tensor,
                attn: Callable[[int], Callable],
                rows: Callable[[str, int], dict],
                capacity_factor: Optional[float],
                cross: Optional[Callable[[int], Callable]] = None
                ) -> torch.Tensor:
        """The family's stack between the embedding and the LM head;
        ``cross(i)`` is enc_dec's cross-attention hook for decoder layer
        ``i``."""
        cfg = self.cfg
        if cfg.family == "enc_dec":
            for i in range(cfg.enc_dec.n_decoder_layers):
                x = _dec_layer(_layer_params(params["dec_layers"], i), x,
                               cfg, attn(i), cross(i))
            return x
        if cfg.family == "hybrid_ssm":
            return self._hybrid_stack(params, x, attn, rows)
        if cfg.family == "xlstm":
            return self._xlstm_stack(params, x, rows)
        if cfg.family == "mla_moe":
            kd = cfg.moe.first_k_dense
            for i in range(kd):
                x = _tf_layer(_layer_params(params["dense_layers"], i), x,
                              cfg, attn(i))
            for i in range(cfg.n_layers - kd):
                x = _tf_layer(_layer_params(params["layers"], i), x, cfg,
                              attn(kd + i), "mla", capacity_factor)
            return x
        for i in range(cfg.n_layers):
            x = _tf_layer(_layer_params(params["layers"], i), x, cfg,
                          attn(i), cfg.family, capacity_factor)
        return x

    # ------------------------------------------------------------ enc-dec
    def _encode(self, params: PyTree, enc_embeds: torch.Tensor,
                dtype) -> torch.Tensor:
        """The encoder stack: ``_tf_layer`` over ``enc_layers`` with a
        non-causal attention hook (RoPE at the frame positions, as the
        reference), then the final norm.  ``enc_embeds`` ``(B, Se, d)``
        -> ``(B, Se, d)``."""
        cfg = self.cfg
        enc = enc_embeds.to(dtype)
        enc_pos = torch.arange(enc.shape[1], device=enc.device)

        def attn(ap, h):
            return L.attention_block(ap, h, enc_pos, cfg, causal=False)

        for i in range(cfg.enc_dec.n_encoder_layers):
            enc = _tf_layer(_layer_params(params["enc_layers"], i), enc, cfg,
                            attn)
        return L.rms_norm(enc, params["enc_final_norm"], cfg.norm_eps)

    def cross_kv(self, params: PyTree, enc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross K/V from the encoder output, ``(nd,
        B, Se, KV, D)`` each: one batched product over the stacked
        ``cross`` weights.  Computed once per request (it never grows)."""
        cfg = self.cfg
        b, se = enc.shape[0], enc.shape[1]
        cp = params["dec_layers"]["cross"]
        shape = (-1, b, se, cfg.n_kv_heads, cfg.head_dim)
        k = enc[None] @ cp["wk"].to(enc.dtype)[:, None]
        v = enc[None] @ cp["wv"].to(enc.dtype)[:, None]
        return k.reshape(shape), v.reshape(shape)

    def encode_cross(self, params: PyTree, batch: Dict[str, torch.Tensor],
                     dtype=torch.bfloat16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The encoder pass and every decoder layer's cross K/V: the paged
        engine's admission-time install for an enc-dec request."""
        return self.cross_kv(params,
                             self._encode(params, batch["enc_embeds"], dtype))

    def _cross_attn(self, cp: dict, x: torch.Tensor, q_pos: torch.Tensor,
                    k_pos: torch.Tensor, kv: Tuple[torch.Tensor, torch.Tensor],
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Cross-attention of ``x`` ``(B, S, d)`` over the encoder's
        pre-projected K/V (``kv``: ``cross_kv``'s rows, as the serving
        steps keep them), masked past ``kv_len`` (a scalar or one length a
        row).  No RoPE: the reference ropes no cross-attention.  (The
        reference's branch that projects K/V from the encoder output
        serves its training forward, which waits for the cohort slice.)"""
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ cp["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads,
                                                cfg.head_dim)
        k, v = kv
        out = L.attention_op(q, k.to(x.dtype), v.to(x.dtype), q_pos, k_pos,
                             cfg, causal=False, kv_len=kv_len)
        return out.reshape(b, s, -1) @ cp["wo"].to(x.dtype)

    def _cross_hook(self, state: PyTree, q_pos: torch.Tensor, rows: slice
                    ) -> Callable[[int], Callable]:
        """enc_dec's cross-attention hook for decoder layer ``i`` of a
        serving step: queries at ``q_pos`` against the ``rows`` (slots) of
        ``state["cross_k"/"cross_v"]``, each row masked to its own
        ``state["enc_len"]``."""
        ck, cv = state["cross_k"], state["cross_v"]
        enc_pos = torch.arange(ck.shape[2], device=ck.device)
        kv_len = state["enc_len"][rows]
        return lambda i: lambda cp, h: self._cross_attn(
            cp, h, q_pos, enc_pos, (ck[i, rows], cv[i, rows]), kv_len)

    # ------------------------------------------------------- paged decode
    def decode_step_paged(self, params: PyTree, cache: PyTree,
                          batch: Dict[str, torch.Tensor],
                          dtype=torch.bfloat16
                          ) -> Tuple[torch.Tensor, PyTree]:
        """One-token decode against the paged cache.

        ``cache`` is the pooled layout of ``serve.pages.init_paged_cache``:
        ``pool`` (``k``/``v``, each ``(L, P, T, KV, D)``; for mla_moe one
        ``lat`` of ``(L, P, T, 1, R + dr)``; none for xlstm),
        ``table`` (the ``(S, NP)`` int32 page table), ``pos`` (the
        per-slot position vector) and ``state`` (``Model.init_state``'s
        groups, the slot on axis 1; enc_dec's ``cross_k``/``cross_v``
        ``(nd, S, Se_max, KV, D)`` and ``enc_len`` ``(S,)``, read only).
        ``batch["tokens"]`` is ``(S, 1)``.
        Every row carries its own RoPE offset and length mask, so slots at
        different depths decode as one batch; empty slots (``pos == 0``,
        null table row) decode garbage the engine ignores.  MoE decode
        dispatches at ``CAPACITY_FACTOR`` (one token a row: dropless by
        construction).  The pool and the state are written in place;
        returns ``(logits (S, V), cache)`` with ``cache["pos"]`` advanced.
        """
        cfg = self.cfg
        pos, table = cache["pos"], cache["table"]
        kp, vp = cache["pool"].get("k"), cache["pool"].get("v")
        lat = cache["pool"].get("lat")
        x = L.embed_tokens(params, batch["tokens"], dtype)

        def attn(i):
            if lat is not None:
                return lambda ap, h: MLA.paged_mla_attention_block(
                    ap, h, pos, cfg, lat, i, table)
            return lambda ap, h: L.paged_attention_block(
                ap, h, pos, cfg, kp, vp, i, table)

        def rows(group, i):
            return {k: buf[i] for k, buf in cache["state"][group].items()}

        cross = (self._cross_hook(cache["state"], pos[:, None], slice(None))
                 if cfg.family == "enc_dec" else None)
        x = self._layers(params, x, attn, rows, CAPACITY_FACTOR, cross)
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        logits = L.lm_logits(params, x, cfg)
        return logits[:, -1], new_cache

    # ----------------------------------------------------- chunked prefill
    def prefill_chunk(self, params: PyTree, cache: PyTree,
                      batch: Dict[str, Any], dtype=torch.bfloat16
                      ) -> Tuple[torch.Tensor, PyTree]:
        """One prompt CHUNK of one slot against the paged cache.

        ``batch``: ``tokens`` (1, C), ``pos0`` -- the chunk's first
        absolute position -- and ``slot``.  K/V rows go straight into the
        slot's pool pages through its table row (in place).  Returns the
        chunk's last-token logits ``(1, V)`` (meaningful on the final
        chunk) and the cache.  Recurrent blocks start from the slot's
        state rows and leave the next chunk's there; enc_dec's
        cross-attention reads the slot's cross rows up to its
        ``enc_len``.  MoE dispatches dropless, so any chunking of a prompt
        gives the same tokens.
        """
        cfg = self.cfg
        slot, pos0 = int(batch["slot"]), int(batch["pos0"])
        kp, vp = cache["pool"].get("k"), cache["pool"].get("v")
        lat = cache["pool"].get("lat")
        x = L.embed_tokens(params, batch["tokens"], dtype)
        c = x.shape[1]
        positions = pos0 + torch.arange(c, device=x.device)
        table_row = cache["table"][slot]

        def attn(i):
            if lat is not None:
                return lambda ap, h: MLA.paged_mla_prefill_block(
                    ap, h, positions, cfg, lat, i, table_row)
            return lambda ap, h: L.paged_prefill_block(
                ap, h, positions, cfg, kp, vp, i, table_row)

        def rows(group, i):
            return {k: buf[i, slot:slot + 1]
                    for k, buf in cache["state"][group].items()}

        cross = (self._cross_hook(cache["state"], positions,
                                  slice(slot, slot + 1))
                 if cfg.family == "enc_dec" else None)
        x = self._layers(params, x, attn, rows, None, cross)
        logits = L.lm_logits(params, x[:, -1:], cfg)
        return logits[:, -1], dict(cache)


def _write_back(rows: dict, new: dict) -> None:
    """A block's new state into its cache rows (views), in place."""
    for k, buf in rows.items():
        buf.copy_(new[k])
