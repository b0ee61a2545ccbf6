"""Model assembly for the dense, vlm, moe, mla_moe, hybrid_ssm, xlstm and
enc_dec families (the port of the serving paths of
``repro.models.model``).

``Model`` declares the parameter tree (same paths and shapes as the JAX
package) and runs the serving steps of both engines:

  * the cohort engine's, over a contiguous cache (``init_cache``: the
    reference's layout, written in place, grown only by the engine):
    ``prefill`` (a batch of same-length prompts into a fresh cache) and
    ``decode_step`` (one token a row at the batch's one position);
  * the paged engine's, over the page pool (``serve.pages``) and the
    per-slot recurrent state (``init_state``, the state part of
    ``init_cache``): ``decode_step_paged`` (one token per slot at its own
    position) and ``prefill_chunk`` (one prompt chunk of one slot).

The transformer families run the one shared layer body ``_tf_layer`` with
a mode-specific attention hook -- the cached GQA or MLA block
(``_cached_attn``) over the layer's rows of a contiguous cache, or the
paged blocks over the pool; its FFN is SwiGLU, or ``moe_ffn`` for ``moe``
(Mixtral) and ``mla_moe``.  ``vlm`` (Qwen2-VL) is the dense tree whose
prompt may be precomputed ``embeds`` (its vision tower is a stub, as in
the reference) with M-RoPE at ``positions_3d``; only the cohort engine
serves it.  ``mla_moe`` (DeepSeek-V2) runs its ``first_k_dense`` leading
layers (``dense_layers``: MLA attention, SwiGLU at ``dense_d_ff``) and
then its MoE layers (``layers``) through the same body; in the pool they
are latent layers ``[0, kd)`` and ``kd + i``.  Layers run as a Python
loop over the stacked parameters; a layer's cache or state rows are views
of the stacked buffers, so its writes land in them (the reference's
``_cache_update``).  A contiguous cache keeps its counters on the host
(``len``, one a layer, and ``pos``), so a step never waits for the card.

``hybrid_ssm`` (Zamba2) is a stack of Mamba2 mixers with ONE weight-shared
attention block (``_tf_layer`` over ``shared_attn``) applied before each
group of ``attn_every`` mixers; application ``app`` owns attention layer
``app`` of the cache or pool, and each mixer owns its rows of ``mamba``
(conv and SSM state).  ``xlstm`` is token-free: periods of
``slstm_every - 1`` mLSTM blocks and one sLSTM block, whose states
(``mlstm``, ``slstm``) are its whole cache.

``enc_dec`` (Whisper) runs its bidirectional encoder once per request
(``_encode``: ``_tf_layer`` over ``enc_layers`` with a non-causal hook, the
final norm; ``cross_kv``: every decoder layer's cross K/V) and then
``_dec_layer`` over ``dec_layers``: cached or paged self-attention, then
cross-attention against the request's cross K/V (per-slot rows masked to
each slot's ``enc_len`` in the pool).

Training (``forward``, ``loss``) runs every family without a cache: the
same layer bodies with the attention hooks over no cache (attention within
the sequence, MLA in its expanded form), the Mamba2 mixers on the plain
``ssd_chunked`` (``plain_scan``) and the xLSTM blocks from their zero
state, MoE's load-balancing loss summed over the layers.  Each layer body
runs under ``_maybe_remat``: ``"none"``, ``"full"`` (recompute the whole
body in the backward) or ``"dots"`` (keep the unbatched weight products,
recompute the rest) -- ``torch.utils.checkpoint``'s counterparts of the
reference's ``jax.checkpoint`` policies.  No hand-written kernel is on the
training path, as no Pallas kernel is on the reference's.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.dist.sharding import (constrain, local_rows_heads,
                                       read_rows, split_heads, write_rows)
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as XL
from repro_torch.models.params import ParamSpec, count_params, init_params

PyTree = Any

#: Families this port can run.
FAMILIES = ("dense", "vlm", "moe", "mla_moe", "hybrid_ssm", "xlstm",
            "enc_dec")

#: The MoE capacity factor of the training forward and the decode steps
#: (the reference ``Model``'s default); prefills and prefill chunks
#: dispatch dropless.
CAPACITY_FACTOR = 1.25

#: ``Model.remat`` modes.
REMAT = ("none", "full", "dots")

#: The products the ``"dots"`` policy keeps: those without a batch
#: dimension (a weight against the flattened tokens), as
#: ``checkpoint_dots_with_no_batch_dims`` keeps them; the batched ones
#: (attention's, the experts') are recomputed.
_UNBATCHED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_unbatched_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _UNBATCHED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: The residual stream's logical axes (the reference's ``constrain``).
_RESIDUAL = ("batch", "seq", "embed")


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
              capacity_factor: Optional[float] = None,
              aux: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """ONE decoder-layer body for every mode: pre-norm attention +
    residual, pre-norm FFN + residual.  ``attn(lp["attn"], h)`` is the
    mode's attention hook (paged decode or chunked prefill, GQA or MLA,
    or attention within the sequence in training); ``kind`` picks the FFN:
    "moe" and "mla" route through ``moe_ffn`` at ``capacity_factor``, whose
    load-balancing loss is appended to ``aux`` when a list is given (the
    training forward) and dropped otherwise (serving has no loss); anything
    else is SwiGLU."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = constrain(x + attn(lp["attn"], h), _RESIDUAL)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if kind in ("moe", "mla"):
        f, a = MOE.moe_ffn(lp["moe"], h, cfg.moe, capacity_factor)
        if aux is not None:
            aux.append(a)
    else:
        f = L.swiglu_ffn(lp["ffn"], h)
    return constrain(x + f, _RESIDUAL)


def _cached_attn(cfg, attn_kind: str, q_pos: torch.Tensor,
                 cache: Optional[dict],
                 positions_3d: Optional[torch.Tensor] = None,
                 causal: bool = True) -> Callable:
    """Attention hook of the cohort modes and the encoder: the family's
    cache semantics (full KV, sliding-window ring, MLA latent) over one
    layer's rows of a contiguous cache (None: attention within the input),
    with batch-shared positions ``q_pos``.  ``attn_kind`` "mla" routes to
    the latent-attention block, anything else to the GQA block."""
    if attn_kind == "mla":
        return lambda ap, h: MLA.mla_attention(ap, h, q_pos, cfg, cache)
    return lambda ap, h: L.attention_block(ap, h, q_pos, cfg, cache,
                                           positions_3d, causal=causal)


def _dec_layer(lp: dict, x: torch.Tensor, cfg,
               self_attn: Callable[[dict, torch.Tensor], torch.Tensor],
               cross_attn: Callable[[dict, torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """The enc-dec decoder-layer body of every serving mode: pre-norm
    self-attention (``self_attn(lp["attn"], h)``: the cached or paged
    hook),
    pre-norm cross-attention (``cross_attn(lp["cross"], h)``) and pre-norm
    SwiGLU, each with a residual."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = constrain(x + self_attn(lp["attn"], h), _RESIDUAL)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = constrain(x + cross_attn(lp["cross"], h), _RESIDUAL)
    h = L.rms_norm(x, lp["ln3"], cfg.norm_eps)
    return constrain(x + L.swiglu_ffn(lp["ffn"], h), _RESIDUAL)


class Model:
    """The dense, VLM, MoE and MLA-MoE decoders, the Zamba2 hybrid, xLSTM
    and the Whisper encoder-decoder; see the module docstring."""

    #: The training forward's MoE capacity factor.
    capacity_factor = CAPACITY_FACTOR

    def __init__(self, cfg, remat: str = "full"):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"repro_torch serves families {FAMILIES}; "
                f"{cfg.arch!r} is {cfg.family!r}")
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}; got {remat!r}")
        self.cfg = cfg
        self.remat = remat

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

    def init(self, seed: int = 0, device=None, dtype=torch.float32,
             place=None) -> PyTree:
        return init_params(self.param_specs(), seed, resolve_device(device),
                           dtype, place)

    def n_params(self) -> int:
        """The parameter tree's element count (from the specs)."""
        return count_params(self.param_specs())

    # ------------------------------------------------------------ training
    def _maybe_remat(self, fn: Callable) -> Callable:
        """``fn`` under the model's remat mode: as is (``"none"``),
        recomputed whole in the backward (``"full"``), or recomputed but
        for its unbatched weight products (``"dots"``).  All three give the
        same numbers."""
        if self.remat == "none":
            return fn
        kw = dict(use_reentrant=False)
        if self.remat == "dots":
            kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _save_unbatched_dots)
        return lambda *args: checkpoint(fn, *args, **kw)

    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor],
                dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward over a batch of whole sequences: ``tokens``
        ``(B, S)`` (vlm: ``embeds`` ``(B, S, d)`` and ``positions_3d`` ``(3,
        B, S)``; enc_dec: ``enc_embeds`` too).  No cache: causal attention
        within the sequence, recurrent blocks from their zero state, MoE at
        ``capacity_factor``.  Returns ``(logits (B, S, V) in dtype, aux ()
        float32)``, ``aux`` the MoE load-balancing losses summed over the
        layers (zero for the other families)."""
        cfg = self.cfg
        fam = cfg.family
        if fam == "enc_dec":
            return self._forward_encdec(params, batch, dtype)
        x = constrain(self._embed_in(params, batch, dtype), _RESIDUAL)
        q_pos = torch.arange(x.shape[1], device=x.device)
        pos3d = batch.get("positions_3d")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        cf = self.capacity_factor

        def tf_body(kind: str, attn_kind: str):
            hook = _cached_attn(cfg, attn_kind, q_pos, None, pos3d)

            def body(lp, x):
                acc: List[torch.Tensor] = []
                y = _tf_layer(lp, x, cfg, hook, kind, cf, acc)
                return y, (acc[0] if acc else torch.zeros_like(aux))
            return self._maybe_remat(body)

        def run(body, stack, n, x, aux):
            for i in range(n):
                x, a = body(_layer_params(stack, i), x)
                aux = aux + a
            return x, aux

        if fam in ("dense", "vlm", "moe"):
            x, aux = run(tf_body(fam, "dense"), params["layers"],
                         cfg.n_layers, x, aux)
        elif fam == "mla_moe":
            kd = cfg.moe.first_k_dense
            if kd:
                x, aux = run(tf_body("dense", "mla"), params["dense_layers"],
                             kd, x, aux)
            x, aux = run(tf_body("mla", "mla"), params["layers"],
                         cfg.n_layers - kd, x, aux)
        elif fam == "hybrid_ssm":
            x = self._hybrid_train(params, x, q_pos)
        else:
            x = self._xlstm_train(params, x)
        logits = constrain(L.lm_logits(params, x, cfg),
                           ("batch", "seq", "vocab"))
        return logits, aux

    def _hybrid_train(self, params: PyTree, x: torch.Tensor,
                      q_pos: torch.Tensor) -> torch.Tensor:
        """Zamba2's stack without a cache: the shared block before each
        group of ``attn_every`` mixers, each mixer on ``ssd_chunked``."""
        cfg = self.cfg
        per = cfg.ssm.attn_every or cfg.n_layers
        hook = _cached_attn(cfg, "dense", q_pos, None)
        attn_body = self._maybe_remat(
            lambda ap, x: _tf_layer(ap, x, cfg, hook))
        mam_body = self._maybe_remat(
            lambda lp, x: M2.mamba2_block(lp, x, cfg, plain_scan=True)[0])
        for start in range(0, cfg.n_layers, per):
            if cfg.ssm.attn_every:
                x = attn_body(params["shared_attn"], x)
            for i in range(start, min(start + per, cfg.n_layers)):
                x = mam_body(_layer_params(params["mamba_layers"], i), x)
        return x

    def _xlstm_train(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        """xLSTM's stack without a cache: each pre-norm block from its zero
        state, the mLSTM chunkwise at the reference's chunk."""
        cfg = self.cfg
        per = cfg.xlstm.slstm_every
        m_per = per - 1
        chunk = min(cfg.ssm.chunk if cfg.ssm else 256, max(16, x.shape[1]))

        def m_body(lp, ln, x):
            h = L.rms_norm(x, ln, cfg.norm_eps)
            return x + XL.mlstm_block(lp, h, cfg, None, chunk)[0]

        def s_body(lp, ln, x):
            h = L.rms_norm(x, ln, cfg.norm_eps)
            return x + XL.slstm_block(lp, h, cfg)[0]
        m_body, s_body = self._maybe_remat(m_body), self._maybe_remat(s_body)
        for p in range(cfg.n_layers // per):
            for i in range(p * m_per, (p + 1) * m_per):
                x = m_body(_layer_params(params["mlstm_layers"], i),
                           params["mlstm_ln"][i], x)
            x = s_body(_layer_params(params["slstm_layers"], p),
                       params["slstm_ln"][p], x)
        return x

    def _forward_encdec(self, params: PyTree, batch: Dict[str, torch.Tensor],
                        dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """Whisper's training forward: the encoder over ``enc_embeds``,
        then each decoder layer with causal self-attention and
        cross-attention against K/V projected from the encoder output."""
        cfg = self.cfg
        enc = self._encode(params, batch["enc_embeds"], dtype,
                           self._maybe_remat)
        enc_pos = torch.arange(enc.shape[1], device=enc.device)
        x = L.embed_tokens(params, batch["tokens"], dtype)
        dec_pos = torch.arange(x.shape[1], device=x.device)
        self_attn = _cached_attn(cfg, "dense", dec_pos, None)

        def cross(cp, h):
            k, v = L.fused_column_matmul(enc, (cp["wk"].to(h.dtype),
                                               cp["wv"].to(h.dtype)))
            return self._cross_attn(cp, h, dec_pos, enc_pos, (
                split_heads(k, cfg.n_kv_heads, cfg.head_dim, "kv_heads"),
                split_heads(v, cfg.n_kv_heads, cfg.head_dim, "kv_heads")))
        body = self._maybe_remat(
            lambda lp, x: _dec_layer(lp, x, cfg, self_attn, cross))
        for i in range(cfg.enc_dec.n_decoder_layers):
            x = body(_layer_params(params["dec_layers"], i), x)
        return (L.lm_logits(params, x, cfg),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor],
             dtype=torch.bfloat16
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(nll + aux, {"nll", "aux"})``: ``cross_entropy_loss`` (with
        its z-loss) of the forward's logits against ``batch["labels"]``,
        plus the MoE load-balancing loss."""
        logits, aux = self.forward(params, batch, dtype)
        nll = L.cross_entropy_loss(logits, batch["labels"])
        return nll + aux, {"nll": nll, "aux": aux}

    def _embed_in(self, params: PyTree, batch: Dict[str, Any],
                  dtype) -> torch.Tensor:
        """The prompt's rows: its precomputed ``embeds`` where the family
        takes them (``cfg.input_embeds``: vlm) and they are given, else
        the embedded ``tokens``."""
        if self.cfg.input_embeds and "embeds" in batch:
            return batch["embeds"].to(dtype)
        return L.embed_tokens(params, batch["tokens"], dtype)

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

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   enc_len: int = 0, device=None) -> PyTree:
        """The cohort engine's contiguous cache of ``batch`` rows, as the
        reference's ``init_cache`` lays it out (layer-stacked, the batch on
        axis 1, the sequence on axis 2):

          * dense, vlm, moe: ``layers`` ``{k, v: (L, B, W, KV, D)}`` with
            ``W = min(max_len, window)`` under a sliding window (a ring),
            else ``max_len``;
          * mla_moe: ``layers`` (and ``dense_layers`` for the leading dense
            ones) ``{ckv: (n, B, max_len, R), krope: (n, B, max_len, dr)}``;
          * hybrid_ssm: ``init_state``'s ``mamba`` and, with the shared
            block, ``attn`` ``{k, v}`` with one layer per application;
          * xlstm: ``init_state``'s ``mlstm`` and ``slstm``;
          * enc_dec: ``layers`` for the decoder's self-attention and
            ``cross_k``/``cross_v`` ``(nd, B, enc_len, KV, D)``.

        Every KV stack also holds ``len``, its layers' filled lengths, and
        the cache ``pos``, the batch's position: host counters (an int32
        CPU tensor of one entry a layer, and an int) that the steps
        advance.  KV buffers are zeros in ``dtype`` on ``device``."""
        cfg = self.cfg
        fam = cfg.family
        device = resolve_device(device)
        kv, hd = cfg.n_kv_heads, cfg.head_dim
        window = cfg.sliding_window
        s_kv = min(max_len, window) if window else max_len

        def stack(n: int, **rows) -> dict:
            out = {name: torch.zeros((n, batch) + shape, dtype=dtype,
                                     device=device)
                   for name, shape in rows.items()}
            out["len"] = torch.zeros((n,), dtype=torch.int32)
            return out

        cache = self.init_state(batch, dtype, device)
        if fam in ("dense", "vlm", "moe"):
            cache["layers"] = stack(cfg.n_layers, k=(s_kv, kv, hd),
                                    v=(s_kv, kv, hd))
        elif fam == "mla_moe":
            m, kd = cfg.mla, cfg.moe.first_k_dense
            lat = dict(ckv=(max_len, m.kv_lora_rank),
                       krope=(max_len, m.rope_head_dim))
            cache["layers"] = stack(cfg.n_layers - kd, **lat)
            if kd:
                cache["dense_layers"] = stack(kd, **lat)
        elif fam == "hybrid_ssm":
            s = cfg.ssm
            n_apps = -(-cfg.n_layers // s.attn_every) if s.attn_every else 0
            if n_apps:
                cache["attn"] = stack(n_apps, k=(max_len, kv, hd),
                                      v=(max_len, kv, hd))
        elif fam == "enc_dec":
            nd = cfg.enc_dec.n_decoder_layers
            cache["layers"] = stack(nd, k=(s_kv, kv, hd), v=(s_kv, kv, hd))
            cache["cross_k"] = torch.zeros((nd, batch, enc_len, kv, hd),
                                           dtype=dtype, device=device)
            cache["cross_v"] = torch.zeros_like(cache["cross_k"])
        cache["pos"] = 0
        return cache

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
                dtype, wrap: Callable = lambda fn: fn) -> torch.Tensor:
        """The encoder stack: ``_tf_layer`` over ``enc_layers`` with a
        non-causal attention hook (RoPE at the frame positions, as the
        reference), each layer under ``wrap`` (the training forward's
        remat), then the final norm.  ``enc_embeds`` ``(B, Se, d)`` ->
        ``(B, Se, d)``."""
        cfg = self.cfg
        enc = enc_embeds.to(dtype)
        enc_pos = torch.arange(enc.shape[1], device=enc.device)
        attn = _cached_attn(cfg, "dense", enc_pos, None, causal=False)
        body = wrap(lambda lp, x: _tf_layer(lp, x, cfg, attn))
        for i in range(cfg.enc_dec.n_encoder_layers):
            enc = body(_layer_params(params["enc_layers"], i), enc)
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
        wk, wv = cp["wk"].to(enc.dtype), cp["wv"].to(enc.dtype)

        def project(enc, wk, wv):
            return enc[None] @ wk[:, None], enc[None] @ wv[:, None]

        if isinstance(enc, DTensor):
            # On a mesh each rank projects its own rows onto its KV heads'
            # columns (where the heads divide the axis: the result is then
            # viewed as heads): DTensor's batched product of the flattened
            # (layers, batch) dims refuses the strided shard it makes.
            mesh = enc.device_mesh
            k, v = local_rows_heads(
                project, [(enc, 0, None), (wk, None, 2), (wv, None, 2)],
                [(1, 3), (1, 3)],
                tuple("row" if isinstance(p, Shard) and p.dim == 0
                      else "head" if isinstance(q, Shard) and q.dim == 2
                      and cfg.n_kv_heads % mesh.size(i) == 0 else None
                      for i, (p, q) in enumerate(zip(enc.placements,
                                                     wk.placements))))
        else:
            k, v = project(enc, wk, wv)
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
        training forward projects ``kv`` from the encoder output, as the
        reference's branch without ``kv`` does.)"""
        cfg = self.cfg
        b, s, _ = x.shape
        q = split_heads(L.tp_matmul(x, cp["wq"].to(x.dtype), "column"),
                        cfg.n_heads, cfg.head_dim, "heads")
        k, v = kv
        out = L.attention_op(q, k.to(x.dtype), v.to(x.dtype), q_pos, k_pos,
                             cfg, causal=False, kv_len=kv_len)
        return L.tp_matmul(out.reshape(b, s, -1), cp["wo"].to(x.dtype), "row")

    def _cross_hook(self, ck: torch.Tensor, cv: torch.Tensor,
                    q_pos: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None
                    ) -> Callable[[int], Callable]:
        """enc_dec's cross-attention hook for decoder layer ``i`` of a
        serving step: queries at ``q_pos`` against layer ``i`` of the
        cross K/V ``ck``, ``cv`` ``(nd, B, Se, KV, D)``, masked past
        ``kv_len`` (one encoder length a row in the pool; None in a cohort,
        whose rows share one)."""
        enc_pos = torch.arange(ck.shape[2], device=ck.device)
        return lambda i: lambda cp, h: self._cross_attn(
            cp, h, q_pos, enc_pos, (ck[i], cv[i]), kv_len)

    def _cohort_hooks(self, cache: PyTree, q_pos: torch.Tensor,
                      positions_3d: Optional[torch.Tensor] = None):
        """``(attn, rows, cross)`` for ``_layers`` over a contiguous cache:
        ``attn(i)`` the cached hook over attention layer ``i``'s rows (for
        mla_moe, ``dense_layers`` below ``first_k_dense``, then
        ``layers``; for hybrid_ssm, ``attn``), ``rows(group, i)`` block
        ``i``'s state rows, ``cross`` enc_dec's cross hook."""
        cfg = self.cfg
        fam = cfg.family

        def attn(i: int) -> Callable:
            if fam == "mla_moe":
                kd = cfg.moe.first_k_dense
                c = (_layer_params(cache["dense_layers"], i) if i < kd
                     else _layer_params(cache["layers"], i - kd))
                return _cached_attn(cfg, "mla", q_pos, c)
            stack = cache["attn"] if fam == "hybrid_ssm" else cache["layers"]
            return _cached_attn(cfg, "dense", q_pos,
                                _layer_params(stack, i), positions_3d)

        def rows(group: str, i: int) -> dict:
            return {k: buf[i] for k, buf in cache[group].items()}

        cross = (self._cross_hook(cache["cross_k"], cache["cross_v"], q_pos)
                 if fam == "enc_dec" else None)
        return attn, rows, cross

    # ------------------------------------------------------- cohort steps
    def prefill(self, params: PyTree, batch: Dict[str, Any], max_len: int,
                dtype=torch.bfloat16, place: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, PyTree]:
        """A batch of same-length prompts into a fresh contiguous cache of
        ``max_len`` tokens: ``batch`` holds ``tokens`` ``(B, S)`` (vlm:
        or ``embeds`` ``(B, S, d)``, with ``positions_3d`` ``(3, B, S)``
        for M-RoPE; enc_dec: ``enc_embeds`` ``(B, Se, d)`` and the decoder
        prompt's ``tokens``).  MoE dispatches dropless.  ``place`` puts the
        fresh cache on the serving mesh (``serve.steps``).  Returns the
        last-token logits ``(B, V)`` and the cache, at ``pos`` S."""
        cfg = self.cfg
        place = place or (lambda c: c)
        if cfg.family == "enc_dec":
            return self._prefill_encdec(params, batch, max_len, dtype, place)
        x = constrain(self._embed_in(params, batch, dtype), _RESIDUAL)
        b, s = x.shape[:2]
        cache = place(self.init_cache(b, max_len, dtype, device=x.device))
        q_pos = torch.arange(s, device=x.device)
        attn, rows, _ = self._cohort_hooks(cache, q_pos,
                                           batch.get("positions_3d"))
        x = self._layers(params, x, attn, rows, None)
        cache["pos"] = s
        logits = L.lm_logits(params, x[:, -1:], cfg)
        return logits[:, -1], cache

    def _prefill_encdec(self, params: PyTree, batch: Dict[str, Any],
                        max_len: int, dtype, place: Callable
                        ) -> Tuple[torch.Tensor, PyTree]:
        """enc_dec's prefill: the encoder over ``enc_embeds``, the cross
        K/V into the cache, then the decoder over the prompt ``tokens``."""
        enc = self._encode(params, batch["enc_embeds"], dtype)
        b, se = enc.shape[:2]
        cache = self.init_cache(b, max_len, dtype, enc_len=se,
                                device=enc.device)
        ck, cv = self.cross_kv(params, enc)
        cache["cross_k"], cache["cross_v"] = ck.to(dtype), cv.to(dtype)
        cache = place(cache)
        x = L.embed_tokens(params, batch["tokens"], dtype)
        sd = x.shape[1]
        attn, rows, cross = self._cohort_hooks(
            cache, torch.arange(sd, device=x.device))
        x = self._layers(params, x, attn, rows, None, cross)
        cache["pos"] = sd
        logits = L.lm_logits(params, x[:, -1:], self.cfg)
        return logits[:, -1], cache

    def decode_step(self, params: PyTree, cache: PyTree,
                    batch: Dict[str, Any], dtype=torch.bfloat16
                    ) -> Tuple[torch.Tensor, PyTree]:
        """One token a row at the cache's position ``pos``:
        ``batch["tokens"]`` ``(B, 1)`` (vlm: and ``positions_3d`` ``(3, B,
        1)``).  Every layer writes its K/V (or latent, or state) into the
        cache in place; MoE dispatches at ``CAPACITY_FACTOR``.  Returns
        ``(logits (B, V), cache)`` with ``pos`` advanced."""
        x = constrain(self._embed_in(params, batch, dtype),
                      ("batch", None, "embed"))
        pos = int(cache["pos"])
        q_pos = torch.arange(pos, pos + 1, device=x.device)
        attn, rows, cross = self._cohort_hooks(cache, q_pos,
                                               batch.get("positions_3d"))
        x = self._layers(params, x, attn, rows, CAPACITY_FACTOR, cross)
        cache["pos"] = pos + 1
        logits = L.lm_logits(params, x, self.cfg)
        return logits[:, -1], cache

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
        x = constrain(L.embed_tokens(params, batch["tokens"], dtype),
                      ("batch", None, "embed"))

        def attn(i):
            if lat is not None:
                return lambda ap, h: MLA.paged_mla_attention_block(
                    ap, h, pos, cfg, lat, i, table)
            return lambda ap, h: L.paged_attention_block(
                ap, h, pos, cfg, kp, vp, i, table)

        def rows(group, i):
            return {k: buf[i] for k, buf in cache["state"][group].items()}

        st = cache["state"]
        cross = (self._cross_hook(st["cross_k"], st["cross_v"], pos[:, None],
                                  st["enc_len"])
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
        x = constrain(L.embed_tokens(params, batch["tokens"], dtype),
                      _RESIDUAL)
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
            bufs = {k: buf[i] for k, buf in cache["state"][group].items()}
            if not any(isinstance(b, DTensor) for b in bufs.values()):
                return {k: b[slot:slot + 1] for k, b in bufs.items()}
            # On a mesh the slot axis may shard over the data axes: the
            # slot's rows are read off the local shards and written back
            # through them.
            return _SlotRows({k: read_rows(b, 0, [slot])
                              for k, b in bufs.items()}, bufs, slot)

        st, one = cache["state"], slice(slot, slot + 1)
        cross = (self._cross_hook(st["cross_k"][:, one], st["cross_v"][:, one],
                                  positions, st["enc_len"][one])
                 if cfg.family == "enc_dec" else None)
        x = self._layers(params, x, attn, rows, None, cross)
        logits = L.lm_logits(params, x[:, -1:], cfg)
        return logits[:, -1], dict(cache)


class _SlotRows(dict):
    """One slot's state rows read off mesh-sharded buffers (copies, not
    views): ``_write_back`` writes a block's new state into the buffers
    through their local shards (``dist.sharding.write_rows``)."""

    def __init__(self, rows: dict, bufs: dict, slot: int):
        super().__init__(rows)
        self.bufs, self.slot = bufs, slot


def _write_back(rows: dict, new: dict) -> None:
    """A block's new state into its cache rows (views), in place."""
    if isinstance(rows, _SlotRows):
        for k, buf in rows.bufs.items():
            write_rows(buf, 0, [rows.slot], new[k])
        return
    for k, buf in rows.items():
        buf.copy_(new[k])
