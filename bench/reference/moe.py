"""Plain reference of the ``moe`` family (Mixtral, arXiv:2401.04088), read
from the configuration's own keys.

Each layer: RMSNorm, grouped-query attention (``num_attention_heads``
queries over ``num_key_value_heads`` keys and values of ``head_dim``,
rotary at ``rope_theta``, causal, within ``sliding_window`` when it is
set), a residual; RMSNorm, the sparse experts (softmax over the top
``num_experts_per_tok`` of ``num_local_experts`` router logits, each
chosen expert's SwiGLU weighted by its gate), a residual.  A final RMSNorm
and the head.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from bench.reference import common as C


def _head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["assumed"]["head_dim"]


def _attention(aw: dict, x: torch.Tensor, lens: List[int], cfg: dict,
               precision: str) -> torch.Tensor:
    h, g, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        _head_dim(cfg)
    q = C.linear(x, aw["wq"], precision).reshape(-1, h, dh)
    k = C.linear(x, aw["wk"], precision).reshape(-1, g, dh)
    v = C.linear(x, aw["wv"], precision).reshape(-1, g, dh)
    outs, lo = [], 0
    for n in lens:
        rows = slice(lo, lo + n)
        outs.append(C.causal_attention(
            C.rope(q[rows], cfg["rope_theta"]),
            C.rope(k[rows], cfg["rope_theta"]), v[rows],
            1.0 / math.sqrt(dh), cfg["sliding_window"] or 0))
        lo += n
    return C.linear(torch.cat(outs).reshape(-1, h * dh), aw["wo"], precision)


def final_hidden(weights: dict, cfg: dict, seqs: List[torch.Tensor],
                 precision: str = "f32") -> List[torch.Tensor]:
    """Each sequence's hidden states after the final norm, ``(S, d)``
    float32, from the token ids ``seqs`` (each ``(S,)`` on the weights'
    device), the sequences run together layer by layer."""
    C.exact_float32()
    eps = cfg["rms_norm_eps"]
    lens = [int(s.numel()) for s in seqs]
    x = C.embed(weights, torch.cat(seqs))
    for i in range(cfg["num_hidden_layers"]):
        lw = C.layer(weights["layers"], i)
        x = x + _attention(lw["attn"], C.rms_norm(x, lw["ln1"], eps), lens,
                           cfg, precision)
        x = x + C.routed_experts(C.rms_norm(x, lw["ln2"], eps), lw["moe"],
                                 cfg["num_experts_per_tok"], True, 1.0,
                                 precision)
    x = C.rms_norm(x, weights["final_norm"], eps)
    return list(torch.split(x, lens))


def head(weights: dict, cfg: dict) -> torch.Tensor:
    """The output head ``(d, vocab_size)`` (the weights' own dtype)."""
    return weights["lm_head"][:, :cfg["vocab_size"]]


def arithmetic(cfg: dict) -> Dict[str, float]:
    """As ``mla_moe.arithmetic``: ``token`` (2 x the attention projections,
    router and top-k experts' parameters of all layers), ``head`` and
    ``context`` (score and value products a key, all layers)."""
    d, h, g, dh = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"], _head_dim(cfg)
    nl = cfg["num_hidden_layers"]
    attn = 2 * d * h * dh + 2 * d * g * dh
    moe = d * cfg["num_local_experts"] + 3 * d * cfg["intermediate_size"] \
        * cfg["num_experts_per_tok"]
    return {"token": 2.0 * nl * (attn + moe),
            "head": 2.0 * d * cfg["vocab_size"],
            "context": 2.0 * nl * h * 2 * dh}
