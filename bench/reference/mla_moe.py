"""Plain reference of the ``mla_moe`` family (DeepSeek-V2,
arXiv:2405.04434), read from the configuration's own keys.

Each layer: RMSNorm, multi-head latent attention in its expanded form (the
query through its low-rank ``q_lora_rank`` projection and norm; keys and
values up-projected from the ``kv_lora_rank`` latent, one shared rope key
of ``qk_rope_head_dim``), a residual; RMSNorm, then a SwiGLU of
``intermediate_size`` in the first ``first_k_dense_replace`` layers and in
the rest the routed experts (softmax gates, top ``num_experts_per_tok``,
``norm_topk_prob``, times ``routed_scaling_factor``) plus
``n_shared_experts`` shared ones, a residual.  A final RMSNorm and the
head.  Only the configuration's choices that the cells run are written:
``topk_method`` "greedy", and no ``rope_scaling`` unless ``reduced`` lists
it (the file then keeps the published group, which the cells do not
apply); any other value raises.
The rope dims rotate by halves (the source interleaves them: a fixed
permutation of seeded random weights).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from bench.reference import common as C


def _check(cfg: dict) -> None:
    scaled = cfg.get("rope_scaling") and "rope_scaling" not in cfg["reduced"]
    if cfg["topk_method"] != "greedy" or scaled:
        raise NotImplementedError(
            "the reference routes greedily and ropes without scaling")
    if cfg["scoring_func"] != "softmax" or cfg["moe_layer_freq"] != 1:
        raise NotImplementedError("softmax gates on every layer only")


def _attention(aw: dict, x: torch.Tensor, lens: List[int], cfg: dict,
               precision: str) -> torch.Tensor:
    h = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    eps = cfg["rms_norm_eps"]
    cq = C.rms_norm(C.linear(x, aw["wq_a"], precision), aw["q_norm"], eps)
    q = C.linear(cq, aw["wq_b"].reshape(cfg["q_lora_rank"], -1),
                 precision).reshape(-1, h, dn + dr)
    kv = C.linear(x, aw["wkv_a"], precision)
    ckv = C.rms_norm(kv[:, :r], aw["kv_norm"], eps)
    k_nope = C.linear(ckv, aw["wk_b"].reshape(r, -1), precision
                      ).reshape(-1, h, dn)
    v = C.linear(ckv, aw["wv_b"].reshape(r, -1), precision).reshape(-1, h, dv)
    outs, lo = [], 0
    for n in lens:
        rows = slice(lo, lo + n)
        q_s = torch.cat([q[rows, :, :dn],
                         C.rope(q[rows, :, dn:], cfg["rope_theta"])], -1)
        k_pe = C.rope(kv[rows, r:], cfg["rope_theta"])
        k_s = torch.cat([k_nope[rows], k_pe[:, None].expand(n, h, dr)], -1)
        outs.append(C.causal_attention(q_s, k_s, v[rows],
                                       1.0 / math.sqrt(dn + dr)))
        lo += n
    out = torch.cat(outs).reshape(-1, h * dv)
    return C.linear(out, aw["wo"].reshape(h * dv, -1), precision)


def final_hidden(weights: dict, cfg: dict, seqs: List[torch.Tensor],
                 precision: str = "f32") -> List[torch.Tensor]:
    """Each sequence's hidden states after the final norm, ``(S, d)``
    float32, from the token ids ``seqs`` (each ``(S,)`` on the weights'
    device), the sequences run together layer by layer."""
    _check(cfg)
    C.exact_float32()
    eps = cfg["rms_norm_eps"]
    lens = [int(s.numel()) for s in seqs]
    x = C.embed(weights, torch.cat(seqs))
    kd = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        dense = i < kd
        lw = C.layer(weights["dense_layers"] if dense else weights["layers"],
                     i if dense else i - kd)
        x = x + _attention(lw["attn"], C.rms_norm(x, lw["ln1"], eps), lens,
                           cfg, precision)
        hn = C.rms_norm(x, lw["ln2"], eps)
        if dense:
            f = lw["ffn"]
            x = x + C.swiglu(hn, f["wg"], f["wi"], f["wo"], precision)
            continue
        m = lw["moe"]
        y = C.routed_experts(hn, m, cfg["num_experts_per_tok"],
                             cfg["norm_topk_prob"],
                             cfg["routed_scaling_factor"], precision)
        if cfg["n_shared_experts"]:
            y = y + C.swiglu(hn, m["shared_wg"], m["shared_wi"],
                             m["shared_wo"], precision)
        x = x + y
    x = C.rms_norm(x, weights["final_norm"], eps)
    return list(torch.split(x, lens))


def head(weights: dict, cfg: dict) -> torch.Tensor:
    """The output head ``(d, vocab_size)`` (the weights' own dtype)."""
    return weights["lm_head"][:, :cfg["vocab_size"]]


def arithmetic(cfg: dict) -> Dict[str, float]:
    """Operations of the model's own form, for its FLOP count: ``token``,
    2 x the parameters one token multiplies through all layers (its
    attention projections, the dense FFN or the router with the top-k
    routed and the shared experts); ``head``, 2 x the head's; ``context``,
    the score and value products a token spends on each key it attends to,
    over all layers."""
    d, h, nl = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_hidden_layers"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    r, rq = cfg["kv_lora_rank"], cfg["q_lora_rank"]
    attn = (d * rq + rq * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
            + h * dv * d)
    kd = cfg["first_k_dense_replace"]
    dense = 3 * d * cfg["intermediate_size"]
    moe = d * cfg["n_routed_experts"] + 3 * d * cfg["moe_intermediate_size"] \
        * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
    per_token = nl * attn + kd * dense + (nl - kd) * moe
    return {"token": 2.0 * per_token,
            "head": 2.0 * d * cfg["vocab_size"],
            "context": 2.0 * nl * h * (dn + dr + dv)}
