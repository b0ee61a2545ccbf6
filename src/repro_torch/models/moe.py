"""Mixture-of-Experts FFN with capacity-based scatter dispatch (the port of
``repro.models.moe``).

Routing is the reference's: router logits in the compute dtype, a float32
softmax, top-k, renormalised in float32 and cast back (Mixtral/DeepSeek
style), and the load-balancing auxiliary loss.  Dispatch scatters each
routed token into its expert's ``(B, E, cap, d)`` buffer at the exclusive
cumulative count of that expert over the row's flattened ``(S, K)``
stream, runs the expert SwiGLUs with the experts as a batch dimension,
and gathers the outputs back weighted by the kept gates.

The JAX scatter drops out-of-range slots (``mode="drop"``) and its gather
clamps them; torch's indexing would raise (on the card, a device assert).
So every slot index is clamped to ``cap - 1`` and a dropped slot carries a
zero weight both ways: it adds zero to the buffer and takes nothing back.
Nothing in the dispatch reads a value on the host (no ``.item()``, no
``nonzero``), so the step never waits for the card.

The expert products are ``torch.einsum``, as the reference's are jnp
``einsum`` outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import active_rule, constrain
from repro_torch.models.params import ParamSpec


def moe_param_specs(cfg, layers: int = 0) -> dict:
    mo = cfg.moe
    d = cfg.d_model
    f = mo.d_ff_expert or cfg.d_ff
    ls = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    out_scale = 1.0 / math.sqrt(2 * max(1, cfg.n_layers))
    specs = {
        "router": ParamSpec(ls + (d, mo.n_experts), la + ("embed", None)),
        "wi": ParamSpec(ls + (mo.n_experts, d, f),
                        la + ("experts", "embed", "mlp_expert")),
        "wg": ParamSpec(ls + (mo.n_experts, d, f),
                        la + ("experts", "embed", "mlp_expert")),
        "wo": ParamSpec(ls + (mo.n_experts, f, d),
                        la + ("experts", "mlp_expert", "embed"),
                        scale=out_scale),
    }
    if mo.n_shared_experts:
        fs = f * mo.n_shared_experts
        specs["shared_wi"] = ParamSpec(ls + (d, fs), la + ("embed", "mlp"))
        specs["shared_wg"] = ParamSpec(ls + (d, fs), la + ("embed", "mlp"))
        specs["shared_wo"] = ParamSpec(ls + (fs, d), la + ("mlp", "embed"),
                                       scale=out_scale)
    return specs


def moe_ffn(
    params: dict,
    x: torch.Tensor,              # (B, S, d)
    moe,
    capacity_factor: Optional[float] = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output (B, S, d), aux_loss ())``.

    ``capacity_factor=None`` dispatches dropless (``cap = s``: an expert
    appears at most once in a token's top-k), which chunked prefill uses
    so that any chunking of a prompt gives the same tokens; otherwise
    ``cap = max(1, ceil(s * k * capacity_factor / e))`` per batch row and
    slots at or past ``cap`` are dropped.
    """
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    cap = s if capacity_factor is None else \
        max(1, math.ceil(s * k * capacity_factor / e))

    logits = x @ params["router"].float().to(x.dtype)           # (B, S, E)
    gates = torch.softmax(logits.float(), dim=-1)               # f32
    top_v, top_i = torch.topk(gates, k, dim=-1)                 # (B, S, K)
    top_v = (top_v / top_v.sum(-1, keepdim=True).clamp_min(1e-9)
             ).to(x.dtype)

    # Each (token, k) slot's place in its expert's buffer: the exclusive
    # cumulative count over the row's flattened (S, K) stream.
    onehot = F.one_hot(top_i, e)                                # (B, S, K, E)
    flat = onehot.reshape(b, s * k, e)
    pos_in_e = flat.cumsum(dim=1) - 1
    pos_tok = (pos_in_e * flat).sum(-1).reshape(b, s, k)
    keep = pos_tok < cap
    slot = pos_tok.clamp(max=cap - 1)        # dropped slots: weight 0 below

    buf = x.new_zeros((b, e, cap, d))
    b_idx = torch.arange(b, device=x.device)[:, None].expand(b, s)
    for kk in range(k):
        w = keep[:, :, kk].to(x.dtype)[..., None]
        buf.index_put_((b_idx, top_i[:, :, kk], slot[:, :, kk]), x * w,
                       accumulate=True)

    # Tensor-parallel experts (the expert count does not fill the model
    # axis): pin the dispatch buffers and the expert hidden activations, as
    # the reference does; under expert parallelism it constrains nothing.
    tp_experts = active_rule("experts") is None
    if tp_experts:
        buf = constrain(buf, ("batch", "experts", None, None))
    h = F.silu(torch.einsum("becd,edf->becf", buf,
                            params["wg"].to(x.dtype)))
    h = h * torch.einsum("becd,edf->becf", buf, params["wi"].to(x.dtype))
    if tp_experts:
        h = constrain(h, ("batch", "experts", None, "mlp"))
    out_buf = torch.einsum("becf,efd->becd", h, params["wo"].to(x.dtype))
    if tp_experts:
        out_buf = constrain(out_buf, ("batch", "experts", None, None))

    y = torch.zeros_like(x)
    for kk in range(k):
        gathered = out_buf[b_idx, top_i[:, :, kk], slot[:, :, kk]]
        w = (top_v[:, :, kk] * keep[:, :, kk].to(x.dtype))[..., None]
        y = y + gathered * w

    if "shared_wi" in params:
        hs = F.silu(x @ params["shared_wg"].to(x.dtype)) * (
            x @ params["shared_wi"].to(x.dtype))
        y = y + hs @ params["shared_wo"].to(x.dtype)

    # Load-balancing aux loss (Switch/GShard): E * sum_e f_e * p_e.
    me = gates.mean(dim=(0, 1))                                 # (E,)
    ce = onehot.float().sum(2).mean(dim=(0, 1))                 # (E,)
    aux = moe.router_aux_weight * e * (me * ce).sum()
    return y, aux
