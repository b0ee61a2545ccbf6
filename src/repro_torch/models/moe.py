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
from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.dist.sharding import (active_rule, constrain, local_rows_heads,
                                       rows_heads_roles)
from repro_torch.models.layers import swiglu_ffn
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


def _route(x: torch.Tensor, router: torch.Tensor, e: int, k: int,
           cap: int) -> tuple:
    """Router, top-k and dispatch of the rows of ``x`` ``(B, S, d)``:
    ``(buf (B, E, cap, d), top_i, top_v, keep, slot (B, S, K), gates (B, S,
    E) f32, counts (B, S, E))`` -- each (token, k) slot placed in its
    expert's buffer at the exclusive cumulative count over the row's
    flattened (S, K) stream, slots at or past ``cap`` dropped."""
    b, s, d = x.shape
    logits = x @ router                                         # (B, S, E)
    gates = torch.softmax(logits.float(), dim=-1)               # f32
    top_v, top_i = torch.topk(gates, k, dim=-1)                 # (B, S, K)
    top_v = (top_v / top_v.sum(-1, keepdim=True).clamp_min(1e-9)
             ).to(x.dtype)
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
    return buf, top_i, top_v, keep, slot, gates, onehot.float().sum(2)


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their dispatch buffers ``(B, E, C, d)``."""
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg))
    h = h * torch.einsum("becd,edf->becf", buf, wi)
    return torch.einsum("becf,efd->becd", h, wo)


def _combine(out_buf: torch.Tensor, top_i: torch.Tensor,
             top_v: torch.Tensor, keep: torch.Tensor,
             slot: torch.Tensor) -> torch.Tensor:
    """Each token's top-k expert outputs, gathered from ``out_buf`` and
    weighted by their gates (dropped slots by 0): ``(B, S, d)``."""
    b, s, k = top_i.shape
    b_idx = torch.arange(b, device=out_buf.device)[:, None].expand(b, s)
    y = out_buf.new_zeros((b, s, out_buf.shape[-1]))
    for kk in range(k):
        gathered = out_buf[b_idx, top_i[:, :, kk], slot[:, :, kk]]
        w = (top_v[:, :, kk] * keep[:, :, kk].to(y.dtype))[..., None]
        y = y + gathered * w
    return y


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

    On a mesh the routing, dispatch and combine run on each rank's rows
    (``dist.sharding.local_rows_heads``, the router's small weight whole):
    DTensor has no sharding rule for the dispatch's ``index_put_`` on some
    torch versions, and its propagation of the router product's backward
    refuses the uneven strided token shards the dispatch leaves.
    """
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    cap = s if capacity_factor is None else \
        max(1, math.ceil(s * k * capacity_factor / e))

    router = params["router"].float().to(x.dtype)
    mesh = isinstance(x, DTensor)
    if mesh:
        rows = rows_heads_roles(x, 0, None)
        buf, top_i, top_v, keep, slot, gates, counts = local_rows_heads(
            partial(_route, e=e, k=k, cap=cap),
            [(x, 0, None), (router, None, None)], [(0, None)] * 7, rows)
    else:
        buf, top_i, top_v, keep, slot, gates, counts = _route(
            x, router, e, k, cap)

    # Tensor-parallel experts (the expert count does not fill the model
    # axis): pin the dispatch buffers and the expert hidden activations, as
    # the reference does; under expert parallelism it constrains nothing.
    tp_experts = active_rule("experts") is None
    wg, wi, wo = (params[k].to(x.dtype) for k in ("wg", "wi", "wo"))
    if not tp_experts and mesh:
        # Expert parallelism on a mesh: each rank runs its own experts on
        # its own rows' buffers (DTensor's einsum decomposition fails to
        # view the local expert blocks).
        roles = tuple("row" if isinstance(p, Shard) and p.dim == 0
                      else "head" if isinstance(q, Shard) and q.dim == 0
                      else None
                      for p, q in zip(buf.placements, wg.placements))
        out_buf = local_rows_heads(
            _expert_ffn, [(buf, 0, 1), (wg, None, 0), (wi, None, 0),
                          (wo, None, 0)], [(0, 1)], roles)
    else:
        if tp_experts:
            buf = constrain(buf, ("batch", "experts", None, None))
        h = F.silu(torch.einsum("becd,edf->becf", buf, wg))
        h = h * torch.einsum("becd,edf->becf", buf, wi)
        if tp_experts:
            h = constrain(h, ("batch", "experts", None, "mlp"))
        out_buf = torch.einsum("becf,efd->becd", h, wo)
        if tp_experts:
            out_buf = constrain(out_buf, ("batch", "experts", None, None))

    if mesh:
        y = local_rows_heads(
            _combine, [(out_buf, 0, None), (top_i, 0, None),
                       (top_v, 0, None), (keep, 0, None), (slot, 0, None)],
            [(0, None)], rows)
    else:
        y = _combine(out_buf, top_i, top_v, keep, slot)

    if "shared_wi" in params:
        # The shared experts are a SwiGLU FFN: on a mesh its row-parallel
        # down-projection runs on local shards, so no gradient reaches the
        # up-projections' weight products unevenly sharded.
        y = y + swiglu_ffn({"wg": params["shared_wg"],
                            "wi": params["shared_wi"],
                            "wo": params["shared_wo"]}, x)

    # Load-balancing aux loss (Switch/GShard): E * sum_e f_e * p_e.
    me = gates.mean(dim=(0, 1))                                 # (E,)
    ce = counts.mean(dim=(0, 1))                                # (E,)
    aux = moe.router_aux_weight * e * (me * ce).sum()
    return y, aux
