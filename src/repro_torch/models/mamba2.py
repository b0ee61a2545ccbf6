"""Mamba2 / SSD mixer (the port of ``repro.models.mamba2``): its
parameters, the causal depthwise conv, the chunked scan and the one-token
step, the mixer block, and the chunk selection of the tuning path.

The SSD chunk length ``Q`` is the paper's partition-size knob for the time
axis: one chunk's working set must fit the target level, and the run time
picks it (``choose_chunk``).  On Hopper the working set is what one block
of ``csrc/ssd_scan.cu`` stages in shared memory, for the body the shape
takes (``kernels.ssd_scan.ssd_path``):

  * ``tc`` (bf16): the chunk axis is three launches -- chunk states, state
    passing, outputs -- and a block of passes 1 and 3 holds one chunk (or
    a 128-row panel of it) for a group of heads, staging B, C and x in bf16
    once for all of them.  Its working set is the largest block of the
    three passes, and does not grow with the heads;
  * ``simt`` (float32 and the rest): one block per (batch, head) walks the
    chunks in order with everything in float32.

Either way the model counts one block, not all heads' (the reference
multiplies by ``n_heads``, which on Hopper would reject every chunk at
zamba2-1.2b's 64 heads).

``mamba2_block`` keeps the reference's dispatch: with a cache and one
token it takes ``ssd_step``; otherwise the chunked scan, from the cache's
state and giving the next one.  The chunked scan is the hand-written
kernel for CUDA tensors (``kernels.ssd_scan.ssd_scan``, at the largest
chunk up to the requested one whose block fits, ``kernel_chunk``) and
``ssd_chunked``, the plain port of the reference's jnp function with its
casts, for CPU tensors.  The training forward asks for ``ssd_chunked`` on
every device (``plain_scan=True``): the reference's training forward runs
that jnp function, not its Pallas kernel, and neither package has a
backward for the kernel (its wrapper refuses inputs that require grad).
``ssd_step``, ``causal_conv1d`` and the projections are plain torch ops,
as they are plain jnp in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.dist.sharding import (active_rule, constrain,
                                       local_rows_heads, rows_heads_roles)
from repro_torch.models.layers import rms_norm, row_parallel
from repro_torch.models.params import ParamSpec

#: Chunks the tc body's planner chooses among.
TC_CHUNKS = (64, 128, 256)


def ssd_workset_bytes(chunk: int, head_dim: int, state_dim: int,
                      path: str = "tc") -> int:
    """Shared memory of one ``ssd_scan`` block of body ``path``;
    ``csrc/ssd_scan.cu``'s ``ssd_scan_smem_bytes`` reports the same.

    ``tc``: the larger of pass 1 -- B (Q x (N+8)) and two buffers of x
    (Q x (P+8)) in bf16 -- and pass 3 -- B (Q x (N+8)), the panel's C
    (R x (N+8)), one buffer of x (Q x (P+8)) and S_prev as two bf16 terms
    (2 x N x (P+8)) in bf16, the panel's C.B^T (R x (Q+4)) in f32 --
    each with dt and cum of up to 8 heads (2 x 8 x Q floats), and
    R = min(Q, 128).
    Rows are padded by 8 bf16 (16 B) so ldmatrix reads hit 8 banks.

    ``simt``, all float32: the chunk's x (Q x P), B (Q x N, rows padded by
    one float so the score tile's reads hit 32 different banks) and C
    (Q x N), dt and its cumulative decay (Q each), the decay-weighted
    score tile (Q x Q) and the running state (N x P).

    Neither depends on the number of heads."""
    q, p, n = chunk, head_dim, state_dim
    if path == "tc":
        from repro_torch.kernels.ssd_scan import (TC_MAX_HEADS_PER_BLOCK,
                                                  TC_PAD, TC_PANEL)

        r = min(q, TC_PANEL)
        heads = 4 * 2 * TC_MAX_HEADS_PER_BLOCK * q
        pass1 = 2 * (q * (n + TC_PAD) + 2 * q * (p + TC_PAD)) + heads
        pass3 = (2 * (q * (n + TC_PAD) + r * (n + TC_PAD)
                      + q * (p + TC_PAD) + 2 * n * (p + TC_PAD))
                 + 4 * r * (q + 4) + heads)
        return max(pass1, pass3)
    return 4 * (q * p + q * (n + 1) + q * n + 2 * q + q * q + n * p)


def chunk_path(dtype_bytes: int, chunk: int, head_dim: int,
               state_dim: int) -> str:
    """The body ``ssd_scan`` runs at this chunk (``ssd_path``), from the
    element size alone: 2 bytes is bf16."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_path

    dtype = torch.bfloat16 if dtype_bytes == 2 else torch.float32
    return ssd_path(dtype, chunk, head_dim, state_dim)


def choose_chunk(seq_len: int, n_heads: int, head_dim: int, state_dim: int,
                 dtype_bytes: int = 2, spec=None,
                 use_tuned: bool = True) -> int:
    """The analytic chunk, by the working set of the body it runs on:

      * tc: the largest of ``TC_CHUNKS`` (64, 128, 256), at most the
        sequence rounded up to 16, whose largest pass block fits the SMEM
        level;
      * simt: the largest power-of-two chunk (64 to 1024, at most the
        sequence) whose block fits the SMEM level.

    With ``use_tuned`` a measured sweep winner from the port's tuning
    artifact overrides it (precedence analytic < tuned) after re-passing
    the filter of one block within the level.  ``n_heads`` and
    ``dtype_bytes`` key the tuning lookup; ``dtype_bytes`` also picks the
    body."""
    from repro_torch.hw.h100 import h100_spec

    spec = spec or h100_spec()
    budget = spec.hierarchy().find("SMEM").per_core_size()
    if chunk_path(dtype_bytes, 64, head_dim, state_dim) == "tc":
        cap = max(64, -(-seq_len // 16) * 16)
        q = 64
        for c in TC_CHUNKS:
            if c <= cap and chunk_path(dtype_bytes, c, head_dim,
                                       state_dim) == "tc" \
                    and ssd_workset_bytes(c, head_dim, state_dim,
                                          "tc") <= budget:
                q = c
    else:
        q = 64
        while q * 2 <= min(seq_len, 1024):
            if ssd_workset_bytes(q * 2, head_dim, state_dim, "simt") > budget:
                break
            q *= 2
    if use_tuned:
        from repro_torch.tune.cache import bucket_ssd, lookup_tuned

        entry = lookup_tuned(
            "ssd_scan", spec.name,
            bucket_ssd(seq_len, n_heads, head_dim, state_dim, dtype_bytes))
        if entry is not None:
            c = entry.get("block", {}).get("chunk")
            cap = -(-min(max(seq_len, 64), 1024) // 8) * 8
            if (isinstance(c, int) and c >= 8 and c % 8 == 0 and c <= cap
                    and ssd_workset_bytes(
                        c, head_dim, state_dim,
                        chunk_path(dtype_bytes, c, head_dim, state_dim))
                    <= budget):
                return c
    return q


def kernel_chunk(chunk: int, head_dim: int, state_dim: int,
                 dtype_bytes: int = 2, spec=None) -> int:
    """The chunk the kernel runs for a requested ``chunk`` (the
    reference's ``cfg.ssm.chunk``): halved until the block of the body it
    runs on fits one block's shared memory -- zamba2-1.2b's 256 becomes
    128 in bf16.  The scan's value does not depend on the chunk, only its
    rounding does."""
    from repro_torch.hw.h100 import h100_spec

    limit = (spec or h100_spec()).smem_bytes
    q = chunk
    while q > 16 and ssd_workset_bytes(
            q, head_dim, state_dim,
            chunk_path(dtype_bytes, q, head_dim, state_dim)) > limit:
        q //= 2
    return q


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def mamba2_param_specs(cfg, layers: int = 0) -> dict:
    """The mixer's parameters, same paths and shapes as the reference's
    (``layers`` > 0 stacks them on a leading ``"layers"`` axis)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    h = d_inner // s.head_dim
    n = s.state_dim
    conv_ch = d_inner + 2 * n                     # x, B, C convolved (G=1)
    ls = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "wz": ParamSpec(ls + (d, d_inner), la + ("embed", "mlp")),
        "wx": ParamSpec(ls + (d, d_inner), la + ("embed", "mlp")),
        "wB": ParamSpec(ls + (d, n), la + ("embed", None)),
        "wC": ParamSpec(ls + (d, n), la + ("embed", None)),
        "wdt": ParamSpec(ls + (d, h), la + ("embed", "heads")),
        "dt_bias": ParamSpec(ls + (h,), la + ("heads",), init="zeros"),
        "A_log": ParamSpec(ls + (h,), la + ("heads",), init="ones"),
        "D": ParamSpec(ls + (h,), la + ("heads",), init="ones"),
        "conv_w": ParamSpec(ls + (s.conv_width, conv_ch), la + (None, "mlp")),
        "conv_b": ParamSpec(ls + (conv_ch,), la + ("mlp",), init="zeros"),
        "norm": ParamSpec(ls + (d_inner,), la + ("mlp",), init="ones"),
        "out": ParamSpec(ls + (d_inner, d), la + ("mlp", "embed"),
                         scale=1.0 / math.sqrt(2 * max(1, cfg.n_layers))),
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, C); w: (W, C) depthwise; state: (B, W-1, C), the trailing
    inputs of the previous call (zeros when None).  Returns
    ``(silu(conv), new_state)``, both in x's dtype."""
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+W-1, C)
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i: i + x.shape[1]] * w[i].to(x.dtype)
    out = out + b.to(x.dtype)
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return F.silu(out), new_state


# ---------------------------------------------------------------------------
# SSD: chunked scan (prefill) + sequential step (decode)
# ---------------------------------------------------------------------------


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise sums: out[..., i, j] = sum_{j<r<=i} dA_r
    (-inf above the diagonal)."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]        # (..., i, j)
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=dA.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H)  (post-softplus)
    A: torch.Tensor,        # (H,)       (negative)
    Bm: torch.Tensor,       # (B, S, N)
    Cm: torch.Tensor,       # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked scan in plain torch, with its casts (the
    products' operands in x's dtype, the decays and the carried state in
    float32).  Returns ``(y (B, S, H, P), final_state (B, H, P, N))``."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // q

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = Bm.reshape(b, nc, q, n)
    Cc = Cm.reshape(b, nc, q, n)

    dA = (dtc * A).movedim(-1, 2)                     # (B,nc,H,Q) log-decay
    cum = torch.cumsum(dA, dim=-1)                    # (B,nc,H,Q)

    # Intra-chunk (attention-like) term.
    L = torch.exp(_segsum(dA))                        # (B,nc,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B,nc,Q,Q)
    w = scores[:, :, None] * L                        # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]                         # x * dt (B,nc,Q,H,P)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", w.to(x.dtype), xdt)

    # Chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x_j)^T.
    decay_out = torch.exp(cum[..., -1:] - cum)        # (B,nc,H,Q)
    sdt = (decay_out * dtc.movedim(2, 3)).to(x.dtype)  # (B,nc,H,Q)
    states = torch.einsum("bchq,bcqn,bcqhp->bchpn", sdt, Bc, xc)

    # Cross-chunk recurrence.
    chunk_decay = torch.exp(cum[..., -1])             # (B,nc,H)
    run = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
           if init_state is None else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(run)
        run = run * chunk_decay[:, c, :, None, None] + states[:, c].float()
    prev = torch.stack(prevs, dim=1)                  # (B,nc,H,P,N)

    # Inter-chunk contribution: y_off_i = exp(cum_i) C_i . S_prev.
    decay_in = torch.exp(cum)                         # (B,nc,H,Q)
    y_off = torch.einsum("bcqn,bchpn,bchq->bcqhp", Cc, prev.to(x.dtype),
                         decay_in.to(x.dtype))
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y, run


def ssd_step(
    x: torch.Tensor,        # (B, H, P) one token
    dt: torch.Tensor,       # (B, H)
    A: torch.Tensor,        # (H,)
    Bm: torch.Tensor,       # (B, N)
    Cm: torch.Tensor,       # (B, N)
    state: torch.Tensor,    # (B, H, P, N) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the recurrence: ``(y (B, H, P), new_state)``.
    On a mesh it runs on local shards, rows and heads split as the
    state's are (as ``_chunked_scan`` does)."""
    if isinstance(state, DTensor):
        return local_rows_heads(
            ssd_step, [(x, 0, 1), (dt, 0, 1), (A, None, 0), (Bm, 0, None),
                       (Cm, 0, None), (state, 0, 1)],
            [(0, 1), (0, 1)], _scan_roles(x, state, 0, 1))
    dec = torch.exp(dt * A)                           # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x.float(), Bm.float())
    new_state = state * dec[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    return y.to(x.dtype), new_state


def _scan_roles(x: torch.Tensor, state: Optional[torch.Tensor],
                row: int, head: int) -> Tuple[Optional[str], ...]:
    """For each mesh dim of a mixer's DTensors, what it splits
    (``local_rows_heads``' roles): as the state's rows and heads shard;
    without a state, the batch rows where ``x``'s ``row`` dim shards and
    the heads where the active rules map "state_heads" and the heads
    divide."""
    if isinstance(state, DTensor):
        return rows_heads_roles(state, 0, 1)
    mesh = x.device_mesh
    axes = active_rule("state_heads")
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return tuple(
        "row" if isinstance(p, Shard) and p.dim == row
        else "head" if name in axes and x.shape[head] % mesh.size(i) == 0
        else None
        for i, (name, p) in enumerate(zip(mesh.mesh_dim_names,
                                          x.placements)))


def _chunked_scan(x, dt, A, Bm, Cm, chunk: int,
                  init: Optional[torch.Tensor], plain: bool = False):
    """``ssd_chunked``'s function: the hand-written kernel for CUDA tensors
    (no fallback: it launches or raises), the plain port for CPU ones, and
    the plain port on any device when ``plain`` is asked for (the
    differentiable training forward).

    On a mesh (DTensor arguments) the scan runs on local shards, as
    ``models.layers._pool_write_attend`` runs the paged kernel: the batch
    rows shard as the state's (the cache's slots) do and the heads as the
    state's heads do, B and C (no head dim) replicate over the head axes,
    and the kernel -- or ``ssd_chunked`` on the CPU -- gets this rank's
    rows and heads as plain tensors; ``y`` and the final state come back
    as DTensors placed alike."""
    if isinstance(x, DTensor):
        roles = _scan_roles(x, init, 0, 2)
        return local_rows_heads(
            lambda *t: _chunked_scan(*t[:5], chunk, t[5], plain),
            [(x, 0, 2), (dt, 0, 2), (A, None, 0), (Bm, 0, None),
             (Cm, 0, None), (init, 0, 1)], [(0, 2), (0, 1)], roles)
    if plain or x.device.type != "cuda":
        return ssd_chunked(x, dt, A, Bm, Cm, chunk, init)
    from repro_torch.kernels.ssd_scan import ssd_scan

    q = kernel_chunk(chunk, x.shape[-1], Bm.shape[-1], x.element_size())
    return ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                    Bm.contiguous(), Cm.contiguous(), chunk=q,
                    init_state=None if init is None else init.contiguous(),
                    return_final=True)


# ---------------------------------------------------------------------------
# Full mixer block
# ---------------------------------------------------------------------------


def mamba2_block(
    params: dict,
    hidden: torch.Tensor,             # (B, S, d)
    cfg,
    cache: Optional[dict] = None,     # {"conv": (B,W-1,C), "ssm": (B,H,P,N)}
    chunk: Optional[int] = None,
    plain_scan: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The Mamba2 mixer: ``(out (B, S, d), new_cache)``, the new cache
    None without one.  The caller writes the new cache back.

    ``plain_scan`` runs the chunked scan as ``ssd_chunked`` on any device:
    the training forward's route, since the reference's training forward
    is the jnp ``ssd_chunked`` (``repro.models.mamba2.mamba2_block``) and
    the ``ssd_scan`` kernel has no backward.  Serving leaves it off and
    launches the kernel on the card."""
    s_cfg = cfg.ssm
    b, s, d = hidden.shape
    d_inner = s_cfg.expand * d
    # On a mesh the residual stream may arrive as a partial sum over
    # "model" (a row-parallel output that did not take the local route);
    # the scan multiplies B by C, so it is reduced here first (DTensor's
    # einsum gave a wrong product of two partial sums when the batch was
    # replicated).  The identity off a mesh.
    hidden = constrain(hidden, ("batch", "seq", "embed"))
    h = d_inner // s_cfg.head_dim
    p = s_cfg.head_dim
    n = s_cfg.state_dim
    dtype = hidden.dtype

    z = hidden @ params["wz"].to(dtype)
    xin = hidden @ params["wx"].to(dtype)
    Bm = hidden @ params["wB"].to(dtype)
    Cm = hidden @ params["wC"].to(dtype)
    dt_raw = hidden @ params["wdt"].to(dtype)

    xbc = torch.cat([xin, Bm, Cm], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = causal_conv1d(xbc, params["conv_w"], params["conv_b"],
                                  conv_state)
    xin, Bm, Cm = torch.split(xbc, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())

    xh = xin.reshape(b, s, h, p)
    new_cache = None
    if cache is not None and s == 1:
        y, new_state = ssd_step(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                cache["ssm"])
        y = y[:, None]                                  # (B,1,H,P)
        new_cache = {"conv": new_conv, "ssm": new_state}
    else:
        q = chunk or s_cfg.chunk
        init = cache["ssm"] if cache is not None else None
        # dt enters the scan rounded to x's dtype, as in the reference.
        y, final = _chunked_scan(xh, dt.to(xh.dtype), A, Bm, Cm, q, init,
                                 plain_scan)
        if cache is not None:
            new_cache = {"conv": new_conv, "ssm": final}

    y = y + xh * params["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = row_parallel(y, params["out"].to(y.dtype))
    return out, new_cache
