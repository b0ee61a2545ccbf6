"""Plain PyTorch pieces the references share: norms, rotary embeddings,
causal attention, SwiGLU, MoE routing and the linear layer, in float32
with TF32 off.

``precision="fp8"`` is the control: every linear layer's input rows and
weight columns are rounded to float8 e4m3, each scaled by its own absolute
maximum, and the product is taken in float32 -- the step below bf16 that a
later change to the program would be tempted by.  Attention's score and
value products stay float32 in both.

Nothing here imports the program: the references take the benchmark's own
weights (the tree the benchmark drew, in the layout the program reads)
and work out everything else again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0                  # largest finite float8 e4m3 value
SCORE_BYTES = 1 << 29            # float32 scores one attention block holds


def exact_float32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, each slice along ``dim`` scaled to its
    own absolute maximum, and returned in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x (N, in) @ w (in, out)`` in float32 (``w`` upcast here)."""
    w = w.float()
    if precision == "fp8":
        return fp8_round(x, -1) @ fp8_round(w, 0)
    if precision != "f32":
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x (S, ..., D)`` at positions ``0..S-1``: the
    two halves of the last dim rotated by ``theta ** (-2i / D)``."""
    s, d = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                         dtype=torch.float32) / d)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    shape = (s,) + (1,) * (x.dim() - 2) + (d // 2,)
    cos, sin = ang.cos().reshape(shape), ang.sin().reshape(shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, window: int = 0) -> torch.Tensor:
    """Softmax attention of ``q (S, H, Dk)`` over ``k (S, G, Dk)``, ``v (S,
    G, Dv)``, query head ``h`` reading key head ``h // (H / G)``; token
    ``i`` sees tokens ``j <= i`` (and ``i - j < window`` when ``window``).
    Heads go in blocks so the float32 scores stay under ``SCORE_BYTES``."""
    s, h, _ = q.shape
    group = h // k.shape[1]
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    out = q.new_empty((s, h, v.shape[-1]))
    hb = max(1, min(h, SCORE_BYTES // (4 * s * s)))
    for h0 in range(0, h, hb):
        heads = torch.arange(h0, min(h, h0 + hb), device=q.device)
        kh, vh = k[:, heads // group], v[:, heads // group]
        scores = torch.einsum("qhd,khd->hqk", q[:, heads], kh) * scale
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        out[:, heads] = torch.einsum("hqk,khd->qhd", probs, vh)
    return out


def swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
           wo: torch.Tensor, precision: str) -> torch.Tensor:
    h = F.silu(linear(x, wg, precision)) * linear(x, wi, precision)
    return linear(h, wo, precision)


def routed_experts(x: torch.Tensor, moe: dict, top_k: int, renormalise: bool,
                   scale: float, precision: str) -> torch.Tensor:
    """The routed experts of one layer over the rows of ``x (N, d)``: a
    softmax over every expert's router logit, the ``top_k`` largest kept
    (renormalised to sum to 1 when ``renormalise``, then times ``scale``),
    each kept expert's SwiGLU weighted by its gate.  Every token reaches
    every expert it chose: nothing is dropped."""
    gates = torch.softmax(linear(x, moe["router"], precision), dim=-1)
    top_v, top_i = torch.topk(gates, top_k, dim=-1)
    if renormalise:
        top_v = top_v / top_v.sum(-1, keepdim=True)
    top_v = top_v * scale
    out = torch.zeros_like(x)
    for e in torch.unique(top_i).tolist():
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        y = swiglu(x[rows], moe["wg"][e], moe["wi"][e], moe["wo"][e],
                   precision)
        out.index_add_(0, rows, y * top_v[rows, slot][:, None])
    return out


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree stacked over its leading dim (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def embed(weights: dict, tokens: torch.Tensor) -> torch.Tensor:
    return weights["embedding"][tokens].float()
