"""Mamba2 / SSD chunk selection: the part of ``repro.models.mamba2`` the
tuning path needs.

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

Left for the ``hybrid_ssm`` slice: the parameters, ``causal_conv1d``,
``ssd_chunked`` (with initial and final state: the tc body's state-passing
pass takes one and gives the other), ``ssd_step`` and the mixer block.
"""

from __future__ import annotations

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
