"""Mamba2 / SSD chunk selection: the part of ``repro.models.mamba2`` the
tuning path needs.

The SSD chunk length ``Q`` is the paper's partition-size knob for the time
axis: one chunk's working set must fit the target level, and the run time
picks it (``choose_chunk``).  On Hopper one block of ``csrc/ssd_scan.cu``
holds one (batch, head) and stages its chunk in shared memory, so the
working set is that block's shared memory -- one head's, not all heads'
(the reference multiplies by ``n_heads``, which on Hopper would reject
every chunk at zamba2-1.2b's 64 heads).

Left for the ``hybrid_ssm`` slice: the parameters, ``causal_conv1d``,
``ssd_chunked`` (with initial and final state), ``ssd_step`` and the mixer
block.
"""

from __future__ import annotations


def ssd_workset_bytes(chunk: int, head_dim: int, state_dim: int) -> int:
    """Shared memory of one ``ssd_scan`` block, all float32: the chunk's
    x (Q x P), B (Q x N, rows padded by one float so the score tile's reads
    hit 32 different banks) and C (Q x N), dt and its cumulative decay (Q
    each), the decay-weighted score tile (Q x Q) and the running state
    (N x P).  ``csrc/ssd_scan.cu``'s ``ssd_scan_smem_bytes`` reports the
    same.  It does not depend on the inputs' dtype (the block converts
    them to float32 as it stages them) or on the number of heads."""
    q, p, n = chunk, head_dim, state_dim
    return 4 * (q * p + q * (n + 1) + q * n + 2 * q + q * q + n * p)


def choose_chunk(seq_len: int, n_heads: int, head_dim: int, state_dim: int,
                 dtype_bytes: int = 2, spec=None,
                 use_tuned: bool = True) -> int:
    """The largest power-of-two chunk (64 to 1024, at most the sequence)
    whose block fits one block's shared memory; with ``use_tuned`` a
    measured sweep winner from the port's tuning artifact overrides it
    (precedence analytic < tuned) after re-passing the same filter.
    ``n_heads`` and ``dtype_bytes`` only key the tuning lookup."""
    from repro_torch.hw.h100 import h100_spec

    spec = spec or h100_spec()
    budget = spec.hierarchy().find("SMEM").per_core_size()
    q = 64
    while q * 2 <= min(seq_len, 1024):
        if ssd_workset_bytes(q * 2, head_dim, state_dim) > budget:
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
                    and ssd_workset_bytes(c, head_dim, state_dim)
                    <= budget):
                return c
    return q
