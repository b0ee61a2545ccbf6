"""Paged decode attention: the wrapper of ``csrc/paged_attention.cu``.

Replaces ``repro.kernels.paged_attention.paged_attention`` (the Pallas TPU
kernel ``_pa_kernel``).  One query token per row attends over the KV stream
its page-table row names, with grouped GQA, causal/window/length masks and
an online softmax across pages; see the CUDA source's header for the design
and what bounds it.

Routing, with no fallback between any two:
  * CPU tensors -> ``kernels.ref.paged_attention_ref``, the plain version;
  * CUDA tensors -> the kernel's body that ``paged_path`` names
    (``"split"``: bf16 at head dims 64 and 128, pages of 8 to 256 tokens in
    steps of 8, up to 16 query heads per KV head -- the KV stream split
    across blocks, pages staged by TMA, products on the tensor cores, and
    a second launch that merges the splits; ``"mla"``: bf16 at the MLA
    latent's head dim 576 with up to 128 query heads per KV head (the
    absorbed MLA decode of DeepSeek-V2: K = V = the latent pool) -- 64-head
    tiles on wgmma fed by TMA, the two head tiles of a row one cluster fed
    by multicast, and a row's splits, where there are several, one cluster
    that merges through distributed shared memory; ``"simt"``: the
    rest, on the CUDA cores, in 16-head, 16-token tiles where the whole
    group does not fit a block), or an exception.  The wrapper checks
    devices, dtypes, contiguity and shapes, allocates the output (and the
    split body's workspace), launches on ``torch.cuda.current_stream()``
    and raises when the launch reports an error.

The split count comes from shapes alone (``split_plan``,
``mla_split_plan``): ``lengths`` is never read on the host, so a launch
never waits for the card.

``LAUNCHES_SPLIT``, ``LAUNCHES_MLA`` and ``LAUNCHES_SIMT`` count kernel
launches by body (never CPU calls); ``LAUNCHES`` is their sum, so a run
can show its main path went through the kernel.  They count under a lock:
the cluster's thread transport launches from one thread per replica.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.hw.h100 import h100_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

#: Kernel launches made by this process, by body, and in all.
LAUNCHES_SPLIT = 0
LAUNCHES_MLA = 0
LAUNCHES_SIMT = 0
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

#: Tokens of a page the simt body stages at a time (``kTileTokens``), and
#: its heads and tokens a block where the whole group does not fit
#: (``kWideHeads``, ``kWideTileTokens``).
TILE_TOKENS = 64
WIDE_HEADS = 16
WIDE_TILE_TOKENS = 16

#: The split body: warps per block, page stages in its ring (the plan's
#: ``PAGE_BUFFERING``), the most pages one split covers, and the blocks a
#: launch aims at if every row's table were full (32 per SM: decode rows
#: hold a few pages of a long table, so most splits are empty).
SPLIT_WARPS = 4
SPLIT_STAGES = 2
MAX_SPLIT_PAGES = 16
SPLIT_TARGET_BLOCKS_PER_SM = 32
#: Head dims and the largest page the split body takes (one TMA box).
SPLIT_HEAD_DIMS = (64, 128)
SPLIT_MAX_PAGE = 256
SPLIT_MAX_GROUP = 16
#: The mla body: the head dim it takes (DeepSeek-V2's latent row, kv_lora
#: 512 + rope 64), the most query heads per KV head, its block's heads (one
#: wgmma m64 tile), the token tiles it is built for (largest first; K != V
#: takes ``MLA_TILES_KV``), its most ring stages, the bytes a block holds
#: besides the ring (alignment slack, the Q tile, the P tile, mbarriers
#: and per-row floats), and the blocks of a cluster its plan uses
#: (portable) and the kernel takes (non-portable above 8).
MLA_HEAD_DIM = 576
MLA_MAX_GROUP = 128
MLA_HEADS = 64
MLA_TILES = (64, 48, 32, 16)
MLA_TILES_KV = (32, 16)
MLA_MAX_STAGES = 8
MLA_FIXED_BYTES = 1024 + MLA_HEADS * MLA_HEAD_DIM * 2 + MLA_HEADS * 128 \
    + 1024
MLA_PLAN_CLUSTER = 8
MLA_MAX_CLUSTER = 16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"simt": 0, "split": 1, "mla": 2}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.paged_attention_smem_bytes
        smem.argtypes = [ctypes.c_int] * 5
        smem.restype = ctypes.c_size_t
        _FN = (fn, smem)
    return _FN


def paged_path(dtype: torch.dtype, head_dim: int, page_tokens: int,
               group: int) -> str:
    """The body a shape takes on the card: ``"split"`` for bf16 at head
    dims 64 and 128, pages a multiple of 8 up to 256 tokens (one TMA box)
    whose two stages fit one block's shared memory, and at most 16 query
    heads per KV head (one m16 tile); ``"mla"`` for bf16 at head dim 576
    with at most 128 query heads per KV head, any page; ``"simt"``
    otherwise."""
    if (dtype == torch.bfloat16 and head_dim == MLA_HEAD_DIM
            and 1 <= group <= MLA_MAX_GROUP):
        return "mla"
    if (dtype == torch.bfloat16 and head_dim in SPLIT_HEAD_DIMS
            and page_tokens % 8 == 0 and 8 <= page_tokens <= SPLIT_MAX_PAGE
            and 1 <= group <= SPLIT_MAX_GROUP
            and smem_bytes(group, head_dim, page_tokens)
            <= h100_spec().smem_bytes):
        return "split"
    return "simt"


def split_plan(rows: int, n_kv: int, table_width: int, page_tokens: int,
               spec=None) -> Tuple[int, int]:
    """``(splits, split_pages)`` of the split body, from shapes alone.

    A split covers ``split_pages`` whole logical pages of a row's table.
    The launch aims at ``SPLIT_TARGET_BLOCKS_PER_SM`` blocks per SM over
    full tables, since the host cannot see how full they are (reading
    ``lengths`` would sync the stream); a split covers at least 64 tokens
    and at most ``MAX_SPLIT_PAGES`` pages.  At llama3.2-1b decode (8 rows,
    8 KV heads, 74 pages of 56 tokens) that is 2 pages, 37 splits."""
    spec = spec or h100_spec()
    target = SPLIT_TARGET_BLOCKS_PER_SM * spec.num_sms
    want = max(1, -(-target // max(1, rows * n_kv)))
    pages = max(-(-table_width // want), -(-64 // page_tokens), 1)
    pages = min(pages, MAX_SPLIT_PAGES, max(1, table_width))
    return -(-max(1, table_width) // pages), pages


def mla_tile(page_tokens: int, shared_kv: bool = True) -> Tuple[int, int]:
    """``(tokens a tile, ring stages)`` of the mla body for pages of
    ``page_tokens`` (its ``tile_tokens`` and ``num_stages``).

    A tile never crosses a page, so of ``MLA_TILES`` (``MLA_TILES_KV``
    when K and V are two tensors) the tile is the one that pads a page
    least, the larger on a tie: 48 at DeepSeek-V2's 96-token pages, 64 at
    64 and 128, 16 at 8.  The ring holds as many stages as fit a block beside
    ``MLA_FIXED_BYTES``, at most ``MLA_MAX_STAGES``."""
    best, best_pad = 16, None
    for bt in (MLA_TILES if shared_kv else MLA_TILES_KV):
        pad = -(-page_tokens // bt) * bt
        if best_pad is None or pad < best_pad:
            best, best_pad = bt, pad
    stage = _mla_stage_bytes(best, shared_kv)
    return best, min(MLA_MAX_STAGES,
                     (h100_spec().smem_bytes - MLA_FIXED_BYTES) // stage)


def _mla_stage_bytes(tile: int, shared_kv: bool) -> int:
    return (MLA_HEAD_DIM // 64) * tile * 128 * (1 if shared_kv else 2)


def mla_split_plan(rows: int, n_kv: int, group: int, table_width: int,
                   page_tokens: int, spec=None) -> Tuple[int, int]:
    """``(splits, blocks of a cluster)`` of the mla body, from shapes alone.

    A block is one (row, KV head, 64-head tile); a group over 64 heads is
    two tiles, one cluster fed by TMA multicast.  Where those blocks fill
    the card's SMs -- a prefill chunk: 96 rows x 2 head tiles at
    DeepSeek-V2 -- there is one split.  Otherwise each (row, head tile)
    gets the splits that bring the launch to about one block per SM, at
    most ``MLA_PLAN_CLUSTER`` blocks a cluster with its head tiles, and no
    more than a full table has tiles: the splits share the row's live
    tiles evenly on the card (from ``lengths`` there), so every split of a
    long row works, and merge in their cluster.  At decode (8 rows x 2
    head tiles) 4 splits, clusters of 8; at 16 heads 8 splits."""
    spec = spec or h100_spec()
    tiles = -(-group // MLA_HEADS)
    blocks = rows * n_kv * tiles
    if blocks >= spec.num_sms:
        return 1, tiles
    tile, _ = mla_tile(page_tokens)
    full = max(1, table_width) * -(-page_tokens // tile)
    splits = min(MLA_PLAN_CLUSTER // tiles, -(-spec.num_sms // blocks), full)
    return splits, tiles * splits


def simt_plan(group: int, head_dim: int) -> Tuple[int, int]:
    """``(heads a block, tokens a tile)`` of the simt body (its ``plan``):
    the whole group and ``TILE_TOKENS`` where they fit a block's shared
    memory, else ``WIDE_HEADS`` heads and ``WIDE_TILE_TOKENS`` tokens."""
    if _simt_floats(group, head_dim, TILE_TOKENS) * 4 <= \
            h100_spec().smem_bytes:
        return group, TILE_TOKENS
    return min(group, WIDE_HEADS), WIDE_TILE_TOKENS


def _simt_floats(gb: int, d: int, tile: int) -> int:
    return 2 * gb * d + tile * (d + 1) + tile * d + gb * tile + 3 * gb


def split_workspace(rows: int, n_kv: int, splits: int, group: int,
                    head_dim: int) -> Tuple[tuple, tuple]:
    """Shapes of the split body's float32 workspace: each split's
    unnormalised accumulator (S, KV, splits, G, D) and its (max, sum)
    (S, KV, splits, G, 2)."""
    return ((rows, n_kv, splits, group, head_dim),
            (rows, n_kv, splits, group, 2))


def workspace_bytes(path: str, rows: int, n_kv: int, splits: int,
                    group: int, head_dim: int) -> int:
    """Bytes of float32 workspace body ``path`` writes to device memory:
    the split body's partials (``split_workspace``); none for the mla body,
    whose splits merge in their cluster, or for simt."""
    if path != "split":
        return 0
    acc, ml = split_workspace(rows, n_kv, splits, group, head_dim)
    return 4 * (math.prod(acc) + math.prod(ml))


def smem_bytes(group: int, head_dim: int, page_tokens: int,
               path: str = "split", shared_kv: bool = True) -> int:
    """Shared memory of one block of body ``path``, as the CUDA source lays
    it out (its ``paged_attention_smem_bytes`` reports the same).

    ``split``: 1,024 B of alignment slack for the swizzled ring; the ring
    of ``SPLIT_STAGES`` stages, each one KV head's K and V slices of one
    page in bf16 (``page_tokens x head_dim x 2`` B each) -- or, if larger,
    the warps' float32 softmax states that reuse it at the end
    (``SPLIT_WARPS x (G x D + 2G)`` floats); one 8-byte mbarrier per stage
    and ``MAX_SPLIT_PAGES`` table entries.

    ``mla``: ``MLA_FIXED_BYTES`` (1,024 B of alignment slack, the bf16 Q
    tile of ``MLA_HEADS`` x 576, the bf16 P tile of 64 x 64 and 1,024 B of
    mbarriers and per-row floats) and ``mla_tile``'s stages of its token
    tile, each the tile's 576 columns of K, and of V when V is a tensor of
    its own (``shared_kv`` False); it depends on the page, not the group.
    After the last tile the Q tile and the ring hold the block's bf16 rows
    or its float32 partial (64 rows of 584).

    ``simt``: float32 q and accumulator (heads x D each), one tile of K
    (rows padded by one float) and of V, the tile's logits (heads x tile)
    and the softmax state (3 x heads), at ``simt_plan``'s heads and tile;
    it does not depend on the page."""
    g, d = group, head_dim
    if path == "split":
        ring = SPLIT_STAGES * 2 * page_tokens * d * 2
        merge = SPLIT_WARPS * (g * d + 2 * g) * 4
        return 1024 + max(ring, merge) + SPLIT_STAGES * 8 \
            + MAX_SPLIT_PAGES * 4
    if path == "mla":
        tile, stages = mla_tile(page_tokens, shared_kv)
        return MLA_FIXED_BYTES + stages * _mla_stage_bytes(tile, shared_kv)
    gb, tile = simt_plan(g, d)
    return 4 * _simt_floats(gb, d, tile)


def kernel_smem_bytes(group: int, head_dim: int, page_tokens: int,
                      path: str = "split") -> int:
    """The shared memory the CUDA kernel's ``path`` body reports for one
    block (builds the kernel first; the mla body's with K and V one
    tensor, as serving calls it)."""
    return int(_kernel()[1](group, head_dim, page_tokens, _PATHS[path], 1))


def _count(path: str) -> None:
    global LAUNCHES, LAUNCHES_MLA, LAUNCHES_SIMT, LAUNCHES_SPLIT
    with _COUNT_LOCK:
        if path == "split":
            LAUNCHES_SPLIT += 1
        elif path == "mla":
            LAUNCHES_MLA += 1
        else:
            LAUNCHES_SIMT += 1
        LAUNCHES += 1


def paged_attention(
    q: torch.Tensor,            # (S, H, D)  one query token per row
    k_pages: torch.Tensor,      # (P, T, KV, D)  one layer's page pool
    v_pages: torch.Tensor,      # (P, T, KV, D)
    page_table: torch.Tensor,   # (S, NP) int32, entries in [0, P)
    lengths: torch.Tensor,      # (S,) int32  valid tokens incl. current
    window: int = 0,
    page_tokens: Optional[int] = None,
    path: Optional[str] = None,
    split_pages: Optional[int] = None,
) -> torch.Tensor:
    """One step of attention against the paged KV pool; returns (S, H, D).

    ``page_tokens`` is the plan's page size; when given it must equal the
    pool's second dim -- the kernel streams at the planned page and no
    other granule.  ``path="simt"`` runs the CUDA-core body where
    ``paged_path`` would pick split or mla (to compare them);
    ``split_pages`` overrides the split plan's pages per split (to time
    other splits; up to ``MAX_SPLIT_PAGES`` on the split body, up to the
    table's width on the mla body, whose splits are then
    ``ceil(table width / split_pages)``, at most ``MLA_MAX_CLUSTER``
    blocks a cluster with the head tiles).
    """
    if any(isinstance(x, DTensor)
           for x in (q, k_pages, v_pages, page_table, lengths)):
        raise TypeError("paged_attention takes local tensors, not DTensors: "
                        "on a mesh call it on each rank's shard "
                        "(models.layers.paged_attention_block does)")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    s, h, d = q.shape
    p_total, t, n_kv, dk = k_pages.shape
    if page_tokens is not None and t != page_tokens:
        raise ValueError(
            f"pool page_tokens={t} != planned page_tokens={page_tokens}; "
            f"the kernel block must be the planned page")
    if h % n_kv != 0:
        raise ValueError(f"{h} query heads do not group over {n_kv} KV heads")
    if dk != d or page_table.dim() != 2 or page_table.shape[0] != s \
            or tuple(lengths.shape) != (s,):
        raise ValueError(
            f"bad shapes: q {tuple(q.shape)}, pool {tuple(k_pages.shape)}, "
            f"table {tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    routed = paged_path(q.dtype, d, t, h // n_kv)
    if path not in (None, "simt", routed):
        raise ValueError(f"paged_attention: the {path} body cannot take "
                         f"{q.dtype} at D={d}, page {t}, group {h // n_kv}")
    path = path or routed
    # The split body holds a split's table entries in shared memory; the
    # mla body reads them as it goes, and its splits are one cluster.
    top = MAX_SPLIT_PAGES if path == "split" else max(1, page_table.shape[1])
    if split_pages is not None and not 1 <= split_pages <= top:
        raise ValueError(f"split_pages must be in 1..{top}; got "
                         f"{split_pages}")
    if split_pages is not None and path == "mla":
        tiles = -(-(h // n_kv) // MLA_HEADS)
        blocks = tiles * -(-page_table.shape[1] // split_pages)
        if blocks > MLA_MAX_CLUSTER:
            raise ValueError(f"split_pages={split_pages} makes clusters of "
                             f"{blocks} blocks; the mla body takes at most "
                             f"{MLA_MAX_CLUSTER}")
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if all(x.device.type == "cpu" for x in tensors):
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   window=window)
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise ValueError("paged_attention: all tensors must be on one CUDA "
                         "device (or all on the CPU); got "
                         f"{[str(x.device) for x in tensors]}")
    _build.refuse_grad("paged_attention", tensors)
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_attention needs contiguous tensors")
    if (d * q.element_size()) % 16 or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError("the kernel loads K/V 16 bytes at a time: the head "
                         "dim must span a multiple of 16 B and the pools "
                         "must be 16-byte aligned")
    out = torch.empty_like(q)
    if s == 0:
        return out
    g = h // n_kv
    n_pages = page_table.shape[1]
    shared_kv = k_pages.data_ptr() == v_pages.data_ptr()
    fn, kernel_smem = _kernel()
    smem = kernel_smem(g, d, t, _PATHS[path], int(shared_kv))
    limit = h100_spec().smem_bytes
    if smem > limit:
        raise ValueError(f"{g} query heads per KV head at head dim {d} and "
                         f"page {t} need {smem} B of shared memory per "
                         f"block on the {path} path; a block may use {limit}")
    splits = pages = 0
    ws_acc = ws_ml = None
    if path in ("split", "mla"):
        if s > 65535 or p_total * t >= 2 ** 32:
            raise ValueError(f"the {path} body takes at most 65535 rows and "
                             f"2**32 pool tokens; got {s} rows, "
                             f"{p_total * t} tokens")
        splits, pages = (split_plan(s, n_kv, n_pages, t) if path == "split"
                         else mla_split_plan(s, n_kv, g, n_pages, t))
        if split_pages is not None:
            pages = split_pages
            splits = -(-max(1, n_pages) // pages)
        if path == "split":
            acc_shape, ml_shape = split_workspace(s, n_kv, splits, g, d)
            ws_acc = torch.empty(acc_shape, dtype=torch.float32,
                                 device=q.device)
            ws_ml = torch.empty(ml_shape, dtype=torch.float32,
                                device=q.device)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            0 if ws_acc is None else ws_acc.data_ptr(),
            0 if ws_ml is None else ws_ml.data_ptr(),
            s, h, n_kv, d, t, n_pages, p_total, int(window),
            1.0 / math.sqrt(d), splits, pages, _DTYPES[q.dtype],
            _PATHS[path], q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed ({path} "
                           f"body): error {rc}")
    _count(path)
    return out
