#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # also: device time by kernel in serving

Phases (each prints its results; the script exits non-zero if any fails):

  0. header: the card's name and power limit, torch and CUDA versions;
  1. build: compile the four sources of ``src/repro_torch/csrc/`` with nvcc
     for sm_90a, one nvcc each, all started together, and print the build
     seconds and ptxas' register/shared-memory report; then count, with
     ``cuobjdump -sass``, the tensor-core (HGMMA, HMMA) and async-copy
     (UTMALDG for TMA, LDGSTS for cp.async) instructions of the
     tensor-core bodies: ``matmul_cc`` and ``flash_attention`` (wgmma),
     ``paged_attention`` (split and mla) and ``ssd_scan`` (tc); the phase
     fails if one of them has none of either;
  2. kernel against its plain version: ``paged_attention`` on the card
     against ``paged_attention_ref`` on the same inputs, at the full width
     of llama3.2-1b (H=32, KV=8, D=64, the planned page) in the decode shape
     (8 rows), the chunked-prefill shape (one page of rows over one table)
     and a decode shape whose rows end on split boundaries, bf16 (the
     ``split`` body) and float32 (``simt``), windows 0 and 256, each check
     naming the body that ran, and two bf16 runs bit-identical; then, for
     the decode and prefill shapes, the times of the split body, of the
     simt body (``ms_simt``), of the plain version and of a library
     yardstick (gather + SDPA) beside the least time the card could take
     (``bound_ms``), the device time of each CUDA kernel
     (``torch.profiler``) and the time at other split sizes;
  3. the slice against its plain path: full-width llama3.2-1b cut to 2
     layers, float32, one prefill chunk per slot and one paged decode step
     on the card and on the CPU with the same weights;
  4. serving: ``ServeEngine`` on full-width llama3.2-1b (16 layers, seeded
     random weights, bf16) with paged batching and chunked prefill serves 8
     prompts of mixed length; every decode tick and prefill chunk of every
     layer must have launched the kernel's split body.
  5. the three kernels of the tuning path against their plain versions at
     full width, bf16 and float32, at the planner's analytic blocks, plus
     one ragged case each: ``matmul_cc`` at llama3.2-1b's MLP up-projection
     for a 4096-token prefill (4096 x 2048 x 8192), orders cc and srrc
     (bit-identical); ``flash_attention`` at llama3.2-1b's attention over
     4096 tokens (1, 32, 4096, 64), causal; ``ssd_scan`` at zamba2-1.2b's
     mixer over 4096 tokens (1, 4096, 64 heads, 64, state 64).  Each check
     names the body that ran (``wgmma``, ``tc`` or ``simt``, from the
     per-body launch counters).  Then each kernel's time beside its plain
     version's, a library call's where one computes the same function,
     and its bound, and the time of the CUDA-core (simt) body at the same
     bf16 shape (``ms_simt``; matmul and attention at their planner's simt
     blocks, the SSD scan at the same chunk), and the device time of each
     of the SSD tc body's three CUDA kernels;
  6. the tuning path at full width: the four sweeps on the card (phase 5's
     shapes in bf16, and ``sweep_paged`` at llama3.2-1b decode: 8 slots,
     4096 tokens, 8 KV heads, group 4, D 64), each candidate's shared
     memory held to the kernel's own ``*_smem_bytes`` for its block and
     the body it runs on (the paged page, the SSD chunk), the winners written
     under the card's fingerprint to a file under ``build/``, the planner
     shown to return each of them, and ``python -m repro_torch.launch.tune
     --quick`` run on the card;
  7. zamba2-1.2b's kernel shapes (the hybrid_ssm family): ``paged_attention``
     at its shared attention block (32 query heads over 32 KV heads, group
     1, D 64, the planned 8-token page) in the decode shape (8 rows) and
     the prefill shape (one 8-row chunk), bf16 (split) and float32 (simt),
     two bf16 runs bit-identical; ``ssd_scan`` with a random initial state
     at its mixer (1, S, 64 heads, 64, state 64) for S = 8 (one planned
     prefill chunk: bf16 tc on a 16-row chunk, float32 simt) and S = 1000
     (ragged), y and final state against the plain version, and 125
     chained 8-token calls against one 1000-token call; then the times of
     both kernels at these shapes beside simt, plain, library and bound;
  8. zamba2-1.2b at full width cut to 2 Mamba2 layers and one application
     of the shared block, float32: prefill in planned chunks and one paged
     decode step on the card and on the CPU with the same weights; logits,
     pool and Mamba state agree;
  9. serving: ``ServeEngine`` on full-width zamba2-1.2b (38 layers, seeded
     random bf16 weights) serving phase 4's trace; every paged launch must
     be ``split`` and every SSD launch ``tc``.
 10. mixtral-8x7b's kernel shape (the moe family): ``paged_attention`` at
     32 query heads over 8 KV heads (group 4), D 128, the planned 24-token
     page and the 4096-token sliding window, over the engine's table for
     8192 tokens whose pages below the window are null entries (as window
     reclaim leaves them): 8 decode rows, some past the window, and one
     page of prefill rows over one table; bf16 (split) and float32 (simt)
     against the plain version, two bf16 runs bit-identical; then the
     times of split, simt, plain and gather + SDPA beside the bound, and
     the device time of each CUDA kernel;
 11. mixtral-8x7b at full width (8 experts of 14,336, top 2) cut to 2
     layers, float32: one prefill chunk for each of 2 slots and one paged
     decode step on the card and on the CPU with the same weights; logits
     and pool agree;
 12. serving: full-width mixtral-8x7b cut in depth to the deepest stack
     whose bf16 weights fit beside the pool (printed; ~70 GB at 24
     layers), seeded random weights, serving phase 4's trace with every
     paged launch ``split``; then, on the same weights, one request of
     4,400 prompt tokens and 32 new ones at ``max_len`` 8192, whose pages
     below the window are reclaimed while it runs (at least 12); then the
     card's busy share over a 2-prompt sub-trace (``torch.profiler``);
 13. xlstm-1.3b at full width cut to one period (7 mLSTM and 1 sLSTM
     block), float32: prefill in the engine's 64-token chunks and one
     decode step on the card and on the CPU; logits and every state leaf
     agree;
 14. serving: full-width, full-depth xlstm-1.3b (48 blocks, seeded random
     bf16 weights) serving phase 4's trace; token-free, so no page is
     allocated and no paged-attention kernel runs.
 15. deepseek-v2-236b's kernel shape (the mla_moe family):
     ``paged_attention`` at 128 query heads over the one latent "KV head"
     at D 576, K = V = the latent pool, the planned 96-token page: 8
     decode rows at ``DECODE_LENS`` and one page of prefill rows at
     ~1,024 tokens over one table; bf16 (the mla body) and float32 (simt,
     16-head tiles) against the plain version, two bf16 runs
     bit-identical; then the times of mla, simt, plain and gather + SDPA
     beside the bound, and the mla kernel's SASS counts from phase 1;
 16. deepseek-v2-236b at full width cut to 2 layers (the dense one and
     one MoE layer of 160 experts), float32, ~21 GB of weights on each
     side (the host's free memory printed first): prefill in planned
     chunks and one paged decode step on the card and on the CPU; logits
     and the ``lat`` pool agree, and the greedy tokens;
 17. serving: full-width deepseek-v2-236b cut in depth to the deepest
     stack (a dense layer and MoE layers) whose bf16 weights -- the
     parameter tree's bytes -- fit beside the pool (10 of 60 layers,
     74.3 GB), seeded random weights, serving phase 4's trace with every
     paged launch on the mla body; then the card's busy share over a
     2-prompt sub-trace.
 18. whisper-large-v3's kernel shape (the enc_dec family):
     ``paged_attention`` at its decoder self-attention (20 query heads
     over 20 KV heads, group 1, D 64, the planned 16-token page): 8 decode
     rows at ``DECODE_LENS`` and one page of prefill rows over one table;
     bf16 (split) and float32 (simt) against the plain version, two bf16
     runs bit-identical; then the times of split, simt, plain and gather
     + SDPA beside the bound, and the device time of each CUDA kernel;
 19. whisper-large-v3 at full width cut to 2 encoder and 2 decoder
     layers, float32: 2 slots with 1,500 and 600 encoder frames, each
     encoded and its cross K/V installed (``encode_cross``,
     ``reset_slot``), prefill in planned chunks and one paged decode step
     on the card and on the CPU; logits, pool and cross state agree, and
     the greedy tokens;
 20. serving: full-width, full-depth whisper-large-v3 (32 + 32 layers,
     seeded random bf16 weights) on its own trace of 8 requests
     (``WHISPER_FRAMES`` encoder frames, ``WHISPER_PROMPTS`` decoder
     prompts, ``WHISPER_NEW`` new tokens each); every paged launch
     ``split``, one per decoder layer and tick or chunk; then the
     encoder's time per request and the card's busy share over a
     2-request sub-trace.
 21. qwen2-vl-7b (the vlm family, served by the cohort engine only) at
     full width cut to 2 layers, float32: a cohort of 2 requests, each a
     16 x 16 patch grid (256 ``embeds`` at M-RoPE positions (0, row, col))
     then 32 text rows at positions 16..47 on all three streams,
     ``Model.prefill`` into a contiguous cache and 4 ``decode_step``s, on
     the card and on the CPU with the same weights; logits and the K/V
     cache agree within ``SLICE_TOL``, and the greedy tokens;
 22. the cohort engine against the paged engine on the card, float32:
     llama3.2-1b at full width cut to 4 layers and zamba2-1.2b cut to 8
     mixers serve ``AB_LENS`` prompts with ``AB_NEWS`` new tokens over 4
     slots (cohort caches grow and compact, the paged engine backfills);
     greedy tokens equal, and both engines' slot utilization printed;
 23. ``ssd_scan`` at zamba2-1.2b's cohort prefill shapes on phase 24's
     trace (batch 4 x 288, 2 x 1,088 and 2 x 64 tokens, 64 heads of 64,
     state 64; ``COHORT_SSD_SHAPES``), from the zero state
     with the final state out: bf16 (tc) and float32 (simt) against the
     plain version, two bf16 runs bit-identical, then tc, simt and plain
     timed beside the bound;
 24. cohort serving at full width and depth, bf16, seeded random weights,
     8 slots: qwen2-vl-7b (28 layers) on ``COHORT_TRACE`` (4 requests of a
     16 x 16 image and 32 text rows, 2 of a 32 x 32 image and 64, 2 of 64
     text tokens: three cohorts, 64 new tokens each; no hand-written
     kernel on this path), then zamba2-1.2b on the same lengths as token
     prompts, whose every cohort prefill launches ``ssd_scan`` on tc once
     a mixer; wall, decode rate, TTFT, peak memory, cohorts, capacities
     grown, slot utilization and the busy share over a 2-request
     sub-trace for each.

Phases 0-4 and 7-24 plan and serve without a tuning artifact (the port's
tuning path points at a file that does not exist until phase 6 writes
one), so their numbers compare with earlier runs'.  Each phase prints its
seconds.

Output, at the end: one JSON line describing the kernels (the zamba2,
mixtral, deepseek and whisper shapes nested under the paged and SSD
entries, and the cohort engine's ``ssd_scan`` launches and shapes under
``cohort``), the
card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/`` beside it, the script fails before printing results.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: Kernel against plain version, as in tests/test_kernels.py: float32 for
#: blocked-vs-flat summation order, bf16 for the rounding of the output
#: (and of attention's probabilities); relative and absolute alike.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: SSD, as in tests/test_kernels.py: the chunked form against the
#: sequential recurrence.
SSD_TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-4}
#: 2-layer slice, card against CPU, float32 (TF32 off): the same products
#: summed in another order over 2048-wide rows.
SLICE_TOL = dict(rtol=1e-3, atol=1e-3)

ARCH = "llama3.2-1b"
ZAMBA = "zamba2-1.2b"
MIXTRAL = "mixtral-8x7b"
XLSTM = "xlstm-1.3b"
DEEPSEEK = "deepseek-v2-236b"
WHISPER = "whisper-large-v3"
QWEN = "qwen2-vl-7b"
DEVICE = "cuda"
MAX_SLOTS = 8
MAX_LEN = 4096
MAX_NEW = 32
PROMPT_LENS = (64, 1024, 200, 512, 96, 768, 333, 900)
#: Decode-shape lengths: empty, one token, many pages.
DECODE_LENS = (0, 1, 57, 300, 700, 1056, 1000, 64)
LAYER_COPIES = 16       # one pool per layer, as the main path reads them
REPS = 50
#: Phases 10 and 12: mixtral-8x7b's decode rows (some past its 4096-token
#: window) and the long windowed request, served at ``LONG_MAX_LEN``.
MIXTRAL_DECODE_LENS = (0, 1, 700, 2048, 4096, 4097, 4400, 8000)
LONG_PROMPT = 4400
#: Phase 20's trace: encoder frames (six of Whisper's fixed 30-s window,
#: two shorter), decoder prompts (the 4-token start-of-transcript
#: sequence, some after previous-text prompts) and new tokens a request.
WHISPER_FRAMES = (1500, 1500, 1000, 1500, 500, 1500, 1500, 1500)
WHISPER_PROMPTS = (4, 4, 36, 4, 132, 4, 224, 68)
WHISPER_NEW = 64
LONG_MAX_LEN = 8192
#: Card memory phase 12's depth cut leaves beside the weights and the
#: pool: one layer's float32 draw (1.9 GB for the experts' ``wi``),
#: activations, workspaces and the allocator's slack.
MIXTRAL_HEADROOM = 6e9
PROFILE = "--profile" in sys.argv[1:]
#: Phase 5/6 shapes: llama3.2-1b's MLP up-projection and attention over a
#: 4096-token prefill, zamba2-1.2b's SSD mixer (d_inner 2 x 2048 = 64 heads
#: of 64, state 64; configs/archs.py) over 4096 tokens.
MM_SHAPE = (4096, 2048, 8192)
FA_SHAPE = (1, 32, 4096, 64)
SSD_SHAPE = (1, 4096, 64, 64, 64)
BUILD = os.path.join(ROOT, "build", "repro_torch")


def log(*args) -> None:
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``reps`` calls, CUDA
    events.  The card first sleeps (``torch.cuda._sleep``) while the host
    queues all the calls, so the events time the card's work and not the
    host's: a wrapper's Python, allocation and launch cost can exceed a
    small kernel's time.  If queueing outlasted the sleep, the time may
    hold host gaps, and a line says so."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_s = 2 * reps * host_s + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * 2e9))      # cycles at <= 2 GHz
    start.record()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i + 1)
    end.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued_s > sleep_s:
        log(f"    (queueing {reps} calls took {queued_s * 1e3:.1f} ms, more "
            f"than the {sleep_s * 1e3:.1f} ms sleep: host gaps may count)")
    return start.elapsed_time(end) / reps


def profiled_kernels(fn, reps: int, tries: int = 3) -> dict:
    """``{kernel: (device us in all, launches recorded)}`` of ``reps``
    calls of ``fn()`` under ``torch.profiler``.  Late in a long run the
    profiler has been seen to record no kernel, or only some launches, of
    a session: a session that recorded none is tried again, up to
    ``tries`` sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {e.key[:60]: (e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
        if out:
            return out
        log("    (torch.profiler recorded no kernel in this session)")
    return out


def kernel_us(fn, reps: int = 10) -> dict:
    """Device microseconds per launch of each CUDA kernel ``fn()``
    launches (``profiled_kernels``: the mean over the launches the
    profiler recorded)."""
    return {k: round(us / n, 3)
            for k, (us, n) in profiled_kernels(fn, reps).items()}


# ---------------------------------------------------------------------------
# Phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------


def make_case(dtype, lens, t, rows_share_table: bool, copies: int, seed=0,
              cfg=None, max_len=MAX_LEN, window=0):
    """Inputs at the attention width of ``cfg`` (default llama3.2-1b; for
    an MLA config, its latent: ``mla_heads``) on the card, over the
    engine's table for ``max_len`` tokens.

    Decode: one row per slot, each slot with its own pages.  Prefill: the
    rows are one chunk's tokens over ONE table row (``lens`` = positions
    + 1).  ``copies`` pools stand for the model's layers.  With a
    ``window``, the pages the engine's window reclaim has freed (wholly
    below ``len - 1 - window``; for a chunk, below its first row's) are
    null entries (page 0) and hold no pool page, as in serving.  An MLA
    config's V is its K: the one latent pool, as serving passes it.
    """
    cfg = cfg or get_cfg()
    h, kv, d = mla_heads(cfg) if cfg.mla else (cfg.n_heads, cfg.n_kv_heads,
                                               cfg.head_dim)
    np_ = -(-max_len // t)                       # the engine's table width
    need = [-(-n // t) for n in lens]

    def dead(n):
        return max(0, n - 1 - window) // t if window else 0

    gen = torch.Generator().manual_seed(seed)
    if rows_share_table:
        lo, n_live = dead(min(lens)), max(need)
        p_total = 1 + n_live - lo
        perm = torch.randperm(p_total - 1, generator=gen) + 1
        row = torch.zeros(np_, dtype=torch.int32)
        row[lo:n_live] = perm.int()
        table = row[None].expand(len(lens), np_).contiguous()
    else:
        p_total = 1 + sum(n - dead(ln) for n, ln in zip(need, lens))
        perm = (torch.randperm(p_total - 1, generator=gen) + 1).int()
        table = torch.zeros(len(lens), np_, dtype=torch.int32)
        at = 0
        for i, (n, ln) in enumerate(zip(need, lens)):
            table[i, dead(ln):n] = perm[at:at + n - dead(ln)]
            at += n - dead(ln)
    q = torch.randn(len(lens), h, d, generator=gen)
    k = torch.randn(copies, p_total, t, kv, d, generator=gen).to(DEVICE,
                                                                 dtype)
    v = k if cfg.mla else torch.randn(copies, p_total, t, kv, d,
                                      generator=gen).to(DEVICE, dtype)
    dev = DEVICE
    return dict(q=q.to(dev, dtype), k=k, v=v, table=table.to(dev),
                lengths=torch.tensor(lens, dtype=torch.int32, device=dev))


def mla_heads(cfg) -> tuple:
    """(query heads, KV heads, head dim) of an MLA config's paged call:
    every query head over the one latent row of ``kv_lora_rank +
    rope_head_dim`` (DeepSeek-V2: 128 over 1 at 576)."""
    m = cfg.mla
    return cfg.n_heads, 1, m.kv_lora_rank + m.rope_head_dim


def live_work(case, window: int):
    """(bytes, operations) the function needs on these inputs: q, table,
    lengths and the output once, and each live K/V token of the pool once
    (rows that share a page read it once; where K and V are one tensor, as
    MLA's latent pool, its token once); 4 flops per live (row, key, query
    head, dim): q.k and p.v."""
    q, kp, table, lengths = case["q"], case["k"], case["table"], case["lengths"]
    s, h, d = q.shape
    _, p_total, t, kv, _ = kp.shape
    np_ = table.shape[1]
    tab = table.cpu().long()
    live = torch.zeros(p_total, t, dtype=torch.bool)
    pairs = 0
    for i, n in enumerate(lengths.cpu().tolist()):
        if n <= 0:
            continue
        hi = min(n - 1, np_ * t - 1)
        lo = max(0, n - window) if window else 0
        if hi < lo:
            continue
        pos = torch.arange(lo, hi + 1)
        live[tab[i, pos // t], pos % t] = True
        pairs += hi - lo + 1
    el = q.element_size()
    kv_reads = 1 if case["v"] is kp else 2
    nbytes = (2 * q.numel() * el + tab.numel() * 4 + s * 4
              + int(live.sum()) * kv_reads * kv * d * el)
    return nbytes, 4 * pairs * h * d


def library_attention(q, kp, vp, table, lengths, window,
                      fold_group=False):
    """Yardstick only (the port never calls it): gather the pages, then
    ``scaled_dot_product_attention`` with grouped heads and a length mask.
    ``fold_group`` puts a KV head's G query heads on the query-length axis
    instead (the same function, and SDPA does not repeat K and V G times:
    at MLA's 128 heads over one 576-wide latent that would be 58 GB for a
    prefill chunk)."""
    import torch.nn.functional as F

    s, h, d = q.shape
    kv = kp.shape[2]
    idx = table.long()
    k = kp[idx].reshape(s, -1, kv, d).transpose(1, 2)
    v = vp[idx].reshape(s, -1, kv, d).transpose(1, 2)
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    qpos = lengths.long()[:, None] - 1
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if fold_group:
        return F.scaled_dot_product_attention(
            q.reshape(s, kv, h // kv, d), k, v,
            attn_mask=mask[:, None, None, :]).reshape(s, h, d)
    return F.scaled_dot_product_attention(
        q[:, :, None, :], k, v, attn_mask=mask[:, None, None, :],
        enable_gqa=True)[:, :, 0]


def bound_ms(nbytes: int, ops: int, dtype) -> tuple:
    """The least time one H100 SXM could take (its published peaks, 700 W):
    the larger of bytes over HBM bandwidth and operations over the peak
    rate of the inputs' type; and which of the two it is."""
    from repro_torch.hw.h100 import h100_spec

    spec = h100_spec()
    peak = {torch.bfloat16: spec.peak_bf16_flops,
            torch.float32: spec.peak_f32_flops}[dtype]
    t_bytes = nbytes / spec.hbm_bw * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


#: The paged kernel's bodies, each with its launch counter.
PAGED_BODIES = ("split", "mla", "simt")


def counters(mod, bodies) -> dict:
    return {p: getattr(mod, f"LAUNCHES_{p.upper()}") for p in bodies}


def body(mod, before, what) -> str:
    """The one body the calls since ``before`` (``counters``) ran."""
    moved = {p: getattr(mod, f"LAUNCHES_{p.upper()}") - before[p]
             for p in before}
    ran = [p for p, n in moved.items() if n]
    assert len(ran) == 1, f"{what}: launches by body {moved}"
    return ran[0]


def paged_timing(pa_mod, name, lens, shared, t, cfg, split_sizes=(),
                 max_len=MAX_LEN, window=0) -> dict:
    """Times of ``paged_attention`` at one shape of ``cfg``, bf16: the
    routed body, the simt body (``ms_simt``), the plain version, gather +
    SDPA, the bound, the device time of each CUDA kernel and, for
    ``split_sizes``, the time at other pages per split.  ``max_len`` and
    ``window`` as in ``make_case``."""
    from repro_torch.kernels.paged_attention import (mla_split_plan,
                                                     paged_attention,
                                                     split_plan)
    from repro_torch.kernels.ref import paged_attention_ref

    case = make_case(torch.bfloat16, lens, t, shared, LAYER_COPIES, cfg=cfg,
                     max_len=max_len, window=window)
    q, kp, vp = case["q"], case["k"], case["v"]
    table, lengths = case["table"], case["lengths"]

    def layer(i):
        return kp[i % LAYER_COPIES], vp[i % LAYER_COPIES]

    def run_kernel(i, path=None, split_pages=None):
        kl, vl = layer(i)
        paged_attention(q, kl, vl, table, lengths, window=window,
                        page_tokens=t, path=path, split_pages=split_pages)

    def run_ref(i):
        kl, vl = layer(i)
        paged_attention_ref(q, kl, vl, table, lengths, window=window)

    def run_lib(i):
        kl, vl = layer(i)
        library_attention(q, kl, vl, table, lengths, window,
                          fold_group=cfg.mla is not None)

    nbytes, ops = live_work(case, window)
    bound, bound_by = bound_ms(nbytes, ops, torch.bfloat16)
    n_kv = kp.shape[3]
    splits, pages = (
        mla_split_plan(len(lens), n_kv, q.shape[1] // n_kv, table.shape[1], t)
        if cfg.mla else split_plan(len(lens), n_kv, table.shape[1], t))
    before = counters(pa_mod, PAGED_BODIES)
    ms = cuda_ms(run_kernel)
    row = {
        "ms": ms, "path": body(pa_mod, before, f"paged {name} timing"),
        "ms_simt": cuda_ms(lambda i: run_kernel(i, path="simt")),
        "ms_again": cuda_ms(run_kernel),
        "plain_ms": cuda_ms(run_ref, reps=10),
        "library_ms": cuda_ms(run_lib, reps=10),
        "bound_ms": bound, "bound_by": bound_by,
        "bytes": nbytes, "ops": ops, "rows": len(lens),
        "splits": splits, "split_pages": pages,
    }
    row["kernels_us"] = kernel_us(lambda: run_kernel(0))
    log(f"    {name} kernels (torch.profiler, us per call): "
        + json.dumps(row["kernels_us"]))
    log(f"  time bf16 {name:7s} rows={len(lens)} ({row['path']}, "
        f"{splits} splits of {pages} pages): kernel_ms={row['ms']:.4f} "
        f"(again {row['ms_again']:.4f}) ms_simt={row['ms_simt']:.4f} "
        f"ref_ms={row['plain_ms']:.4f} library_ms="
        f"{row['library_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
        f"({row['bound_by']}, {nbytes} B, {ops} flop) "
        f"share_of_bound={row['bound_ms'] / row['ms']:.3f}")
    if split_sizes:
        row["ms_by_split_pages"] = {
            sp: cuda_ms(lambda i, sp=sp: run_kernel(i, split_pages=sp))
            for sp in split_sizes}
        log(f"    {name} ms by pages per split: " + json.dumps(
            {k: round(v, 5) for k, v in row["ms_by_split_pages"].items()}))
    return row


def paged_checks(pa_mod, shapes, t, cfg, windows, max_len=MAX_LEN,
                 null_window=0, bf16_body="split") -> tuple:
    """``paged_attention`` against its plain version at each of ``shapes``
    (name -> (lens, rows share one table)) of ``cfg``, bf16 and float32,
    at each window: within ``TOL``, two runs bit-identical, empty rows
    zero, bf16 on ``bf16_body`` and float32 on simt.  ``max_len`` and
    ``null_window`` (``make_case``'s ``window``) shape the tables.
    Returns the worst error by (dtype, shape) and the body by shape."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref

    worst, bodies = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (lens, shared) in shapes.items():
            case = make_case(dtype, lens, t, shared, copies=1, cfg=cfg,
                             max_len=max_len, window=null_window)
            live = case["lengths"] > 0
            for window in windows:
                args = (case["q"], case["k"][0], case["v"][0],
                        case["table"], case["lengths"])
                before = counters(pa_mod, PAGED_BODIES)
                out = paged_attention(*args, window=window, page_tokens=t)
                again = paged_attention(*args, window=window, page_tokens=t)
                torch.cuda.synchronize()
                ran = body(pa_mod, before, f"paged {name}")
                ref = paged_attention_ref(*args, window=window)
                err = (out.float() - ref.float())[live].abs()
                bound = TOL[dtype] * (1 + ref.float()[live].abs())
                ok = bool((err <= bound).all())
                same = torch.equal(out, again)
                key = (str(dtype).split(".")[-1], name)
                worst[key] = max(worst.get(key, 0.0), float(err.max()))
                bodies[f"{key[0]}/{name}"] = ran
                log(f"  check {key[0]:8s} {name:8s} window={window:3d} "
                    f"{ran:5s}: max_abs_err={float(err.max()):.3e} "
                    f"(tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}, "
                    f"repeat {'bit-identical' if same else 'DIFFERS'}")
                if not ok:
                    raise AssertionError(
                        f"kernel disagrees with its plain version: {key}, "
                        f"window {window}")
                assert same, f"two runs differ: {key}, window {window}"
                assert not out[~live].float().abs().any(), "empty row not 0"
    assert all(b == (bf16_body if k.startswith("bfloat16") else "simt")
               for k, b in bodies.items()), bodies
    return worst, bodies


def phase_kernel(t: int) -> dict:
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels.paged_attention import split_plan

    prefill_pos0 = 8 * t
    np_ = -(-MAX_LEN // t)
    _, pages = split_plan(len(DECODE_LENS), get_cfg().n_kv_heads, np_, t)
    span = pages * t
    shapes = {
        "decode": (DECODE_LENS, False),
        "prefill": (tuple(range(prefill_pos0 + 1, prefill_pos0 + t + 1)),
                    True),
        # rows whose last key ends a split (and one that ends just before)
        "boundary": ((span, 2 * span, 9 * span, 1, 3 * span - 1, 0,
                      5 * span, span + 1), False),
    }
    worst, bodies = paged_checks(pa_mod, shapes, t, get_cfg(), (0, 256))

    timings = {}
    for name in ("decode", "prefill"):
        lens, shared = shapes[name]
        timings[name] = paged_timing(pa_mod, name, lens, shared, t,
                                     get_cfg(), split_sizes=(1, 2, 3, 4, 8))
    log("  phase 2 bodies: " + json.dumps(bodies))
    log("  phase 2 max_abs_err: " + json.dumps(
        {f"{a}/{b}": e for (a, b), e in worst.items()}))
    assert timings["prefill"]["ms"] <= timings["prefill"]["ms_simt"], \
        "the split body is slower than simt at the prefill shape"
    return {"timings": timings,
            "max_abs_err": worst[("bfloat16", "decode")]}


# ---------------------------------------------------------------------------
# Phase 3: the 2-layer slice on the card against the CPU
# ---------------------------------------------------------------------------


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_slice(t: int) -> None:
    from repro_torch.models.model import Model
    from repro_torch.serve.pages import init_paged_cache

    cfg = dataclasses.replace(get_cfg(), n_layers=2)
    model = Model(cfg)
    params = {"cpu": model.init(seed=0, device="cpu")}
    params[DEVICE] = tree_to(params["cpu"], DEVICE)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (t, 40)]
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    res = {}
    for dev in ("cpu", DEVICE):
        cache = init_paged_cache(cfg, 2, 5, t, 2, torch.float32, dev)
        cache["table"] = table.to(dev)
        firsts = []
        with torch.no_grad():
            for slot, p in enumerate(prompts):
                logits, cache = model.prefill_chunk(
                    params[dev], cache,
                    {"tokens": torch.from_numpy(p)[None].to(dev),
                     "pos0": 0, "slot": slot}, dtype=torch.float32)
                firsts.append(logits)
            toks = torch.stack([lg.argmax(-1) for lg in firsts])  # (2, 1)
            cache["pos"] = torch.tensor([len(p) for p in prompts],
                                        dtype=torch.int32, device=dev)
            dec, cache = model.decode_step_paged(
                params[dev], cache, {"tokens": toks}, dtype=torch.float32)
        res[dev] = (torch.cat(firsts).cpu(), dec.cpu(),
                    cache["pool"]["k"].cpu())
    (pc, dc, kc), (pg, dg, kg) = res["cpu"], res[DEVICE]
    for name, a, b in (("prefill logits", pg, pc), ("decode logits", dg, dc),
                       ("K pool", kg, kc)):
        err = float((a - b).abs().max())
        log(f"  {name}: max_abs_err={err:.3e} (shape {tuple(a.shape)})")
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, **SLICE_TOL)
    tok_c = (pc.argmax(-1).tolist(), dc.argmax(-1).tolist())
    tok_g = (pg.argmax(-1).tolist(), dg.argmax(-1).tolist())
    log(f"  greedy tokens cuda={tok_g} cpu={tok_c}")
    assert tok_g == tok_c, "greedy tokens differ between cuda and cpu"


# ---------------------------------------------------------------------------
# Phase 4: serving full-width llama3.2-1b
# ---------------------------------------------------------------------------


def serve_trace(cfg, mods: dict, warm_prompts,
                kv_budget_bytes=None, prompts=None,
                max_new: int = MAX_NEW) -> tuple:
    """``ServeEngine`` on ``cfg`` (seeded random bf16 weights, paged
    batching, chunked prefill, ``MAX_SLOTS`` slots, ``MAX_LEN``, the
    engine's KV budget unless ``kv_budget_bytes`` is given) serving
    ``prompts`` (default: ``PROMPT_LENS`` seeded token prompts) of
    ``max_new`` tokens each, after a warm-up engine (same weights) served
    ``warm_prompts`` of them.  Every launch counter of ``mods`` is set to 0
    just before the main path's run and read just after it.  Returns
    ``(row, outputs, engine, prompts)``."""
    from repro_torch.serve import ServeEngine, ServePolicy

    policy = ServePolicy(batching="paged", prefill="chunked",
                         max_slots=MAX_SLOTS, max_len=MAX_LEN,
                         max_new_tokens=max_new,
                         kv_budget_bytes=kv_budget_bytes)
    if prompts is None:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
                   for n in PROMPT_LENS]
    t0 = time.perf_counter()
    warm = ServeEngine(cfg, policy, dtype=torch.bfloat16, seed=0,
                       device=DEVICE)
    t1 = time.perf_counter()
    warm.generate([prompts[i] for i in warm_prompts], max_new_tokens=2)
    torch.cuda.synchronize()
    log(f"  seeded weights on the card: {t1 - t0:.1f} s; warm-up run: "
        f"{time.perf_counter() - t1:.1f} s")
    engine = ServeEngine(cfg, policy, dtype=torch.bfloat16,
                         params=warm.params, device=DEVICE)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    names = ("LAUNCHES", "LAUNCHES_SPLIT", "LAUNCHES_MLA", "LAUNCHES_TC",
             "LAUNCHES_SIMT")
    for mod in mods.values():       # the main path's run starts here
        for name in names:
            if hasattr(mod, name):
                setattr(mod, name, 0)
    t0 = time.perf_counter()
    outs = engine.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: {n: getattr(mod, n) for n in names if hasattr(mod, n)}
                for k, mod in mods.items()}           # ... and ends here
    m = engine.metrics
    steps, chunks = int(m["decode_steps"]), int(m["prefill_chunks"])
    events = engine.tracer.export_events()
    submit = {e["tid"]: e["ts"] for e in events if e["name"] == "submit"}
    ttft = sorted((e["ts"] - submit[e["tid"]]) / 1e6 for e in events
                  if e["name"] == "first_token")
    ticks = [e for e in events if e["name"] == "decode_tick"]
    last_chunk = max(e["ts"] + e["dur"] for e in events
                     if e["name"] == "prefill_chunk")
    steady = [e for e in ticks if e["ts"] >= last_chunk]
    decode_tok_s = (sum(e["args"]["active"] for e in ticks)
                    / (sum(e["dur"] for e in ticks) / 1e6))
    steady_tok_s = (sum(e["args"]["active"] for e in steady)
                    / (sum(e["dur"] for e in steady) / 1e6)) if steady \
        else float("nan")
    row = {
        "arch": cfg.arch, "layers": cfg.n_layers,
        "tokens": int(m["tokens"]), "wall_s": wall,
        "decode_steps": steps, "prefill_chunks": chunks,
        "decode_tok_s": decode_tok_s,
        "decode_tok_s_after_prefill": steady_tok_s,
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "page_tokens": int(m["page_tokens"]),
        "pages_total": int(m["pages_total"]),
        "pages_per_slot": int(m["pages_per_slot"]),
        "pages_allocated": int(m["pages_allocated"]),
        "pages_released": int(m["pages_released"]),
        "backfills": int(m["backfills"]), "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("  serve: " + json.dumps(row))
    assert [len(o) for o in outs] == [max_new] * len(prompts), \
        [len(o) for o in outs]
    assert all(0 <= tok < cfg.vocab_size for o in outs for tok in o)
    assert row["pages_allocated"] == row["pages_released"]
    return row, outs, engine, prompts


def phase_serve(pa_mod) -> dict:
    cfg = get_cfg()
    row, _, engine, prompts = serve_trace(cfg, {"paged": pa_mod}, (0, 1))
    launches = row["LAUNCHES"] = row["launches"]["paged"]["LAUNCHES"]
    split = row["LAUNCHES_SPLIT"] = \
        row["launches"]["paged"]["LAUNCHES_SPLIT"]
    steps, chunks = row["decode_steps"], row["prefill_chunks"]
    assert launches > 0, "the main path never launched the kernel"
    assert launches == split == cfg.n_layers * (steps + chunks), \
        (launches, split, cfg.n_layers, steps, chunks)
    if PROFILE:
        profile_serve(engine, prompts, row["wall_s"])
    return row


def profile_serve(engine, prompts, unprofiled_wall_s: float,
                  max_new=None) -> tuple:
    """Device time by kernel over one more generate call of the same
    prompts under ``torch.profiler``.  The card's busy share is printed
    and returned twice: over this call's wall time (the profiler's own
    host cost included), and over the wall time of the unprofiled call
    before it (same prompts, same tokens; two calls, so an estimate)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, max_new_tokens=max_new)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    log(avgs.table(sort_by="self_cuda_time_total", row_limit=30))
    # Kernel rows only: an operator's row repeats its kernels' time.
    busy_us = sum(e.self_device_time_total for e in avgs
                  if e.device_type == DeviceType.CUDA)
    log(f"  profile: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, busy share {busy_us / wall_us:.3f}; "
        f"over the unprofiled call's wall {unprofiled_wall_s * 1e3:.1f} ms: "
        f"{busy_us / (unprofiled_wall_s * 1e6):.3f}")
    return busy_us / wall_us, busy_us / (unprofiled_wall_s * 1e6)


# ---------------------------------------------------------------------------
# Phase 5: the tuning path's kernels against their plain versions
# ---------------------------------------------------------------------------


def held_to(out, ref, tol: float, what: str, rows=None) -> float:
    """Max abs error of ``out`` against ``ref``; raises unless every element
    is within ``tol * (1 + |ref|)`` (``rows``: a mask over dim 2, the query
    rows that are defined)."""
    diff = (out.float() - ref.float())
    r = ref.float()
    if rows is not None:
        diff, r = diff[:, :, rows], r[:, :, rows]
    err = diff.abs()
    ok = bool((err <= tol * (1 + r.abs())).all())
    assert bool(torch.isfinite(out.float()).all()), f"{what}: not finite"
    log(f"  check {what}: max_abs_err={float(err.max()):.3e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{what}")
    return float(err.max())


def randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEVICE)
            * scale).to(dtype)


def ssd_inputs(gen, b, s, h, p, n, dtype):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1)) / 2 and
    A = -exp(0.3 N(0, 1)) in float32, as the reference's tests make them."""
    x = randn(gen, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=DEVICE)) * 0.5
    A = -torch.exp(torch.randn((h,), generator=gen, device=DEVICE) * 0.3)
    return x, dt, A, randn(gen, (b, s, n), dtype), randn(gen, (b, s, n),
                                                         dtype)


def phase_tuning_kernels() -> dict:
    """Each kernel against its plain version at full width in bf16 and
    float32 plus a ragged case, then its times (bf16)."""
    import torch.nn.functional as F

    from repro_torch.core.autotile import plan_attention, plan_matmul
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import matmul_cc as mm_mod
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_cc import matmul_cc
    from repro_torch.kernels.ref import (flash_attention_ref, matmul_ref,
                                         ssd_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.mamba2 import choose_chunk

    from repro_torch.kernels import ssd_scan as ssd_mod

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    worst = {}
    paths = {}
    wg = ("wgmma", "simt")

    # matmul_cc: B scaled by 1/sqrt(K), as weights are initialised, so the
    # products sum to O(1) values and float32's 1e-4 measures the kernel.
    for dtype, (m, k, n) in ((torch.bfloat16, MM_SHAPE),
                             (torch.float32, MM_SHAPE),
                             (torch.bfloat16, (4000, 2000, 8000))):
        a = randn(gen, (m, k), dtype)
        b = randn(gen, (k, n), dtype, scale=k ** -0.5)
        plan = plan_matmul(m, k, n, dtype_bytes=a.element_size())
        before = counters(mm_mod, wg)
        cc = matmul_cc(a, b, plan=plan)
        srrc = matmul_cc(a, b, plan=dataclasses.replace(plan, order="srrc"))
        torch.cuda.synchronize()
        path = body(mm_mod, before, "matmul_cc")
        assert torch.equal(cc, srrc), "cc and srrc differ"
        what = f"matmul_cc {str(dtype)[6:]} {m}x{k}x{n} tile {plan.bm}x" \
            f"{plan.bk}x{plan.bn} {path} (cc == srrc bit for bit)"
        paths[f"matmul_cc {str(dtype)[6:]} {m}x{k}x{n}"] = path
        err = held_to(cc, matmul_ref(a, b), TOL[dtype], what)
        worst[("matmul_cc", dtype)] = max(
            worst.get(("matmul_cc", dtype), 0.0), err)
    # flash_attention, causal; the ragged case has Sq < Sk (every row sees
    # a key) and lengths off every block.
    b_, h_, s_, d_ = FA_SHAPE
    for dtype, sq, sk in ((torch.bfloat16, s_, s_), (torch.float32, s_, s_),
                          (torch.bfloat16, 1000, 4000)):
        q = randn(gen, (b_, h_, sq, d_), dtype)
        k = randn(gen, (b_, h_, sk, d_), dtype)
        v = randn(gen, (b_, h_, sk, d_), dtype)
        before = counters(fa_mod, wg)
        out, plan = flash_attention(q, k, v, causal=True, return_plan=True)
        torch.cuda.synchronize()
        path = body(fa_mod, before, "flash_attention")
        paths[f"flash_attention {str(dtype)[6:]} ({b_},{h_},{sq},{sk},"
              f"{d_})"] = path
        what = (f"flash_attention {str(dtype)[6:]} ({b_},{h_},{sq},{sk},"
                f"{d_}) blocks {plan.block_q}/{plan.block_kv} {path}")
        err = held_to(out, flash_attention_ref(q, k, v), TOL[dtype], what)
        worst[("flash_attention", dtype)] = max(
            worst.get(("flash_attention", dtype), 0.0), err)
        del q, k, v, out
    # ssd_scan at the planner's chunk; the ragged case ends mid-chunk.
    bs, ss, hs, ps, ns = SSD_SHAPE
    for dtype, s in ((torch.bfloat16, ss), (torch.float32, ss),
                     (torch.bfloat16, 4000)):
        chunk = choose_chunk(s, hs, ps, ns, dtype_bytes=dtype.itemsize)
        args = ssd_inputs(gen, bs, s, hs, ps, ns, dtype)
        before = counters(ssd_mod, ("tc", "simt"))
        y = ssd_scan(*args, chunk=chunk)
        again = ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        path = body(ssd_mod, before, "ssd_scan")
        assert torch.equal(y, again), "ssd_scan: two runs differ"
        paths[f"ssd_scan {str(dtype)[6:]} ({bs},{s},{hs},{ps},{ns})"] = path
        what = f"ssd_scan {str(dtype)[6:]} ({bs},{s},{hs},{ps},{ns}) " \
            f"chunk {chunk} {path} (repeat bit-identical)"
        err = held_to(y, ssd_ref(*args), SSD_TOL[dtype], what)
        worst[("ssd_scan", dtype)] = max(
            worst.get(("ssd_scan", dtype), 0.0), err)

    # Times, bf16, full width: the routed (wgmma) body at the planner's
    # blocks, and the simt body at its own planner's blocks, in turns.
    rows = {}
    m, k, n = MM_SHAPE
    a = randn(gen, (m, k), torch.bfloat16)
    b = randn(gen, (k, n), torch.bfloat16, scale=k ** -0.5)
    plan = plan_matmul(m, k, n, dtype_bytes=2)
    simt_plan = plan_matmul(m, k, n, dtype_bytes=2, path="simt")
    before = counters(mm_mod, wg)
    ms = cuda_ms(lambda i: matmul_cc(a, b, plan=plan), reps=20)
    path = body(mm_mod, before, "matmul_cc timing")
    rows["matmul_cc"] = dict(
        ms=ms, path=path,
        ms_simt=cuda_ms(lambda i: matmul_cc(a, b, plan=simt_plan,
                                            path="simt"), reps=5),
        blocks=f"{plan.bm}x{plan.bk}x{plan.bn}",
        blocks_simt=f"{simt_plan.bm}x{simt_plan.bk}x{simt_plan.bn}",
        plain_ms=cuda_ms(lambda i: matmul_ref(a, b), reps=10),
        library_ms=cuda_ms(lambda i: torch.matmul(a, b), reps=20),
        bytes=(m * k + k * n + m * n) * 2, ops=2 * m * n * k,
        library="torch.matmul")
    rows["matmul_cc"]["ms_again"] = cuda_ms(
        lambda i: matmul_cc(a, b, plan=plan), reps=20)
    del a, b
    q, k_, v = (randn(gen, FA_SHAPE, torch.bfloat16) for _ in range(3))
    fa_plan = plan_attention(s_, s_, d_, dtype_bytes=2)
    fa_simt = plan_attention(s_, s_, d_, dtype_bytes=2, path="simt")
    before = counters(fa_mod, wg)
    ms = cuda_ms(lambda i: flash_attention(q, k_, v, plan=fa_plan), reps=20)
    path = body(fa_mod, before, "flash_attention timing")
    rows["flash_attention"] = dict(
        ms=ms, path=path,
        ms_simt=cuda_ms(lambda i: flash_attention(q, k_, v, plan=fa_simt,
                                                  path="simt"), reps=5),
        blocks=f"{fa_plan.block_q}/{fa_plan.block_kv}",
        blocks_simt=f"{fa_simt.block_q}/{fa_simt.block_kv}",
        plain_ms=cuda_ms(lambda i: flash_attention_ref(q, k_, v), reps=3),
        library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
            q, k_, v, is_causal=True), reps=20),
        bytes=4 * b_ * h_ * s_ * d_ * 2,
        ops=4 * b_ * h_ * d_ * (s_ * (s_ + 1) // 2),   # the causal half
        library="scaled_dot_product_attention(is_causal=True)")
    rows["flash_attention"]["ms_again"] = cuda_ms(
        lambda i: flash_attention(q, k_, v, plan=fa_plan), reps=20)
    del q, k_, v
    chunk = choose_chunk(ss, hs, ps, ns, dtype_bytes=2)
    args = ssd_inputs(gen, bs, ss, hs, ps, ns, torch.bfloat16)
    nq = -(-ss // chunk)
    tri = chunk * (chunk + 1) // 2
    before = counters(ssd_mod, ("tc", "simt"))
    ms = cuda_ms(lambda i: ssd_scan(*args, chunk=chunk), reps=20)
    path = body(ssd_mod, before, "ssd_scan timing")
    rows["ssd_scan"] = dict(
        ms=ms, path=path,
        ms_simt=cuda_ms(lambda i: ssd_scan(*args, chunk=chunk,
                                           path="simt"), reps=5),
        blocks=f"chunk {chunk}", blocks_simt=f"chunk {chunk}",
        # the tc body's float32 chunk states (B, nc, H, N, P): written by
        # pass 1, read and rewritten by pass 2, read by pass 3
        workspace_bytes=bs * nq * hs * ns * ps * 4,
        plain_ms=cuda_ms(lambda i: ssd_ref(*args), reps=1),
        library_ms=None,
        # x and y (bf16), dt (float32), A, B and C, each once.
        bytes=(2 * bs * ss * hs * ps * 2 + bs * ss * hs * 4 + hs * 4
               + 2 * bs * ss * ns * 2),
        # per chunk and head: C.B over the lower triangle, the intra- and
        # inter-chunk terms of y, the state update.
        ops=bs * hs * nq * (2 * tri * ns + 2 * tri * ps
                            + 2 * chunk * ns * ps + 2 * chunk * ns * ps),
        library="none: no single PyTorch call computes the SSD scan")
    rows["ssd_scan"]["ms_again"] = cuda_ms(
        lambda i: ssd_scan(*args, chunk=chunk), reps=20)
    rows["ssd_scan"]["kernels_us"] = kernel_us(
        lambda: ssd_scan(*args, chunk=chunk))
    log("    ssd_scan tc kernels (torch.profiler, us per call): "
        + json.dumps(rows["ssd_scan"]["kernels_us"]))

    log(f"  ssd_scan tc workspace: {rows['ssd_scan']['workspace_bytes']} B "
        f"of float32 chunk states at chunk {chunk} (x4 with its reads and "
        f"rewrites: {4 * rows['ssd_scan']['workspace_bytes']} B of traffic)")
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"],
                                                    torch.bfloat16)
        row["max_abs_err"] = worst[(name, torch.bfloat16)]
        lib = ("null" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        log(f"  time bf16 {name} ({row['path']}): kernel_ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={lib} "
            f"({row['library']}) bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}, {row['bytes']} B, {row['ops']} flop) "
            f"share_of_bound={row['bound_ms'] / row['ms']:.4f}")
        lib_ratio = ("no library call" if row["library_ms"] is None else
                     f"{row['ms'] / row['library_ms']:.2f}x the library call")
        log(f"    {name}: {row['path']} {row['ms']:.4f} ms (again "
            f"{row['ms_again']:.4f}) at {row['blocks']}, simt "
            f"{row['ms_simt']:.4f} ms at {row['blocks_simt']}: "
            f"{row['ms_simt'] / row['ms']:.1f}x faster; {lib_ratio}, "
            f"{row['ops'] / row['ms'] / 1e9:.1f} TFLOP/s")
    log("  phase 5 bodies: " + json.dumps(paths))
    log("  phase 5 max_abs_err: " + json.dumps(
        {f"{a}/{str(b)[6:]}": e for (a, b), e in worst.items()}))
    for name, want in (("matmul_cc", "wgmma"), ("flash_attention", "wgmma"),
                       ("ssd_scan", "tc")):
        assert rows[name]["path"] == want, (name, rows[name]["path"])
        assert rows[name]["ms"] < rows[name]["ms_simt"], name
    assert [p for c, p in paths.items() if "bfloat16" in c] == \
        ["wgmma"] * 4 + ["tc"] * 2, paths
    assert [p for c, p in paths.items() if "float32" in c] == \
        ["simt"] * 3, paths
    return rows


# ---------------------------------------------------------------------------
# Phase 6: the tuning path at full width
# ---------------------------------------------------------------------------


def phase_tune(mods) -> dict:
    from repro_torch.core.autotile import plan_attention
    from repro_torch.core.plan import PlanPolicy, Workload, plan_run
    from repro_torch.hw.h100 import h100_spec
    from repro_torch.kernels import (flash_attention, matmul_cc,
                                     paged_attention, ssd_scan)
    from repro_torch.launch.tune import main as tune_main
    from repro_torch.launch.tune import print_report
    from repro_torch.models.mamba2 import choose_chunk
    from repro_torch.serve.engine import plan_decode
    from repro_torch.tune.cache import (TUNING_ENV, hw_fingerprint,
                                        lookup_tuned, record_tuned)
    from repro_torch.tune.sweep import (sweep_attention, sweep_matmul,
                                        sweep_paged, sweep_ssd)

    artifact = os.path.join(BUILD, "tuning_chip_smoke.json")
    if os.path.exists(artifact):
        os.remove(artifact)
    os.environ[TUNING_ENV] = artifact
    cfg = get_cfg()
    bs, ss, hs, ps, ns = SSD_SHAPE
    for mod in mods.values():              # the main path's run starts here
        for name in ("LAUNCHES", "LAUNCHES_WGMMA", "LAUNCHES_SPLIT",
                     "LAUNCHES_TC", "LAUNCHES_SIMT"):
            if hasattr(mod, name):
                setattr(mod, name, 0)
    t0 = time.perf_counter()
    results = [
        sweep_matmul(*MM_SHAPE, dtype_bytes=2),
        sweep_attention(FA_SHAPE[2], FA_SHAPE[2], FA_SHAPE[3], dtype_bytes=2,
                        heads=FA_SHAPE[1], batch=FA_SHAPE[0]),
        sweep_paged(max_tokens=MAX_LEN, n_kv=cfg.n_kv_heads,
                    group=cfg.n_heads // cfg.n_kv_heads,
                    head_dim=cfg.head_dim, slots=MAX_SLOTS, dtype_bytes=2),
        sweep_ssd(ss, hs, ps, ns, dtype_bytes=2, batch=bs),
    ]
    torch.cuda.synchronize()
    launches = {name: mod.LAUNCHES for name, mod in mods.items()}  # ... ends
    fast = {"matmul_cc": "wgmma", "flash_attention": "wgmma",
            "paged_attention": "split", "ssd_scan": "tc"}
    by_body = {name: counters(mods[name], (fast[name], "simt"))
               for name in fast}
    log(f"  sweeps: {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps(launches)}, by body {json.dumps(by_body)}")
    assert all(by_body[n][fast[n]] == launches[n] for n in fast), \
        "a full-width bf16 sweep left its tensor-core body"
    assert print_report(results), "a candidate breaks its budget"
    for r in results:
        assert r.candidates and r.center in [c.block for c in r.candidates], \
            f"{r.kernel}: the analytic centre does not fit"
        assert r.entry is not None, f"{r.kernel}: no winner"
    # Every candidate's working-set estimate is the kernel's own.
    g = cfg.n_heads // cfg.n_kv_heads
    mm_path = matmul_cc.matmul_path(*MM_SHAPE, torch.bfloat16)
    fa_path = flash_attention.attention_path(FA_SHAPE[2], FA_SHAPE[2],
                                             FA_SHAPE[3], torch.bfloat16)
    smem = {
        "matmul_cc": lambda b: matmul_cc.kernel_smem_bytes(
            b["bm"], b["bk"], b["bn"], torch.bfloat16, mm_path),
        "flash_attention": lambda b: flash_attention.kernel_smem_bytes(
            b["block_q"], b["block_kv"], FA_SHAPE[3], torch.bfloat16,
            fa_path),
        "paged_attention": lambda b: paged_attention.kernel_smem_bytes(
            g, cfg.head_dim, b["page_tokens"],
            paged_attention.paged_path(torch.bfloat16, cfg.head_dim,
                                       b["page_tokens"], g)),
        "ssd_scan": lambda b: ssd_scan.kernel_smem_bytes(
            b["chunk"], ps, ns,
            ssd_scan.ssd_path(torch.bfloat16, b["chunk"], ps, ns)),
    }
    for r in results:
        for c in r.candidates:
            got = smem[r.kernel](c.block)
            assert c.est_vmem_bytes == got, (r.kernel, c.block,
                                             c.est_vmem_bytes, got)
    log(f"  estimates: all {sum(len(r.candidates) for r in results)} "
        f"candidates' shared memory equals the kernels' *_smem_bytes "
        f"(matmul_cc {mm_path}, flash_attention {fa_path}): " + json.dumps(
            {r.kernel: {json.dumps(c.block): c.est_vmem_bytes
                        for c in r.candidates} for r in results}))
    path = record_tuned([r.entry for r in results])
    fp = hw_fingerprint()
    assert fp.startswith("cuda:") and all(
        r.entry.fingerprint == fp for r in results)
    with open(path) as f:
        log(f"  wrote {path} ({len(json.load(f)['entries'])} entries, "
            f"fingerprint {fp})")
    win = {r.kernel: r.entry.block for r in results}
    # The planner returns each winner as tuned.
    fa = plan_attention(FA_SHAPE[2], FA_SHAPE[2], FA_SHAPE[3], dtype_bytes=2)
    assert fa.source == "tuned" and {"block_q": fa.block_q,
                                     "block_kv": fa.block_kv} == \
        win["flash_attention"], fa
    spec = h100_spec()
    tile = plan_run(spec.hierarchy(), Workload(matmul=MM_SHAPE,
                                               dtype_bytes=2),
                    PlanPolicy(spec=spec)).tile_plan()
    assert tile.source == "tuned" and {"bm": tile.bm, "bk": tile.bk,
                                       "bn": tile.bn} == win["matmul_cc"]
    chunk = choose_chunk(ss, hs, ps, ns, dtype_bytes=2)
    assert lookup_tuned("ssd_scan", spec.name, results[3].bucket) \
        and chunk == win["ssd_scan"]["chunk"]
    page = plan_decode(cfg, max_len=MAX_LEN, batch=MAX_SLOTS,
                       dtype_bytes=2).page_plan()
    assert page["source"] == "tuned" and \
        page["page_tokens"] == win["paged_attention"]["page_tokens"]
    log(f"  planner returns the winners as tuned: attention "
        f"{fa.block_q}/{fa.block_kv}, tile {tile.bm}x{tile.bk}x{tile.bn}, "
        f"chunk {chunk}, page {page['page_tokens']}")
    rc = tune_main(["--quick", "--out",
                    os.path.join(BUILD, "tuning_quick.json")])
    assert rc == 0, f"launch.tune --quick exited {rc}"
    return {"launches": launches,
            "sweeps": {r.kernel: {"center": r.center,
                                  "winner": r.entry.block,
                                  "analytic_us": r.entry.analytic_us,
                                  "median_us": r.entry.median_us,
                                  "speedup": r.entry.speedup}
                       for r in results}}


# ---------------------------------------------------------------------------
# Phases 7-9: zamba2-1.2b, the hybrid_ssm family
# ---------------------------------------------------------------------------


def ssd_work(b, s, h, p, n, chunk, el, state: bool) -> tuple:
    """(bytes, operations) of one SSD scan: x and y in the inputs' type,
    dt in float32, A, B and C, each once, and with ``state`` the initial
    state read and the final one written (float32); per (batch, head) and
    chunk of L real steps, C.B over the lower triangle, the intra- and
    inter-chunk terms of y and the state update."""
    nbytes = (2 * b * s * h * p * el + b * s * h * 4 + h * 4
              + 2 * b * s * n * el + (2 * b * h * p * n * 4 if state else 0))
    ops = 0
    for lo in range(0, s, chunk):
        ln = min(chunk, s - lo)
        tri = ln * (ln + 1) // 2
        ops += b * h * (2 * tri * n + 2 * tri * p + 4 * ln * n * p)
    return nbytes, ops


def ssd_state_case(gen, s, dtype, cfg):
    """zamba2-1.2b's mixer scan over ``s`` tokens (batch 1, 64 heads of 64,
    state 64) with a random float32 initial state."""
    sc = cfg.ssm
    h = sc.expand * cfg.d_model // sc.head_dim
    args = ssd_inputs(gen, 1, s, h, sc.head_dim, sc.state_dim, dtype)
    init = torch.randn((1, h, sc.head_dim, sc.state_dim), generator=gen,
                       device=DEVICE)
    return args, init


def ssd_timing(ssd_mod, args, init, kc: int, what: str,
               max_abs_err: float) -> dict:
    """Times of ``ssd_scan`` on the bf16 inputs ``args`` from ``init`` at
    the model's chunk ``kc``, final state out: the routed body, the simt
    body (``ms_simt``), the plain version beside the bound (``ssd_work``),
    and the device time of each CUDA kernel; no library call computes
    the scan (``library_ms`` null)."""
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import call_chunk, ssd_scan

    b, s, h, p = args[0].shape
    n = args[3].shape[-1]
    q = call_chunk(torch.bfloat16, kc, s, p, n)

    def run(i, path=None):
        ssd_scan(*args, chunk=kc, init_state=init, return_final=True,
                 path=path)

    nbytes, ops = ssd_work(b, s, h, p, n, min(q, s), 2, True)
    bound, bound_by = bound_ms(nbytes, ops, torch.bfloat16)
    before = counters(ssd_mod, ("tc", "simt"))
    row = {"ms": cuda_ms(run), "path": body(ssd_mod, before, "ssd"),
           "ms_simt": cuda_ms(lambda i: run(i, "simt")),
           "plain_ms": cuda_ms(lambda i: ssd_ref(
               *args, init_state=init, return_final=True),
               reps=10 if s <= 8 else 1),
           "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
           "bytes": nbytes, "ops": ops, "chunk": q,
           "max_abs_err": max_abs_err}
    row["kernels_us"] = kernel_us(lambda: run(0))
    log(f"  time bf16 ssd_scan {what} ({row['path']}, chunk {q}): "
        f"kernel_ms={row['ms']:.4f} ms_simt={row['ms_simt']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms=null "
        f"bound_ms={bound:.5f} ({bound_by}, {nbytes} B, {ops} flop) "
        f"share_of_bound={bound / row['ms']:.3f}; kernels (us): "
        + json.dumps(row["kernels_us"]))
    return row


def phase_zamba_kernels(t: int) -> dict:
    """Paged attention and the SSD scan at the shapes zamba2-1.2b's serving
    path gives them, against their plain versions, then their times."""
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import call_chunk, ssd_scan
    from repro_torch.models.mamba2 import kernel_chunk

    cfg = zamba_cfg()
    g = cfg.n_heads // cfg.n_kv_heads
    log(f"  shared attention: {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads (group {g}), D {cfg.head_dim}, page {t}")
    shapes = {"decode": (DECODE_LENS, False),
              "prefill": (tuple(range(8 * t + 1, 9 * t + 1)), True)}
    worst, bodies = paged_checks(pa_mod, shapes, t, cfg, (0,))
    paged = {name: paged_timing(pa_mod, name, lens, shared, t, cfg)
             for name, (lens, shared) in shapes.items()}

    sc = cfg.ssm
    p, n = sc.head_dim, sc.state_dim
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    ssd_err, ssd_bodies = {}, {}
    cases = {}
    for s in (8, 1000):
        for dtype in (torch.bfloat16, torch.float32):
            args, init = ssd_state_case(gen, s, dtype, cfg)
            kc = kernel_chunk(sc.chunk, p, n, dtype.itemsize)
            before = counters(ssd_mod, ("tc", "simt"))
            y, fin = ssd_scan(*args, chunk=kc, init_state=init,
                              return_final=True)
            y2, fin2 = ssd_scan(*args, chunk=kc, init_state=init,
                                return_final=True)
            torch.cuda.synchronize()
            ran = body(ssd_mod, before, f"ssd_scan S={s}")
            assert torch.equal(y, y2) and torch.equal(fin, fin2), \
                f"ssd_scan S={s}: two runs differ"
            ry, rfin = ssd_ref(*args, init_state=init, return_final=True)
            name = f"{str(dtype)[6:]} S={s}"
            q = call_chunk(dtype, kc, s, p, n)
            what = f"ssd_scan {name} chunk {q} {ran} with state"
            ssd_err[name] = {
                "y": held_to(y, ry, SSD_TOL[dtype], what + ": y"),
                "final": held_to(fin, rfin, SSD_TOL[dtype],
                                 what + ": final state")}
            ssd_bodies[name] = ran
            if dtype == torch.bfloat16:
                cases[s] = (args, init, kc)
    # 125 calls of 8 tokens, each from the last one's final state, against
    # one 1000-token call.
    for dtype in (torch.bfloat16, torch.float32):
        args, init = ssd_state_case(gen, 1000, dtype, cfg)
        kc = kernel_chunk(sc.chunk, p, n, dtype.itemsize)
        y, fin = ssd_scan(*args, chunk=kc, init_state=init,
                          return_final=True)
        state, parts = init, []
        for lo in range(0, 1000, 8):
            # A (H,) has no time axis
            piece = [a if a.dim() == 1 else a[:, lo:lo + 8].contiguous()
                     for a in args]
            part, state = ssd_scan(*piece, chunk=kc, init_state=state,
                                   return_final=True)
            parts.append(part)
        name = f"{str(dtype)[6:]} 125 x 8 vs 1000"
        ssd_err[name] = {
            "y": held_to(torch.cat(parts, 1), y, SSD_TOL[dtype],
                         f"ssd_scan {name}: y"),
            "final": held_to(state, fin, SSD_TOL[dtype],
                             f"ssd_scan {name}: final state")}
    assert all(b == ("tc" if k.startswith("bfloat16") else "simt")
               for k, b in ssd_bodies.items()), ssd_bodies

    ssd = {f"S={s}": ssd_timing(
        ssd_mod, args, init, kc, f"S={s} with state",
        max(ssd_err[f"bfloat16 S={s}"].values()))
        for s, (args, init, kc) in cases.items()}
    log("  phase 7 paged bodies: " + json.dumps(bodies))
    log("  phase 7 paged max_abs_err: " + json.dumps(
        {f"{a}/{b}": e for (a, b), e in worst.items()}))
    log("  phase 7 ssd bodies: " + json.dumps(ssd_bodies))
    log("  phase 7 ssd max_abs_err: " + json.dumps(ssd_err))
    return {"paged": paged, "paged_err": worst[("bfloat16", "decode")],
            "ssd": ssd, "ssd_err": ssd_err}


def phase_zamba_slice(t: int) -> None:
    """zamba2-1.2b at full width cut to 2 Mamba2 layers and one application
    of the shared block, float32: two slots prefill in planned chunks of
    ``t`` tokens (16 and 13 tokens: the state carried from chunk to
    chunk), then one paged decode step, on the card and on the CPU with
    the same weights; logits, pool and Mamba state agree."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models.model import Model
    from repro_torch.serve.pages import init_paged_cache

    cfg = dataclasses.replace(zamba_cfg(), n_layers=2)
    model = Model(cfg)
    params = {"cpu": model.init(seed=0, device="cpu")}
    params[DEVICE] = tree_to(params["cpu"], DEVICE)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (2 * t, 13)]
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    res = {}
    before = counters(ssd_mod, ("tc", "simt"))
    for dev in ("cpu", DEVICE):
        cache = init_paged_cache(cfg, 2, 7, t, 3, torch.float32, dev)
        cache["table"] = table.to(dev)
        firsts = []
        with torch.no_grad():
            for slot, prompt in enumerate(prompts):
                for lo in range(0, len(prompt), t):
                    logits, cache = model.prefill_chunk(
                        params[dev], cache,
                        {"tokens": torch.from_numpy(
                            prompt[lo:lo + t])[None].to(dev),
                         "pos0": lo, "slot": slot}, dtype=torch.float32)
                firsts.append(logits)
            toks = torch.stack([lg.argmax(-1) for lg in firsts])  # (2, 1)
            cache["pos"] = torch.tensor([len(p) for p in prompts],
                                        dtype=torch.int32, device=dev)
            dec, cache = model.decode_step_paged(
                params[dev], cache, {"tokens": toks}, dtype=torch.float32)
        mc = cache["state"]["mamba"]
        res[dev] = (torch.cat(firsts).cpu(), dec.cpu(),
                    cache["pool"]["k"].cpu(), mc["ssm"].cpu(),
                    mc["conv"].cpu())
    torch.cuda.synchronize()
    chunks = sum(-(-len(p) // t) for p in prompts)
    moved = {k: getattr(ssd_mod, f"LAUNCHES_{k.upper()}") - v
             for k, v in before.items()}
    log(f"  ssd_scan launches on the card: {json.dumps(moved)} ({chunks} "
        f"chunks x {cfg.n_layers} mixers)")
    assert moved == {"tc": 0, "simt": chunks * cfg.n_layers}, moved
    names = ("prefill logits", "decode logits", "K pool", "SSM state",
             "conv state")
    for name, a, b in zip(names, res[DEVICE], res["cpu"]):
        err = float((a - b).abs().max())
        log(f"  {name}: max_abs_err={err:.3e} (shape {tuple(a.shape)})")
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, **SLICE_TOL)
    (pc, dc), (pg, dg) = res["cpu"][:2], res[DEVICE][:2]
    tok_c = (pc.argmax(-1).tolist(), dc.argmax(-1).tolist())
    tok_g = (pg.argmax(-1).tolist(), dg.argmax(-1).tolist())
    log(f"  greedy tokens cuda={tok_g} cpu={tok_c}")
    assert tok_g == tok_c, "greedy tokens differ between cuda and cpu"


def phase_zamba_serve(pa_mod, ssd_mod) -> dict:
    """Full-width zamba2-1.2b (38 Mamba2 layers, the shared block 7 times)
    serving phase 4's trace: every paged launch on the split body, every
    SSD launch on tc, one per mixer and prefill chunk of more than one
    token (a one-token chunk takes ``ssd_step``)."""
    from repro_torch.serve.kvcache import attn_apps

    cfg = zamba_cfg()
    row, _, engine, prompts = serve_trace(
        cfg, {"paged": pa_mod, "ssd": ssd_mod}, (0,))
    apps = attn_apps(cfg)
    steps, chunks = row["decode_steps"], row["prefill_chunks"]
    multi = sum(1 for e in engine.metrics["interleave"]
                if e[0] == "chunk" and e[3] > 1)
    pa, sd = row["launches"]["paged"], row["launches"]["ssd"]
    log(f"  launches: paged {json.dumps(pa)} (want {apps} applications x "
        f"({steps} ticks + {chunks} chunks)), ssd {json.dumps(sd)} (want "
        f"{cfg.n_layers} mixers x {multi} chunks of > 1 token)")
    assert pa["LAUNCHES"] > 0 and sd["LAUNCHES"] > 0, \
        "the main path never launched a kernel"
    assert pa["LAUNCHES"] == pa["LAUNCHES_SPLIT"] == apps * (steps + chunks)
    assert sd["LAUNCHES"] == sd["LAUNCHES_TC"] == cfg.n_layers * multi
    if PROFILE:
        sub = [prompts[0], prompts[4]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(sub, max_new_tokens=8)
        torch.cuda.synchronize()
        profile_serve(engine, sub, time.perf_counter() - t0, max_new=8)
    return row


# ---------------------------------------------------------------------------
# Phases 10-12: mixtral-8x7b, the moe family (sliding window 4096)
# ---------------------------------------------------------------------------


def phase_mixtral_kernels(t: int) -> dict:
    """``paged_attention`` at the shapes mixtral-8x7b's serving path gives
    it -- 32 query heads over 8 KV heads (group 4), D 128, the planned
    page, window 4096, over the engine's table for ``LONG_MAX_LEN`` tokens
    whose pages below the window are null entries, as reclaim leaves them
    -- against its plain version, then its times."""
    from repro_torch.kernels import paged_attention as pa_mod

    cfg = mixtral_cfg()
    w = cfg.sliding_window
    log(f"  {cfg.n_heads} query heads over {cfg.n_kv_heads} KV heads (group "
        f"{cfg.n_heads // cfg.n_kv_heads}), D {cfg.head_dim}, page {t}, "
        f"window {w}, table for {LONG_MAX_LEN} tokens")
    pos0 = (LONG_PROMPT // t) * t            # a chunk past the window
    shapes = {"decode": (MIXTRAL_DECODE_LENS, False),
              "prefill": (tuple(range(pos0 + 1, pos0 + t + 1)), True)}
    worst, bodies = paged_checks(pa_mod, shapes, t, cfg, (w,),
                                 max_len=LONG_MAX_LEN, null_window=w)
    paged = {name: paged_timing(pa_mod, name, lens, shared, t, cfg,
                                max_len=LONG_MAX_LEN, window=w)
             for name, (lens, shared) in shapes.items()}
    log("  phase 10 bodies: " + json.dumps(bodies))
    log("  phase 10 max_abs_err: " + json.dumps(
        {f"{a}/{b}": e for (a, b), e in worst.items()}))
    return {"paged": paged, "paged_err": worst[("bfloat16", "decode")],
            "errors": {f"{a}/{b}": e for (a, b), e in worst.items()}}


def free_card() -> int:
    """Release what earlier phases left in the allocator's cache; the
    card's free bytes."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0]


def run_slice(model, params, t, prompts, dev, decode_tokens=None,
              frames=None) -> dict:
    """Each of ``prompts`` prefilled into its own slot in chunks of ``t``
    tokens, then one paged decode step over all slots fed
    ``decode_tokens`` (default: each slot's greedy token), float32 on
    ``dev``: the logits, the decode step's tokens, the K/V pool (where the
    family has one) and every state leaf, on the CPU.  An enc-dec model
    takes each slot's encoder input from ``frames`` (``(Se, d)`` each):
    its encoder pass and cross K/V are installed into the slot's rows
    (``encode_cross``, ``reset_slot``) before its prompt."""
    from repro_torch.serve.pages import init_paged_cache, reset_slot

    cfg = model.cfg
    n_pages = [-(-len(p) // t) + 1 for p in prompts]
    width = max(n_pages)
    table = torch.zeros((len(prompts), width), dtype=torch.int32)
    at = 1
    for i, n in enumerate(n_pages):
        table[i, :n] = torch.arange(at, at + n, dtype=torch.int32)
        at += n
    enc_max = max(len(f) for f in frames) if frames else 0
    cache = init_paged_cache(cfg, len(prompts), at, t, width, torch.float32,
                             dev, enc_len=enc_max)
    cache["table"] = table.to(dev)
    firsts = []
    with torch.no_grad():
        for slot, prompt in enumerate(prompts):
            if frames:
                enc = torch.from_numpy(frames[slot])[None].to(dev)
                cache = reset_slot(cfg, cache, slot, enc_len=enc.shape[1],
                                   cross_kv=model.encode_cross(
                                       params, {"enc_embeds": enc},
                                       dtype=torch.float32))
            for lo in range(0, len(prompt), t):
                logits, cache = model.prefill_chunk(
                    params, cache,
                    {"tokens": torch.from_numpy(prompt[lo:lo + t])[None].to(
                        dev), "pos0": lo, "slot": slot}, dtype=torch.float32)
            firsts.append(logits)
        toks = torch.stack([lg.argmax(-1) for lg in firsts]) \
            if decode_tokens is None else decode_tokens.to(dev)
        cache["pos"] = torch.tensor([len(p) for p in prompts],
                                    dtype=torch.int32, device=dev)
        dec, cache = model.decode_step_paged(params, cache, {"tokens": toks},
                                             dtype=torch.float32)
    out = {"prefill logits": torch.cat(firsts), "decode logits": dec,
           "decode tokens": toks}
    for part in ("pool", "state"):
        for name, leaf in flat_leaves(cache[part]).items():
            out[f"{part}.{name}"] = leaf
    return {k: v.cpu() for k, v in out.items()}


def slice_against_cpu(cfg, t, prompts, what, params=None,
                      chaotic=(), frames=None) -> dict:
    """``cfg`` in float32 on the card and on the CPU with the same seeded
    weights (drawn on the card unless ``params`` holds both copies): each
    of ``prompts`` prefilled into its own slot in chunks of ``t`` tokens,
    then one paged decode step over both slots, fed the CPU's greedy
    tokens on both.  Logits, the K/V pool (where the family has one) and
    every state leaf agree within ``SLICE_TOL``, and so do the greedy
    tokens -- except the results named by a prefix in ``chaotic``: those
    are printed beside the CPU's own float32 sensitivity (the same run on
    weights moved by one float32 rounding unit, a relative 2**-24
    N(0, 1)), and held to being finite.  ``frames`` are an enc-dec
    model's encoder inputs, one a slot (``run_slice``).  Returns each
    compared tensor's max abs error."""
    from repro_torch.models.model import Model

    model = Model(cfg)
    if params is None:
        params = {DEVICE: model.init(seed=0, device=DEVICE)}
        params["cpu"] = tree_to(params[DEVICE], "cpu")
    res, toks = {}, None
    for dev in ("cpu", DEVICE):
        t0 = time.perf_counter()
        res[dev] = run_slice(model, params[dev], t, prompts, dev, toks,
                             frames)
        toks = res[dev].pop("decode tokens")
        log(f"  {what} on {dev}: {time.perf_counter() - t0:.1f} s")
    floor = {}
    if chaotic:
        gen = torch.Generator().manual_seed(1)

        def nudge(tree):
            if isinstance(tree, dict):
                return {k: nudge(v) for k, v in tree.items()}
            return tree * (1 + 2.0 ** -24 * torch.randn(
                tree.shape, generator=gen))

        nudged = run_slice(model, nudge(params["cpu"]), t, prompts, "cpu",
                           toks, frames)
        nudged.pop("decode tokens")
        floor = {k: float((v - res["cpu"][k]).abs().max())
                 for k, v in nudged.items()}
    errs = {}
    for name, b in res["cpu"].items():
        a = res[DEVICE][name]
        errs[name] = float((a.float() - b.float()).abs().max())
        assert torch.isfinite(a).all(), name
        if name.startswith(chaotic) and chaotic:
            log(f"  {name}: max_abs_err={errs[name]:.3e} (shape "
                f"{tuple(a.shape)}; the CPU against itself on weights one "
                f"rounding unit apart: {floor[name]:.3e})")
            continue
        log(f"  {name}: max_abs_err={errs[name]:.3e} (shape "
            f"{tuple(a.shape)})")
        torch.testing.assert_close(a, b, **SLICE_TOL)
    tok = {d: (res[d]["prefill logits"].argmax(-1).tolist(),
               res[d]["decode logits"].argmax(-1).tolist())
           for d in ("cpu", DEVICE)}
    log(f"  greedy tokens cuda={tok[DEVICE]} cpu={tok['cpu']}")
    assert chaotic or tok[DEVICE] == tok["cpu"], \
        "greedy tokens differ between cuda and cpu"
    return errs


def flat_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def phase_mixtral_slice(t: int) -> dict:
    """mixtral-8x7b at full width (8 experts of 14,336, top 2, window
    4096) cut to 2 layers, float32: one prefill chunk for each of 2 slots
    and one paged decode step, card against CPU."""
    free_card()
    cfg = dataclasses.replace(mixtral_cfg(), n_layers=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (t, 13)]
    return slice_against_cpu(cfg, t, prompts, "mixtral 2-layer slice")


def mixtral_depth(free_bytes: int):
    """The deepest cut of full-width mixtral-8x7b whose bf16 weights and
    phase 4's page pool (8 slots of 4096 tokens at the planned page) leave
    ``MIXTRAL_HEADROOM`` of ``free_bytes``: ``(cfg, weight bytes, pool
    bytes)``."""
    from repro_torch.serve.engine import plan_decode
    from repro_torch.serve.kvcache import kv_token_bytes

    full = mixtral_cfg()
    for n in range(full.n_layers, 0, -1):
        cfg = dataclasses.replace(full, n_layers=n)
        plan = plan_decode(cfg, max_len=MAX_LEN, batch=MAX_SLOTS,
                           dtype_bytes=2)
        pages = 1 + MAX_SLOTS * plan.page_table()["pages_per_slot"]
        pool = kv_token_bytes(cfg, 2)[0] * plan.page_plan()["page_tokens"] \
            * pages
        weights = cfg.param_count() * 2
        if weights + pool + MIXTRAL_HEADROOM <= free_bytes:
            return cfg, weights, pool
    raise RuntimeError(f"no depth of {full.arch} fits {free_bytes} B")


def reclaimed_pages(engine) -> int:
    """Pages freed while their request still ran (one request: only the
    window reclaim does that), from the engine's trace."""
    events = engine.tracer.export_events()
    end = max(e["ts"] + e["dur"] for e in events if e["name"] == "request")
    return sum(e["args"]["n"] for e in events
               if e["name"] == "page_free" and e["ts"] < end)


def phase_mixtral_serve(pa_mod) -> dict:
    """Full-width mixtral-8x7b, cut in depth to fit the card (bf16 seeded
    weights), serving phase 4's trace with every paged launch on the split
    body; then, on the same weights, one request of ``LONG_PROMPT``
    tokens and ``MAX_NEW`` new ones at ``max_len`` ``LONG_MAX_LEN``, whose
    pages below the window are reclaimed as it runs; then the card's busy
    share over a short sub-trace."""
    from repro_torch.serve import ServeEngine, ServePolicy

    free = free_card()
    cfg, weights, pool = mixtral_depth(free)
    log(f"  depth cut: {cfg.n_layers} of {mixtral_cfg().n_layers} layers "
        f"(widths, experts, top-k, vocab and window as published): "
        f"{weights / 1e9:.2f} GB of bf16 weights + {pool / 1e9:.2f} GB of "
        f"page pool + {MIXTRAL_HEADROOM / 1e9:.0f} GB headroom <= "
        f"{free / 1e9:.2f} GB free")
    row, _, engine, prompts = serve_trace(cfg, {"paged": pa_mod}, (0,))
    pa = row["launches"]["paged"]
    steps, chunks = row["decode_steps"], row["prefill_chunks"]
    log(f"  launches: {json.dumps(pa)} (want {cfg.n_layers} layers x "
        f"({steps} ticks + {chunks} chunks))")
    assert pa["LAUNCHES"] > 0, "the main path never launched the kernel"
    assert pa["LAUNCHES"] == pa["LAUNCHES_SPLIT"] == \
        cfg.n_layers * (steps + chunks)
    row.update(depth=cfg.n_layers, weight_gb=weights / 1e9,
               free_gb=free / 1e9)

    # One long windowed request on the same weights.
    long_eng = ServeEngine(cfg, ServePolicy(max_slots=1,
                                            max_len=LONG_MAX_LEN,
                                            max_new_tokens=MAX_NEW),
                           dtype=torch.bfloat16, params=engine.params,
                           device=DEVICE)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               LONG_PROMPT, dtype=np.int32)
    before = pa_mod.LAUNCHES_SPLIT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = long_eng.generate([prompt])[0]
    torch.cuda.synchronize()
    m = long_eng.metrics
    longrow = {
        "prompt": LONG_PROMPT, "new": len(out),
        "wall_s": time.perf_counter() - t0,
        "prefill_chunks": int(m["prefill_chunks"]),
        "decode_steps": int(m["decode_steps"]),
        "pages_allocated": int(m["pages_allocated"]),
        "pages_released": int(m["pages_released"]),
        "peak_pages": int(m["peak_pages"]),
        "pages_reclaimed": reclaimed_pages(long_eng),
        "launches_split": pa_mod.LAUNCHES_SPLIT - before,
    }
    log("  long request: " + json.dumps(longrow))
    assert len(out) == MAX_NEW and all(0 <= x < cfg.vocab_size for x in out)
    assert longrow["pages_reclaimed"] >= \
        (LONG_PROMPT - cfg.sliding_window) // long_eng.page.page_tokens, \
        longrow
    assert longrow["pages_allocated"] == longrow["pages_released"]
    row["long"] = longrow
    del long_eng

    # The card's busy share over a sub-trace (2 prompts, 8 new tokens).
    sub = [prompts[0], prompts[4]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(sub, max_new_tokens=8)
    torch.cuda.synchronize()
    row["busy_share_profiled"], row["busy_share"] = profile_serve(
        engine, sub, time.perf_counter() - t0, max_new=8)
    log(f"  mixtral {cfg.n_layers} layers: wall {row['wall_s']:.2f} s for "
        f"the trace; device busy share {row['busy_share']:.3f} of the "
        f"sub-trace's unprofiled wall")
    return row


# ---------------------------------------------------------------------------
# Phases 13-14: xlstm-1.3b, the token-free xlstm family
# ---------------------------------------------------------------------------


def phase_xlstm_slice() -> dict:
    """xlstm-1.3b at full width cut to one period (7 mLSTM blocks and one
    sLSTM block), float32, card against CPU on the same weights.

    Prompts of 100 and 40 tokens in the engine's 64-token chunks, then one
    decode step fed the same tokens on both: every mLSTM state leaf agrees
    within ``SLICE_TOL``; the sLSTM state and the logits are printed
    beside the CPU's own float32 sensitivity.  With these seeded weights
    the sLSTM recurrence is chaotic -- its recurrent weights (std 0.25
    over 512-wide heads) grow a rounding-level difference by orders of
    magnitude within tens of tokens -- so over a prompt, float32 runs one
    rounding unit apart part on any device.  The sLSTM is the period's
    last block, so no mLSTM state depends on it.  So the sLSTM block is
    then held to its plain version teacher-forced: 40 tokens of 2 slots,
    each token one call on the card from the CPU's state, its output and
    new state within ``SLICE_TOL``."""
    from repro_torch.models import xlstm as XL
    from repro_torch.models.model import Model, _layer_params
    from repro_torch.serve.kvcache import DEFAULT_PAGE_TOKENS

    free_card()
    full = xlstm_cfg()
    cfg = dataclasses.replace(full, n_layers=full.xlstm.slstm_every)
    model = Model(cfg)
    params = {DEVICE: model.init(seed=0, device=DEVICE)}
    params["cpu"] = tree_to(params[DEVICE], "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (100, 40)]
    errs = slice_against_cpu(
        cfg, DEFAULT_PAGE_TOKENS, prompts, "xlstm 8-block slice", params,
        chaotic=("prefill logits", "decode logits", "state.slstm."))

    sp = {d: _layer_params(params[d]["slstm_layers"], 0) for d in params}
    x = torch.randn((2, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    state = {k: v[0] for k, v in model.init_state(2, torch.float32,
                                                  "cpu")["slstm"].items()}
    worst = {}
    for i in range(x.shape[1]):
        ref, new = XL.slstm_block(sp["cpu"], x[:, i:i + 1], cfg, state)
        out, got = XL.slstm_block(sp[DEVICE], x[:, i:i + 1].to(DEVICE), cfg,
                                  tree_to(state, DEVICE))
        for name, a, b in [("out", out, ref)] + [
                (k, got[k], new[k]) for k in new]:
            a = a.cpu()
            worst[name] = max(worst.get(name, 0.0),
                              float((a - b).abs().max()))
            torch.testing.assert_close(a, b, **SLICE_TOL)
        state = new
    log("  sLSTM block teacher-forced, 40 tokens x 2 slots, max_abs_err: "
        + json.dumps(worst))
    errs.update({f"slstm teacher-forced {k}": v for k, v in worst.items()})
    return errs


def phase_xlstm_serve(pa_mod) -> dict:
    """Full-width, full-depth xlstm-1.3b (42 mLSTM and 6 sLSTM blocks,
    seeded random bf16 weights) serving phase 4's trace.  It is token-free:
    no page is allocated and no paged-attention kernel runs; its sLSTM
    blocks step through each chunk's tokens one at a time."""
    free_card()
    cfg = xlstm_cfg()
    row, _, engine, _ = serve_trace(cfg, {"paged": pa_mod}, (0,))
    assert row["pages_allocated"] == 0
    assert row["launches"]["paged"]["LAUNCHES"] == 0
    chunk_ms = [e["dur"] / 1e3 for e in engine.tracer.export_events()
                if e["name"] == "prefill_chunk"]
    row["prefill_chunk_ms_p50"] = float(np.median(chunk_ms))
    log(f"  xlstm: {row['prefill_chunks']} chunks of "
        f"{row['page_tokens']} tokens, p50 {row['prefill_chunk_ms_p50']:.1f}"
        f" ms a chunk; {row['decode_steps']} ticks")
    row["block_ms"] = xlstm_block_ms(cfg, engine.params, row["page_tokens"])
    return row


def xlstm_block_ms(cfg, params, t: int) -> dict:
    """What one prefill chunk of ``t`` tokens of one slot costs each xLSTM
    block kind (its first layer, bf16): host wall per call with the card
    synchronised, and device time (``cuda_ms``).  The sLSTM block steps
    the chunk's tokens one at a time in Python (the reference's
    ``lax.scan``), so its host time grows with ``t``."""
    from repro_torch.models import xlstm as XL
    from repro_torch.models.model import Model, _layer_params

    state = Model(cfg).init_state(1, torch.bfloat16, DEVICE)
    x = torch.randn((1, t, cfg.d_model), device=DEVICE).to(torch.bfloat16)
    chunk = min(256, max(16, t))
    calls = {
        "mlstm": lambda p, c: XL.mlstm_block(p, x, cfg, c, chunk),
        "slstm": lambda p, c: XL.slstm_block(p, x, cfg, c)}
    out = {}
    for kind, call in calls.items():
        p = _layer_params(params[f"{kind}_layers"], 0)
        c = {k: v[0] for k, v in state[kind].items()}
        with torch.no_grad():
            call(p, c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                call(p, c)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 5 * 1e3
            dev = cuda_ms(lambda i: call(p, c), reps=5)
        out[kind] = {"wall_ms": wall, "device_ms": dev}
    n_s = cfg.n_layers // cfg.xlstm.slstm_every
    n_m = cfg.n_layers - n_s
    total = n_m * out["mlstm"]["wall_ms"] + n_s * out["slstm"]["wall_ms"]
    log(f"  one {t}-token chunk, per block (bf16): " + json.dumps(out)
        + f"; {n_m} mLSTM + {n_s} sLSTM blocks: {total:.1f} ms of wall")
    return out


# ---------------------------------------------------------------------------
# Phases 15-17: deepseek-v2-236b, the mla_moe family
# ---------------------------------------------------------------------------


def phase_deepseek_kernels(t: int, sass_by_fn: dict) -> dict:
    """``paged_attention`` at the shapes deepseek-v2-236b's serving path
    gives it -- 128 query heads over the one latent "KV head" at D 576
    (kv_lora 512 + rope 64), K = V = the latent pool, the planned page --
    against its plain version: 8 decode rows at ``DECODE_LENS`` and one
    page of prefill rows at ~1,024 tokens over one table; bf16 on the mla
    body, float32 on simt, two bf16 runs bit-identical; then the times of
    mla, simt, plain and gather + SDPA beside the bound, and the device
    time of each CUDA kernel; and the mla kernel's tensor-core and
    async-copy instructions from phase 1's SASS scan."""
    from repro_torch.kernels import paged_attention as pa_mod

    cfg = deepseek_cfg()
    h, kv, d = mla_heads(cfg)
    log(f"  {h} query heads over {kv} latent head, D {d}, page {t}, K = V")
    pos0 = (1024 // t) * t
    shapes = {"decode": (DECODE_LENS, False),
              "prefill": (tuple(range(pos0 + 1, pos0 + t + 1)), True)}
    worst, bodies = paged_checks(pa_mod, shapes, t, cfg, (0,),
                                 bf16_body="mla")
    paged = {name: paged_timing(pa_mod, name, lens, shared, t, cfg)
             for name, (lens, shared) in shapes.items()}
    sass = {op: n for fn, c in sass_by_fn.items() if "paged_mla_kernel" in fn
            for op, n in c.items()}
    log("  phase 15 bodies: " + json.dumps(bodies))
    log("  phase 15 max_abs_err: " + json.dumps(
        {f"{a}/{b}": e for (a, b), e in worst.items()}))
    log("  phase 15 mla kernel SASS (phase 1): " + json.dumps(sass))
    return {"paged": paged, "paged_err": worst[("bfloat16", "decode")],
            "errors": {f"{a}/{b}": e for (a, b), e in worst.items()},
            "sass": sass}


def host_free_bytes() -> int:
    """The host's available memory (``MemAvailable`` of /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def tree_bytes(specs, el: int) -> int:
    """Bytes of a parameter tree (``Model.param_specs``) at ``el`` bytes an
    element: the tree's own leaves, not ``cfg.param_count()``."""
    from repro_torch.models.params import spec_tree_map

    sizes = []
    spec_tree_map(lambda _, sp: sizes.append(int(np.prod(sp.shape))), specs)
    return sum(sizes) * el


def phase_deepseek_slice(t: int) -> dict:
    """deepseek-v2-236b at full width cut to 2 layers (the dense one and
    one MoE layer: 160 experts of 1,536, top 6, 2 shared), float32: each
    of 2 slots prefilled in planned chunks and one paged decode step, card
    against CPU on the same weights; logits and the ``lat`` pool agree,
    and so do the greedy tokens.  Both copies of the weights are float32
    (~21 GB each); if the host cannot hold its copy the phase stops."""
    from repro_torch.models.model import Model

    free_card()
    cfg = dataclasses.replace(deepseek_cfg(), n_layers=2)
    need = tree_bytes(Model(cfg).param_specs(), 4)
    host = host_free_bytes()
    log(f"  host memory available {host / 1e9:.1f} GB; the CPU copy of the "
        f"2-layer float32 weights takes {need / 1e9:.1f} GB")
    if host < need * 1.3:
        raise RuntimeError(f"the host cannot hold the slice's float32 "
                           f"weights ({need / 1e9:.1f} GB of "
                           f"{host / 1e9:.1f} GB available); widths are "
                           f"not cut")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (t + 7, 13)]
    return slice_against_cpu(cfg, t, prompts, "deepseek 2-layer slice")


#: Card memory phase 17's depth cut leaves beside the weights and the
#: pool: one layer's float32 draw (5.03 GB for the experts' ``wi``: 160 x
#: 5120 x 1536), the prefill chunk's expert buffers, activations, the
#: split workspace and the allocator's slack.
DEEPSEEK_HEADROOM = 8e9


def deepseek_depth(free_bytes: int):
    """The deepest cut of full-width deepseek-v2-236b -- the leading dense
    layer and MoE layers -- whose bf16 weights (the parameter tree's own
    bytes: ``cfg.param_count()`` overcounts this model) and phase 4's page
    pool (8 slots of 4096 tokens at the planned page) leave
    ``DEEPSEEK_HEADROOM`` of ``free_bytes``: ``(cfg, weight bytes, pool
    bytes)``."""
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import plan_decode
    from repro_torch.serve.kvcache import kv_token_bytes

    full = deepseek_cfg()
    for n in range(full.n_layers, full.moe.first_k_dense, -1):
        cfg = dataclasses.replace(full, n_layers=n)
        plan = plan_decode(cfg, max_len=MAX_LEN, batch=MAX_SLOTS,
                           dtype_bytes=2)
        pages = MAX_SLOTS * plan.page_table()["pages_per_slot"]
        pool = kv_token_bytes(cfg, 2)[0] * plan.page_plan()["page_tokens"] \
            * pages
        weights = tree_bytes(Model(cfg).param_specs(), 2)
        if weights + pool + DEEPSEEK_HEADROOM <= free_bytes:
            return cfg, weights, pool
    raise RuntimeError(f"no depth of {full.arch} fits {free_bytes} B")


def phase_deepseek_serve(pa_mod) -> dict:
    """Full-width deepseek-v2-236b, cut in depth to fit the card (bf16
    seeded weights), serving phase 4's trace with every paged launch on
    the mla body; then the card's busy share over a short sub-trace.  The
    engine's own KV budget subtracts ``cfg.param_count()``'s weights from
    the card, which at this cut exceed it, so the pool the depth was sized
    for is given as the budget."""
    free = free_card()
    cfg, weights, pool = deepseek_depth(free)
    log(f"  depth cut: {cfg.n_layers} of {deepseek_cfg().n_layers} layers "
        f"({cfg.moe.first_k_dense} dense + "
        f"{cfg.n_layers - cfg.moe.first_k_dense} MoE; widths, experts, "
        f"top-k, MLA ranks and vocab as published): {weights / 1e9:.2f} GB "
        f"of bf16 weights + {pool / 1e9:.2f} GB of page pool + "
        f"{DEEPSEEK_HEADROOM / 1e9:.0f} GB headroom <= {free / 1e9:.2f} GB "
        f"free (param_count() would say {cfg.param_count() * 2 / 1e9:.2f} "
        f"GB)")
    row, _, engine, prompts = serve_trace(cfg, {"paged": pa_mod}, (0,),
                                          kv_budget_bytes=pool)
    pa = row["launches"]["paged"]
    steps, chunks = row["decode_steps"], row["prefill_chunks"]
    log(f"  launches: {json.dumps(pa)} (want {cfg.n_layers} layers x "
        f"({steps} ticks + {chunks} chunks), all mla)")
    assert pa["LAUNCHES"] > 0, "the main path never launched the kernel"
    assert pa["LAUNCHES"] == pa["LAUNCHES_MLA"] == \
        cfg.n_layers * (steps + chunks), pa
    assert pa["LAUNCHES_SIMT"] == pa["LAUNCHES_SPLIT"] == 0, pa
    row.update(depth=cfg.n_layers, weight_gb=weights / 1e9,
               pool_gb=pool / 1e9, free_gb=free / 1e9)

    # The card's busy share over a sub-trace (2 prompts, 8 new tokens).
    sub = [prompts[0], prompts[4]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(sub, max_new_tokens=8)
    torch.cuda.synchronize()
    row["busy_share_profiled"], row["busy_share"] = profile_serve(
        engine, sub, time.perf_counter() - t0, max_new=8)
    log(f"  deepseek {cfg.n_layers} layers: wall {row['wall_s']:.2f} s for "
        f"the trace; device busy share {row['busy_share']:.3f} of the "
        f"sub-trace's unprofiled wall")
    return row


# ---------------------------------------------------------------------------
# Phases 18-20: whisper-large-v3, the enc_dec family
# ---------------------------------------------------------------------------


def phase_whisper_kernels(t: int) -> dict:
    """``paged_attention`` at the shapes whisper-large-v3's decoder
    self-attention gives it -- 20 query heads over 20 KV heads (group 1),
    D 64, the planned page -- against its plain version: 8 decode rows at
    ``DECODE_LENS`` and one page of prefill rows over one table; bf16 on
    the split body, float32 on simt, two bf16 runs bit-identical; then the
    times of split, simt, plain and gather + SDPA beside the bound, and
    the device time of each CUDA kernel."""
    from repro_torch.kernels import paged_attention as pa_mod

    cfg = whisper_cfg()
    log(f"  decoder self-attention: {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads (group "
        f"{cfg.n_heads // cfg.n_kv_heads}), D {cfg.head_dim}, page {t}")
    shapes = {"decode": (DECODE_LENS, False),
              "prefill": (tuple(range(8 * t + 1, 9 * t + 1)), True)}
    worst, bodies = paged_checks(pa_mod, shapes, t, cfg, (0,))
    paged = {name: paged_timing(pa_mod, name, lens, shared, t, cfg)
             for name, (lens, shared) in shapes.items()}
    log("  phase 18 bodies: " + json.dumps(bodies))
    log("  phase 18 max_abs_err: " + json.dumps(
        {f"{a}/{b}": e for (a, b), e in worst.items()}))
    return {"paged": paged, "paged_err": worst[("bfloat16", "decode")]}


def whisper_frames(rng, cfg, n: int) -> np.ndarray:
    """``n`` encoder frames of precomputed embeddings (Whisper's conv front
    end is stubbed, as in the reference): seeded normal x 0.02."""
    return (rng.standard_normal((n, cfg.d_model)) * 0.02).astype(np.float32)


def phase_whisper_slice(t: int) -> dict:
    """whisper-large-v3 at full width cut to 2 encoder and 2 decoder
    layers, float32, card against CPU on the same weights: 2 slots with
    1,500 and 600 encoder frames, each encoded and installed
    (``encode_cross``, ``reset_slot``), its decoder prompt prefilled in
    planned chunks, then one paged decode step; logits, the pool and the
    cross state agree, and the greedy tokens."""
    free_card()
    full = whisper_cfg()
    cfg = dataclasses.replace(full, n_layers=2, enc_dec=dataclasses.replace(
        full.enc_dec, n_encoder_layers=2, n_decoder_layers=2))
    rng = np.random.default_rng(0)
    frames = [whisper_frames(rng, cfg, n) for n in (1500, 600)]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (t + 5, 4)]
    return slice_against_cpu(cfg, t, prompts, "whisper 2+2-layer slice",
                             frames=frames)


def encoder_ms(engine, frames) -> dict:
    """The admission-time encoder pass and cross projections of one
    request (``engine.steps.encode``, bf16) at each of ``frames``' lengths:
    host wall with the card synchronised (mean of 3), and the device time
    of its kernels (``torch.profiler``: one pass launches ~1,300 kernels,
    more than the card's launch queue holds, so ``cuda_ms`` cannot queue
    it behind a sleep)."""
    out = {}
    for f in frames:
        enc = torch.from_numpy(f)[None].to(DEVICE)

        def run():
            engine.steps.encode(engine.params, enc)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 3 * 1e3
        kernels = profiled_kernels(run, reps=1)
        out[len(f)] = {
            "wall_ms": wall_ms,
            "device_ms": sum(us for us, _ in kernels.values()) / 1e3,
            "launches": sum(n for _, n in kernels.values())}
    log("  encoder pass per request (bf16): " + json.dumps(out))
    return out


def phase_whisper_serve(pa_mod) -> dict:
    """Full-width, full-depth whisper-large-v3 (32 encoder and 32 decoder
    layers, seeded random bf16 weights), 8 slots, serving
    ``WHISPER_FRAMES`` encoder inputs with ``WHISPER_PROMPTS`` decoder
    prompts and ``WHISPER_NEW`` new tokens each; every paged launch on the
    split body, one per decoder layer and tick or chunk.  Then the
    encoder's time per request, and the card's busy share over a
    2-request sub-trace."""
    from repro_torch.models.model import Model

    free = free_card()
    cfg = whisper_cfg()
    weights = tree_bytes(Model(cfg).param_specs(), 2)
    log(f"  {cfg.enc_dec.n_encoder_layers} encoder + "
        f"{cfg.enc_dec.n_decoder_layers} decoder layers: {weights / 1e9:.2f}"
        f" GB of bf16 weights (param_count() says "
        f"{cfg.param_count() * 2 / 1e9:.2f}), {free / 1e9:.2f} GB free")
    rng = np.random.default_rng(0)
    prompts = [{"enc_embeds": whisper_frames(rng, cfg, se),
                "tokens": rng.integers(0, cfg.vocab_size, n,
                                       dtype=np.int32)}
               for se, n in zip(WHISPER_FRAMES, WHISPER_PROMPTS)]
    row, outs, engine, _ = serve_trace(cfg, {"paged": pa_mod}, (0,),
                                       prompts=prompts, max_new=WHISPER_NEW)
    pa = row["launches"]["paged"]
    steps, chunks = row["decode_steps"], row["prefill_chunks"]
    nd = cfg.enc_dec.n_decoder_layers
    log(f"  launches: {json.dumps(pa)} (want {nd} decoder layers x "
        f"({steps} ticks + {chunks} chunks), all split)")
    assert pa["LAUNCHES"] > 0, "the main path never launched the kernel"
    assert pa["LAUNCHES"] == pa["LAUNCHES_SPLIT"] == nd * (steps + chunks), \
        pa
    t0 = time.perf_counter()
    row.update(weight_gb=weights / 1e9, free_gb=free / 1e9,
               encoder=encoder_ms(engine, [prompts[i]["enc_embeds"]
                                           for i in (0, 2, 4)]))
    log(f"  encoder timing: {time.perf_counter() - t0:.1f} s")

    # The card's busy share over a sub-trace (2 requests, 8 new tokens).
    sub = [prompts[0], prompts[4]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(sub, max_new_tokens=8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    row["busy_share_profiled"], row["busy_share"] = profile_serve(
        engine, sub, t1 - t0, max_new=8)
    log(f"  sub-trace and its profile: {time.perf_counter() - t0:.1f} s")
    log(f"  whisper: wall {row['wall_s']:.2f} s for the trace; device busy "
        f"share {row['busy_share']:.3f} of the sub-trace's unprofiled wall")
    return row


# ---------------------------------------------------------------------------
# Phases 21-24: the cohort engine over contiguous caches; qwen2-vl-7b
# ---------------------------------------------------------------------------


def vlm_request(rng, cfg, grid: int, text: int) -> dict:
    """One qwen2-vl request as the stubbed vision tower hands it over: a
    ``grid`` x ``grid`` patch grid at positions (0, row, col), then
    ``text`` text rows at ``grid``, ``grid + 1``, ... on all three
    streams; the embeddings seeded normal x 0.02."""
    g = np.arange(grid * grid)
    pos = np.concatenate(
        [np.stack([np.zeros_like(g), g // grid, g % grid]),
         np.tile(np.arange(grid, grid + text), (3, 1))], axis=1)
    emb = rng.standard_normal((grid * grid + text, cfg.d_model)) * 0.02
    return {"embeds": emb.astype(np.float32),
            "positions_3d": pos.astype(np.int32)}


def phase_qwen_slice() -> dict:
    """qwen2-vl-7b at full width cut to 2 layers, float32, card against CPU
    on the same weights: a cohort of 2 requests (a 16 x 16 patch grid and
    32 text rows each, ``vlm_request``) prefilled into a contiguous cache,
    then 4 ``decode_step``s fed the CPU's greedy tokens on both, at the
    reference engine's decode positions (all three streams at the cache
    position); logits and the K/V cache agree within ``SLICE_TOL``, and so
    do the greedy tokens."""
    from repro_torch.models.model import Model

    free_card()
    cfg = dataclasses.replace(qwen_cfg(), n_layers=2)
    model = Model(cfg)
    params = {DEVICE: model.init(seed=0, device=DEVICE)}
    params["cpu"] = tree_to(params[DEVICE], "cpu")
    rng = np.random.default_rng(0)
    reqs = [vlm_request(rng, cfg, 16, 32) for _ in range(2)]
    batch = {"embeds": np.stack([r["embeds"] for r in reqs]),
             "positions_3d": np.stack([r["positions_3d"] for r in reqs], 1)}
    b, s = batch["embeds"].shape[:2]
    res, feed = {}, None
    for dev in ("cpu", DEVICE):
        t0 = time.perf_counter()
        out, toks = {}, []
        with torch.no_grad():
            logits, cache = model.prefill(
                params[dev], {k: torch.from_numpy(v).to(dev)
                              for k, v in batch.items()}, s + 8,
                dtype=torch.float32)
            out["prefill logits"] = logits
            for i in range(4):
                tok = (logits.argmax(-1)[:, None] if feed is None
                       else feed[i].to(dev))
                toks.append(tok.cpu())
                pos3d = torch.full((3, b, 1), int(cache["pos"]),
                                   dtype=torch.int64, device=dev)
                logits, cache = model.decode_step(
                    params[dev], cache,
                    {"tokens": tok, "positions_3d": pos3d},
                    dtype=torch.float32)
                out[f"decode {i} logits"] = logits
        out["cache.k"] = cache["layers"]["k"]
        out["cache.v"] = cache["layers"]["v"]
        res[dev] = {k: v.cpu() for k, v in out.items()}
        feed = toks
        log(f"  qwen2-vl 2-layer slice on {dev}: "
            f"{time.perf_counter() - t0:.1f} s")
    errs = {}
    for name, want in res["cpu"].items():
        got = res[DEVICE][name]
        errs[name] = float((got - want).abs().max())
        log(f"  {name}: max_abs_err={errs[name]:.3e} (shape "
            f"{tuple(got.shape)})")
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got, want, **SLICE_TOL)
    tok = {d: [res[d][k].argmax(-1).tolist() for k in res[d]
               if k.endswith("logits")] for d in res}
    log(f"  greedy tokens cuda={tok[DEVICE]} cpu={tok['cpu']}")
    assert tok[DEVICE] == tok["cpu"], \
        "greedy tokens differ between cuda and cpu"
    return errs


#: Phase 22's trace: two prompts of 64 (one finishing early: compaction),
#: three of 200 (more than the 4 slots hold in a cohort with the others:
#: the paged engine backfills) and one of 512.
AB_LENS = (64, 64, 200, 200, 200, 512)
AB_NEWS = (32, 8, 32, 16, 32, 24)
AB_SLOTS = 4


def cohort_against_paged(cfg) -> dict:
    """``cfg`` in float32 on the card, seeded weights, ``AB_SLOTS``
    slots: the cohort engine and the paged engine (same weights) serve
    ``AB_LENS`` with ``AB_NEWS`` new tokens; their greedy tokens agree."""
    from repro_torch.serve import ServeEngine, ServePolicy

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in AB_LENS]
    row, outs, params = {"arch": cfg.arch, "layers": cfg.n_layers}, {}, None
    for batching in ("cohort", "paged"):
        engine = ServeEngine(
            cfg, ServePolicy(batching=batching, max_slots=AB_SLOTS,
                             max_len=MAX_LEN), dtype=torch.float32,
            params=params, seed=0, device=DEVICE)
        params = engine.params
        t0 = time.perf_counter()
        outs[batching] = engine.generate(prompts,
                                         max_new_tokens=list(AB_NEWS))
        torch.cuda.synchronize()
        m = engine.metrics
        row[batching] = {
            "wall_s": time.perf_counter() - t0,
            "slot_utilization": m["slot_utilization"],
            "decode_steps": int(m["decode_steps"]),
            "cohorts": int(m["cohorts"]),
            "capacities": list(m["capacities"]),
            "backfills": int(m["backfills"]),
            "pages_allocated": int(m["pages_allocated"]),
            "pages_released": int(m["pages_released"])}
    log(f"  {cfg.arch} ({cfg.n_layers} layers): " + json.dumps(row))
    c, p = row["cohort"], row["paged"]
    assert [len(o) for o in outs["cohort"]] == list(AB_NEWS)
    assert outs["cohort"] == outs["paged"], \
        "greedy tokens differ between the cohort and paged engines"
    assert len(c["capacities"]) > c["cohorts"], "no cohort cache grew"
    assert p["backfills"] >= 1, "the paged engine never backfilled"
    assert c["pages_allocated"] == c["pages_released"]
    log(f"  {cfg.arch}: tokens equal; slot_utilization cohort "
        f"{c['slot_utilization']:.3f}, paged {p['slot_utilization']:.3f}")
    return row


def phase_cohort_vs_paged() -> dict:
    """llama3.2-1b at full width cut to 4 layers and zamba2-1.2b at full
    width cut to 8 mixers, float32: ``cohort_against_paged``."""
    free_card()
    return {name: cohort_against_paged(dataclasses.replace(cfg, n_layers=n))
            for name, cfg, n in (("llama", get_cfg(), 4),
                                 ("zamba2", zamba_cfg(), 8))}


#: Phase 24's trace, one request a line: (image grid, text rows); a grid
#: of 0 is a text-only request of token ids.
COHORT_TRACE = ((16, 32),) * 4 + ((32, 64),) * 2 + ((0, 64),) * 2
COHORT_NEW = 64


def cohort_shapes(trace) -> tuple:
    """The (batch, prompt) of each cohort the engine makes of ``trace``:
    the requests of one prompt length, in order of first arrival (each
    group fits ``MAX_SLOTS``, so it is one cohort)."""
    count = {}
    for g, t in trace:
        count[g * g + t] = count.get(g * g + t, 0) + 1
    assert max(count.values()) <= MAX_SLOTS, count
    return tuple((n, s) for s, n in count.items())


#: Phase 23: zamba2's cohort prefill shapes on phase 24's trace, (4, 288),
#: (2, 1088) and (2, 64).
COHORT_SSD_SHAPES = cohort_shapes(COHORT_TRACE)


def phase_cohort_ssd(ssd_mod) -> dict:
    """``ssd_scan`` at the shapes zamba2-1.2b's cohort prefill gives it --
    its mixer (64 heads of 64, state 64) over a whole cohort's prompts,
    from the zero state a fresh cohort cache holds, final state out, at
    the chunk the model picks -- against its plain version: bf16 on tc,
    float32 on simt, two bf16 runs bit-identical; then the times of tc,
    simt and plain beside the bound."""
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import call_chunk, ssd_scan
    from repro_torch.models.mamba2 import kernel_chunk

    sc = zamba_cfg().ssm
    h = sc.expand * zamba_cfg().d_model // sc.head_dim
    p, n = sc.head_dim, sc.state_dim
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    out = {}
    for b, s in COHORT_SSD_SHAPES:
        errs, cases = {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            args = ssd_inputs(gen, b, s, h, p, n, dtype)
            init = torch.zeros((b, h, p, n), device=DEVICE)
            kc = kernel_chunk(sc.chunk, p, n, dtype.itemsize)
            before = counters(ssd_mod, ("tc", "simt"))
            y, fin = ssd_scan(*args, chunk=kc, init_state=init,
                              return_final=True)
            y2, fin2 = ssd_scan(*args, chunk=kc, init_state=init,
                                return_final=True)
            torch.cuda.synchronize()
            ran = body(ssd_mod, before, f"ssd_scan B={b} S={s}")
            assert ran == ("tc" if dtype == torch.bfloat16 else "simt"), ran
            assert torch.equal(y, y2) and torch.equal(fin, fin2), \
                f"ssd_scan B={b} S={s}: two runs differ"
            ry, rfin = ssd_ref(*args, init_state=init, return_final=True)
            what = (f"ssd_scan {str(dtype)[6:]} B={b} S={s} chunk "
                    f"{call_chunk(dtype, kc, s, p, n)} {ran}")
            errs[str(dtype)[6:]] = {
                "y": held_to(y, ry, SSD_TOL[dtype], what + ": y"),
                "final": held_to(fin, rfin, SSD_TOL[dtype],
                                 what + ": final state")}
            cases[dtype] = (args, init, kc)
        args, init, kc = cases[torch.bfloat16]
        row = ssd_timing(ssd_mod, args, init, kc,
                         f"B={b} S={s} from zero state",
                         max(errs["bfloat16"].values()))
        row["errors"] = errs
        out[f"B={b} S={s}"] = row
    return out


def serve_cohort(cfg, prompts, max_new: int, mods: dict) -> dict:
    """``ServeEngine`` on ``cfg`` with cohort batching (seeded random bf16
    weights, ``MAX_SLOTS``, ``MAX_LEN``) serving ``prompts`` of
    ``max_new`` tokens each, after a warm-up engine (same weights) served
    the last two of them for 2 tokens.  Every launch counter of ``mods``
    is set to 0 just before the main path's run and read just after it.
    Then the card's busy share over a 2-request sub-trace of 8 new tokens
    (``profile_serve``).  Returns the row of figures."""
    from repro_torch.serve import ServeEngine, ServePolicy

    policy = ServePolicy(batching="cohort", max_slots=MAX_SLOTS,
                         max_len=MAX_LEN, max_new_tokens=max_new)
    t0 = time.perf_counter()
    warm = ServeEngine(cfg, policy, dtype=torch.bfloat16, seed=0,
                       device=DEVICE)
    t1 = time.perf_counter()
    warm.generate(prompts[-2:], max_new_tokens=2)
    torch.cuda.synchronize()
    log(f"  seeded weights on the card: {t1 - t0:.1f} s; warm-up run: "
        f"{time.perf_counter() - t1:.1f} s")
    engine = ServeEngine(cfg, policy, dtype=torch.bfloat16,
                         params=warm.params, device=DEVICE)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    names = ("LAUNCHES", "LAUNCHES_SPLIT", "LAUNCHES_MLA", "LAUNCHES_TC",
             "LAUNCHES_SIMT")
    for mod in mods.values():       # the main path's run starts here
        for name in names:
            if hasattr(mod, name):
                setattr(mod, name, 0)
    t0 = time.perf_counter()
    outs = engine.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: {n: getattr(mod, n) for n in names if hasattr(mod, n)}
                for k, mod in mods.items()}           # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 1e9
    m = engine.metrics
    events = engine.tracer.export_events()
    submit = {e["tid"]: e["ts"] for e in events if e["name"] == "submit"}
    ttft = sorted((e["ts"] - submit[e["tid"]]) / 1e6 for e in events
                  if e["name"] == "first_token")
    ticks = [e for e in events if e["name"] == "decode_tick"]
    prefills = [e for e in events if e["name"] == "prefill"]
    row = {
        "arch": cfg.arch, "layers": cfg.n_layers, "batching": "cohort",
        "tokens": int(m["tokens"]), "wall_s": wall,
        "decode_steps": int(m["decode_steps"]), "cohorts": int(m["cohorts"]),
        "prefill_s": [e["dur"] / 1e6 for e in prefills],
        "decode_tok_s": (sum(e["args"]["active"] for e in ticks)
                         / (sum(e["dur"] for e in ticks) / 1e6)),
        "decode_step_ms_p50": float(np.median([e["dur"] / 1e3
                                               for e in ticks])),
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "page_tokens": int(m["page_tokens"]),
        "capacities": list(m["capacities"]),
        "capacities_grown": len(m["capacities"]) - int(m["cohorts"]),
        "slot_utilization": m["slot_utilization"],
        "evictions": int(m["evictions"]),
        "pages_allocated": int(m["pages_allocated"]),
        "pages_released": int(m["pages_released"]),
        "launches": launches, "peak_mem_gb": peak,
    }
    log("  serve: " + json.dumps(row))
    assert [len(o) for o in outs] == [max_new] * len(prompts), \
        [len(o) for o in outs]
    assert all(0 <= tok < cfg.vocab_size for o in outs for tok in o)
    assert row["pages_allocated"] == row["pages_released"]
    sub = prompts[:1] + prompts[-1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(sub, max_new_tokens=8)
    torch.cuda.synchronize()
    row["busy_share_profiled"], row["busy_share"] = profile_serve(
        engine, sub, time.perf_counter() - t0, max_new=8)
    return row


def phase_cohort_serve(pa_mod, ssd_mod, zserve) -> dict:
    """Cohort serving at full width and depth, bf16, seeded random weights:
    qwen2-vl-7b (28 layers, 15.23 GB) on ``COHORT_TRACE`` -- 4 requests of
    a 16 x 16 image and 32 text rows (288), 2 of a 32 x 32 image and 64
    (1,088), 2 of 64 text tokens: three cohorts -- then zamba2-1.2b on
    the same lengths as token prompts, whose cohort prefills run
    ``ssd_scan`` on tc once a mixer (38 x 3 launches), beside phase 9's
    paged run."""
    free = free_card()
    cfg = qwen_cfg()
    weights = cfg.param_count() * 2 / 1e9
    log(f"  {cfg.arch}: {cfg.n_layers} layers, {weights:.2f} GB of bf16 "
        f"weights, {free / 1e9:.2f} GB free")
    rng = np.random.default_rng(0)
    prompts = [vlm_request(rng, cfg, g, t) if g else
               rng.integers(0, cfg.vocab_size, t, dtype=np.int32)
               for g, t in COHORT_TRACE]
    mods = {"paged": pa_mod, "ssd": ssd_mod}
    qwen = serve_cohort(cfg, prompts, COHORT_NEW, mods)
    assert qwen["cohorts"] == 3, qwen["cohorts"]
    assert all(n == 0 for d in qwen["launches"].values()
               for n in d.values()), qwen["launches"]
    log(f"  qwen2-vl: wall {qwen['wall_s']:.2f} s, decode "
        f"{qwen['decode_tok_s']:.1f} tok/s, TTFT p50 "
        f"{qwen['ttft_p50_s']:.3f} s / max {qwen['ttft_max_s']:.3f} s, peak "
        f"{qwen['peak_mem_gb']:.2f} GB, busy share {qwen['busy_share']:.3f};"
        f" no hand-written kernel on this path (launches "
        f"{json.dumps(qwen['launches'])})")

    free_card()
    zcfg = zamba_cfg()
    rng = np.random.default_rng(0)
    lens = [g * g + t for g, t in COHORT_TRACE]
    zprompts = [rng.integers(0, zcfg.vocab_size, n, dtype=np.int32)
                for n in lens]
    zamba = serve_cohort(zcfg, zprompts, COHORT_NEW, mods)
    assert zamba["cohorts"] == len(COHORT_SSD_SHAPES), zamba["cohorts"]
    sd = zamba["launches"]["ssd"]
    want = zcfg.n_layers * zamba["cohorts"]
    log(f"  zamba2 cohort: ssd_scan launches {json.dumps(sd)} (want "
        f"{zcfg.n_layers} mixers x {zamba['cohorts']} cohort prefills = "
        f"{want}, all tc); paged launches "
        f"{json.dumps(zamba['launches']['paged'])}")
    assert sd["LAUNCHES"] > 0, "the main path never launched ssd_scan"
    assert sd["LAUNCHES"] == sd["LAUNCHES_TC"] == want, sd
    assert zamba["launches"]["paged"]["LAUNCHES"] == 0
    if zserve is not None:
        log("  zamba2 cohort beside phase 9's paged run: " + json.dumps({
            k: {"cohort": zamba.get(k), "paged (its own trace)":
                zserve.get(k)}
            for k in ("wall_s", "decode_tok_s", "ttft_p50_s", "ttft_max_s",
                      "peak_mem_gb", "decode_steps", "tokens")}))
    return {"qwen2_vl": qwen, "zamba2": zamba}


def qwen_cfg():
    from repro_torch.configs import get_model_config

    return get_model_config(QWEN)


def whisper_cfg():
    from repro_torch.configs import get_model_config

    return get_model_config(WHISPER)


def zamba_cfg():
    from repro_torch.configs import get_model_config

    return get_model_config(ZAMBA)


def mixtral_cfg():
    from repro_torch.configs import get_model_config

    return get_model_config(MIXTRAL)


def xlstm_cfg():
    from repro_torch.configs import get_model_config

    return get_model_config(XLSTM)


def deepseek_cfg():
    from repro_torch.configs import get_model_config

    return get_model_config(DEEPSEEK)


def get_cfg():
    from repro_torch.configs import get_model_config

    return get_model_config(ARCH)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails without the repository's src/)
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import matmul_cc as mm_mod
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.serve.engine import plan_decode
    from repro_torch.tune.cache import TUNING_ENV

    # Phases 0-4 see no tuning artifact: the path names no file.
    os.environ[TUNING_ENV] = os.path.join(BUILD, "no_tuning_artifact.json")
    # Float32 products in full float32 (the default for matmuls; stated).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []
    smi = smi_line()
    log(f"[0] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            log(f"  {name}: ok ({time.perf_counter() - t0:.1f} s)")
            return out
        except Exception:
            traceback.print_exc()
            log(f"  {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)
            return None

    sass, sass_by_fn = {}, {}

    def build():
        t0 = time.perf_counter()
        try:
            paths = _build.build_all()
        finally:
            for name, (secs, out) in _build.BUILD_LOG.items():
                log(f"  built {name} in {secs:.1f} s")
                for line in out.splitlines():
                    if any(w in line for w in ("Compiling entry", "registers",
                                               "spill", "error", "warning")):
                        log(f"    {line.strip()}")
        log(f"  libraries: {[str(p) for p in paths.values()]}")
        # The tensor-core bodies really hold tensor-core instructions
        # (HGMMA: wgmma, HMMA: mma.sync) and async copies (UTMALDG: TMA,
        # LDGSTS: cp.async); the combine and state-passing kernels of the
        # split and tc bodies are elementwise and hold neither.
        ops = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")
        bodies = {"matmul_cc": ("wgmma_kernel",),
                  "flash_attention": ("wgmma_kernel",),
                  "paged_attention": ("paged_split_kernel",
                                      "paged_mla_kernel"),
                  "ssd_scan": ("ssd_states_kernel", "ssd_out_kernel")}
        for name, marks in bodies.items():
            counts = _build.sass_counts(name, ops)
            total = dict.fromkeys(ops, 0)
            sass_by_fn.update(counts)
            for fn, c in counts.items():
                log(f"  sass {fn}: " + ", ".join(f"{op} {c[op]}"
                                                  for op in ops))
                if any(m in fn for m in marks):
                    assert c["HGMMA"] + c["HMMA"] > 0, (fn, c)
                    assert c["UTMALDG"] + c["LDGSTS"] > 0, (fn, c)
                    for op in total:
                        total[op] += c[op]
            assert total["HGMMA"] + total["HMMA"] > 0, \
                f"{name}: no tensor-core kernel"
            sass[name] = {op: n for op, n in total.items() if n}
        return time.perf_counter() - t0

    log("[1] build (one nvcc per source, all started together)")
    build_s = phase("phase 1 build", build)
    plan = plan_decode(get_cfg(), max_len=MAX_LEN, batch=MAX_SLOTS,
                       dtype_bytes=2)
    t = plan.page_plan()["page_tokens"]
    log(f"  planned page: {t} tokens ({plan.page_plan()['page_bytes']} B "
        f"per layer page, SMEM budget {plan.level('SMEM').budget_bytes} B, "
        f"{plan.page_plan()['source']})")
    kern = serve = tk = tune = zk = zserve = mk = mserve = xserve = None
    dk = dserve = wk = wserve = qslice = ab = cssd = cserve = None
    if build_s is not None:
        log("[2] kernel against its plain version")
        kern = phase("phase 2 kernel", phase_kernel, t)
        log("[3] 2-layer full-width slice, cuda against cpu, float32")
        phase("phase 3 slice", phase_slice, t)
        log("[4] serving full-width llama3.2-1b, bf16")
        serve = phase("phase 4 serve", phase_serve, pa_mod)
        log("[5] the tuning path's kernels against their plain versions, "
            "full width")
        tk = phase("phase 5 kernels", phase_tuning_kernels)
        log("[6] the tuning path at full width")
        tune = phase("phase 6 tune", phase_tune, {
            "matmul_cc": mm_mod, "flash_attention": fa_mod,
            "paged_attention": pa_mod, "ssd_scan": ssd_mod})
        # Phases 7-9 plan without a tuning artifact, as phases 0-4 do.
        os.environ[TUNING_ENV] = os.path.join(BUILD,
                                              "no_tuning_artifact.json")
        zplan = plan_decode(zamba_cfg(), max_len=MAX_LEN, batch=MAX_SLOTS,
                            dtype_bytes=2)
        zt = zplan.page_plan()["page_tokens"]
        log(f"  zamba2-1.2b planned page: {zt} tokens, chunk "
            f"{zplan.chunk_tokens()} ({zplan.page_plan()['source']})")
        log("[7] zamba2-1.2b's shapes: paged attention (group 1, page "
            f"{zt}) and the SSD scan with state, against their plain "
            "versions")
        zk = phase("phase 7 zamba2 kernels", phase_zamba_kernels, zt)
        log("[8] zamba2-1.2b at full width cut to 2 mixers and 1 shared "
            "block, cuda against cpu, float32")
        phase("phase 8 zamba2 slice", phase_zamba_slice, zt)
        log("[9] serving full-width zamba2-1.2b, bf16")
        zserve = phase("phase 9 zamba2 serve", phase_zamba_serve, pa_mod,
                       ssd_mod)
        mplan = plan_decode(mixtral_cfg(), max_len=MAX_LEN, batch=MAX_SLOTS,
                            dtype_bytes=2)
        mt = mplan.page_plan()["page_tokens"]
        log(f"  mixtral-8x7b planned page: {mt} tokens "
            f"({mplan.page_plan()['source']})")
        log(f"[10] mixtral-8x7b's shapes: paged attention (group 4, D 128, "
            f"page {mt}, window 4096, null pages below the window), against "
            "its plain version")
        mk = phase("phase 10 mixtral kernels", phase_mixtral_kernels, mt)
        log("[11] mixtral-8x7b at full width cut to 2 layers, cuda against "
            "cpu, float32")
        phase("phase 11 mixtral slice", phase_mixtral_slice, mt)
        log("[12] serving full-width mixtral-8x7b cut in depth, bf16; one "
            f"{LONG_PROMPT}-token windowed request")
        mserve = phase("phase 12 mixtral serve", phase_mixtral_serve, pa_mod)
        log("[13] xlstm-1.3b at full width cut to one period of 8 blocks, "
            "cuda against cpu, float32")
        phase("phase 13 xlstm slice", phase_xlstm_slice)
        log("[14] serving full-width xlstm-1.3b, bf16")
        xserve = phase("phase 14 xlstm serve", phase_xlstm_serve, pa_mod)
        free_card()
        dplan = plan_decode(deepseek_cfg(), max_len=MAX_LEN, batch=MAX_SLOTS,
                            dtype_bytes=2)
        dt = dplan.page_plan()["page_tokens"]
        log(f"  deepseek-v2-236b planned page: {dt} tokens, "
            f"{dplan.page_table()['pages_per_slot']} pages a slot "
            f"({dplan.page_plan()['source']})")
        log(f"[15] deepseek-v2-236b's shapes: paged attention (128 heads "
            f"over the 576-wide latent, page {dt}), against its plain "
            "version")
        dk = phase("phase 15 deepseek kernels", phase_deepseek_kernels, dt,
                   sass_by_fn)
        log("[16] deepseek-v2-236b at full width cut to 2 layers (dense + "
            "MoE), cuda against cpu, float32")
        phase("phase 16 deepseek slice", phase_deepseek_slice, dt)
        log("[17] serving full-width deepseek-v2-236b cut in depth, bf16")
        dserve = phase("phase 17 deepseek serve", phase_deepseek_serve,
                       pa_mod)
        free_card()
        wplan = plan_decode(whisper_cfg(), max_len=MAX_LEN, batch=MAX_SLOTS,
                            dtype_bytes=2)
        wt = wplan.page_plan()["page_tokens"]
        log(f"  whisper-large-v3 planned page: {wt} tokens, "
            f"{wplan.page_table()['pages_per_slot']} pages a slot "
            f"({wplan.page_plan()['source']})")
        log(f"[18] whisper-large-v3's decoder shapes: paged attention "
            f"(group 1, 20 KV heads, page {wt}), against its plain version")
        wk = phase("phase 18 whisper kernels", phase_whisper_kernels, wt)
        log("[19] whisper-large-v3 at full width cut to 2 encoder and 2 "
            "decoder layers, cuda against cpu, float32")
        phase("phase 19 whisper slice", phase_whisper_slice, wt)
        log("[20] serving full-width, full-depth whisper-large-v3, bf16")
        wserve = phase("phase 20 whisper serve", phase_whisper_serve, pa_mod)
        log("[21] qwen2-vl-7b at full width cut to 2 layers: a cohort of 2 "
            "image + text requests, cuda against cpu, float32")
        qslice = phase("phase 21 qwen2-vl slice", phase_qwen_slice)
        log("[22] the cohort engine against the paged engine on the card, "
            "float32: llama3.2-1b (4 layers), zamba2-1.2b (8 mixers)")
        ab = phase("phase 22 cohort vs paged", phase_cohort_vs_paged)
        log("[23] ssd_scan at zamba2-1.2b's cohort prefill shapes, against "
            "its plain version")
        cssd = phase("phase 23 cohort ssd_scan", phase_cohort_ssd, ssd_mod)
        log("[24] cohort serving at full width and depth, bf16: qwen2-vl-7b "
            "and zamba2-1.2b")
        cserve = phase("phase 24 cohort serve", phase_cohort_serve, pa_mod,
                       ssd_mod, zserve)
    if failed or None in (kern, serve, tk, tune, zk, zserve, mk, mserve,
                          xserve, dk, dserve, wk, wserve, qslice, ab, cssd,
                          cserve):
        log(f"FAILED phases: {failed}")
        return 1
    dec = kern["timings"]["decode"]
    pre = kern["timings"]["prefill"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:50",
        "launches": serve["LAUNCHES"],
        "max_abs_err": kern["max_abs_err"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "path": dec["path"],
        "ms_simt": dec["ms_simt"], "sass": sass["paged_attention"],
        "prefill": {k: pre[k] for k in ("ms", "ms_simt", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "bound_by", "path")},
    }]
    for name, line in (("matmul_cc", 33), ("flash_attention", 34),
                       ("ssd_scan", 25)):
        row = tk[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": tune["launches"][name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "path": row["path"],
        })
        kernels[-1].update(ms_simt=row["ms_simt"], sass=sass[name])
    # zamba2-1.2b: the paged kernel's and the SSD scan's serving launches
    # (phase 9), and their times and bounds at its shapes (phase 7).  The
    # SSD scan's main path is now serving; its sweep launches stay beside.
    keys = ("ms", "ms_simt", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "path")
    zl = zserve["launches"]
    kernels[0]["zamba2"] = {
        "launches": zl["paged"]["LAUNCHES"],
        "launches_split": zl["paged"]["LAUNCHES_SPLIT"],
        "max_abs_err": zk["paged_err"],
        **{name: {k: row[k] for k in keys}
           for name, row in zk["paged"].items()}}
    # mixtral-8x7b: the paged kernel's serving launches (phase 12) and its
    # times and bounds at group 4, D 128, window 4096 (phase 10).
    kernels[0]["mixtral"] = {
        "layers": mserve["depth"],
        "launches": mserve["launches"]["paged"]["LAUNCHES"],
        "launches_split": mserve["launches"]["paged"]["LAUNCHES_SPLIT"],
        "max_abs_err": mk["paged_err"],
        **{name: {k: row[k] for k in keys}
           for name, row in mk["paged"].items()}}
    # deepseek-v2-236b: the paged kernel's serving launches (phase 17) by
    # body, and its times and bounds at 128 heads x D 576 (phase 15).
    dl = dserve["launches"]["paged"]
    kernels[0]["deepseek"] = {
        "layers": dserve["depth"],
        "launches": dl["LAUNCHES"],
        "launches_mla": dl["LAUNCHES_MLA"],
        "launches_simt": dl["LAUNCHES_SIMT"],
        "max_abs_err": dk["paged_err"], "sass_mla": dk["sass"],
        **{name: {k: row[k] for k in keys}
           for name, row in dk["paged"].items()}}
    # whisper-large-v3: the paged kernel's serving launches (phase 20) and
    # its times and bounds at 20 over 20 heads, D 64, page 16 (phase 18).
    wl = wserve["launches"]["paged"]
    kernels[0]["whisper"] = {
        "launches": wl["LAUNCHES"],
        "launches_split": wl["LAUNCHES_SPLIT"],
        "max_abs_err": wk["paged_err"],
        **{name: {k: row[k] for k in keys}
           for name, row in wk["paged"].items()}}
    ssd = kernels[3]
    ssd["launches_tune"] = ssd["launches"]
    ssd["launches"] = zl["ssd"]["LAUNCHES"]
    ssd["zamba2"] = {
        "launches": zl["ssd"]["LAUNCHES"],
        "launches_tc": zl["ssd"]["LAUNCHES_TC"],
        "max_abs_err": zk["ssd_err"],
        **{name: {k: row[k] for k in keys + ("chunk",)}
           for name, row in zk["ssd"].items()}}
    # The cohort engine: zamba2-1.2b's cohort prefills (phase 24) launch
    # ssd_scan once a mixer, on tc; its times at their shapes (phase 23).
    zc = cserve["zamba2"]["launches"]["ssd"]
    ssd["cohort"] = {
        "launches": zc["LAUNCHES"], "launches_tc": zc["LAUNCHES_TC"],
        "launches_simt": zc["LAUNCHES_SIMT"],
        "max_abs_err": max(row["max_abs_err"] for row in cssd.values()),
        **{name: {k: row[k] for k in keys + ("chunk",)}
           for name, row in cssd.items()}}
    # Phase 24's figures again at the end of the output, where the
    # profiler tables above do not push them out of a short tail.
    log("cohort serving: " + json.dumps({
        name: {k: row[k] for k in (
            "wall_s", "decode_tok_s", "ttft_p50_s", "ttft_max_s",
            "peak_mem_gb", "decode_steps", "cohorts", "slot_utilization",
            "busy_share")}
        for name, row in cserve.items()}))
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        log(f"FAILED: the main path never launched {missing}")
        return 1
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
