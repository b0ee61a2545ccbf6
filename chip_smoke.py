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
 25. the radix prefix cache, float32 at cut depth, seeded weights, one
     slot: llama3.2-1b (4 layers), mixtral-8x7b (2, window 4096),
     deepseek-v2-236b (2: the dense layer and one MoE layer), zamba2-1.2b
     (8 mixers) and xlstm-1.3b (one mLSTM and one sLSTM block).  For a
     prefix of 2.5 pages (mid-page) and of 2 pages (page boundary), call
     A publishes a prompt and call B sends one sharing the prefix to the
     warm engine and to a cold one: the warm call's hits, hit tokens,
     pages saved, CoW copies and prefill tokens equal what the CPU tests
     expect, and its greedy tokens the cold run's (xLSTM: the state
     restored at the hit boundary equals the cold run's there);
 26. the system-prompt trace on full-width llama3.2-1b, bf16, 8 slots:
     call A is a seeded 1,000-token system prompt and a 24-token tail (1
     new token); call B is 8 requests of the system prompt and tails of
     24-248 tokens, 32 new tokens each, streamed through ``on_token``,
     served by the warm engine and by a cold one (cache off, same
     weights).  Warm beside cold: wall, TTFT, decode rate, prefill tokens
     and chunks, hits, hit tokens, pages saved, CoW copies, resident bytes
     against ``plan.prefix_budget()``, peak memory, the share of matching
     tokens and launches by body (all ``split``); 8 hits of 1,000 tokens,
     each a CoW of its 56-token page;
 27. the same on full-width zamba2-1.2b (8-token pages): 8 hits of 1,000
     tokens, no CoW, the state snapshots' bytes resident, every paged
     launch ``split`` and every SSD launch ``tc``;
 28. ``export_pages`` from a llama3.2-1b engine (4 layers, float32) after
     call A, ``import_pages`` into a second engine on the same weights:
     its next request hits the whole page-aligned prefix, with the first
     engine's tokens;
 29. ``python -m repro_torch.obs.cli report`` (its ``pool_pages`` row
     inside the band) and ``python -m repro_torch.launch.serve --arch
     llama3.2-1b --prefix radix --tokens 8`` exit 0 on the card.
 30. zamba2-1.2b's state snapshots under a cap of ``CAP_SNAPSHOTS``, 8
     long prefills at once: live snapshots stay within the cap.
 31. the paper's run-time system on the card's host (host code: its
     numbers are the host CPU's, not the card's): the CPU's vendor,
     family, model and model name, the logical CPU count, the cache sizes
     glibc reads from the CPU (shown, not used) and the host's cache tree
     as the port's ``read_linux_hierarchy`` reads it (a tree with no cache
     level is said so, and the phase then runs on ``paper_system_a``,
     labelled so);
     then Table 3's MatMult (n = 768, TCL L2) and SOR (2048 x 2048, 4
     sweeps, TCL L1) through the port's ``Engine``, cache-conscious
     beside horizontal, each with 1 worker on the calling thread (the
     reference's setting) and with the cores of the host's lowest shared
     cache group as threads under CC and under SRRC; every product equals
     a float64 product within 2e-4 x (1 + |ref|), every SOR grid a plain
     sweep exactly; one line a run with np, tasks, workers, the four
     stage times of the best of 2 repeats, and horizontal over
     cache-conscious.  The bodies are the caller's numpy code: the product
     numpy's unblocked ``einsum(..., optimize=False)`` over views, the
     sweep the reference benchmark's 5-point update of a padded copy.
 32. the serving cluster on the card, llama3.2-1b at full width and depth:
     (a) ``plan_decode(cluster=2)`` places 2 replicas at the DCN level
     with the single engine's page table below it, and a 2-host hierarchy
     without ``cluster`` raises ``PlanError`` at DCN; the card memory one
     spawned worker holds outside its allocator is measured and must fit
     ``cluster.CONTEXT_BYTES``; (b) float32, 6 prompts of 300-700 tokens,
     16 new each, greedy: one engine (one slot, radix cache, one prompt a
     call), a 2-replica ``ServeCluster`` over threads (every paged launch
     ``simt``, as float32 routes it, one per layer and tick or chunk) and
     one over spawned processes give identical tokens, with the
     placements printed; (e) ``ClusterServer`` in front of the spawned
     cluster streams one prompt's tokens as NDJSON, equal to (b)'s, and
     ``/stats`` lists 2 replicas; (d) disaggregated 1:1 over spawned
     processes: the 700-token prompt's pages cross the spawn queues as
     host numpy (pages, bytes and seconds printed), the decode replica
     hits all of them, and its tokens equal (b)'s; (c) bf16, 16 requests
     of 512 prompt tokens and 64 new ones, all submitted at once, policy
     ``free_pages``, 8 slots an engine: one engine, 2 thread replicas
     (every paged launch ``split``) and 2 spawned ones side by side --
     wall, tok/s, TTFT p50/p95, each replica's pages, tokens and KV
     budget, the card's used memory before, during and after, nvidia-smi's
     utilization and the profiled busy share (in-process ways only).
     Replicas on one card split its HBM (``cluster.replica_kv_budget``).
 33. training, whose path holds no hand-written kernel (the reference's
     training forward reaches no Pallas kernel, and no kernel has a
     backward): (a) each of the four wrappers refuses a CUDA input that
     requires grad under grad mode (no launch counted), and a reduced
     zamba2-1.2b training forward and backward on the card launches no
     ``ssd_scan`` (it runs ``ssd_chunked``) and gives its Mamba2 ``wx``,
     ``wB``, ``wC``, ``wdt``, ``conv_w``, ``A_log`` and ``dt_bias``
     non-zero gradients, beside phase 9's serving ``ssd_scan`` launches;
     (b) every registered arch, reduced, float32 with TF32 off: the loss
     and every gradient leaf on the card, and one ``make_train_step``
     step (moments, and the parameters where |g| > 1e-6: Adam's first
     step is a sign), against the port on the CPU within ``TRAIN_TOL``;
     (c) full-width llama3.2-1b (16 layers, d_model 2048) through
     ``Trainer.fit`` on ``DataPipeline``: bf16 compute over float32
     parameters and moments, remat "full", train_4k's 4,096 tokens at a
     global batch of 8 -- cut from its 256 -- in 4 microbatches, lr
     3e-4, warmup 2; 1 warm-up step (finite gradient norm, every leaf
     changed, step-0 nll within [0.5, 3] x ln V), 4 timed steps (median
     step seconds, tokens/s, the model FLOP share of 989 TFLOP/s with
     its formula, peak memory) with every launch counter at 0, then one
     step under ``torch.profiler`` (busy share, top 10 device ops);
     (d) ``python -m repro_torch.launch.train`` on the card at reduced
     llama3.2-1b for 40 steps (lr 3e-3, warmup 5) drops the loss by more
     than 0.5, and 2 + 2 steps across a blocking save and a fresh
     ``Trainer``'s restore equal 4 straight steps (float32).

 35. serving over a device mesh: (a) full-width llama3.2-1b through
     ``ServeEngine(mesh=make_host_mesh())`` on a one-rank NCCL world, phase
     4's first four prompts: float32 greedy tokens of the paged engine (8
     new) and of the cohort engine on the mesh equal the meshless paged
     engine's; bf16 on phase 4's whole trace
     (32 new, after a 2-prompt warm-up), the mesh engine's wall and tok/s
     beside the meshless engine's and its paged launches, all ``split``
     (counted in the kernels line under ``mesh``); the world is destroyed
     after; (b) 4 gloo ranks on the card's host (``spawn_world``) serve
     the reduced llama3.2-1b at (2, 2), paged and cohort, under a shrunk
     ``h100_spec(hbm_bytes=250_000)`` (kv_shard 2) and the default spec
     (kv_shard 1): tokens equal the meshless engine's; (c) the dry run on
     the host in two subprocesses started together: ``--plan-tree`` for
     every arch on both production meshes, and ``--calibrate`` of
     llama3.2-1b x train_4k and x decode_32k on 16 x 16 (each cell's
     roofline row printed; host-CPU seconds) into a temporary artifact
     that ``calibration_overhead`` reads back.

Phases 0-4, 7-30 and 32 plan and serve without a tuning artifact (the port's
tuning path points at a file that does not exist until phase 6 writes
one), so their numbers compare with earlier runs'.  Each phase prints its
seconds.

Output, at the end: one JSON line describing the kernels (the zamba2,
mixtral, deepseek and whisper shapes nested under the paged and SSD
entries, the cohort engine's ``ssd_scan`` launches and shapes under
``cohort``, the radix cache's warm launches under ``prefix`` and the
cluster's under ``cluster``; phase 33's training figures on a line of
their own before it), the
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
#: Phase 12's deepest cut: 12 of mixtral-8x7b's 32 layers (25 fit the
#: card), which keeps the script inside its time limit.
MIXTRAL_LAYERS = 12
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


#: Every launch counter a kernel module may have (``LAUNCHES`` their sum).
COUNTERS = ("LAUNCHES", "LAUNCHES_SPLIT", "LAUNCHES_MLA", "LAUNCHES_TC",
            "LAUNCHES_SIMT")


def zero_counts(mods: dict) -> None:
    """Set every launch counter of each module of ``mods`` to 0 (just
    before a main path's run)."""
    for mod in mods.values():
        for name in COUNTERS:
            if hasattr(mod, name):
                setattr(mod, name, 0)


def read_counts(mods: dict) -> dict:
    """``{key: {counter: launches}}`` for each module of ``mods`` (just
    after the run)."""
    return {k: {n: getattr(mod, n) for n in COUNTERS if hasattr(mod, n)}
            for k, mod in mods.items()}


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
    zero_counts(mods)               # the main path's run starts here
    t0 = time.perf_counter()
    outs = engine.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)                      # ... and ends here
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
    # Device activity only: the busy share reads kernels, and the host
    # ops' events would take the profiler a minute to sort (whisper).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, max_new_tokens=max_new)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    t1 = time.perf_counter()
    avgs = prof.key_averages()
    log(avgs.table(sort_by="self_cuda_time_total", row_limit=30))
    log(f"  profile sorted in {time.perf_counter() - t1:.1f} s")
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


#: Phase 9's zamba2 depth: 19 of its 38 mixers, which keeps the script
#: inside its time limit.
SERVE_ZAMBA_LAYERS = 19


def phase_zamba_serve(pa_mod, ssd_mod) -> dict:
    """Full-width zamba2-1.2b cut to ``SERVE_ZAMBA_LAYERS`` Mamba2 layers
    (and the shared block's applications among them) serving phase 4's
    trace: every paged launch on the split body, every SSD launch on tc,
    one per mixer and prefill chunk of more than one token (a one-token
    chunk takes ``ssd_step``)."""
    from repro_torch.serve.kvcache import attn_apps

    cfg = parity_cfg(ZAMBA, SERVE_ZAMBA_LAYERS)
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
    from repro_torch.tree import tree_flatten_with_paths

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
        for name, leaf in tree_flatten_with_paths(cache[part]).items():
            out[f"{part}/{name}"] = leaf
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
    """The deepest cut of full-width mixtral-8x7b, at most
    ``MIXTRAL_LAYERS``, whose bf16 weights and phase 4's page pool (8
    slots of 4096 tokens at the planned page) leave ``MIXTRAL_HEADROOM``
    of ``free_bytes``: ``(cfg, weight bytes, pool bytes)``."""
    from repro_torch.serve.engine import plan_decode
    from repro_torch.serve.kvcache import kv_token_bytes

    full = mixtral_cfg()
    for n in range(min(full.n_layers, MIXTRAL_LAYERS), 0, -1):
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
        chaotic=("prefill logits", "decode logits", "state/slstm/"))

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

    full = deepseek_cfg()
    for n in range(full.n_layers, full.moe.first_k_dense, -1):
        cfg = dataclasses.replace(full, n_layers=n)
        pool = deepseek_pool_bytes(cfg, 2)
        weights = tree_bytes(Model(cfg).param_specs(), 2)
        if weights + pool + DEEPSEEK_HEADROOM <= free_bytes:
            return cfg, weights, pool
    raise RuntimeError(f"no depth of {full.arch} fits {free_bytes} B")


def deepseek_pool_bytes(cfg, el: int) -> int:
    """Bytes of phase 4's page pool for a deepseek-v2-236b cut (``MAX_SLOTS``
    slots of ``MAX_LEN`` tokens at the planned page), at ``el`` bytes an
    element: given to its engines as ``kv_budget_bytes``, since their own
    budget subtracts ``cfg.param_count()``, which overcounts the cut."""
    from repro_torch.serve.engine import plan_decode
    from repro_torch.serve.kvcache import kv_token_bytes

    plan = plan_decode(cfg, max_len=MAX_LEN, batch=MAX_SLOTS,
                       dtype_bytes=el)
    pages = MAX_SLOTS * plan.page_table()["pages_per_slot"]
    return kv_token_bytes(cfg, el)[0] * plan.page_plan()["page_tokens"] \
        * pages


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
    zero_counts(mods)               # the main path's run starts here
    t0 = time.perf_counter()
    outs = engine.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)                      # ... and ends here
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
            k: {"cohort": zamba.get(k),
                f"paged (its own trace, {SERVE_ZAMBA_LAYERS} mixers)":
                zserve.get(k)}
            for k in ("wall_s", "decode_tok_s", "ttft_p50_s", "ttft_max_s",
                      "peak_mem_gb", "decode_steps", "tokens")}))
    return {"qwen2_vl": qwen, "zamba2": zamba}


# ---------------------------------------------------------------------------
# Phases 25-29: the radix prefix cache, page export/import, streaming and
# the command lines
# ---------------------------------------------------------------------------

#: The five prefix families at phase 25's cut depth, float32: (arch,
#: layers).  xlstm-1.3b's two blocks are one mLSTM and one sLSTM block
#: (``parity_cfg``).
PARITY_CUTS = ((ARCH, 4), (MIXTRAL, 2), (DEEPSEEK, 2), (ZAMBA, 8),
               (XLSTM, 2))
PARITY_NEW = 8
#: Phases 26-27's system-prompt trace: call A is a seeded system prompt of
#: ``SYSTEM_PROMPT`` tokens and a 24-token tail, 1 new token; call B is 8
#: requests of the same system prompt and distinct seeded tails of
#: ``SYSTEM_TAILS`` tokens (first token unlike call A's), ``PREFIX_NEW``
#: new tokens each.
SYSTEM_PROMPT = 1000
SYSTEM_TAILS = (24, 56, 88, 120, 152, 184, 216, 248)
PREFIX_NEW = 32
#: Phase 27's zamba2 depth: 10 of its 38 mixers, which keeps the script
#: inside its time limit since phase 35 serves zamba2 and deepseek-v2 on
#: a mesh too.
PREFIX_ZAMBA_LAYERS = 10
#: Engine counters read as deltas over one call.
CALL_KEYS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
             "pages_saved", "cow_copies", "prefill_tokens",
             "prefill_chunks", "decode_steps", "tokens")


def parity_cfg(arch: str, layers: int):
    """``arch`` at full width cut to ``layers``; xLSTM's period shrinks to
    the cut (one mLSTM and one sLSTM block at 2), so both state groups
    run."""
    from repro_torch.configs import get_model_config

    cfg = get_model_config(arch)
    if cfg.family == "xlstm":
        return dataclasses.replace(cfg, n_layers=layers, xlstm=dataclasses
                                   .replace(cfg.xlstm, slstm_every=layers))
    return dataclasses.replace(cfg, n_layers=layers)


def expected_hit(shared: int, published: int, t: int, state: bool) -> tuple:
    """``(hit tokens, CoW)`` of a request sharing ``shared`` tokens with a
    published prompt of ``published`` tokens on ``t``-token pages: a state
    family rounds down to the page; an attention family reuses all of it,
    copying the page it ends in when that page was completed."""
    full = (shared // t) * t
    if state or shared == full:
        return full, False
    if published >= full + t:
        return shared, True
    return full, False


def measured_call(engine, prompts, max_new, mods: dict,
                  on_token=None) -> tuple:
    """One ``generate`` call on the card: the launch counters of ``mods``
    set to 0 just before and read just after, the engine's counters as
    deltas, wall, TTFT and decode rate from this call's trace events, and
    peak memory.  Returns ``(row, outputs)``."""
    before = {k: int(engine.metrics[k]) for k in CALL_KEYS}
    first = engine._next_rid
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(mods)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=max_new,
                           on_token=on_token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    tids = set(range(first + 1, engine._next_rid + 1))
    events = engine.tracer.export_events()
    submit = {e["tid"]: e["ts"] for e in events
              if e["name"] == "submit" and e["tid"] in tids}
    start = min(submit.values())
    ttft = sorted((e["ts"] - submit[e["tid"]]) / 1e6 for e in events
                  if e["name"] == "first_token" and e["tid"] in tids)
    ticks = [e for e in events
             if e["name"] == "decode_tick" and e["ts"] >= start]
    busy = sum(e["dur"] for e in ticks) / 1e6
    row = {k: int(engine.metrics[k]) - before[k] for k in CALL_KEYS}
    row.update({
        "requests": len(prompts), "wall_s": wall,
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "decode_tok_s": (sum(e["args"]["active"] for e in ticks) / busy
                         if busy else float("nan")),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "multi_token_chunks": sum(1 for e in engine.metrics["interleave"]
                                  if e[0] == "chunk" and e[3] > 1),
    })
    return row, outs


def prefix_parity(cfg, mods: dict) -> dict:
    """``cfg`` in float32 on the card, seeded weights, one slot: for each
    geometry a call A publishes a prompt, and a call B sends a request
    sharing its first 2.5 pages (mid-page) or 2 pages (page boundary) to
    the warm engine and to a cold one (same weights, the cache on but
    holding nothing of B).  The warm call's prefix counters equal what the
    CPU test expects and its greedy tokens equal the cold run's.  For the
    state families (xLSTM's seeded sLSTM is chaotic) the slot's state rows
    just after the restore equal the state the cold engine computed from
    scratch at the hit boundary, and the slot's state after call B (the
    restore, then the suffix and the decode) equals the cold run's, both
    within ``SLICE_TOL``: a lost or misplaced restore fails even where the
    tokens would not show it."""
    from repro_torch.serve import ServeEngine, ServePolicy
    from repro_torch.serve.pages import slot_rows
    from repro_torch.serve.prefix import STATE_FAMILIES

    pol = ServePolicy(batching="paged", max_slots=1, max_len=MAX_LEN,
                      max_new_tokens=PARITY_NEW, prefix_cache="radix")
    warm = ServeEngine(cfg, pol, dtype=torch.float32, seed=0, device=DEVICE)
    cold = ServeEngine(cfg, pol, dtype=torch.float32, params=warm.params,
                       device=DEVICE)
    t = warm.page.page_tokens
    state = cfg.family in STATE_FAMILIES
    row = {"arch": cfg.arch, "layers": cfg.n_layers, "page_tokens": t}
    restored = {}
    apply = warm._apply_prefix_hit

    def recording(cache, slot, hit):
        cache = apply(cache, slot, hit)
        restored.update({g: {k: slot_rows(buf, slot).float().cpu().clone()
                             .numpy() for k, buf in cache["state"][g].items()}
                         for g in hit.state or {}})
        return cache

    warm._apply_prefix_hit = recording
    rng = np.random.default_rng(0)
    for geometry in ("mid_page", "page_boundary"):
        n = 2 * t + (t // 2 if geometry == "mid_page" else 0)
        shared = rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
        tails = [rng.integers(0, cfg.vocab_size, t // 2 + 2, dtype=np.int32)
                 for _ in range(2)]
        tails[1][0] = (tails[0][0] + 1) % cfg.vocab_size
        a, b = [np.concatenate([shared, x]) for x in tails]
        warm.generate([a])                        # call A publishes
        restored.clear()
        got, out = measured_call(warm, [b], PARITY_NEW, mods)   # call B
        want_row, want = measured_call(cold, [b], PARITY_NEW, {})
        hit, cow = expected_hit(n, len(a), t, state)
        expect = {"prefix_hits": 1, "prefix_hit_tokens": hit,
                  "pages_saved": hit // t, "cow_copies": int(cow),
                  "prefill_tokens": len(b) - hit}
        assert want_row["prefix_hits"] == 0, "the cold engine hit"
        match = float(np.mean(np.array(out[0]) == np.array(want[0])))
        cell = {**{k: got[k] for k in expect}, "match": match,
                "launches": got["launches"]}
        if state:
            # At the hit boundary: the rows the restore wrote against the
            # cold engine's from-scratch snapshot of ``b`` there; after
            # call B: the whole state against the cold run's.
            at_hit = cold.export_pages(b)["snaps"][hit]
            mine = warm._paged_session.cache["state"]
            theirs = cold._paged_session.cache["state"]
            assert set(restored) == set(at_hit), "no state was restored"
            for name, pairs in (
                    ("restore", [(f"{g}.{k}", restored[g][k], v)
                                 for g, d in at_hit.items()
                                 for k, v in d.items()]),
                    ("after", [(f"{g}.{k}", mine[g][k].float().cpu().numpy(),
                                v.float().cpu().numpy())
                               for g, d in theirs.items()
                               for k, v in d.items()])):
                err = 0.0
                for what, got_rows, ref_rows in pairs:
                    err = max(err, float(np.abs(got_rows - ref_rows).max()))
                    np.testing.assert_allclose(got_rows, ref_rows,
                                               err_msg=f"{name} {what}",
                                               **SLICE_TOL)
                cell[f"state_{name}_max_abs_err"] = err
        log(f"  {cfg.arch} ({cfg.n_layers} layers, page {t}) {geometry}: "
            + json.dumps(cell))
        assert {k: got[k] for k in expect} == expect, (got, expect)
        assert out == want, "a prefix hit changed the greedy tokens"
        row[geometry] = cell
    return row


def phase_prefix_parity(mods: dict, cfgs=None) -> dict:
    """Phase 25: ``prefix_parity`` for each prefix family at its cut."""
    out = {}
    for cfg in cfgs or [parity_cfg(a, n) for a, n in PARITY_CUTS]:
        free_card()
        out[cfg.arch] = prefix_parity(cfg, mods)
    return out


def system_trace(cfg, seed: int = 0) -> tuple:
    """``(call A's prompt, call B's prompts)`` of the system-prompt
    trace."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_PROMPT, dtype=np.int32)
    tail_a = rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)
    tails = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
             for n in SYSTEM_TAILS]
    for tail in tails:
        if tail[0] == tail_a[0]:
            tail[0] = (tail[0] + 1) % cfg.vocab_size
    return (np.concatenate([system, tail_a]),
            [np.concatenate([system, tail]) for tail in tails])


def phase_prefix_serve(cfg, mods: dict) -> dict:
    """Phases 26-27: ``cfg`` at full width and depth, bf16, seeded
    weights, ``MAX_SLOTS`` slots, ``MAX_LEN``, on the system-prompt trace.
    A warm engine (radix cache) serves call A, then call B with
    ``on_token``; a cold engine (cache off, same weights, warmed up on 8
    short prompts) serves call B alone.  Warm beside cold: wall, TTFT,
    decode rate, prefill tokens and chunks, the prefix counters, resident
    bytes against ``plan.prefix_budget()``, peak memory, the share of
    tokens that match, and launches by body; every paged launch ``split``
    (one per attention layer and tick or chunk) and every SSD launch
    ``tc`` (one per mixer and chunk of more than one token)."""
    from repro_torch.serve import ServeEngine, ServePolicy
    from repro_torch.serve.kvcache import attn_apps
    from repro_torch.serve.prefix import STATE_FAMILIES

    free_card()
    pol = dict(batching="paged", max_slots=MAX_SLOTS, max_len=MAX_LEN,
               max_new_tokens=PREFIX_NEW)
    t0 = time.perf_counter()
    warm = ServeEngine(cfg, ServePolicy(prefix_cache="radix", **pol),
                       dtype=torch.bfloat16, seed=0, device=DEVICE)
    cold = ServeEngine(cfg, ServePolicy(**pol), dtype=torch.bfloat16,
                       params=warm.params, device=DEVICE)
    rng = np.random.default_rng(1)
    cold.generate([rng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
                   for _ in range(MAX_SLOTS)], max_new_tokens=2)
    torch.cuda.synchronize()
    log(f"  seeded weights and the cold engine's warm-up: "
        f"{time.perf_counter() - t0:.1f} s")
    t = warm.page.page_tokens
    state = cfg.family in STATE_FAMILIES
    a, bs = system_trace(cfg)
    hit, cow = expected_hit(SYSTEM_PROMPT, len(a), t, state)
    row_a, _ = measured_call(warm, [a], 1, mods)
    st = warm.stats()

    def snapshot_bytes(stats) -> int:
        return stats["prefix_resident_bytes"] - \
            stats["prefix_pages"] * warm.page.page_bytes

    after_a = {"nodes": st["prefix_nodes"], "pages": st["prefix_pages"],
               "resident_bytes": st["prefix_resident_bytes"],
               "snapshot_bytes": snapshot_bytes(st)}
    cold_row, cold_outs = measured_call(cold, bs, PREFIX_NEW, mods)
    streamed = []
    warm_row, warm_outs = measured_call(
        warm, bs, PREFIX_NEW, mods,
        on_token=lambda i, tok: streamed.append((i, tok)))
    st = warm.stats()
    warm_row.update(resident_bytes=st["prefix_resident_bytes"],
                    snapshot_bytes=snapshot_bytes(st),
                    prefix_nodes=st["prefix_nodes"],
                    prefix_pages=st["prefix_pages"])
    budget = warm.plan.prefix_budget()
    total = sum(len(o) for o in cold_outs)
    match = sum(int(x == y) for o, p in zip(warm_outs, cold_outs)
                for x, y in zip(o, p)) / total
    row = {"arch": cfg.arch, "layers": cfg.n_layers, "page_tokens": t,
           "expected_hit": hit, "cow": cow, "call_a": row_a,
           "after_a": after_a, "prefix_budget": budget, "warm": warm_row,
           "cold": cold_row, "match": match}
    log(f"  {cfg.arch}: call A " + json.dumps(row_a))
    log(f"  {cfg.arch}: tree after call A " + json.dumps(after_a))
    keys = ("wall_s", "ttft_p50_s", "ttft_max_s", "decode_tok_s",
            "prefill_tokens", "prefill_chunks", "decode_steps",
            "prefix_hits", "prefix_hit_tokens", "pages_saved", "cow_copies",
            "peak_mem_gb", "launches")
    log(f"  {cfg.arch} call B, warm beside cold: " + json.dumps(
        {k: {"warm": warm_row[k], "cold": cold_row[k]} for k in keys}))
    log(f"  {cfg.arch}: resident {warm_row['resident_bytes']} B "
        f"({warm_row['snapshot_bytes']} B of state snapshots) of the "
        f"prefix budget {budget} B; {match:.4f} of call B's tokens match "
        f"the cold run's")
    # Streaming: every token of call B, in order, and no reset.
    replay = [[] for _ in bs]
    for i, tok in streamed:
        assert tok is not None, "a stream reset without a preemption"
        replay[i].append(tok)
    assert replay == warm_outs, "on_token's stream differs from generate"
    assert [len(o) for o in warm_outs] == [PREFIX_NEW] * len(bs)
    assert all(0 <= tok < cfg.vocab_size for o in warm_outs for tok in o)
    n = len(bs)
    assert warm_row["prefix_hits"] == n, warm_row["prefix_hits"]
    assert warm_row["prefix_hit_tokens"] == n * hit
    assert warm_row["cow_copies"] == (n if cow else 0)
    assert warm_row["prefill_tokens"] == sum(len(b) for b in bs) - n * hit
    assert cold_row["prefill_tokens"] == sum(len(b) for b in bs)
    assert warm_row["resident_bytes"] <= budget
    apps = attn_apps(cfg) if cfg.family == "hybrid_ssm" else cfg.n_layers
    for r in (warm_row, cold_row):
        pa = r["launches"]["paged"]
        assert pa["LAUNCHES"] > 0, "the main path never launched the kernel"
        assert pa["LAUNCHES"] == pa["LAUNCHES_SPLIT"] == \
            apps * (r["decode_steps"] + r["prefill_chunks"]), pa
        if "ssd" in r["launches"]:
            sd = r["launches"]["ssd"]
            assert sd["LAUNCHES"] == sd["LAUNCHES_TC"] == \
                cfg.n_layers * r["multi_token_chunks"] > 0, sd
    return row


#: Phase 30: the snapshot cap it sets, in snapshots, and its prompts.
CAP_SNAPSHOTS = 24
CAP_PROMPT = 64


def phase_snapshot_cap(cfg, mods: dict) -> dict:
    """Phase 30: zamba2-1.2b at full width and depth, bf16, seeded weights.
    A probe engine reads the default snapshot cap (the KV budget less the
    pool and the slots' state rows) and one snapshot's bytes; a second
    engine on the same weights gets a KV budget that leaves room for
    ``CAP_SNAPSHOTS`` snapshots, and its ``MAX_SLOTS`` slots prefill
    distinct ``CAP_PROMPT``-token prompts together (8 page boundaries
    each, 64 snapshots wanted).  The snapshots alive on the card (counted
    by reference) never pass the cap, the tree fills to it, and the
    tokens are in the vocabulary."""
    import weakref

    from repro_torch.serve import ServeEngine, ServePolicy

    free_card()
    pol = dict(batching="paged", max_slots=MAX_SLOTS, max_len=MAX_LEN,
               max_new_tokens=2, prefix_cache="radix")
    probe = ServeEngine(cfg, ServePolicy(**pol), dtype=torch.bfloat16,
                        seed=0, device=DEVICE)
    t = probe.page.page_tokens
    rng = np.random.default_rng(2)
    probe.generate([rng.integers(0, cfg.vocab_size, 2 * t + 1,
                                 dtype=np.int32)])
    sess = probe._paged_session
    snap = sess.prefix.state_bytes // sess.prefix.n_nodes
    default_cap = sess.prefix.state_budget_bytes
    held = probe.budget_bytes - default_cap
    key, params = sess.key, probe.params
    del probe, sess
    free_card()
    eng = ServeEngine(cfg, ServePolicy(
        kv_budget_bytes=held + CAP_SNAPSHOTS * snap, **pol),
        dtype=torch.bfloat16, params=params, device=DEVICE)
    live, peak = [], [0]
    snapshot = eng._snapshot

    def tracked(cache, slot, clone=True):
        out = snapshot(cache, slot, clone)
        if clone:
            live[:] = [r for r in live if r() is not None]
            live.append(weakref.ref(out["mamba"]["ssm"]))
            peak[0] = max(peak[0], len(live))
        return out

    eng._snapshot = tracked
    prompts = [rng.integers(0, cfg.vocab_size, CAP_PROMPT, dtype=np.int32)
               for _ in range(MAX_SLOTS)]
    got, outs = measured_call(eng, prompts, 2, mods)
    prefix = eng._paged_session.prefix
    cap = prefix.state_budget_bytes
    row = {"arch": cfg.arch, "page_tokens": t, "snapshot_bytes": snap,
           "default_cap_bytes": default_cap, "held_bytes": held,
           "cap_bytes": cap, "peak_live_snapshots": peak[0],
           "peak_state_bytes": prefix.peak_state_bytes,
           "state_bytes": prefix.state_bytes,
           "evicted_nodes": prefix.evicted_nodes,
           "nodes": prefix.n_nodes, "wall_s": got["wall_s"],
           "peak_mem_gb": got["peak_mem_gb"]}
    log("  snapshot cap: " + json.dumps(row))
    assert eng._paged_session.key == key, "the cap changed the pool"
    assert CAP_SNAPSHOTS * snap <= cap < (CAP_SNAPSHOTS + 1) * snap
    assert 0 < peak[0] * snap <= cap, (peak[0], cap)
    assert prefix.peak_state_bytes <= cap
    assert cap - snap < prefix.state_bytes <= cap, "the tree did not fill"
    assert all(len(o) == 2 and all(0 <= x < cfg.vocab_size for x in o)
               for o in outs)
    assert got["launches"]["ssd"]["LAUNCHES"] == \
        got["launches"]["ssd"]["LAUNCHES_TC"] > 0
    return row


def phase_export_import(cfg=None) -> dict:
    """Phase 28: ``export_pages`` from one engine (llama3.2-1b at full
    width cut to 4 layers, float32, radix cache) after it served call A of
    the system-prompt trace, ``import_pages`` into a second engine on the
    same weights; the second engine's next request (call B's first) hits
    the whole page-aligned prefix, and its greedy tokens equal the first
    engine's."""
    from repro_torch.serve import ServeEngine, ServePolicy

    free_card()
    cfg = cfg or parity_cfg(ARCH, 4)
    pol = ServePolicy(batching="paged", max_slots=1, max_len=MAX_LEN,
                      max_new_tokens=PARITY_NEW, prefix_cache="radix")
    src = ServeEngine(cfg, pol, dtype=torch.float32, seed=0, device=DEVICE)
    dst = ServeEngine(cfg, pol, dtype=torch.float32, params=src.params,
                      device=DEVICE)
    t = src.page.page_tokens
    a, bs = system_trace(cfg)
    b = bs[0]
    src.generate([a], max_new_tokens=1)
    t0 = time.perf_counter()
    payload = src.export_pages(b)
    export_s = time.perf_counter() - t0
    covered = (SYSTEM_PROMPT // t) * t
    nbytes = sum(arr.nbytes for page in payload["pages"]
                 for arr in page.values())
    t0 = time.perf_counter()
    got = dst.import_pages(payload["tokens"], payload["pages"],
                           payload["snaps"])
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    out = dst.generate([b])
    m = dst.metrics
    row = {"arch": cfg.arch, "layers": cfg.n_layers, "page_tokens": t,
           "pages": len(payload["pages"]), "bytes": nbytes,
           "export_s": export_s, "import_s": import_s, "covered": got,
           "hits": int(m["prefix_hits"]),
           "hit_tokens": int(m["prefix_hit_tokens"]),
           "prefill_tokens": int(m["prefill_tokens"])}
    log("  export/import: " + json.dumps(row))
    assert got == covered == len(payload["tokens"])
    assert (row["hits"], row["hit_tokens"]) == (1, covered)
    assert row["prefill_tokens"] == len(b) - covered
    assert out == src.generate([b]), "imported pages changed the tokens"
    return row


def phase_clis() -> dict:
    """Phase 29: ``python -m repro_torch.obs.cli report`` on the card exits
    0 with its ``pool_pages`` row inside the band, and ``python -m
    repro_torch.launch.serve --arch llama3.2-1b --prefix radix --tokens
    8`` exits 0 (each a process of its own, both started together; the
    kernels are already built)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    row = {}
    cmds = {"report": ["repro_torch.obs.cli", "report"],
            "serve": ["repro_torch.launch.serve", "--arch", ARCH, "--prefix",
                      "radix", "--tokens", "8"]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in cmds.items()}           # both at once
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            row[name] = {"rc": proc.returncode,
                         "s": time.perf_counter() - t0}
            log(f"  python -m {' '.join(cmds[name])}: rc {proc.returncode}"
                f", {row[name]['s']:.1f} s")
            for line in stdout.splitlines():
                log(f"    {line}")
            assert proc.returncode == 0, stderr[-2000:]
            if name == "report":
                pool = [ln for ln in stdout.splitlines()
                        if " pool_pages " in ln]
                assert len(pool) == 1 and "outside band" not in pool[0], \
                    pool
                assert "on cuda" in stdout
                # The shared prefix spans a page: the HBM prefix row
                # observes the tree's bytes.
                held = [ln for ln in stdout.splitlines()
                        if " hbm_prefix_leftover " in ln]
                assert len(held) == 1 and int(held[0].split()[4]) > 0, held
                row[name]["prefix_observed_bytes"] = int(
                    held[0].split()[4])
            else:
                assert "[serve] prefix: hits=" in stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return row


#: Phase 31: Table 3's MatMult and SOR sizes and TCLs as the reference's
#: benchmark runs them (benchmarks/run.py:55,60-61; paper_cpu.py's SOR
#: defaults to L1), and the repeats kept (the best).
PAPER_MM = (768, "L2")
PAPER_SOR = (2048, 4, "L1")
PAPER_REPEATS = 2
PAPER_OMEGA = np.float32(1.25)


def host_cpu() -> dict:
    """The host's CPU (the first processor of ``/proc/cpuinfo``: vendor,
    family, model number and model name, which a sandboxed kernel may give
    as "unknown") and its logical CPU counts."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    model = " ".join(f"{k} {fields[k]}" for k in (
        "vendor_id", "cpu family", "model", "model name") if k in fields)
    return {"model": model or "unknown", "logical_cpus": os.cpu_count(),
            "usable_cpus": len(os.sched_getaffinity(0))}


def paper_matmul(core, engine, A, B):
    """Fig. 3's blocked product through ``engine``: one task per (i, j, k)
    block triple, numpy's unblocked ``einsum`` over views; tasks of one C
    block may run on different threads, so each adds under its block's
    lock."""
    import threading

    n = A.shape[0]
    C = np.zeros((n, n), np.float32)
    locks = {}

    def make_tasks(plan):
        a_regions, b_regions, c_regions = plan.regions
        side = round(plan.np ** 0.5)
        locks.update((c, threading.Lock()) for c in range(side * side))
        return [(a_regions[i * side + kk], b_regions[kk * side + j],
                 i * side + j, c_regions[i * side + j])
                for (i, j, kk) in core.matmul_task_grid(plan.np)]

    def compute(task):
        a_reg, b_reg, c_id, c_reg = task
        part = np.einsum("ik,kj->ij", A[a_reg], B[b_reg], optimize=False)
        with locks[c_id]:
            C[c_reg] += part

    res = engine.run(core.matmul_domain(n, n, n, 4), compute,
                     make_tasks=make_tasks)
    return C, [res]


def paper_sor(core, engine, grid, sweeps: int):
    """The reference benchmark's SOR body (paper_cpu.py): each sweep reads
    a padded copy of the grid made before it and writes its own block."""
    cur = grid.copy()
    d = core.StencilDistribution(*grid.shape, 4, halo=1)
    runs = []
    for _ in range(sweeps):
        pad = np.pad(cur, 1, mode="edge")

        def compute(task):
            ((rs, cs),) = task
            blk = 0.25 * (
                pad[rs.start: rs.stop, cs.start + 1: cs.stop + 1]
                + pad[rs.start + 2: rs.stop + 2, cs.start + 1: cs.stop + 1]
                + pad[rs.start + 1: rs.stop + 1, cs.start: cs.stop]
                + pad[rs.start + 1: rs.stop + 1, cs.start + 2: cs.stop + 2])
            cur[rs, cs] = (1 - PAPER_OMEGA) * cur[rs, cs] + PAPER_OMEGA * blk

        runs.append(engine.run([d], compute))
    return cur, runs


def plain_sor(grid, sweeps: int):
    cur = grid.copy()
    for _ in range(sweeps):
        pad = np.pad(cur, 1, mode="edge")
        blk = 0.25 * (pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2]
                      + pad[1:-1, 2:])
        cur = (1 - PAPER_OMEGA) * cur + PAPER_OMEGA * blk
    return cur


def phase_paper_engine(smi: str) -> dict:
    """Phase 31: the port's ``Engine`` on the card's host (host code; every
    time here is the host CPU's), Table 3's MatMult and SOR under both
    strategies, 1 worker and the lowest shared cache group's cores under
    CC and SRRC, each result held to its plain computation."""
    from repro_torch import core

    cpu = host_cpu()
    log(f"  host CPU: {cpu['model']}; {cpu['logical_cpus']} logical CPUs, "
        f"{cpu['usable_cpus']} usable by this process")
    log(f"  card: {smi}")
    tree = core.read_linux_hierarchy()
    for lvl in tree.levels():
        log(f"  sysfs {lvl.name}: size {lvl.size} B, line "
            f"{lvl.cache_line_size}, {len(lvl.siblings)} copies, "
            f"{lvl.cores_per_copy} cores a copy")
    label = "host"
    if not tree.cache_levels():
        log("  the host's sysfs shows no cache level: the runs below use "
            "paper_system_a (the paper's System A), not this host's caches")
        tree, label = core.paper_system_a(), "paper_system_a"
    groups = core.lowest_level_shared_cache_groups(tree)
    k = max(len(g) for g in groups)
    llsc = tree.lowest_shared_cache()
    log(f"  tree: {label}; lowest shared cache {llsc.name if llsc else None}"
        f", groups of {k} cores: {groups}")
    configs = [(1, "cc", False), (k, "cc", True), (k, "srrc", True)]

    rng = np.random.default_rng(0)
    n, mm_tcl = PAPER_MM
    A = rng.standard_normal((n, n)).astype(np.float32)
    B = rng.standard_normal((n, n)).astype(np.float32)
    exact = A.astype(np.float64) @ B.astype(np.float64)
    sn, sweeps, sor_tcl = PAPER_SOR
    grid = rng.standard_normal((sn, sn)).astype(np.float32)
    sor_ref = plain_sor(grid, sweeps)

    def check_mm(C):
        err = np.abs(C - exact)
        assert (err <= 2e-4 * (1 + np.abs(exact))).all(), float(err.max())
        return float(err.max())

    def check_sor(out):
        assert np.array_equal(out, sor_ref), \
            float(np.abs(out - sor_ref).max())
        return 0.0

    benches = {
        f"matmult_{n}": (mm_tcl, lambda eng: paper_matmul(core, eng, A, B),
                         check_mm),
        f"sor_{sn}x{sweeps}": (sor_tcl,
                               lambda eng: paper_sor(core, eng, grid, sweeps),
                               check_sor),
    }
    threads_before = torch.get_num_threads()
    torch.set_num_threads(1)
    log(f"  threads: torch intra-op {threads_before} -> "
        f"{torch.get_num_threads()} for this phase (the bodies are numpy; "
        f"the engine's workers are OS threads)")
    rows = []
    try:
        for name, (tcl, run, check) in benches.items():
            for workers, schedule, parallel in configs:
                best = {}
                for strategy in ("cache_conscious", "horizontal"):
                    eng = core.Engine(tree, n_workers=workers, tcl=tcl,
                                      schedule=schedule, strategy=strategy,
                                      parallel=parallel)
                    for _ in range(PAPER_REPEATS):
                        t0 = time.perf_counter()
                        out, runs = run(eng)
                        wall = time.perf_counter() - t0
                        err = check(out)
                        if strategy in best and best[strategy]["s"] <= wall:
                            continue
                        stages = {f: sum(getattr(r.times, f) for r in runs)
                                  for f in ("decomposition", "scheduling",
                                            "execution", "reduction")}
                        best[strategy] = {
                            "bench": name, "tcl": tcl, "tree": label,
                            "strategy": strategy, "schedule": schedule,
                            "parallel": parallel, "n_workers": workers,
                            "np": runs[0].np,
                            "n_tasks": sum(r.n_tasks for r in runs),
                            "runs": len(runs),
                            "s": wall, "stages_s": stages,
                            "max_abs_err": err}
                ratio = best["horizontal"]["s"] / best["cache_conscious"]["s"]
                for strategy, row in best.items():
                    row["horizontal_over_cc"] = ratio
                    rows.append(row)
                    st = row["stages_s"]
                    log(f"  {name} tcl={tcl} {strategy} {schedule} "
                        f"workers={workers} "
                        f"{'threads' if parallel else 'one thread'}: "
                        f"np={row['np']} tasks={row['n_tasks']} over "
                        f"{row['runs']} run(s) "
                        f"best of {PAPER_REPEATS} {row['s']:.6f} s "
                        f"(decomposition {st['decomposition']:.6f}, "
                        f"scheduling {st['scheduling']:.6f}, execution "
                        f"{st['execution']:.6f}, reduction "
                        f"{st['reduction']:.6f}); horizontal / "
                        f"cache-conscious {ratio:.3f}")
    finally:
        torch.set_num_threads(threads_before)
    return {"cpu": cpu, "tree": label, "groups": groups, "runs": rows}


# ---------------------------------------------------------------------------
# Phase 32: the serving cluster on one card (the planner's DCN level, two
# replicas behind the router over threads and over spawned processes,
# disaggregated prefill/decode, the HTTP front end)
# ---------------------------------------------------------------------------

#: Replicas of the fleet, and the planning bound of every engine of it.
CLUSTER_N = 2
CLUSTER_MAX_LEN = 1024
#: (b): float32, greedy, one request a call; (d) serves prompt
#: ``DISAGG_PROMPT`` of them disaggregated.
CLUSTER_LENS = (300, 700, 420, 555, 333, 640)
CLUSTER_NEW = 16
DISAGG_PROMPT = 1
#: (c): bf16, 8 requests of 512 prompt tokens and 64 new ones each, all
#: submitted at once (8, not 16, for the script's time); ``MAX_SLOTS``
#: slots per engine; two windows of
#: ``CLUSTER_PROFILED`` more requests of 16 new tokens, one timed and one
#: profiled.
CLUSTER_REQS = 8
CLUSTER_PROMPT = 512
CLUSTER_SERVE_NEW = 64
CLUSTER_PROFILED = 4
#: Seconds any one reply of a worker may take (the first builds its
#: engine: full-width weights on the card).
CLUSTER_TIMEOUT = 900.0


def card_used() -> int:
    """Bytes in use on the card, by every process (``mem_get_info``)."""
    free, total = torch.cuda.mem_get_info()
    return total - free


class CardSampler:
    """Beside a run, every 0.2 s: the card's used memory (every process's)
    and ``nvidia-smi``'s ``utilization.gpu``, the share of the last sample
    period in which a kernel of any process ran.  ``row()`` gives the peak
    memory and the mean utilization ("not measured" where nvidia-smi gave
    no number)."""

    def __init__(self):
        import threading

        self.used, self.util = [], []
        self._stop = threading.Event()
        self._threads = []
        self._smi = None

    def __enter__(self):
        import threading

        self._smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

        def read_smi():
            for line in self._smi.stdout:
                if line.strip().isdigit():
                    self.util.append(int(line.strip()))

        def read_mem():
            while not self._stop.wait(0.2):
                self.used.append(card_used())

        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (read_smi, read_mem)]
        for th in self._threads:
            th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._smi.terminate()
        self._smi.wait(10)
        for th in self._threads:
            th.join(10)
        return False

    def row(self) -> dict:
        return {
            "mem_during_gb": max(self.used) / 1e9 if self.used else None,
            "smi_util_mean": (float(np.mean(self.util)) if self.util
                              else "not measured"),
            "smi_util_samples": len(self.util),
        }


def profiled_busy(serve, windows) -> dict:
    """The card's busy share as phases 4 and 9 read it (``profile_serve``):
    ``serve(windows[0])`` unprofiled and timed, then ``serve(windows[1])``
    (fresh prompts of the same shapes) under ``torch.profiler``; CUDA
    kernel time (this process's kernels only) over the profiled call's
    wall, which holds the profiler's own host cost, and over the
    unprofiled call's (two calls, so an estimate)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(windows[0])
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(windows[1])
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return {"busy_share": busy_us / wall_us,
            "busy_share_unprofiled_wall": busy_us / plain_us}


def cluster_prompts(cfg, lens, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32).tolist()
            for n in lens]


def cluster_plan(cfg, dtype_bytes: int, batch: int):
    """(a) The fleet plan: ``plan_decode(cluster=2)`` places 2 whole
    replicas at the DCN level, with the single engine's page table below
    it; a 2-host hierarchy without ``cluster`` raises at DCN."""
    from repro_torch.core.plan import PlanError
    from repro_torch.hw.h100 import h100_spec
    from repro_torch.serve.engine import plan_decode

    kw = dict(max_len=CLUSTER_MAX_LEN, batch=batch, dtype_bytes=dtype_bytes)
    fleet = plan_decode(cfg, cluster=CLUSTER_N, **kw)
    single = plan_decode(cfg, **kw)
    dcn = fleet.level("DCN")
    assert fleet.replicas() == dcn.np == CLUSTER_N, (fleet.replicas(), dcn)
    assert dcn.detail["placement"] == "replicas", dcn.detail
    assert dict(fleet.page_table()) == dict(single.page_table())
    try:
        plan_decode(cfg, hierarchy=h100_spec().hierarchy(hosts=CLUSTER_N),
                    **kw)
    except PlanError as e:
        assert e.level == "DCN", e.level
    else:
        raise AssertionError("a DCN plan without cluster= was accepted")
    for line in fleet.describe():
        log(f"    {line}")
    return fleet


def routed(cluster, prompts, max_new: int) -> tuple:
    """Every prompt submitted at once through the router; every reply
    read (an ``err`` reply, a dead worker or a timeout raises).  Returns
    the outputs in order, each request's replica, the sorted TTFTs
    (``ClusterRequest.ttft``: from submission) and the wall seconds."""
    t0 = time.perf_counter()
    crs = [cluster.submit(p, max_new) for p in prompts]
    outs = [cr.result(timeout=CLUSTER_TIMEOUT) for cr in crs]
    wall = time.perf_counter() - t0
    assert [len(o) for o in outs] == [max_new] * len(prompts), outs
    return outs, [cr.replica for cr in crs], \
        sorted(cr.ttft() for cr in crs), wall


def build_replicas(replicas, warm_prompts=None) -> None:
    """Each replica builds its engine (one ``stats`` instruction each, all
    at once); with ``warm_prompts``, each then serves one of them for 2
    tokens (the kernels' first launches), outside any measurement, and
    answers one more ``stats`` instruction, so that every spawned
    replica's last tick is its warm-up's before the router reads it (a
    tick still in flight would show one replica's pool fuller than the
    other's, and ``free_pages`` would send a whole burst to the other)."""
    calls = [rep.submit("stats", None) for rep in replicas]
    for call in calls:
        call.wait(CLUSTER_TIMEOUT)
    if warm_prompts:
        calls = [rep.generate([warm_prompts[i]], 2)
                 for i, rep in enumerate(replicas)]
        for call in calls:
            call.wait(CLUSTER_TIMEOUT)
        for call in [rep.submit("stats", None) for rep in replicas]:
            call.wait(CLUSTER_TIMEOUT)


def http_check(cluster, prompt, want) -> dict:
    """(e) ``ClusterServer`` in front of ``cluster``: one ``POST
    /generate`` streams NDJSON tokens equal to ``want``, ``GET /stats``
    lists every replica and ``GET /healthz`` admits them."""
    import urllib.request

    from repro_torch.cluster import ClusterServer

    srv = ClusterServer(cluster).start()
    try:
        host, port = srv.address
        base = f"http://{host}:{port}"
        req = urllib.request.Request(
            f"{base}/generate", data=json.dumps(
                {"tokens": prompt, "max_new_tokens": len(want)}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=CLUSTER_TIMEOUT) as r:
            lines = [json.loads(x) for x in r.read().splitlines()
                     if x.strip()]
        streamed = []
        for ln in lines:
            assert "error" not in ln, ln
            if ln.get("reset"):
                streamed.clear()
            elif "token" in ln:
                streamed.append(ln["token"])
        assert streamed == want and lines[-1].get("done") \
            and lines[-1]["tokens"] == want, lines[-1]
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            doc = json.loads(r.read())
        assert len(doc["replicas"]) == CLUSTER_N, doc
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "replicas": CLUSTER_N,
                          "admissible": CLUSTER_N}, health
    finally:
        srv.close()
    return {"replica": lines[-1]["replica"], "lines": len(lines),
            "stats_replicas": len(doc["replicas"])}


def fresh_stats(cluster) -> list:
    """Each replica's telemetry after one more ``stats`` instruction (a
    spawned replica's tick of its last run has then arrived)."""
    for rep in cluster.replicas:
        rep.submit("stats", None).wait(CLUSTER_TIMEOUT)
    return [rep.stats() for rep in cluster.replicas]


def replica_rows(stats) -> list:
    return [{"replica": s.replica, "free_pages": s.free_pages,
             "pages_total": s.pages_total, "tokens": s.tokens,
             "kv_budget_bytes": s.metrics.get("budget_bytes")}
            for s in stats]


def serve_way(name: str, run, stats) -> dict:
    """One way of (c): ``run()`` serves the trace (returns outputs, TTFTs
    and wall) beside a ``CardSampler``; ``stats()`` reads the replicas."""
    with CardSampler() as smp:
        outs, ttft, wall = run()
    tokens = sum(len(o) for o in outs)
    row = {"way": name, "wall_s": wall, "tokens": tokens,
           "tok_s": tokens / wall,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p95_s": float(np.percentile(ttft, 95)),
           **smp.row(), "replicas": replica_rows(stats())}
    return row


def phase_cluster(pa_mod) -> dict:
    """Phase 32: (a) the fleet plan; the context one spawned worker holds;
    (b) float32 token identity of a single engine and 2-replica clusters
    over threads and spawned processes; (e) HTTP in front of the spawned
    cluster; (d) disaggregated 1:1 over spawned processes; (c) bf16
    serving of a single engine and both clusters, side by side."""
    import dataclasses

    from repro_torch.cluster import (CONTEXT_BYTES, DisaggCluster,
                                     EngineSpec, ReplicaStats, ServeCluster,
                                     cuda_context_bytes, replica_kv_budget)

    cfg = get_cfg()
    mods = {"paged": pa_mod}
    out = {}
    log("  (a) the fleet plan, float32 at 1 slot and bf16 at "
        f"{MAX_SLOTS} slots:")
    plan32 = cluster_plan(cfg, 4, 1)
    plan16 = cluster_plan(cfg, 2, MAX_SLOTS)
    free_card()
    ctx = cuda_context_bytes()
    log(f"  one spawned worker's context (cuBLAS and a kernel library "
        f"loaded): {ctx / 2**20:.1f} MiB, reserved per replica "
        f"{CONTEXT_BYTES / 2**20:.0f} MiB")
    assert 0 < ctx <= CONTEXT_BYTES, ctx
    out["context_bytes"] = ctx

    # (b) float32 token identity: one engine, one prompt a call.
    spec32 = EngineSpec(arch=cfg.arch, reduced=False,
                        max_new_tokens=CLUSTER_NEW, max_slots=1,
                        max_len=CLUSTER_MAX_LEN, prefix_cache="radix",
                        dtype="float32")
    prompts = cluster_prompts(cfg, CLUSTER_LENS, 32)
    single = spec32(0)
    want = [single.generate([p], CLUSTER_NEW)[0] for p in prompts]
    del single
    free_card()
    spec_t = dataclasses.replace(spec32, kv_budget_bytes=replica_kv_budget(
        spec32, CLUSTER_N, 0))
    cl = ServeCluster.from_plan(plan32, spec_t, transport="thread")
    try:
        zero_counts(mods)           # the cluster's main path starts here
        got_t, placed_t, _, wall_t = routed(cl, prompts, CLUSTER_NEW)
        f32 = read_counts(mods)["paged"]              # ... and ends here
        steps = sum(int(rep.engine.metrics["decode_steps"])
                    + int(rep.engine.metrics["prefill_chunks"])
                    for rep in cl.replicas)
    finally:
        cl.close()
    free_card()
    log(f"  (b) thread: placements {placed_t}, {wall_t:.2f} s; paged "
        f"launches {f32}")
    assert got_t == want, "thread cluster tokens differ from one engine's"
    # Float32 routes the paged kernel to its simt body.
    assert f32["LAUNCHES"] == f32["LAUNCHES_SIMT"] \
        == cfg.n_layers * steps > 0, (f32, steps)
    spec_p = dataclasses.replace(spec32, kv_budget_bytes=replica_kv_budget(
        spec32, CLUSTER_N, CONTEXT_BYTES))
    cl = ServeCluster.from_plan(plan32, spec_p, transport="proc")
    try:
        build_replicas(cl.replicas)
        got_p, placed_p, _, wall_p = routed(cl, prompts, CLUSTER_NEW)
        log(f"  (b) proc: placements {placed_p}, {wall_p:.2f} s")
        assert got_p == want, "proc cluster tokens differ from one engine's"
        out["http"] = http_check(cl, prompts[0], want[0])
        log(f"  (e) HTTP: {out['http']}")
    finally:
        cl.close()
    out["identity"] = {"prompts": list(CLUSTER_LENS), "new": CLUSTER_NEW,
                       "placed_thread": placed_t, "placed_proc": placed_p,
                       "launches_thread": f32}

    # (d) disaggregated 1:1 over spawned processes.
    dc = DisaggCluster.from_plan(plan32, spec_p, split="1:1",
                                 transport="proc")
    try:
        build_replicas(dc.prefill + dc.decode)
        prompt = prompts[DISAGG_PROMPT]
        got_d = dc.generate(prompt, CLUSTER_NEW)
        tr = dc.last_transfer
        dec = dc.decode[0]
        dec.submit("stats", None).wait(CLUSTER_TIMEOUT)  # generate's tick
        hit = int(dec.last_stats.metrics["prefix_hit_tokens"])
    finally:
        dc.close()
    out["disagg"] = {"prompt": len(prompt), "pages": tr.n_pages,
                     "page_tokens": tr.page_tokens, "bytes": tr.nbytes,
                     "export_s": tr.export_s, "import_s": tr.import_s,
                     "prefix_hit_tokens": hit}
    log(f"  (d) disagg 1:1: {out['disagg']}")
    assert tr.n_pages >= 3 and hit >= tr.n_pages * tr.page_tokens, \
        out["disagg"]
    assert got_d == want[DISAGG_PROMPT], "disagg tokens differ"
    free_card()

    # (c) bf16 serving, three ways.
    spec16 = EngineSpec(arch=cfg.arch, reduced=False,
                        max_new_tokens=CLUSTER_SERVE_NEW,
                        max_slots=MAX_SLOTS, max_len=CLUSTER_MAX_LEN,
                        prefix_cache="radix", dtype="bfloat16")
    trace = cluster_prompts(cfg, (CLUSTER_PROMPT,) * CLUSTER_REQS, 33)
    warm = cluster_prompts(cfg, (CLUSTER_PROMPT,) * CLUSTER_N, 34)
    windows = [cluster_prompts(cfg, (CLUSTER_PROMPT,) * CLUSTER_PROFILED,
                               seed) for seed in (35, 36)]
    ways = []

    before = card_used()
    eng = spec16(0)
    eng.generate(warm, max_new_tokens=2)

    def run_single():
        first = {}

        def on_token(i, tok):
            if tok is not None:
                first.setdefault(i, time.monotonic())

        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = eng.generate(trace, on_token=on_token)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        return outs, sorted(first[i] - t0 for i in range(len(trace))), wall

    row = serve_way("single", run_single,
                    lambda: [ReplicaStats.from_engine(eng, 0)])
    row.update(profiled_busy(
        lambda w: eng.generate(w, max_new_tokens=16), windows))
    del eng
    free_card()
    row["mem_before_gb"], row["mem_after_gb"] = before / 1e9, \
        card_used() / 1e9
    ways.append(row)

    for transport, context in (("thread", 0), ("proc", CONTEXT_BYTES)):
        spec = dataclasses.replace(spec16, kv_budget_bytes=replica_kv_budget(
            spec16, CLUSTER_N, context))
        before = card_used()
        cl = ServeCluster.from_plan(plan16, spec, transport=transport,
                                    policy="free_pages")
        try:
            build_replicas(cl.replicas, warm)

            def run_cluster():
                outs, _, ttft, wall = routed(cl, trace, CLUSTER_SERVE_NEW)
                return outs, ttft, wall

            zero_counts(mods)
            row = serve_way(transport, run_cluster,
                            lambda: fresh_stats(cl))
            if transport == "thread":
                bf16 = read_counts(mods)["paged"]
                log(f"  (c) thread: paged launches {bf16}")
                assert bf16["LAUNCHES"] == bf16["LAUNCHES_SPLIT"] > 0, bf16
                row["launches"] = bf16
                row.update(profiled_busy(lambda w: routed(cl, w, 16),
                                         windows))
            else:
                row["busy_share"] = row["busy_share_unprofiled_wall"] = (
                    "not measured: torch.profiler traces this process's "
                    "kernels only")
        finally:
            cl.close()
        free_card()
        row["mem_before_gb"], row["mem_after_gb"] = before / 1e9, \
            card_used() / 1e9
        ways.append(row)
    for row in ways:
        log(f"  (c) {row['way']}: " + json.dumps(row))
    out["serve"] = {row["way"]: row for row in ways}
    return out


# ---------------------------------------------------------------------------
# Phase 33: training (no hand-written kernel on its path)
# ---------------------------------------------------------------------------


#: The f32 tolerance of the card-against-CPU training checks (the repo's:
#: ``tests/test_kernels.py``), ``|err| <= TRAIN_TOL * (1 + |ref|)``.
TRAIN_TOL = 1e-4
#: Full-width training: train_4k's sequence, its batch of 256 cut to 8 (4
#: microbatches of 2 sequences), 1 warm-up step and 4 timed ones.
TRAIN_SEQ = 4096
TRAIN_BATCH = 8
TRAIN_MICRO = 4
TRAIN_TIMED = 4
#: bf16 dense peak of one H100 SXM (the data sheet's, at 700 W).
H100_BF16_FLOPS = 989e12


def rel_err(a, b) -> float:
    """``max |a - b| / (1 + |b|)`` in float64 on the CPU."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def phase_train_guard(mods: dict, zserve: dict) -> dict:
    """(a) The repair: every wrapper refuses a CUDA input that requires
    grad under grad mode (no launch counted), the zamba2 training forward
    takes ``ssd_chunked`` (no ``ssd_scan`` launch) and its Mamba2 weights
    get gradients, and phase 9's serving launches stood."""
    from repro_torch.configs import SMOKE_SHAPES, get_model_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_cc import matmul_cc
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves

    def leaf(*shape):
        return torch.randn(*shape, device=DEVICE).requires_grad_(True)

    table = torch.zeros((2, 1), dtype=torch.int32, device=DEVICE)
    lengths = torch.ones(2, dtype=torch.int32, device=DEVICE)
    calls = {
        "matmul_cc": lambda: matmul_cc(leaf(64, 64), leaf(64, 64)),
        "flash_attention": lambda: flash_attention(
            leaf(1, 2, 64, 64), leaf(1, 2, 64, 64), leaf(1, 2, 64, 64)),
        "paged_attention": lambda: paged_attention(
            leaf(2, 4, 64), leaf(1, 16, 2, 64), leaf(1, 16, 2, 64), table,
            lengths),
        "ssd_scan": lambda: ssd_scan(
            leaf(1, 16, 2, 16), torch.rand(1, 16, 2, device=DEVICE),
            -torch.rand(2, device=DEVICE), leaf(1, 16, 16), leaf(1, 16, 16),
            chunk=16),
    }
    zero_counts(mods)
    refused = {}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            refused[name] = str(e).split(";")[0]
        else:
            raise AssertionError(f"{name} launched on inputs that require "
                                 "grad")
    counts = read_counts(mods)
    assert all(c["LAUNCHES"] == 0 for c in counts.values()), counts
    for name, msg in refused.items():
        log(f"  (a) {name} refused: {msg}")

    cfg = get_model_config(ZAMBA).reduced()
    model = Model(cfg, remat="full")
    params = model.init(0, device=DEVICE)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = make_batch(cfg, SMOKE_SHAPES["train_4k"],
                       np.random.default_rng(0), torch.float32,
                       device=DEVICE)
    zero_counts(mods)
    loss, _ = model.loss(params, batch, torch.float32)
    loss.backward()
    torch.cuda.synchronize()
    counts = read_counts(mods)
    assert counts["ssd"]["LAUNCHES"] == 0, counts
    grads = {}
    for k in ("wx", "wB", "wC", "wdt", "conv_w", "A_log", "dt_bias"):
        g = params["mamba_layers"][k].grad
        assert g is not None, k
        grads[k] = float(g.abs().sum())
        assert grads[k] > 0 and np.isfinite(grads[k]), (k, grads[k])
    served = zserve["launches"]["ssd"]
    log(f"  (a) zamba2 (reduced) training forward on the card: loss "
        f"{float(loss.detach()):.4f}, ssd_scan launches 0 (ssd_chunked); "
        "|grad| sums "
        + json.dumps({k: round(v, 6) for k, v in grads.items()})
        + f"; phase 9's serving ssd_scan launches {served['LAUNCHES']} "
        f"(tc {served['LAUNCHES_TC']})")
    assert served["LAUNCHES"] > 0
    return {"refused": sorted(refused), "mamba_grad_abs_sums": grads,
            "serve_ssd_launches": served["LAUNCHES"]}


def phase_train_parity() -> dict:
    """(b) Every family, reduced, float32 (TF32 off): the loss and every
    gradient leaf on the card against the port on the CPU, then one
    ``make_train_step`` step each way (params where |g| > 1e-6: Adam's
    first step is a sign, so a noise-sized gradient may move +-lr)."""
    from repro_torch.configs import (SMOKE_SHAPES, TrainConfig,
                                     get_model_config, list_archs)
    from repro_torch.launch.specs import make_batch
    from repro_torch.launch.trainer import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_flatten_with_paths as flat_leaves
    from repro_torch.tree import tree_leaves, tree_map

    def fresh(tree, device):
        """A detached copy on ``device`` (new leaves)."""
        return tree_map(lambda t: t.detach().to(device, copy=True), tree)

    shape = SMOKE_SHAPES["train_4k"]
    train = TrainConfig(dtype="float32", remat="full", warmup_steps=2,
                        total_steps=10)
    out = {}
    for arch in list_archs():
        cfg = get_model_config(arch).reduced()
        model = Model(cfg, remat="full")
        cpu_params = model.init(0, device="cpu")
        cpu_batch = make_batch(cfg, shape, np.random.default_rng(0),
                               torch.float32, device="cpu")
        res = {}
        for dev in ("cpu", DEVICE):
            params = fresh(cpu_params, dev)
            for p in tree_leaves(params):
                p.requires_grad_(True)
            batch = {k: v.to(dev) for k, v in cpu_batch.items()}
            loss, metrics = model.loss(params, batch, torch.float32)
            loss.backward()
            loss = loss.detach()
            ts = make_train_step(cfg, shape, train=train, device=dev)
            stepped = ts.fn(fresh(cpu_params, dev),
                            adamw_init(fresh(cpu_params, dev)), batch)
            res[dev] = (loss, metrics, flat_leaves(params), stepped)
        (lc, mc, gc, sc), (lg, mg, gg, sg) = res["cpu"], res[DEVICE]
        errs = {"loss": rel_err(lg, lc), "nll": rel_err(mg["nll"], mc["nll"]),
                "aux": rel_err(mg["aux"], mc["aux"])}
        grad_err = 0.0
        for k, p in gc.items():
            if p.grad is None:
                assert gg[k].grad is None, k
                continue
            grad_err = max(grad_err, rel_err(gg[k].grad, p.grad))
        errs["grads"] = grad_err
        (pc, oc, mcs), (pg, og, mgs) = sc, sg
        errs["step_loss"] = rel_err(mgs["loss"], mcs["loss"])
        errs["grad_norm"] = rel_err(mgs["grad_norm"], mcs["grad_norm"])
        mu_c, mu_g = flat_leaves(oc.mu), flat_leaves(og.mu)
        nu_c, nu_g = flat_leaves(oc.nu), flat_leaves(og.nu)
        errs["mu"] = max(rel_err(mu_g[k], v) for k, v in mu_c.items())
        errs["nu"] = max(rel_err(nu_g[k], v) for k, v in nu_c.items())
        p_err, lr = 0.0, float(mcs["lr"])
        p_g = flat_leaves(pg)
        for k, v in flat_leaves(pc).items():
            live = mu_c[k].abs() > (1 - train.b1) * 1e-6
            a, b = p_g[k].detach().cpu(), v.detach()
            if live.any():
                p_err = max(p_err, rel_err(a[live], b[live]))
            assert float((a - b).abs().max()) <= 2 * lr * 1.001 + 1e-6, \
                (arch, k)
        errs["params"] = p_err
        log(f"  (b) {arch}: loss {lg.item():.6f} (cpu {lc.item():.6f}); "
            "rel errs " + json.dumps({k: float(f"{v:.3e}")
                                      for k, v in errs.items()}))
        bad = {k: v for k, v in errs.items() if not v <= TRAIN_TOL}
        assert not bad, (arch, bad)
        out[arch] = errs
    return out


def phase_train_full(mods: dict) -> dict:
    """(c) Full-width llama3.2-1b (16 layers, d_model 2048): bf16 compute
    over float32 parameters and moments, remat "full", train_4k's 4,096
    tokens at a global batch of 8 (cut from 256) in 4 microbatches,
    through ``Trainer.fit`` on ``DataPipeline``: 1 warm-up step, then 4
    timed ones, then one under ``torch.profiler``."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import RunConfig, ShapeConfig, TrainConfig
    from repro_torch.data import DataPipeline, SyntheticLMDataset
    from repro_torch.launch.trainer import Trainer
    from repro_torch.tree import tree_leaves

    free_card()
    cfg = get_cfg()
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    train = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=8,
                        remat="full", microbatches=TRAIN_MICRO,
                        checkpoint_every=10 ** 9, checkpoint_dir=ckpt_dir)
    trainer = Trainer(RunConfig(model=cfg, shape=shape, train=train),
                      device=DEVICE)
    pipe = None
    try:
        trainer.init_or_restore()
        n = trainer.ts.model.n_params()
        log(f"  (c) {cfg.arch}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n} parameters; seq {TRAIN_SEQ} x global "
            f"batch {TRAIN_BATCH} (cut from train_4k's 256), "
            f"{TRAIN_MICRO} microbatches of {TRAIN_BATCH // TRAIN_MICRO}, "
            f"bf16 compute, f32 params and moments, remat full")
        ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                seed=0)
        pipe = DataPipeline(ds, global_batch=TRAIN_BATCH)
        it = iter(pipe)
        # The first step's metrics and every leaf's norm before and after.
        seen, fn = [], trainer.ts.fn

        def step(params, opt, batch):
            out = fn(params, opt, batch)
            seen.append({k: float(v) for k, v in out[2].items()})
            return out
        trainer.ts.fn = step
        norms0 = [float(p.detach().float().norm())
                  for p in tree_leaves(trainer.params)]
        zero_counts(mods)
        torch.cuda.reset_peak_memory_stats()
        warm = trainer.fit(1, it, log_every=0)
        norms1 = [float(p.detach().float().norm())
                  for p in tree_leaves(trainer.params)]
        first = seen[0]
        assert np.isfinite(first["grad_norm"]), first  # every leaf finite
        unchanged = sum(a == b for a, b in zip(norms0, norms1))
        assert unchanged == 0, f"{unchanged} parameter leaves unchanged"
        timed = trainer.fit(TRAIN_TIMED, it, log_every=0)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        counts = read_counts(mods)
        assert all(c["LAUNCHES"] == 0 for c in counts.values()), counts
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_hist = trainer.fit(1, it, log_every=0)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        avgs = prof.key_averages()
        kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda e: -e.self_device_time_total)
        busy_us = sum(e.self_device_time_total for e in kern)
        top = [{"op": e.key[:70], "ms": round(e.self_device_time_total / 1e3,
                                              3), "calls": e.count}
               for e in kern[:10]]
    finally:
        if pipe is not None:
            pipe.close()
        trainer.preempt.uninstall()
        import shutil

        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = warm["loss"] + timed["loss"] + prof_hist["loss"]
    nll0 = first["nll"]
    ln_v = float(np.log(cfg.vocab_size))
    assert 0.5 * ln_v <= nll0 <= 3 * ln_v, (nll0, ln_v)
    assert all(np.isfinite(losses)), losses
    step_s = float(np.median(timed["step_time"]))
    tokens = TRAIN_SEQ * TRAIN_BATCH
    d_attn = cfg.n_heads * cfg.head_dim
    flops_tok = 6 * n + 6 * cfg.n_layers * TRAIN_SEQ * d_attn
    mfu = flops_tok * tokens / step_s / H100_BF16_FLOPS
    row = {
        "arch": cfg.arch, "layers": cfg.n_layers, "params": n,
        "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
        "batch_cut_from": 256, "microbatches": TRAIN_MICRO,
        "remat": "full", "compute": "bfloat16",
        "step_s": step_s, "step_s_all": timed["step_time"],
        "warmup_step_s": warm["step_time"][0],
        "tokens_per_s": tokens / step_s,
        "flops_per_token": flops_tok,
        "mfu_bf16_989": mfu, "peak_mem_gb": peak_gb,
        "busy_share": busy_us / wall_us,
        "profiled_step_s": wall_us / 1e6,
        "first_step": first, "losses": losses, "top_ops": top,
    }
    log("  (c) model FLOPs per token = 6 N + 6 L S d_attn = 6 x "
        f"{n} + 6 x {cfg.n_layers} x {TRAIN_SEQ} x {d_attn} = "
        f"{flops_tok:.4e} (remat's extra forward not counted)")
    log(f"  (c) step {step_s:.4f} s (median of {TRAIN_TIMED}: "
        f"{[round(s, 4) for s in timed['step_time']]}), "
        f"{tokens / step_s:.1f} tokens/s, model FLOP share {mfu:.4f} of "
        f"989 TFLOP/s bf16, peak {peak_gb:.2f} GB; busy share "
        f"{busy_us / wall_us:.4f} over a profiled step of "
        f"{wall_us / 1e6:.3f} s")
    log(f"  (c) first step: nll {nll0:.4f} (ln V = {ln_v:.4f}), grad_norm "
        f"{first['grad_norm']:.4f}, lr {first['lr']:.3e}; every leaf "
        f"changed; losses {[round(x, 4) for x in losses]}")
    for r in top:
        log(f"    {r['ms']:10.3f} ms  x{r['calls']:<6d} {r['op']}")
    return row


def phase_train_loop() -> dict:
    """(d) The CLI on the card: reduced llama3.2-1b, 40 steps at lr 3e-3
    and warmup 5, drops the loss by more than 0.5; and 2 + 2 steps across
    a blocking save and a fresh Trainer's restore equal 4 straight steps
    (float32, reduced)."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    from repro_torch.configs import (RunConfig, ShapeConfig, TrainConfig,
                                     get_model_config)
    from repro_torch.data import DataPipeline, SyntheticLMDataset
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.trainer import Trainer

    root = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main([
                "--device", DEVICE, "--arch", ARCH, "--steps", "40",
                "--seq_len", "32",
                "--batch", "8", "--train.learning_rate", "3e-3",
                "--train.warmup_steps", "5",
                "--train.checkpoint_dir", os.path.join(root, "cli")])
        out = buf.getvalue()
        m = re.search(r"\[train\] loss ([\d.]+) -> ([\d.]+) over 40 steps",
                      out)
        assert rc == 0 and m, out[-2000:]
        first, last = float(m.group(1)), float(m.group(2))
        log(f"  (d) CLI: {out.splitlines()[0]}; loss {first:.3f} -> "
            f"{last:.3f} over 40 steps")
        assert last < first - 0.5, (first, last)

        cfg = get_model_config(ARCH).reduced()
        shape = ShapeConfig("tiny", seq_len=32, global_batch=8, kind="train")

        def trainer(sub):
            return Trainer(RunConfig(model=cfg, shape=shape, train=TrainConfig(
                learning_rate=3e-3, warmup_steps=5, total_steps=60,
                dtype="float32", remat="none",
                checkpoint_dir=os.path.join(root, sub))), device=DEVICE)

        def fit(tr, steps, start):
            ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                                    seed=0)
            pipe = DataPipeline(ds, global_batch=8, start_step=start,
                                prefetch=1)
            try:
                return tr.fit(steps, iter(pipe), log_every=0)["loss"]
            finally:
                pipe.close()

        runs = {}
        for name, plan in (("straight", (4,)), ("resumed", (2, 2))):
            losses, start = [], 0
            for steps in plan:
                tr = trainer(name)
                try:
                    assert tr.init_or_restore() == start
                    losses += fit(tr, steps, start)
                    tr.ckpt.save(tr.step, (tr.params, tr.opt), blocking=True)
                    start = tr.step
                finally:
                    tr.preempt.uninstall()
            runs[name] = losses
        log(f"  (d) 4 straight steps {runs['straight']}; 2 + 2 across a "
            f"save and restore {runs['resumed']}")
        np.testing.assert_allclose(runs["resumed"], runs["straight"],
                                   rtol=1e-6, atol=1e-6)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"cli_loss": [first, last], **runs}


# ---------------------------------------------------------------------------
# Phase 34: tensor-parallel training over a device mesh
# ---------------------------------------------------------------------------

#: The ring's block products: a 4-way ring over llama3.2-1b's projections
#: at one microbatch of phase 33 (c) (2 x 4,096 tokens), forward and
#: backward.  All-gather steps multiply the (m, k/p) chunk by a (k/p, n/p)
#: band of the column-parallel weight (fused q/k/v, fused gate/up);
#: reduce-scatter steps an (m/p, k/p) row block by the (k/p, n) row-parallel
#: weight (attention and MLP out).  Serpentine halves the chunk (all-gather)
#: or the columns (reduce-scatter).  The LM head is tied to the embedding
#: (no ring).
RING_P = 4
RING_M = TRAIN_SEQ * TRAIN_BATCH // TRAIN_MICRO


def ring_block_shapes(cfg) -> dict:
    """``{what: (m, k, n)}``: every distinct block product of a
    ``RING_P``-way ring (both modes) over ``cfg``'s projections at
    ``RING_M`` tokens, forward and backward, as ``dist.overlap``'s
    ``_AgRing``/``_RsRing`` launch them.  The all-gather ring's dx
    reduce-scatters ``dy @ band^T`` (m x n/p by n/p x k/p) and its dw
    re-streams x (``chunk^T @ dy``, k/p x m by m x n/p); the reduce-scatter
    ring's backward streams dy: dx ``dy_part @ w^T`` (m/p x n by n x k/p),
    dw ``x_rows^T @ dy_part`` (k/p x m/p by m/p x n).  A shape that several
    products share is listed once, under all their names."""
    p, m, d = RING_P, RING_M, cfg.d_model
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    names: dict = {}
    for mode, half in (("ring", 1), ("serpentine", 2)):
        kc = d // p // half                  # the streamed chunk of x
        for name, n in (("wq", hq), ("wk/wv", hkv), ("wg/wi", cfg.d_ff)):
            for what, shape in (("", (m, kc, n // p)),
                                (" dx", (m, n // p, kc)),
                                (" dw", (kc, m, n // p))):
                names.setdefault(shape, []).append(f"ag {mode} {name}{what}")
        nc = d // half                       # the streamed columns of y
        for name, k in (("attn wo", hq), ("mlp wo", cfg.d_ff)):
            for what, shape in (("", (m // p, k // p, nc)),
                                (" dx", (m // p, nc, k // p)),
                                (" dw", (k // p, m // p, nc))):
                names.setdefault(shape, []).append(f"rs {mode} {name}{what}")
    return {", ".join(v): shape for shape, v in names.items()}


def phase_ring_blocks(mm_mod) -> dict:
    """(a) ``matmul_cc`` under ``leaf_matmul_plan`` at each ring block
    shape, forward and backward, bf16, against its plain version; its time
    beside the plain version's, ``torch.matmul``'s and the bound."""
    from repro_torch.core.plan import leaf_matmul_plan
    from repro_torch.kernels.matmul_cc import matmul_cc
    from repro_torch.kernels.ref import matmul_ref

    gen = torch.Generator(device=DEVICE).manual_seed(34)
    rows, worst = {}, 0.0
    for what, (m, k, n) in ring_block_shapes(get_cfg()).items():
        a = randn(gen, (m, k), torch.bfloat16)
        b = randn(gen, (k, n), torch.bfloat16, scale=k ** -0.5)
        plan = leaf_matmul_plan(m, k, n, dtype_bytes=2)
        before = counters(mm_mod, ("wgmma", "simt"))
        out = matmul_cc(a, b, plan=plan)
        torch.cuda.synchronize()
        path = body(mm_mod, before, what)
        err = held_to(out, matmul_ref(a, b), TOL[torch.bfloat16],
                      f"matmul_cc ring block {what} {m}x{k}x{n} tile "
                      f"{plan.bm}x{plan.bk}x{plan.bn} {path}")
        worst = max(worst, err)
        nbytes, ops = (m * k + k * n + m * n) * 2, 2 * m * k * n
        bms, by = bound_ms(nbytes, ops, torch.bfloat16)
        row = dict(shape=[m, k, n], path=path,
                   tile=f"{plan.bm}x{plan.bk}x{plan.bn}",
                   ms=cuda_ms(lambda i: matmul_cc(a, b, plan=plan), reps=20),
                   plain_ms=cuda_ms(lambda i: matmul_ref(a, b), reps=10),
                   library_ms=cuda_ms(lambda i: torch.matmul(a, b), reps=20),
                   bound_ms=bms, bound_by=by, max_abs_err=err)
        rows[what] = row
        log(f"  (a) {what} {m}x{k}x{n}: {row['ms']:.4f} ms ({path}, tile "
            f"{row['tile']}), plain {row['plain_ms']:.4f}, torch.matmul "
            f"{row['library_ms']:.4f}, bound {bms:.4f} ({by}): "
            f"{bms / row['ms']:.3f} of bound, "
            f"{row['library_ms'] / row['ms']:.3f} of torch.matmul's speed")
        del a, b, out
    return {"shapes": rows, "max_abs_err": worst}


def phase_ring_one_rank(mm_mod) -> dict:
    """(b) A one-rank NCCL world (``make_host_mesh()``): the ring kernels
    called directly in both modes, forward and backward through their
    autograd Functions, against ``x @ w`` and its gradients, bf16 and
    float32; ``matmul_cc``'s launches counted."""
    import torch.distributed as dist

    from repro_torch.dist.overlap import (make_ag_matmul,
                                          make_ag_matmul_fused,
                                          make_rs_matmul)
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    log(f"  (b) mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
        f"{mesh.device_type}, backend {dist.get_backend()}")
    gen = torch.Generator(device=DEVICE).manual_seed(35)
    m, d = 2048, get_cfg().d_model
    zero_counts({"matmul": mm_mod})
    worst = {}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            for mode in ("ring", "serpentine"):
                for name in ("ag", "agf", "rs"):
                    x = randn(gen, (m, d), dtype)
                    ws = [randn(gen, (d, n), dtype, scale=d ** -0.5)
                          for n in ((d, 512, 512) if name == "agf"
                                    else (d,))]
                    # Output grads scaled by 1/sqrt(m), as the weights by
                    # 1/sqrt(d): every product sums to O(1) values, so
                    # float32's 1e-4 measures the kernel (as phase 5's).
                    gys = [randn(gen, (m, w.shape[1]), dtype,
                                 scale=m ** -0.5) for w in ws]
                    if name == "agf":
                        fn = make_ag_matmul_fused(mesh, "model", mode, 3)
                    else:
                        fn = (make_ag_matmul if name == "ag"
                              else make_rs_matmul)(mesh, "model", mode)
                    xl = x.clone().requires_grad_(True)
                    wl = [w.clone().requires_grad_(True) for w in ws]
                    ys = fn(xl, *wl)
                    ys = ys if isinstance(ys, list) else [ys]
                    torch.autograd.backward(
                        [y.to_local() for y in ys], gys)
                    # The plain version: products summed in float32 and
                    # rounded once, as the kernel's; gradients likewise.
                    want = [matmul_ref(x, w) for w in ws]
                    dx = sum(matmul_ref(g, w.t().contiguous())
                             for g, w in zip(gys, ws))
                    dws = [matmul_ref(x.t().contiguous(), g) for g in gys]
                    what = f"{name} {mode} {str(dtype)[6:]}"
                    tol = TOL[dtype] if dtype == torch.float32 else 5e-2
                    err = max(
                        [held_to(y.to_local().detach(), w, tol, f"{what} y")
                         for y, w in zip(ys, want)]
                        + [held_to(xl.grad, dx, tol, f"{what} dx")]
                        + [held_to(w.grad, g, tol, f"{what} dw")
                           for w, g in zip(wl, dws)])
                    worst[what] = err
        torch.cuda.synchronize()
        counts = read_counts({"matmul": mm_mod})["matmul"]
    finally:
        dist.destroy_process_group()
    log(f"  (b) matmul_cc launches from the rings: {counts}")
    assert counts["LAUNCHES"] > 0, counts
    return {"launches": counts["LAUNCHES"], "counts": counts,
            "max_abs_err": worst}


def phase_train_mesh(tfull) -> dict:
    """(c) Full-width llama3.2-1b on ``make_host_mesh()`` (one card) with
    collectives "auto", against phase 33 (c)'s meshless step on the same
    two batches: loss and grad_norm equal; the mesh step's seconds, peak
    memory, busy share and the planner's FSDP choice."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.trainer import init_train_state, make_train_step

    cfg = get_cfg()
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    train = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=8,
                        remat="full", microbatches=TRAIN_MICRO,
                        collectives="auto")
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                            seed=0)
    batches = [ds.batch(i, TRAIN_BATCH) for i in range(3)]

    def run(mesh, n_steps, profiled=False):
        free_card()
        ts = make_train_step(cfg, shape, mesh, train,
                             device=None if mesh else DEVICE)
        params, opt = init_train_state(ts, 0, train)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, secs = [], []
        for i in range(n_steps):
            t0 = time.perf_counter()
            params, opt, m = ts.fn(params, opt, ts.place_batch(batches[i]))
            metrics.append({k: float(v) for k, v in m.items()})
            secs.append(time.perf_counter() - t0)
        extra = {}
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt, m = ts.fn(params, opt,
                                       ts.place_batch(batches[n_steps]))
                float(m["loss"])
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = sum(e.self_device_time_total
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0)
            extra = {"busy_share": busy / wall_us,
                     "profiled_step_s": wall_us / 1e6}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        meta = ts.rules.meta if ts.rules else {}
        del params, opt, ts
        return metrics, secs, peak, extra, meta

    plain, plain_s, plain_peak, _, _ = run(None, 2)
    mesh = make_host_mesh()
    try:
        meshed, mesh_s, peak, extra, meta = run(mesh, 2, profiled=True)
    finally:
        dist.destroy_process_group()
    free_card()
    errs = {k: max(abs(a[k] - b[k]) / (1 + abs(b[k]))
                   for a, b in zip(meshed, plain))
            for k in ("loss", "grad_norm")}
    fsdp = {k: meta[k] for k in ("fsdp", "mesh_np", "fsdp_degree",
                                 "mesh_fits", "fsdp_capacity",
                                 "mesh_budget_bytes")}
    fsdp["collectives"] = meta.get("collectives", "gspmd")
    row = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "losses": [r["loss"] for r in meshed],
           "losses_meshless": [r["loss"] for r in plain],
           "grad_norms": [r["grad_norm"] for r in meshed],
           "grad_norms_meshless": [r["grad_norm"] for r in plain],
           "rel_err": errs, "step_s": mesh_s, "step_s_meshless": plain_s,
           "step_s_phase33c": tfull["step_s"] if tfull else None,
           "peak_mem_gb": peak, "peak_mem_gb_meshless": plain_peak,
           "planner": fsdp, **extra}
    log(f"  (c) mesh {row['mesh']}, planner {json.dumps(fsdp)}")
    log(f"  (c) losses {row['losses']} (meshless {row['losses_meshless']}),"
        f" grad norms {row['grad_norms']} (meshless "
        f"{row['grad_norms_meshless']}), rel errs {errs}")
    log(f"  (c) step seconds on the mesh {[round(x, 4) for x in mesh_s]} "
        f"(meshless {[round(x, 4) for x in plain_s]}; phase 33 (c) median "
        f"{row['step_s_phase33c']}); peak {peak:.2f} GB (meshless "
        f"{plain_peak:.2f}); busy share {extra['busy_share']:.4f} over a "
        f"profiled step of {extra['profiled_step_s']:.3f} s")
    assert fsdp["collectives"] == ("serpentine" if fsdp["fsdp"]
                                   else "gspmd"), fsdp
    assert all(v <= TRAIN_TOL for v in errs.values()), errs
    return row


def world_34d(rank: int) -> dict:
    """(d) On every rank of a 4-rank gloo world on the card's host: the
    reduced llama3.2-1b forward under gspmd, ring and serpentine on a
    (1, 4) mesh, and one step on (2, 2) under each, float32."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeConfig, TrainConfig, get_model_config
    from repro_torch.dist.sharding import (arch_rules, param_shardings,
                                           placements, use_mesh_rules,
                                           with_collectives)
    from repro_torch.launch.specs import make_batch
    from repro_torch.launch.trainer import (distribute, init_train_state,
                                            make_train_step)
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    cfg = get_model_config(ARCH).reduced()
    shape = ShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")
    batch = make_batch(cfg, shape, np.random.default_rng(0), torch.float32,
                       device="cpu")
    out = {}
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    rules = arch_rules(cfg, mesh)
    model = Model(cfg, remat="none")
    params = model.init(0, device="cpu")
    shard = param_shardings(mesh, rules, model.param_specs())
    from repro_torch.tree import tree_map
    dparams = tree_map(lambda p, pl: distribute(p, mesh, pl), params, shard)
    dbatch = {k: distribute(v, mesh, placements(mesh, rules.act_spec(
        ("batch", "seq")))) for k, v in batch.items()}
    for mode in ("gspmd", "ring", "serpentine"):
        with torch.no_grad(), use_mesh_rules(
                mesh, with_collectives(rules, mode)), implicit_replication():
            logits, _ = model.forward(dparams, dbatch, torch.float32)
        out[f"forward/{mode}"] = logits.full_tensor().numpy()
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for mode in ("gspmd", "ring", "serpentine"):
        train = TrainConfig(learning_rate=3e-4, dtype="float32",
                            remat="full", warmup_steps=2, total_steps=10,
                            collectives=mode)
        ts = make_train_step(cfg, shape, mesh22, train)
        p, o = init_train_state(ts, 0, train)
        p, o, m = ts.fn(p, o, ts.place_batch(batch))
        out[f"step/{mode}"] = np.array([float(m["loss"]),
                                        float(m["grad_norm"])])
        out[f"params/{mode}"] = np.concatenate([
            v.full_tensor().detach().reshape(-1).numpy()
            for v in (p["embedding"], p["layers"]["attn"]["wq"],
                      p["layers"]["ffn"]["wo"])])
    return out


def phase_train_mesh_cpu() -> dict:
    """(d) ``world_34d`` on a 4-rank gloo world of spawned processes on the
    card's host (a ``FileStore`` in a temporary directory, a 300 s
    timeout): ring and serpentine equal gspmd within 2e-4."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn_world

    root = tempfile.mkdtemp(prefix="chip_smoke_world_")
    try:
        ranks = spawn_world(world_34d, 4, os.path.join(root, "store"),
                            timeout_s=300)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # The forward within 2e-4; the step's loss and grad_norm within
    # TRAIN_TOL (relative); its parameters within 2 lr (Adam's first step
    # is a sign: a noise-sized gradient may move +-lr either way).
    lr = 3e-4 * 0.5
    limits = {"forward": 2e-4, "step": TRAIN_TOL, "params": 2 * lr * 1.001}
    errs = {}
    for r in ranks:
        for mode in ("ring", "serpentine"):
            for what in ("forward", "step", "params"):
                a, b = r[f"{what}/{mode}"], r[f"{what}/gspmd"]
                d = np.abs(a - b) / ((1 + np.abs(b)) if what == "step"
                                     else 1.0)
                errs[f"{what}/{mode}"] = max(
                    errs.get(f"{what}/{mode}", 0.0), float(d.max()))
    losses = {m: ranks[0][f"step/{m}"].tolist()
              for m in ("gspmd", "ring", "serpentine")}
    log(f"  (d) 4 gloo ranks: (loss, grad_norm) on (2, 2) {losses}; "
        f"differences from gspmd {json.dumps(errs)} (limits {limits})")
    bad = {k: v for k, v in errs.items() if not v <= limits[k.split("/")[0]]}
    assert not bad, bad
    return {"diff": errs, "steps": losses}


# ---------------------------------------------------------------------------
# Phase 35: serving over a device mesh, and the dry run
# ---------------------------------------------------------------------------

MESH_PARITY_NEW = 8
#: The float32 parity runs serve the first prompts of phase 4's trace
#: (64, 1,024, 200 and 512 tokens): DTensor's host dispatch makes the
#: mesh engine's prefill chunks 3x slower than the meshless engine's.
MESH_PARITY_PROMPTS = 4
MESH_B_LENS = (8, 12, 8, 5)
MESH_B_NEWS = (6, 3, 2, 4)
#: A shrunk HBM a card under which the reduced llama's decode plan on
#: (2, 2) shards its KV heads (kv_shard 2); the default spec keeps 1.
MESH_B_SMALL_HBM = 250_000


def mesh_engine_run(engine, prompts, max_new: int, mods: dict) -> dict:
    """One ``generate`` with every launch counter of ``mods`` at 0 just
    before it and read just after: outputs, wall seconds, tok/s."""
    torch.cuda.synchronize()
    zero_counts(mods)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    tokens = sum(len(o) for o in outs)
    return {"outs": outs, "wall_s": wall, "tok_s": tokens / wall,
            "tokens": tokens, "launches": launches}


def phase_serve_mesh(pa_mod) -> dict:
    """(a) Full-width llama3.2-1b on ``make_host_mesh()`` (a one-rank NCCL
    world): float32 greedy tokens of the paged and the cohort engine on
    the mesh equal the meshless paged engine's on the first
    ``MESH_PARITY_PROMPTS`` prompts of phase 4's trace; then bf16 on the
    whole trace, the mesh engine's wall and tok/s beside the meshless
    engine's, with the paged launches of the mesh run (all ``split``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import ServeEngine, ServePolicy

    cfg = get_cfg()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in PROMPT_LENS]
    mods = {"paged": pa_mod}
    out = {}
    mesh = make_host_mesh()
    log(f"  (a) mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
        f"{mesh.device_type}, backend {dist.get_backend()}")
    try:
        for dtype, new, trace in (
                (torch.float32, MESH_PARITY_NEW,
                 prompts[:MESH_PARITY_PROMPTS]),
                (torch.bfloat16, MAX_NEW, prompts)):
            free_card()
            name = str(dtype)[6:]
            pol = dict(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                       max_new_tokens=new)
            plain = ServeEngine(cfg, ServePolicy(batching="paged", **pol),
                                dtype=dtype, seed=0, device=DEVICE)
            meshed = ServeEngine(cfg, ServePolicy(batching="paged", **pol),
                                 dtype=dtype, params=plain.params,
                                 mesh=mesh)
            if dtype == torch.bfloat16:       # warm both (first-call costs)
                for eng in (plain, meshed):
                    eng.generate(prompts[:2], max_new_tokens=2)
            a = mesh_engine_run(plain, trace, new, mods)
            b = mesh_engine_run(meshed, trace, new, mods)
            row = {"kv_shard": meshed.plan.kv_shard(),
                   "meshless": {k: a[k] for k in ("wall_s", "tok_s",
                                                  "tokens", "launches")},
                   "mesh": {k: b[k] for k in ("wall_s", "tok_s", "tokens",
                                              "launches")},
                   "tokens_equal": a["outs"] == b["outs"]}
            if dtype == torch.float32:
                cohort = ServeEngine(cfg, ServePolicy(batching="cohort",
                                                      **pol),
                                     dtype=dtype, params=plain.params,
                                     mesh=mesh)
                c = mesh_engine_run(cohort, trace, new, mods)
                row["cohort_tokens_equal"] = c["outs"] == a["outs"]
                row["cohort_wall_s"] = c["wall_s"]
                del cohort
            log(f"  (a) {name}: " + json.dumps(row))
            assert row["tokens_equal"], f"{name}: mesh tokens differ"
            assert row.get("cohort_tokens_equal", True), \
                f"{name}: cohort mesh tokens differ"
            paged = b["launches"]["paged"]
            assert paged["LAUNCHES"] > 0, paged
            if dtype == torch.bfloat16:
                assert paged["LAUNCHES"] == paged["LAUNCHES_SPLIT"], paged
            out[name] = row
            del plain, meshed
    finally:
        dist.destroy_process_group()
    return out


#: zamba2-1.2b on the one-rank mesh: full width, cut to 8 mixers (two
#: shared-block applications), as phases 22 and 25 cut it; its mesh steps
#: pay DTensor's host dispatch on every op, which the whole depth would
#: pay 38 times a token.
MESH_ZAMBA_LAYERS = 8
MESH_ZAMBA_NEW = 16


def mesh_ssd_route(ssd_mod, cfg, mesh) -> dict:
    """``ssd_scan`` through the mesh route (``models.mamba2._chunked_scan``
    on DTensors over ``mesh``, which hands the kernel each rank's rows and
    heads) at zamba2's serving shape -- S = 8 with state, bf16 -- held to
    the plain version on the same inputs, timed (device ms), its bound,
    and the body it ran."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.models.mamba2 import _chunked_scan, kernel_chunk

    sc = cfg.ssm
    p, n = sc.head_dim, sc.state_dim
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    args, init = ssd_state_case(gen, 8, torch.bfloat16, cfg)
    rep = [Replicate()] * mesh.ndim

    def dt(t):
        return DTensor.from_local(t, mesh, rep, run_check=False)

    dargs = [dt(a) for a in args]
    dinit = dt(init)

    def run(i):
        return _chunked_scan(*dargs, sc.chunk, dinit)

    before = counters(ssd_mod, ("tc", "simt"))
    y, fin = run(0)
    torch.cuda.synchronize()
    ran = body(ssd_mod, before, "ssd_scan on the mesh route")
    assert isinstance(y, DTensor) and isinstance(fin, DTensor)
    ry, rfin = ssd_ref(*args, init_state=init, return_final=True)
    err = max(held_to(y.to_local(), ry, SSD_TOL[torch.bfloat16],
                      "mesh-route ssd_scan: y"),
              held_to(fin.to_local(), rfin, SSD_TOL[torch.bfloat16],
                      "mesh-route ssd_scan: final state"))
    b, s, h, _ = args[0].shape
    q = kernel_chunk(sc.chunk, p, n, 2)
    nbytes, ops = ssd_work(b, s, h, p, n, min(q, s), 2, True)
    bound, bound_by = bound_ms(nbytes, ops, torch.bfloat16)
    row = {"ms": cuda_ms(run), "path": ran, "max_abs_err": err,
           "plain_ms": cuda_ms(lambda i: ssd_ref(
               *args, init_state=init, return_final=True), reps=10),
           "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
           "bytes": nbytes, "ops": ops}
    log(f"  (a) mesh-route ssd_scan S=8 with state ({ran}): "
        f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
        f"bound_ms={bound:.5f} ({bound_by}) max_abs_err={err:.3g}")
    return row


def phase_serve_mesh_zamba(pa_mod, ssd_mod) -> dict:
    """(a) zamba2-1.2b at full width (cut to ``MESH_ZAMBA_LAYERS`` mixers)
    on ``make_host_mesh()``, paged and cohort: in float32 on the first
    ``MESH_PARITY_PROMPTS`` prompts of phase 4's trace each mesh engine's
    greedy tokens equal the meshless engine's of its batching; in bf16
    each mesh engine's ``ssd_scan`` launches (through the mesh route, on
    local tensors) are all ``tc`` and as many as the meshless engine's,
    and the paged one's attention launches are all ``split``;
    then the mesh route's ``ssd_scan`` at the serving shape
    (``mesh_ssd_route``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import ServeEngine, ServePolicy

    cfg = parity_cfg(ZAMBA, MESH_ZAMBA_LAYERS)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in PROMPT_LENS][:MESH_PARITY_PROMPTS]
    mods = {"paged": pa_mod, "ssd": ssd_mod}
    out = {}
    mesh = make_host_mesh()
    try:
        for dtype, new in ((torch.float32, MESH_PARITY_NEW),
                           (torch.bfloat16, MESH_ZAMBA_NEW)):
            free_card()
            name = str(dtype)[6:]
            pol = dict(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                       max_new_tokens=new)
            row = {}
            params = None
            for batching in ("paged", "cohort"):
                plain = ServeEngine(cfg, ServePolicy(batching=batching,
                                                     **pol),
                                    dtype=dtype, params=params, seed=0,
                                    device=DEVICE)
                params = plain.params
                meshed = ServeEngine(cfg, ServePolicy(batching=batching,
                                                      **pol),
                                     dtype=dtype, params=params, mesh=mesh)
                a = mesh_engine_run(plain, prompts, new, mods)
                b = mesh_engine_run(meshed, prompts, new, mods)
                row[batching] = {
                    "tokens_equal": b["outs"] == a["outs"],
                    "meshless": {k: a[k] for k in ("wall_s", "tok_s",
                                                   "launches")},
                    "mesh": {k: b[k] for k in ("wall_s", "tok_s",
                                               "launches")}}
                del plain, meshed
            log(f"  (a) zamba2 {name}: " + json.dumps(row))
            for batching, r in row.items():
                ssd = r["mesh"]["launches"]["ssd"]
                assert ssd["LAUNCHES"] > 0, (batching, ssd)
                if dtype == torch.float32:
                    assert r["tokens_equal"], \
                        f"zamba2 {batching} {name}: mesh tokens differ"
                    continue
                assert ssd["LAUNCHES"] == ssd["LAUNCHES_TC"], ssd
                assert ssd["LAUNCHES"] == \
                    r["meshless"]["launches"]["ssd"]["LAUNCHES"], r
                if batching == "paged":
                    paged = r["mesh"]["launches"]["paged"]
                    assert 0 < paged["LAUNCHES"] == \
                        paged["LAUNCHES_SPLIT"], paged
            out[name] = row
        out["route"] = mesh_ssd_route(ssd_mod, cfg, mesh)
    finally:
        dist.destroy_process_group()
    return out


#: deepseek-v2-236b on the one-rank mesh, at full width: float32 at 2
#: layers (the dense one and one MoE layer, ~21 GB of weights) for the
#: tokens, bf16 at 4 (1 dense + 3 MoE, ~27 GB) on phase 17's trace for the
#: launches and walls.
MESH_DEEPSEEK_LAYERS = {torch.float32: 2, torch.bfloat16: 4}
#: The mla body's local query heads on the production meshes: 128 heads
#: over 8 and over 16 "model" ranks (a one-rank mesh never shows them).
MLA_LOCAL_HEADS = (16, 8)


def phase_serve_mesh_deepseek(pa_mod, t: int) -> dict:
    """(a) deepseek-v2-236b at full width on ``make_host_mesh()``, paged
    (the latent pool on each rank, the mla body on local query rows and
    heads): in float32 at 2 layers on the first ``MESH_PARITY_PROMPTS``
    prompts of phase 4's trace the mesh engine's greedy tokens equal the
    meshless engine's; in bf16 at 4 layers on the whole trace every paged
    launch of the mesh engine is ``mla`` and there are as many as the
    meshless engine's, walls and tok/s side by side.  Each engine's
    weights are freed before the next pair is built.  Then the mla body
    through the mesh route (``mesh_mla_route``) and alone at the
    production meshes' local head counts (``mla_local_heads``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import ServeEngine, ServePolicy

    rng = np.random.default_rng(0)
    full = deepseek_cfg()
    prompts = [rng.integers(0, full.vocab_size, n, dtype=np.int32)
               for n in PROMPT_LENS]
    mods = {"paged": pa_mod}
    out = {}
    mesh = make_host_mesh()
    try:
        for dtype, layers in MESH_DEEPSEEK_LAYERS.items():
            free_card()
            name = str(dtype)[6:]
            f32 = dtype == torch.float32
            new, trace = ((MESH_PARITY_NEW, prompts[:MESH_PARITY_PROMPTS])
                          if f32 else (MAX_NEW, prompts))
            cfg = dataclasses.replace(full, n_layers=layers)
            pol = ServePolicy(
                batching="paged", max_slots=MAX_SLOTS, max_len=MAX_LEN,
                max_new_tokens=new,
                kv_budget_bytes=deepseek_pool_bytes(cfg, 4 if f32 else 2))
            plain = ServeEngine(cfg, pol, dtype=dtype, seed=0, device=DEVICE)
            meshed = ServeEngine(cfg, pol, dtype=dtype, params=plain.params,
                                 mesh=mesh)
            if not f32:                       # warm both (first-call costs)
                for eng in (plain, meshed):
                    eng.generate(prompts[:2], max_new_tokens=2)
            a = mesh_engine_run(plain, trace, new, mods)
            b = mesh_engine_run(meshed, trace, new, mods)
            row = {"layers": layers, "kv_shard": meshed.plan.kv_shard(),
                   "tokens_equal": a["outs"] == b["outs"],
                   "meshless": {k: a[k] for k in ("wall_s", "tok_s",
                                                  "tokens", "launches")},
                   "mesh": {k: b[k] for k in ("wall_s", "tok_s", "tokens",
                                              "launches")}}
            log(f"  (a) deepseek-v2 {layers} layers {name}: "
                + json.dumps(row))
            pa = b["launches"]["paged"]
            assert pa["LAUNCHES"] > 0, pa
            assert pa["LAUNCHES"] == a["launches"]["paged"]["LAUNCHES"], row
            if f32:
                assert row["tokens_equal"], "deepseek: mesh tokens differ"
            else:
                assert pa["LAUNCHES"] == pa["LAUNCHES_MLA"], pa
            out[name] = row
            del plain, meshed, a, b
        free_card()
        out["route"] = mesh_mla_route(pa_mod, t, mesh)
    finally:
        dist.destroy_process_group()
    out["heads"] = mla_local_heads(pa_mod, t)
    return out


def mesh_mla_route(pa_mod, t: int, mesh) -> dict:
    """The mla body through the mesh route (``models.layers.
    pool_write_attend`` on DTensors over ``mesh``: the latent rows written
    into each rank's pool, the kernel on this rank's query rows and heads
    as local tensors) at deepseek-v2's decode shape -- 8 rows at
    ``DECODE_LENS``, 128 heads over the one 576-wide latent, K = V, bf16
    -- held to the plain version on the same inputs, timed (device ms),
    its bound, and the body it ran.  The rows written are the pool's own,
    so every timed call sees the same pool."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.models.layers import pool_slots, pool_write_attend

    cfg = deepseek_cfg()
    case = make_case(torch.bfloat16, DECODE_LENS, t, False, copies=1,
                     cfg=cfg)
    q, pool = case["q"], case["k"]
    table, lengths = case["table"], case["lengths"]
    page_ids, off = pool_slots(table, (lengths.long() - 1).clamp(min=0), t)
    rows = pool[0][page_ids, off]                        # (R, 1, D)
    rep = [Replicate()] * mesh.ndim
    heads = [Shard(1) if n == "model" else Replicate()
             for n in mesh.mesh_dim_names]
    dq = DTensor.from_local(q, mesh, heads, run_check=False)
    drows = DTensor.from_local(rows, mesh, rep, run_check=False)
    dpool = DTensor.from_local(pool, mesh, rep, run_check=False)

    def run(i):
        return pool_write_attend(dq, drows, None, dpool, dpool, 0, page_ids,
                                 off, table, lengths, 0, t)

    before = counters(pa_mod, PAGED_BODIES)
    y = run(0)
    torch.cuda.synchronize()
    ran = body(pa_mod, before, "mla on the mesh route")
    assert isinstance(y, DTensor)
    ref = paged_attention_ref(q, pool[0], pool[0], table, lengths)
    live = lengths > 0
    err = held_to(y.to_local()[live], ref[live], TOL[torch.bfloat16],
                  "mesh-route mla")
    nbytes, ops = live_work(case, 0)
    bound, bound_by = bound_ms(nbytes, ops, torch.bfloat16)
    row = {"ms": cuda_ms(run), "path": ran, "max_abs_err": err,
           "plain_ms": cuda_ms(lambda i: paged_attention_ref(
               q, pool[0], pool[0], table, lengths), reps=10),
           "library_ms": cuda_ms(lambda i: library_attention(
               q, pool[0], pool[0], table, lengths, 0, fold_group=True),
               reps=10),
           "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    log(f"  (a) mesh-route mla decode ({ran}): kernel_ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms="
        f"{row['library_ms']:.4f} bound_ms={bound:.5f} ({bound_by}) "
        f"max_abs_err={err:.3g}")
    return row


def mla_local_heads(pa_mod, t: int) -> dict:
    """The mla body at each of ``MLA_LOCAL_HEADS`` query heads over the
    one latent (a partial m16 tile at 8), decode and a prefill chunk as
    phase 15 shapes them: held to its plain version (bf16 on ``mla``,
    float32 on ``simt``, two runs bit-identical) and the bf16 decode
    timed beside its bound."""
    out = {}
    pos0 = (1024 // t) * t
    shapes = {"decode": (DECODE_LENS, False),
              "prefill": (tuple(range(pos0 + 1, pos0 + t + 1)), True)}
    for h in MLA_LOCAL_HEADS:
        cfg = dataclasses.replace(deepseek_cfg(), n_heads=h)
        log(f"  (a) the mla body at {h} local heads over the latent")
        worst, bodies = paged_checks(pa_mod, shapes, t, cfg, (0,),
                                     bf16_body="mla")
        row = paged_timing(pa_mod, "decode", DECODE_LENS, False, t, cfg)
        out[h] = {"errors": {f"{a}/{b}": e for (a, b), e in worst.items()},
                  "max_abs_err": worst[("bfloat16", "decode")],
                  **{k: row[k] for k in ("ms", "ms_simt", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", "path", "splits",
                                         "split_pages")}}
    return out


def phase_serve_mesh_prefix(pa_mod) -> dict:
    """(a) llama3.2-1b at full width on ``make_host_mesh()`` with the radix
    cache, bf16, on the system-prompt trace: a warm mesh engine serves
    call A and then call B, a cold mesh engine call B alone (walls side by
    side), and a meshless warm engine both calls; the mesh engine's
    tokens equal the meshless warm engine's, with as many hits, hit
    tokens, pages saved and CoW copies, and every paged launch ``split``.
    Then one export from the mesh engine (call B's first prompt's pages)
    installed into a fresh meshless engine serves that prompt with one
    hit and the mesh engine's tokens."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import ServeEngine, ServePolicy

    free_card()
    cfg = get_cfg()
    mods = {"paged": pa_mod}
    keys = ("prefix_hits", "prefix_hit_tokens", "pages_saved", "cow_copies")
    pol = dict(batching="paged", max_slots=MAX_SLOTS, max_len=MAX_LEN,
               max_new_tokens=PREFIX_NEW)
    warm = ServePolicy(prefix_cache="radix", **pol)
    plain = ServeEngine(cfg, warm, dtype=torch.bfloat16, seed=0,
                        device=DEVICE)
    a, bs = system_trace(cfg)
    rows = {}
    mesh = make_host_mesh()
    try:
        meshed = ServeEngine(cfg, warm, dtype=torch.bfloat16,
                             params=plain.params, mesh=mesh)
        cold = ServeEngine(cfg, ServePolicy(**pol), dtype=torch.bfloat16,
                           params=plain.params, mesh=mesh)
        cold.generate(bs[:1], max_new_tokens=2)       # first-call costs
        for name, eng in (("meshless", plain), ("mesh", meshed)):
            measured_call(eng, [a], 1, mods)
            rows[name] = measured_call(eng, bs, PREFIX_NEW, mods)
        rows["mesh_cold"] = measured_call(cold, bs, PREFIX_NEW, mods)
        payload = meshed.export_pages(bs[0])
        again = meshed.generate(bs[:1])
    finally:
        dist.destroy_process_group()
    dst = ServeEngine(cfg, warm, dtype=torch.bfloat16, params=plain.params,
                      device=DEVICE)
    dst.import_pages(payload["tokens"], payload["pages"], payload["snaps"])
    imported = dst.generate(bs[:1])
    out = {name: {k: row[k] for k in keys + (
        "wall_s", "ttft_p50_s", "decode_tok_s", "prefill_tokens",
        "launches")} for name, (row, _) in rows.items()}
    out.update(tokens_equal=rows["mesh"][1] == rows["meshless"][1],
               exported_pages=len(payload["pages"]),
               imported_hits=int(dst.metrics["prefix_hits"]),
               imported_equal=imported == again)
    log("  (a) llama3.2-1b radix cache on the mesh, call B: "
        + json.dumps(out))
    assert out["tokens_equal"], "mesh warm tokens differ from meshless"
    for k in keys:
        assert out["mesh"][k] == out["meshless"][k] > 0, (k, out)
    pa = out["mesh"]["launches"]["paged"]
    assert 0 < pa["LAUNCHES"] == pa["LAUNCHES_SPLIT"], pa
    assert out["imported_hits"] == 1 and out["imported_equal"], out
    return out


#: The four reduced cases the 4-rank world gains: per-slot state rows on
#: local shards (paged xlstm and whisper) and zamba2's scan (cohort and
#: paged).
MESH_B_STATE = (("xlstm-1.3b", "paged"), (WHISPER, "paged"),
                (ZAMBA, "cohort"), (ZAMBA, "paged"), (DEEPSEEK, "paged"))
#: (b)'s radix cache case: the reduced llama and zamba2 with two
#: 2-slot calls of prompts sharing 2.5 pages of a 16 KiB leaf's plan, the
#: second hitting the first's pages, then an export of the first prompt's
#: pages installed into a fresh mesh engine.
MESH_B_PREFIX = {ARCH: 32, ZAMBA: 16}
MESH_B_LEAF = 16 << 10


def mesh_b_prefix_prompts(arch: str) -> list:
    """Two prompts sharing 2.5 of ``arch``'s pages, their tails differing
    at the first token."""
    from repro_torch.configs import get_model_config

    cfg = get_model_config(arch).reduced()
    t = MESH_B_PREFIX[arch]
    rng = np.random.default_rng(0xA11CE)
    shared = rng.integers(0, cfg.vocab_size, 2 * t + t // 2, dtype=np.int32)
    tails = [rng.integers(0, cfg.vocab_size, t // 2 + 2, dtype=np.int32)
             for _ in range(2)]
    tails[1][0] = (tails[0][0] + 1) % cfg.vocab_size
    return [np.concatenate([shared, tail]) for tail in tails]


def mesh_b_prefix(arch: str, mesh=None) -> dict:
    """The radix cache case of (b) on ``mesh`` (None: meshless): the
    tokens of one call a prompt, the hits and CoW copies, and the tokens
    a fresh engine that imported the first prompt's exported pages gives
    the second prompt."""
    from repro_torch.configs import get_model_config
    from repro_torch.hw import h100_spec
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine, ServePolicy

    cfg = get_model_config(arch).reduced()

    def engine():
        return ServeEngine(cfg, ServePolicy(
            max_new_tokens=4, max_len=256, max_slots=2, batching="paged",
            prefix_cache="radix"), params=Model(cfg).init(
                0, "cpu", torch.float32), spec=h100_spec(
                    smem_bytes=MESH_B_LEAF), device="cpu", mesh=mesh)

    ps = mesh_b_prefix_prompts(arch)
    eng = engine()
    outs = [eng.generate([p])[0] for p in ps]
    payload = eng.export_pages(ps[0])
    imp = engine()
    imp.import_pages(payload["tokens"], payload["pages"], payload["snaps"])
    return {"outs": outs, "hits": int(eng.metrics["prefix_hits"]),
            "cow": int(eng.metrics["cow_copies"]),
            "page": eng.page.page_tokens,
            "imported": imp.generate(ps[-1:])}


def mesh_b_prompts(arch: str) -> list:
    """Four token prompts (whisper: two requests of encoder frames and
    decoder tokens) for a reduced ``arch``."""
    from repro_torch.configs import get_model_config

    cfg = get_model_config(arch).reduced()
    rng = np.random.default_rng(1)
    if cfg.family == "enc_dec":
        return [{"enc_embeds": (0.02 * rng.standard_normal(
                    (n, cfg.d_model))).astype(np.float32),
                 "tokens": rng.integers(0, cfg.vocab_size, 4,
                                        dtype=np.int32)} for n in (8, 12)]
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
            for n in MESH_B_LENS]


def world_35b(rank: int, inputs: str) -> list:
    """(b) On every rank of a 4-rank gloo world on the card's host: the
    reduced llama3.2-1b on a (2, 2) CPU mesh, paged and cohort, under a
    shrunk HBM (kv_shard 2) and the default spec (kv_shard 1), float32;
    the ``MESH_B_STATE`` cases; and the radix cache cases
    (``mesh_b_prefix``)."""
    from repro_torch.configs import get_model_config
    from repro_torch.hw import h100_spec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_from_numpy
    from repro_torch.serve import ServeEngine, ServePolicy

    torch.set_num_threads(1)
    with np.load(inputs) as z:
        d = {k: z[k] for k in z.files}
    cfg = get_model_config(ARCH).reduced()
    tree: dict = {}
    for k, v in d.items():
        if k.startswith("param/"):
            node = tree
            keys = k[len("param/"):].split("/")
            for kk in keys[:-1]:
                node = node.setdefault(kk, {})
            node[keys[-1]] = v
    prompts = [d[f"prompt/{i}"] for i in range(len(MESH_B_LENS))]
    mesh = make_host_mesh(model_axis=2, device="cpu")
    rows = []
    for hbm in (MESH_B_SMALL_HBM, None):
        spec = h100_spec(hbm_bytes=hbm) if hbm else h100_spec()
        for batching in ("paged", "cohort"):
            eng = ServeEngine(cfg, ServePolicy(
                max_new_tokens=4, max_len=64, max_slots=4,
                batching=batching), params=params_from_numpy(tree, cfg,
                                                              "cpu"),
                spec=spec, device="cpu", mesh=mesh)
            rows.append({"hbm": hbm, "batching": batching,
                         "kv_shard": eng.plan.kv_shard(),
                         "outs": eng.generate(
                             prompts, max_new_tokens=list(MESH_B_NEWS))})
    for arch, batching in MESH_B_STATE:
        scfg = get_model_config(arch).reduced()
        eng = ServeEngine(scfg, ServePolicy(
            max_new_tokens=4, max_len=64, max_slots=4, batching=batching),
            params=Model(scfg).init(0, "cpu", torch.float32), device="cpu",
            mesh=mesh)
        rows.append({"arch": arch, "batching": batching,
                     "outs": eng.generate(mesh_b_prompts(arch))})
    for arch in MESH_B_PREFIX:
        rows.append({"arch": arch, "prefix": mesh_b_prefix(arch, mesh)})
    return rows


def phase_serve_mesh_cpu() -> dict:
    """(b) ``world_35b`` on 4 spawned gloo ranks (a ``FileStore`` in a
    temporary directory, a 300 s timeout) against the meshless engine on
    the same weights and prompts."""
    import shutil
    import tempfile

    from repro_torch.configs import get_model_config
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine, ServePolicy
    from repro_torch.tree import tree_flatten_with_paths

    cfg = get_model_config(ARCH).reduced()
    params = Model(cfg).init(0, "cpu", torch.float32)
    flat = {"param/" + k.replace(".", "/"): v.numpy()
            for k, v in tree_flatten_with_paths(params).items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in MESH_B_LENS]
    for i, p in enumerate(prompts):
        flat[f"prompt/{i}"] = p
    root = tempfile.mkdtemp(prefix="chip_smoke_world_")
    try:
        inputs = os.path.join(root, "inputs.npz")
        np.savez(inputs, **flat)
        ranks = spawn_world(world_35b, 4, os.path.join(root, "store"),
                            args=(inputs,), timeout_s=300)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = ServeEngine(cfg, ServePolicy(max_new_tokens=4, max_len=64,
                                        max_slots=4),
                       params=params, device="cpu").generate(
        prompts, max_new_tokens=list(MESH_B_NEWS))
    shards = [(r["batching"], r["hbm"], r["kv_shard"]) for r in ranks[0]
              if "hbm" in r]
    log(f"  (b) 4 gloo ranks at (2, 2): (batching, hbm, kv_shard) {shards}")
    state = {}
    for arch, batching in MESH_B_STATE:
        scfg = get_model_config(arch).reduced()
        state[f"{arch}/{batching}"] = ServeEngine(
            scfg, ServePolicy(max_new_tokens=4, max_len=64, max_slots=4,
                              batching=batching),
            params=Model(scfg).init(0, "cpu", torch.float32),
            device="cpu").generate(mesh_b_prompts(arch))
    prefix = {arch: mesh_b_prefix(arch) for arch in MESH_B_PREFIX}
    log(f"  (b) state-row, scan and mla cases, tokens equal the meshless "
        f"engine's: {list(state)}; radix cache: " + json.dumps(prefix))
    for arch, row in prefix.items():
        assert row["page"] == MESH_B_PREFIX[arch], row
        assert row["hits"] == 1 and row["imported"] == row["outs"][-1:], row
    for rank in ranks:
        for r in rank:
            if "hbm" in r:
                assert r["outs"] == want, (r["batching"], r["hbm"])
                assert r["kv_shard"] == (2 if r["hbm"] else 1), r
            elif "prefix" in r:
                assert r["prefix"] == prefix[r["arch"]], r
            else:
                assert r["outs"] == state[f"{r['arch']}/{r['batching']}"], \
                    (r["arch"], r["batching"])
    return {"cases": shards + list(state) + list(prefix), "tokens": want}


def start_dryrun() -> dict:
    """Start (c)'s dry run on the card's host, in subprocesses started
    together, their output to files: ``--plan-tree`` for every arch on
    both production meshes, and ``--calibrate`` of llama3.2-1b x train_4k
    and x decode_32k on 16 x 16 into a temporary artifact.  They run on
    the host's CPUs (no card) while (a) and (b) run; ``phase_dryrun``
    collects them."""
    import tempfile

    from repro_torch.configs.base import CALIBRATION_ENV

    root = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    cal = os.path.join(root, "calibration_torch.json")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "CUDA_VISIBLE_DEVICES": "",
           CALIBRATION_ENV: os.path.join(root, "none.json")}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    args = {"plan_tree": ["--plan-tree", "--arch", "all", "--mesh", "both"],
            "calibrate": ["--calibrate", "--arch", ARCH, "--shape",
                          "train_4k,decode_32k", "--mesh", "single",
                          "--calibration-out", cal, "--out", root]}
    procs = {}
    for name, extra in args.items():
        with open(os.path.join(root, f"{name}.log"), "w") as out:
            procs[name] = subprocess.Popen(cmd + extra, stdout=out,
                                           stderr=subprocess.STDOUT,
                                           env=env)
    return {"root": root, "cal": cal, "procs": procs,
            "t0": time.perf_counter()}


def phase_dryrun(started: dict) -> dict:
    """(c) The dry run ``start_dryrun`` started (host-CPU times, not the
    card's): every plan tree printed, each calibrated cell's roofline row
    printed, and the artifact read back."""
    from repro_torch.configs.base import CALIBRATION_ENV, \
        calibration_overhead

    root, cal, procs = started["root"], started["cal"], started["procs"]
    outs = {}
    try:
        for name, proc in procs.items():
            proc.wait(timeout=140)
            with open(os.path.join(root, f"{name}.log")) as f:
                outs[name] = f.read()
            assert proc.returncode == 0, outs[name][-3000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - started["t0"]
    trees = [ln for ln in outs["plan_tree"].splitlines()
             if ln.startswith("[plan]")]
    cal_lines = [ln for ln in outs["calibrate"].splitlines()
                 if ln.startswith("[cal]")]
    for ln in cal_lines:
        log("  (c) " + ln)
    assert len(trees) == 2 * 10, trees
    assert sum("roofline |" in ln for ln in cal_lines) == 2, cal_lines
    with open(cal) as f:
        artifact = json.load(f)
    os.environ[CALIBRATION_ENV] = cal
    try:
        overhead = calibration_overhead(ARCH)
    finally:
        os.environ.pop(CALIBRATION_ENV)
    assert overhead == artifact[ARCH]["overhead"], (overhead, artifact)
    log(f"  (c) {len(trees)} plan trees; calibration {artifact[ARCH]}; "
        f"host seconds {secs:.1f}")
    return {"plan_trees": len(trees), "calibration": artifact[ARCH],
            "host_s": secs, "cal_lines": cal_lines}


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
    pparity = pllama = pzamba = pexport = pcli = pcap = ppaper = None
    pcluster = tguard = tparity = tfull = tloop = None
    rblocks = rone = tmesh = tcpu = smesh = zmesh = scpu = sdry = None
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
        log(f"[9] serving full-width zamba2-1.2b cut to "
            f"{SERVE_ZAMBA_LAYERS} of 38 mixers, bf16")
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
        log("[25] the radix prefix cache on the card, float32 at cut depth: "
            "llama3.2-1b (4 layers), mixtral-8x7b (2), deepseek-v2-236b "
            "(2), zamba2-1.2b (8 mixers), xlstm-1.3b (2 blocks)")
        pparity = phase("phase 25 prefix parity", phase_prefix_parity,
                        {"paged": pa_mod, "ssd": ssd_mod})
        log("[26] the system-prompt trace on full-width llama3.2-1b, bf16: "
            "the radix cache warm beside a cold engine")
        pllama = phase("phase 26 llama prefix serve", phase_prefix_serve,
                       get_cfg(), {"paged": pa_mod})
        log(f"[27] the system-prompt trace on full-width zamba2-1.2b cut "
            f"to {PREFIX_ZAMBA_LAYERS} of 38 mixers, bf16")
        pzamba = phase("phase 27 zamba2 prefix serve", phase_prefix_serve,
                       parity_cfg(ZAMBA, PREFIX_ZAMBA_LAYERS),
                       {"paged": pa_mod, "ssd": ssd_mod})
        log("[28] export_pages / import_pages between two llama3.2-1b "
            "engines (4 layers, float32)")
        pexport = phase("phase 28 export import", phase_export_import)
        log("[29] the command lines on the card")
        pcli = phase("phase 29 command lines", phase_clis)
        log("[30] zamba2-1.2b's state snapshots under a cap of "
            f"{CAP_SNAPSHOTS}, {MAX_SLOTS} long prefills together, bf16")
        pcap = phase("phase 30 snapshot cap", phase_snapshot_cap,
                     zamba_cfg(), {"paged": pa_mod, "ssd": ssd_mod})
        log("[31] the paper's run-time system on the card's host: MatMult "
            "and SOR through the port's Engine (host CPU times)")
        ppaper = phase("phase 31 paper engine", phase_paper_engine, smi)
        free_card()
        log(f"[32] the serving cluster on the card: llama3.2-1b at full "
            f"width, {CLUSTER_N} replicas over threads and spawned "
            f"processes, disaggregated 1:1, HTTP")
        pcluster = phase("phase 32 cluster", phase_cluster, pa_mod)
        free_card()
        train_mods = {"paged": pa_mod, "ssd": ssd_mod, "matmul": mm_mod,
                      "flash": fa_mod}
        log("[33] training on the card (no hand-written kernel on its "
            "path): (a) the kernels' autograd guard, (b) every family cuda "
            "against cpu, (c) full-width llama3.2-1b, (d) the CLI and the "
            "loop")
        tguard = phase("phase 33a train guard", phase_train_guard,
                       train_mods, zserve)
        tparity = phase("phase 33b train parity", phase_train_parity)
        tfull = phase("phase 33c train full width", phase_train_full,
                      train_mods)
        tloop = phase("phase 33d train loop", phase_train_loop)
        log("[34] tensor-parallel training over a device mesh: (a) the "
            "ring's block products, (b) the rings on a one-rank NCCL world, "
            "(c) full-width llama3.2-1b on make_host_mesh(), (d) 4 gloo "
            "ranks on the host CPU")
        t34 = time.perf_counter()
        rblocks = phase("phase 34a ring blocks", phase_ring_blocks, mm_mod)
        rone = phase("phase 34b rings on one rank", phase_ring_one_rank,
                     mm_mod)
        tmesh = phase("phase 34c train on the mesh", phase_train_mesh, tfull)
        tcpu = phase("phase 34d 4 gloo ranks", phase_train_mesh_cpu)
        log(f"  phase 34: {time.perf_counter() - t34:.1f} s")
        free_card()
        log("[35] serving over a device mesh: (a) full-width llama3.2-1b, "
            "zamba2-1.2b and deepseek-v2-236b on make_host_mesh(), and "
            "llama3.2-1b with the radix cache, (b) 4 gloo ranks at (2, 2) "
            "on the host, (c) the dry run on the host")
        t35 = time.perf_counter()
        dry = start_dryrun()
        smesh = phase("phase 35a serve on the mesh", phase_serve_mesh,
                      pa_mod)
        zmesh = phase("phase 35a zamba2 on the mesh",
                      phase_serve_mesh_zamba, pa_mod, ssd_mod)
        dmesh = phase("phase 35a deepseek-v2 on the mesh",
                      phase_serve_mesh_deepseek, pa_mod, dt)
        pmesh = phase("phase 35a radix cache on the mesh",
                      phase_serve_mesh_prefix, pa_mod)
        scpu = phase("phase 35b 4 gloo ranks serve", phase_serve_mesh_cpu)
        sdry = phase("phase 35c dry run", phase_dryrun, dry)
        log(f"  phase 35: {time.perf_counter() - t35:.1f} s")
    if failed or None in (kern, serve, tk, tune, zk, zserve, mk, mserve,
                          xserve, dk, dserve, wk, wserve, qslice, ab, cssd,
                          cserve, pparity, pllama, pzamba, pexport, pcli,
                          pcap, ppaper, pcluster, tguard, tparity, tfull,
                          tloop, rblocks, rone, tmesh, tcpu, smesh, zmesh,
                          dmesh, pmesh, scpu, sdry):
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
    # The rings (phase 34): matmul_cc's launches as their block product on
    # the one-rank world, and its times at the ring's block shapes.
    kernels[1]["ring"] = {
        "launches": rone["launches"],
        "max_abs_err": rblocks["max_abs_err"],
        **{what: {k: row[k] for k in ("shape", "ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by",
                                      "path")}
           for what, row in rblocks["shapes"].items()}}
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
    # The radix cache's warm call B (phases 26-27): paged launches by body
    # on llama and zamba2, zamba2's SSD launches.
    kernels[0]["prefix"] = {
        name: row["warm"]["launches"]["paged"]
        for name, row in (("llama", pllama), ("zamba2", pzamba))}
    ssd["prefix"] = {"zamba2": pzamba["warm"]["launches"]["ssd"]}
    # The cluster (phase 32): the paged launches by body of the thread
    # runs (float32 routes to simt, bf16 to split), and (c)'s tok/s.
    kernels[0]["cluster"] = {
        "launches_f32_thread": pcluster["identity"]["launches_thread"],
        "launches_bf16_thread": pcluster["serve"]["thread"]["launches"],
        "tok_s": {way: row["tok_s"]
                  for way, row in pcluster["serve"].items()}}
    # Serving over the one-rank mesh (phase 35 (a)): the paged launches of
    # the mesh engine's bf16 run, by body, and its tok/s beside the
    # meshless engine's.
    kernels[0]["mesh"] = {
        "launches": smesh["bfloat16"]["mesh"]["launches"]["paged"][
            "LAUNCHES"],
        "launches_split": smesh["bfloat16"]["mesh"]["launches"]["paged"][
            "LAUNCHES_SPLIT"],
        "launches_f32": smesh["float32"]["mesh"]["launches"]["paged"][
            "LAUNCHES"],
        "tok_s": smesh["bfloat16"]["mesh"]["tok_s"],
        "tok_s_meshless": smesh["bfloat16"]["meshless"]["tok_s"]}
    # zamba2 on the one-rank mesh (phase 35 (a)): ssd_scan through the
    # mesh route, on local tensors -- the bf16 paged and cohort runs'
    # launches by body (the main path's count is phase 9's), and its time
    # and bound at the serving shape.
    zr = zmesh["route"]
    ssd["mesh"] = {
        "layers": MESH_ZAMBA_LAYERS,
        "launches_paged": zmesh["bfloat16"]["paged"]["mesh"]["launches"][
            "ssd"],
        "launches_cohort": zmesh["bfloat16"]["cohort"]["mesh"]["launches"][
            "ssd"],
        "S=8": {k: zr[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "path",
                                   "max_abs_err")}}
    kernels[0]["mesh"]["zamba2_launches"] = zmesh["bfloat16"]["paged"][
        "mesh"]["launches"]["paged"]
    kernels[0]["mesh"]["prefix_launches"] = pmesh["mesh"]["launches"][
        "paged"]
    # deepseek-v2 on the one-rank mesh (phase 35 (a)): the mla body's
    # launches in the bf16 mesh run, its time and bound through the mesh
    # route at the decode shape, and alone at the production meshes'
    # local head counts.
    dr = dmesh["route"]
    kernels[0]["mla"] = {"mesh": {
        "layers": dmesh["bfloat16"]["layers"],
        "launches": dmesh["bfloat16"]["mesh"]["launches"]["paged"][
            "LAUNCHES_MLA"],
        "launches_meshless": dmesh["bfloat16"]["meshless"]["launches"][
            "paged"]["LAUNCHES"],
        **{k: dr[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "path", "max_abs_err")},
        "local_heads": {str(h): {k: row[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "path",
            "max_abs_err")} for h, row in dmesh["heads"].items()}}}
    # Phases 26-27's warm and cold figures, then phase 24's, at the end of
    # the output, where the profiler tables above do not push them out.
    log("prefix serving: " + json.dumps({
        name: {side: {k: row[side][k] for k in (
            "wall_s", "ttft_p50_s", "ttft_max_s", "decode_tok_s",
            "prefill_tokens", "prefill_chunks", "prefix_hits",
            "prefix_hit_tokens", "cow_copies", "peak_mem_gb")}
            for side in ("warm", "cold")}
        for name, row in (("llama", pllama), ("zamba2", pzamba))}))
    # Phase 24's figures again at the end of the output, where the
    # profiler tables above do not push them out of a short tail.
    log("cohort serving: " + json.dumps({
        name: {k: row[k] for k in (
            "wall_s", "decode_tok_s", "ttft_p50_s", "ttft_max_s",
            "peak_mem_gb", "decode_steps", "cohorts", "slot_utilization",
            "busy_share")}
        for name, row in cserve.items()}))
    # Phase 31's host runs, one object a run (host CPU seconds).
    log("paper engine: " + json.dumps({
        "cpu": ppaper["cpu"], "tree": ppaper["tree"],
        "runs": [{k: row[k] for k in ("bench", "strategy", "schedule",
                                      "n_workers", "np", "n_tasks", "s",
                                      "horizontal_over_cc")}
                 for row in ppaper["runs"]]}))
    # Phase 32's figures, for the same reason.
    log("cluster serving: " + json.dumps({
        way: {k: row[k] for k in ("wall_s", "tok_s", "ttft_p50_s",
                                  "ttft_p95_s", "mem_before_gb",
                                  "mem_during_gb", "mem_after_gb",
                                  "smi_util_mean", "busy_share",
                                  "busy_share_unprofiled_wall")}
        for way, row in pcluster["serve"].items()}))
    log("cluster disagg: " + json.dumps(pcluster["disagg"]))
    # Phase 33's full-width training figures.
    log("training: " + json.dumps({k: tfull[k] for k in (
        "arch", "seq", "global_batch", "batch_cut_from", "microbatches",
        "step_s", "tokens_per_s", "mfu_bf16_989", "peak_mem_gb",
        "busy_share", "losses")}))
    # Phase 34's sharded step beside the meshless one.
    log("training on a mesh: " + json.dumps({k: tmesh[k] for k in (
        "mesh", "planner", "losses", "losses_meshless", "grad_norms",
        "grad_norms_meshless", "rel_err", "step_s", "step_s_meshless",
        "step_s_phase33c", "peak_mem_gb", "peak_mem_gb_meshless",
        "busy_share")}))
    # Phase 35's serving on the mesh beside the meshless engine.
    log("serving on a mesh: " + json.dumps({
        name: {k: row[k] for k in ("kv_shard", "tokens_equal", "meshless",
                                   "mesh")}
        for name, row in smesh.items()}))
    log("deepseek-v2 on a mesh: " + json.dumps({
        name: {"layers": dmesh[name]["layers"],
               "tokens_equal": dmesh[name]["tokens_equal"],
               "wall_s": [dmesh[name]["meshless"]["wall_s"],
                          dmesh[name]["mesh"]["wall_s"]],
               "tok_s": [dmesh[name]["meshless"]["tok_s"],
                         dmesh[name]["mesh"]["tok_s"]]}
        for name in ("float32", "bfloat16")}))
    log("radix cache on a mesh: " + json.dumps(pmesh))
    log("zamba2 on a mesh: " + json.dumps({
        name: {b: {"tokens_equal": r["tokens_equal"],
                   "wall_s": [r["meshless"]["wall_s"], r["mesh"]["wall_s"]],
                   "tok_s": [r["meshless"]["tok_s"], r["mesh"]["tok_s"]]}
               for b, r in zmesh[name].items()}
        for name in ("float32", "bfloat16")}))
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
