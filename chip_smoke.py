#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # what a check of the port runs
    python3 chip_smoke.py --profile  # also: device time by kernel in serving

Phases (each prints its results; the script exits non-zero if any fails):

  0. header: the card's name and power limit, torch and CUDA versions;
  1. build: compile the four sources of ``src/repro_torch/csrc/`` with nvcc
     for sm_90a, one nvcc each, all started together, and print the build
     seconds and ptxas' register/shared-memory report;
  2. kernel against its plain version: ``paged_attention`` on the card
     against ``paged_attention_ref`` on the same inputs, at the full width
     of llama3.2-1b (H=32, KV=8, D=64, the planned page) in the decode shape
     (8 rows) and the chunked-prefill shape (one page of rows over one
     table), bf16 and float32, windows 0 and 256; then the times of the
     kernel, the plain version and a library yardstick (gather + SDPA)
     beside the least time the card could take (``bound_ms``);
  3. the slice against its plain path: full-width llama3.2-1b cut to 2
     layers, float32, one prefill chunk per slot and one paged decode step
     on the card and on the CPU with the same weights;
  4. serving: ``ServeEngine`` on full-width llama3.2-1b (16 layers, seeded
     random weights, bf16) with paged batching and chunked prefill serves 8
     prompts of mixed length; every decode tick and prefill chunk of every
     layer must have launched the kernel.
  5. the three kernels of the tuning path against their plain versions at
     full width, bf16 and float32, at the planner's analytic blocks, plus
     one ragged case each: ``matmul_cc`` at llama3.2-1b's MLP up-projection
     for a 4096-token prefill (4096 x 2048 x 8192), orders cc and srrc
     (bit-identical); ``flash_attention`` at llama3.2-1b's attention over
     4096 tokens (1, 32, 4096, 64), causal; ``ssd_scan`` at zamba2-1.2b's
     mixer over 4096 tokens (1, 4096, 64 heads, 64, state 64).  Then each
     kernel's time beside its plain version's, a library call's where one
     computes the same function, and its bound;
  6. the tuning path at full width: the four sweeps on the card (phase 5's
     shapes in bf16, and ``sweep_paged`` at llama3.2-1b decode: 8 slots,
     4096 tokens, 8 KV heads, group 4, D 64), each candidate's shared
     memory held to the kernel's own ``*_smem_bytes``, the winners written
     under the card's fingerprint to a file under ``build/``, the planner
     shown to return each of them, and ``python -m repro_torch.launch.tune
     --quick`` run on the card.

Phases 0-4 plan and serve without a tuning artifact (the port's tuning
path points at a file that does not exist until phase 6 writes one), so
their numbers compare with earlier runs'.

Output, at the end: one JSON line describing the kernels, the card's
``nvidia-smi`` name and power limit, and as the last line
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
DEVICE = "cuda"
MAX_SLOTS = 8
MAX_LEN = 4096
MAX_NEW = 32
PROMPT_LENS = (64, 1024, 200, 512, 96, 768, 333, 900)
#: Decode-shape lengths: empty, one token, many pages.
DECODE_LENS = (0, 1, 57, 300, 700, 1056, 1000, 64)
LAYER_COPIES = 16       # one pool per layer, as the main path reads them
REPS = 50
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
    """Mean milliseconds of ``fn(i)`` over ``reps`` calls, CUDA events."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i + 1)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------


def make_case(dtype, lens, t, rows_share_table: bool, copies: int, seed=0):
    """Inputs at llama3.2-1b's attention width on the card.

    Decode: one row per slot, each slot with its own pages.  Prefill: the
    rows are one chunk's tokens over ONE table row (``lens`` = positions
    + 1).  ``copies`` pools stand for the model's layers.
    """
    cfg = get_cfg()
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    np_ = -(-MAX_LEN // t)                       # the engine's table width
    need = [-(-n // t) for n in lens]
    gen = torch.Generator().manual_seed(seed)
    if rows_share_table:
        n_live = max(need)
        p_total = 1 + n_live
        perm = torch.randperm(p_total - 1, generator=gen) + 1
        row = torch.zeros(np_, dtype=torch.int32)
        row[:n_live] = perm[:n_live].int()
        table = row[None].expand(len(lens), np_).contiguous()
    else:
        p_total = 1 + sum(need)
        perm = (torch.randperm(p_total - 1, generator=gen) + 1).int()
        table = torch.zeros(len(lens), np_, dtype=torch.int32)
        at = 0
        for i, n in enumerate(need):
            table[i, :n] = perm[at:at + n]
            at += n
    q = torch.randn(len(lens), h, d, generator=gen)
    k = torch.randn(copies, p_total, t, kv, d, generator=gen)
    v = torch.randn(copies, p_total, t, kv, d, generator=gen)
    dev = DEVICE
    return dict(q=q.to(dev, dtype), k=k.to(dev, dtype), v=v.to(dev, dtype),
                table=table.to(dev),
                lengths=torch.tensor(lens, dtype=torch.int32, device=dev))


def live_work(case, window: int):
    """(bytes, operations) the function needs on these inputs: q, table,
    lengths and the output once, and each live K/V token of the pool once
    (rows that share a page read it once); 4 flops per live (row, key,
    query head, dim): q.k and p.v."""
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
    nbytes = (2 * q.numel() * el + tab.numel() * 4 + s * 4
              + int(live.sum()) * 2 * kv * d * el)
    return nbytes, 4 * pairs * h * d


def library_attention(q, kp, vp, table, lengths, window):
    """Yardstick only (the port never calls it): gather the pages, then
    ``scaled_dot_product_attention`` with grouped heads and a length mask."""
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


def phase_kernel(t: int) -> dict:
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref

    prefill_pos0 = 8 * t
    shapes = {
        "decode": (DECODE_LENS, False),
        "prefill": (tuple(range(prefill_pos0 + 1, prefill_pos0 + t + 1)),
                    True),
    }
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (lens, shared) in shapes.items():
            case = make_case(dtype, lens, t, shared, copies=1)
            live = case["lengths"] > 0
            for window in (0, 256):
                args = (case["q"], case["k"][0], case["v"][0],
                        case["table"], case["lengths"])
                out = paged_attention(*args, window=window, page_tokens=t)
                torch.cuda.synchronize()
                ref = paged_attention_ref(*args, window=window)
                err = (out.float() - ref.float())[live].abs()
                bound = TOL[dtype] * (1 + ref.float()[live].abs())
                ok = bool((err <= bound).all())
                key = (str(dtype).split(".")[-1], name)
                worst[key] = max(worst.get(key, 0.0), float(err.max()))
                log(f"  check {key[0]:8s} {name:7s} window={window:3d}: "
                    f"max_abs_err={float(err.max()):.3e} "
                    f"(tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"kernel disagrees with its plain version: {key}, "
                        f"window {window}")
                assert not out[~live].float().abs().any(), "empty row not 0"

    timings = {}
    for name, (lens, shared) in shapes.items():
        case = make_case(torch.bfloat16, lens, t, shared, LAYER_COPIES)
        q, kp, vp = case["q"], case["k"], case["v"]
        table, lengths = case["table"], case["lengths"]

        def layer(i):
            return kp[i % LAYER_COPIES], vp[i % LAYER_COPIES]

        def run_kernel(i):
            kl, vl = layer(i)
            paged_attention(q, kl, vl, table, lengths, page_tokens=t)

        def run_ref(i):
            kl, vl = layer(i)
            paged_attention_ref(q, kl, vl, table, lengths)

        def run_lib(i):
            kl, vl = layer(i)
            library_attention(q, kl, vl, table, lengths, 0)

        nbytes, ops = live_work(case, 0)
        bound, bound_by = bound_ms(nbytes, ops, torch.bfloat16)
        row = {
            "ms": cuda_ms(run_kernel),
            "plain_ms": cuda_ms(run_ref, reps=10),
            "library_ms": cuda_ms(run_lib, reps=10),
            "bound_ms": bound, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops, "rows": len(lens),
        }
        timings[name] = row
        log(f"  time bf16 {name:7s} rows={len(lens)}: kernel_ms="
            f"{row['ms']:.4f} ref_ms={row['plain_ms']:.4f} library_ms="
            f"{row['library_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}, {nbytes} B, {ops} flop) "
            f"share_of_bound={row['bound_ms'] / row['ms']:.3f}")
    log("  phase 2 max_abs_err: " + json.dumps(
        {f"{a}/{b}": e for (a, b), e in worst.items()}))
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


def phase_serve(pa_mod) -> dict:
    from repro_torch.serve import ServeEngine, ServePolicy

    cfg = get_cfg()
    policy = ServePolicy(batching="paged", prefill="chunked",
                         max_slots=MAX_SLOTS, max_len=MAX_LEN,
                         max_new_tokens=MAX_NEW)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in PROMPT_LENS]
    warm = ServeEngine(cfg, policy, dtype=torch.bfloat16, seed=0,
                       device=DEVICE)
    warm.generate(prompts[:2], max_new_tokens=2)
    engine = ServeEngine(cfg, policy, dtype=torch.bfloat16,
                         params=warm.params, device=DEVICE)
    torch.cuda.synchronize()
    pa_mod.LAUNCHES = 0                    # the main path's run starts here
    t0 = time.perf_counter()
    outs = engine.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa_mod.LAUNCHES             # ... and ends here
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
        "backfills": int(m["backfills"]), "LAUNCHES": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("  serve: " + json.dumps(row))
    assert [len(o) for o in outs] == [MAX_NEW] * len(prompts), \
        [len(o) for o in outs]
    assert all(0 <= tok < cfg.vocab_size for o in outs for tok in o)
    assert launches > 0, "the main path never launched the kernel"
    assert launches == cfg.n_layers * (steps + chunks), \
        (launches, cfg.n_layers, steps, chunks)
    assert row["pages_allocated"] == row["pages_released"]
    if PROFILE:
        profile_serve(engine, prompts, wall)
    return row


def profile_serve(engine, prompts, unprofiled_wall_s: float) -> None:
    """``--profile``: device time by kernel over one more generate call of
    the same prompts under ``torch.profiler``.  The card's busy share is
    printed twice: over this call's wall time (the profiler's own host
    cost included), and over the wall time of the unprofiled call before
    it (same prompts, same tokens; two calls, so an estimate)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts)
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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_cc import matmul_cc
    from repro_torch.kernels.ref import (flash_attention_ref, matmul_ref,
                                         ssd_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.mamba2 import choose_chunk

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    worst = {}
    # matmul_cc: B scaled by 1/sqrt(K), as weights are initialised, so the
    # products sum to O(1) values and float32's 1e-4 measures the kernel.
    for dtype, (m, k, n) in ((torch.bfloat16, MM_SHAPE),
                             (torch.float32, MM_SHAPE),
                             (torch.bfloat16, (4000, 2000, 8000))):
        a = randn(gen, (m, k), dtype)
        b = randn(gen, (k, n), dtype, scale=k ** -0.5)
        plan = plan_matmul(m, k, n, dtype_bytes=a.element_size())
        cc = matmul_cc(a, b, plan=plan)
        srrc = matmul_cc(a, b, plan=dataclasses.replace(plan, order="srrc"))
        torch.cuda.synchronize()
        assert torch.equal(cc, srrc), "cc and srrc differ"
        what = f"matmul_cc {str(dtype)[6:]} {m}x{k}x{n} tile {plan.bm}x" \
            f"{plan.bk}x{plan.bn} (cc == srrc bit for bit)"
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
        out, plan = flash_attention(q, k, v, causal=True, return_plan=True)
        torch.cuda.synchronize()
        what = (f"flash_attention {str(dtype)[6:]} ({b_},{h_},{sq},{sk},"
                f"{d_}) blocks {plan.block_q}/{plan.block_kv}")
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
        y = ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        what = f"ssd_scan {str(dtype)[6:]} ({bs},{s},{hs},{ps},{ns}) " \
            f"chunk {chunk}"
        err = held_to(y, ssd_ref(*args), SSD_TOL[dtype], what)
        worst[("ssd_scan", dtype)] = max(
            worst.get(("ssd_scan", dtype), 0.0), err)

    # Times, bf16, full width.
    rows = {}
    m, k, n = MM_SHAPE
    a = randn(gen, (m, k), torch.bfloat16)
    b = randn(gen, (k, n), torch.bfloat16, scale=k ** -0.5)
    plan = plan_matmul(m, k, n, dtype_bytes=2)
    rows["matmul_cc"] = dict(
        ms=cuda_ms(lambda i: matmul_cc(a, b, plan=plan), reps=10),
        plain_ms=cuda_ms(lambda i: matmul_ref(a, b), reps=10),
        library_ms=cuda_ms(lambda i: torch.matmul(a, b), reps=10),
        bytes=(m * k + k * n + m * n) * 2, ops=2 * m * n * k,
        library="torch.matmul")
    del a, b
    q, k_, v = (randn(gen, FA_SHAPE, torch.bfloat16) for _ in range(3))
    fa_plan = plan_attention(s_, s_, d_, dtype_bytes=2)
    rows["flash_attention"] = dict(
        ms=cuda_ms(lambda i: flash_attention(q, k_, v, plan=fa_plan),
                   reps=10),
        plain_ms=cuda_ms(lambda i: flash_attention_ref(q, k_, v), reps=3),
        library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
            q, k_, v, is_causal=True), reps=10),
        bytes=4 * b_ * h_ * s_ * d_ * 2,
        ops=4 * b_ * h_ * d_ * (s_ * (s_ + 1) // 2),   # the causal half
        library="scaled_dot_product_attention(is_causal=True)")
    del q, k_, v
    chunk = choose_chunk(ss, hs, ps, ns, dtype_bytes=2)
    args = ssd_inputs(gen, bs, ss, hs, ps, ns, torch.bfloat16)
    nq = -(-ss // chunk)
    tri = chunk * (chunk + 1) // 2
    rows["ssd_scan"] = dict(
        ms=cuda_ms(lambda i: ssd_scan(*args, chunk=chunk), reps=10),
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
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"],
                                                    torch.bfloat16)
        row["max_abs_err"] = worst[(name, torch.bfloat16)]
        lib = ("null" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        log(f"  time bf16 {name}: kernel_ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={lib} "
            f"({row['library']}) bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}, {row['bytes']} B, {row['ops']} flop) "
            f"share_of_bound={row['bound_ms'] / row['ms']:.4f}")
    log("  phase 5 max_abs_err: " + json.dumps(
        {f"{a}/{str(b)[6:]}": e for (a, b), e in worst.items()}))
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
    for mod in mods.values():
        mod.LAUNCHES = 0                   # the main path's run starts here
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
    log(f"  sweeps: {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps(launches)}")
    assert print_report(results), "a candidate breaks its budget"
    for r in results:
        assert r.candidates and r.center in [c.block for c in r.candidates], \
            f"{r.kernel}: the analytic centre does not fit"
        assert r.entry is not None, f"{r.kernel}: no winner"
    # Every candidate's working-set estimate is the kernel's own.
    g = cfg.n_heads // cfg.n_kv_heads
    smem = {
        "matmul_cc": lambda b: matmul_cc.kernel_smem_bytes(
            b["bm"], b["bk"], b["bn"], torch.bfloat16),
        "flash_attention": lambda b: flash_attention.kernel_smem_bytes(
            b["block_kv"], FA_SHAPE[3], torch.bfloat16),
        "paged_attention": lambda b: paged_attention.kernel_smem_bytes(
            g, cfg.head_dim),
        "ssd_scan": lambda b: ssd_scan.kernel_smem_bytes(b["chunk"], ps, ns),
    }
    for r in results:
        for c in r.candidates:
            got = smem[r.kernel](c.block)
            assert c.est_vmem_bytes == got, (r.kernel, c.block,
                                             c.est_vmem_bytes, got)
    log(f"  estimates: all {sum(len(r.candidates) for r in results)} "
        f"candidates' shared memory equals the kernels' *_smem_bytes")
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
        return time.perf_counter() - t0

    log("[1] build (one nvcc per source, all started together)")
    build_s = phase("phase 1 build", build)
    plan = plan_decode(get_cfg(), max_len=MAX_LEN, batch=MAX_SLOTS,
                       dtype_bytes=2)
    t = plan.page_plan()["page_tokens"]
    log(f"  planned page: {t} tokens ({plan.page_plan()['page_bytes']} B "
        f"per layer page, SMEM budget {plan.level('SMEM').budget_bytes} B, "
        f"{plan.page_plan()['source']})")
    kern = serve = tk = tune = None
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
    if failed or None in (kern, serve, tk, tune):
        log(f"FAILED phases: {failed}")
        return 1
    dec = kern["timings"]["decode"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:50",
        "launches": serve["LAUNCHES"],
        "max_abs_err": kern["max_abs_err"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
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
            "library_ms": row["library_ms"],
        })
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
