"""Serving launcher: a thin CLI over ``repro_torch.serve.ServeEngine`` (the
port of ``repro.launch.serve``'s single-engine path).

``python -m repro_torch.launch.serve --arch <id> --tokens 32`` serves a
seeded batch of synthetic prompts through one engine on the card
(``--device cpu`` runs it on the CPU with the kernels' plain versions).
Every page and pool choice falls out of the decode plan: the CLI only
names the architecture (its ``.reduced()`` config), the prompt mix, the
sampling config, ``--batching {cohort,paged,auto}`` ("auto", the default,
picks the paged engine whenever the plan has a page level and the family
a per-slot decode path), ``--prefill {chunked,monolithic}`` and
``--prefix {off,radix}`` (the cross-request radix prefix cache of the
paged engine).  ``--metrics_interval S`` prints the registry every S
seconds while it runs, ``--stats 1`` the registry at the end, ``--trace
out.json`` the Chrome trace.

The reference's fleet options (``--cluster N``, ``--disagg P:D``,
``--serve``) belong to the cluster, which the port has not ported yet:
they exit with a message saying so.
"""

from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    import numpy as np
    import torch

    from repro_torch.configs import get_model_config, parse_cli
    from repro_torch.serve import SamplingConfig, ServeEngine, ServePolicy

    overrides, _ = parse_cli(argv if argv is not None else sys.argv[1:])
    for key in ("cluster", "disagg", "serve"):
        if key in overrides:
            raise SystemExit(
                f"--{key}: the cluster (replicas behind a router, "
                f"disaggregated prefill/decode, the HTTP front end) is not "
                f"ported to repro_torch yet; serve one engine without it")
    arch = overrides.pop("arch", "llama3.2-1b")
    n_new = int(overrides.pop("tokens", "16"))
    batch = int(overrides.pop("batch", "4"))
    prompt_len = int(overrides.pop("prompt_len", "64"))
    mixed = overrides.pop("mixed", "0").lower() in ("1", "true", "yes")
    kind = overrides.pop("sampling", "greedy")
    temperature = float(overrides.pop("temperature", "1.0"))
    top_k = int(overrides.pop("top_k", "0"))
    seed = int(overrides.pop("seed", "0"))
    batching = overrides.pop("batching", "auto")
    prefill = overrides.pop("prefill", "chunked")
    prefix = overrides.pop("prefix", "off")
    device = overrides.pop("device", None)
    trace_path = overrides.pop("trace", "")
    metrics_interval = float(overrides.pop("metrics_interval", "0"))
    show_stats = overrides.pop("stats", "0").lower() in ("1", "true",
                                                         "yes")
    if overrides:
        raise SystemExit(f"unknown options: {sorted(overrides)}")

    cfg = get_model_config(arch).reduced()
    sampling = SamplingConfig(kind=kind, temperature=temperature,
                              top_k=top_k or (40 if kind == "top_k" else 0),
                              seed=seed)
    if batching not in ("cohort", "paged", "auto"):
        raise SystemExit(f"--batching must be cohort|paged|auto, "
                         f"got {batching!r}")
    if prefill not in ("chunked", "monolithic"):
        raise SystemExit(f"--prefill must be chunked|monolithic, "
                         f"got {prefill!r}")
    if prefix not in ("off", "radix"):
        raise SystemExit(f"--prefix must be off|radix, got {prefix!r}")
    engine = ServeEngine(
        cfg, ServePolicy(max_new_tokens=n_new, max_slots=max(1, batch),
                         max_len=prompt_len + n_new + 1,
                         batching=batching, prefill=prefill,
                         prefix_cache=prefix, sampling=sampling),
        dtype=torch.float32, seed=seed, device=device)

    rng = np.random.default_rng(seed)
    prompts = []
    for i in range(batch):
        plen = prompt_len if not mixed else max(8, prompt_len // (1 + i % 2))
        prompts.append(engine_prompt(cfg, plen, rng))

    stop_metrics = None
    if metrics_interval > 0:
        stop_metrics = _metrics_ticker(engine.obs, metrics_interval)
    t0 = time.perf_counter()
    try:
        outs = engine.generate(prompts)
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        if stop_metrics is not None:
            stop_metrics()
    dt = time.perf_counter() - t0

    n_tok = sum(len(o) for o in outs)
    m = engine.metrics
    print(f"[serve] arch={arch} requests={batch} prompt={prompt_len}"
          f"{' (mixed)' if mixed else ''} sampling={kind} "
          f"batching={m['batching']} device={engine.device}")
    print(f"[serve] plan: page_tokens={m['page_tokens']} "
          f"page_bytes={m['page_bytes']} kv_shard={m['kv_shard']} "
          f"budget={m['budget_bytes'] / 2**30:.1f}GiB")
    print(f"[serve] {n_tok} tokens in {dt:.2f}s ({n_tok / max(dt, 1e-9):.1f} "
          f"tok/s); cohorts={m['cohorts']} decode_steps={m['decode_steps']} "
          f"evictions={m['evictions']} "
          f"prefill_chunks={m.get('prefill_chunks', 0)} "
          f"slot_utilization={m.get('slot_utilization', 0.0):.2f} "
          f"backfills={m.get('backfills', 0)} "
          f"peak_resident={m.get('peak_resident_bytes', 0)}B")
    if m.get("prefix_cache") == "radix":
        print(f"[serve] prefix: hits={m.get('prefix_hits', 0)} "
              f"hit_tokens={m.get('prefix_hit_tokens', 0)} "
              f"pages_saved={m.get('pages_saved', 0)} "
              f"cow_copies={m.get('cow_copies', 0)} "
              f"hit_rate={m.get('prefix_hit_rate', 0.0):.2f} "
              f"resident_pages={m.get('prefix_resident_pages', 0)} "
              f"budget={m.get('prefix_budget_bytes', 0)}B")
    print(f"[serve] sample continuation ids: {outs[0][:8]}")
    if trace_path:
        engine.tracer.export_chrome(trace_path)
        print(f"[serve] trace: {len(engine.tracer.export_events())} events"
              f" -> {trace_path} (chrome://tracing / ui.perfetto.dev)")
    if show_stats:
        print("[serve] metrics registry:")
        print(engine.obs.format_table())
    return 0


def _metrics_ticker(registry, interval_s: float):
    """Print the registry snapshot every ``interval_s`` on a daemon
    thread (``--metrics_interval``); returns a stop() callable."""
    import threading

    stop = threading.Event()

    def run():
        n = 0
        while not stop.wait(interval_s):
            n += 1
            snap = registry.snapshot()
            keys = ("tokens", "decode_steps", "prefill_chunks",
                    "free_pages", "used_pages", "evictions", "stalls")
            line = " ".join(f"{k}={snap[k]}" for k in keys if k in snap)
            print(f"[metrics t+{n * interval_s:.1f}s] {line}")

    threading.Thread(target=run, name="metrics-ticker",
                     daemon=True).start()
    return stop.set


def engine_prompt(cfg, prompt_len: int, rng):
    """A synthetic prompt in the family's input format (the vlm and
    enc-dec front ends are stubbed: they receive embeddings)."""
    import numpy as np

    if cfg.family == "vlm":
        return {
            "embeds": (rng.standard_normal((prompt_len, cfg.d_model))
                       .astype(np.float32) * 0.02),
            "positions_3d": np.broadcast_to(
                np.arange(prompt_len, dtype=np.int32)[None], (3, prompt_len)),
        }
    if cfg.family == "enc_dec":
        return {
            "enc_embeds": (rng.standard_normal((prompt_len, cfg.d_model))
                           .astype(np.float32) * 0.02),
            "tokens": rng.integers(0, cfg.vocab_size, prompt_len,
                                   dtype=np.int32),
        }
    return rng.integers(0, cfg.vocab_size, prompt_len, dtype=np.int32)


if __name__ == "__main__":
    sys.exit(main())
