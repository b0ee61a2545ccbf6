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

``--cluster N`` serves through ``repro_torch.cluster`` instead of one
engine: ``plan_decode(cluster=N)`` grows a DCN level whose realized ``np``
is the fleet width, N replicas stand up behind a router (``--policy
{free_pages,least_loaded,round_robin}``, ``--transport {thread,proc}``:
threads of this process or spawned processes), and ``--serve 1`` binds
the streaming HTTP front end on ``--port``.  ``--disagg P:D`` splits the
fleet into prefill and decode roles with ring-ordered KV page streaming
between them (P + D replicas); a transfer needs the prompt to span at
least one planned page, so at reduced size pass ``--smem_kib 16`` to force
a small page.  The replicas share one card, so each gets
``cluster.replica_kv_budget``: one engine's planned KV budget less the
other replicas' weights and, for spawned workers, every worker's CUDA
context, divided by their count.
"""

from __future__ import annotations

import dataclasses
import sys
import time


def main(argv=None) -> int:
    import numpy as np
    import torch

    from repro_torch.configs import get_model_config, parse_cli
    from repro_torch.serve import SamplingConfig, ServeEngine, ServePolicy

    overrides, _ = parse_cli(argv if argv is not None else sys.argv[1:])
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
    cluster = int(overrides.pop("cluster", "0"))
    disagg = overrides.pop("disagg", "")
    policy = overrides.pop("policy", "free_pages")
    serve_http = overrides.pop("serve", "0").lower() in ("1", "true", "yes")
    port = int(overrides.pop("port", "8480"))
    transport = overrides.pop("transport", "thread")
    smem_kib = int(overrides.pop("smem_kib", "0"))
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
    if serve_http and not (cluster or disagg):
        raise SystemExit("--serve fronts a cluster: pass --cluster N")
    if cluster or disagg:
        return _main_cluster(
            arch=arch, cfg=cfg, n_new=n_new, batch=batch,
            prompt_len=prompt_len, seed=seed, cluster=cluster, disagg=disagg,
            policy=policy, serve_http=serve_http, port=port,
            transport=transport, smem_kib=smem_kib, device=device,
            trace_path=trace_path, show_stats=show_stats)
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


def _main_cluster(*, arch, cfg, n_new, batch, prompt_len, seed, cluster,
                  disagg, policy, serve_http, port, transport, smem_kib=0,
                  device=None, trace_path="", show_stats=False) -> int:
    """``--cluster N [--disagg P:D] [--serve 1]``: the fleet width comes
    from the plan's DCN level, each replica hosts one ``ServeEngine``
    (float32, the radix prefix cache on), the router places by
    ``--policy``."""
    import numpy as np

    from repro_torch.cluster import (CONTEXT_BYTES, ClusterServer,
                                     DisaggCluster, EngineSpec, ServeCluster,
                                     replica_kv_budget)
    from repro_torch.hw.h100 import h100_spec
    from repro_torch.serve.engine import plan_decode

    if transport not in ("thread", "proc"):
        raise SystemExit(f"--transport must be thread|proc, "
                         f"got {transport!r}")
    if disagg:
        p, d = (int(x) for x in disagg.split(":"))
        cluster = cluster or (p + d)
    if serve_http and disagg:
        raise SystemExit("--serve fronts a ServeCluster; run --disagg "
                         "without --serve (the HTTP front end routes whole "
                         "requests)")
    chip = (("smem_bytes", smem_kib << 10),) if smem_kib else ()
    max_len = prompt_len + n_new + 1
    # The engines run float32, so plan with their KV width: the guard
    # below compares against the geometry they will realize.
    plan = plan_decode(cfg, max_len=max_len, dtype_bytes=4,
                       spec=h100_spec(**dict(chip)), cluster=max(1, cluster))
    dcn = plan.level("DCN")
    n = plan.replicas()
    page_tokens = int((plan.page_plan() or {}).get("page_tokens", 0) or 0)
    if disagg and page_tokens and prompt_len < page_tokens:
        # A transfer streams completed pages; a prompt inside one page has
        # nothing to export.
        raise SystemExit(
            f"--disagg needs the prompt to span >= 1 planned page, but "
            f"page_tokens={page_tokens} > prompt_len={prompt_len}; "
            f"raise --prompt_len or shrink the page with --smem_kib 16")
    spec = EngineSpec(arch=arch, max_new_tokens=n_new, max_slots=1,
                      max_len=max_len, prefix_cache="radix", seed=seed,
                      chip=chip, device=device or "cuda")
    # The replicas share this host's one card: split its HBM once, here.
    context = CONTEXT_BYTES if (transport == "proc"
                                and spec.device != "cpu") else 0
    spec = dataclasses.replace(
        spec, kv_budget_bytes=replica_kv_budget(spec, n, context))
    print(f"[cluster] arch={arch} replicas={n} "
          f"(DCN np={dcn.np if dcn else 1}) policy={policy} "
          f"transport={transport} device={spec.device} "
          f"kv_budget={spec.kv_budget_bytes}B per replica"
          + (f" disagg={disagg}" if disagg else ""))
    if disagg:
        front = DisaggCluster.from_plan(plan, spec, split=disagg,
                                        transport=transport, policy=policy)
    else:
        front = ServeCluster.from_plan(plan, spec, transport=transport,
                                       policy=policy)
    try:
        if serve_http:
            srv = ClusterServer(front, port=port).start()
            host, bound = srv.address
            print(f"[cluster] serving on http://{host}:{bound} "
                  f"(/generate /healthz /stats /metrics /trace); ctrl-c to "
                  f"stop")
            try:
                srv.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                srv.close()
            return 0
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, prompt_len,
                                dtype=np.int32).tolist()
                   for _ in range(batch)]
        t0 = time.perf_counter()
        if disagg:
            outs = [front.generate(p, n_new) for p in prompts]
        else:
            outs = front.generate(prompts, n_new)
        dt = time.perf_counter() - t0
        n_tok = sum(len(o) for o in outs)
        for st in front.stats():
            print(f"[cluster] replica {st.replica} role={st.role} "
                  f"free_pages={st.free_pages}/{st.pages_total} "
                  f"slots={st.slots_free}/{st.slots_total} "
                  f"prefix_nodes={st.prefix_nodes} tokens={st.tokens}")
        print(f"[cluster] {n_tok} tokens in {dt:.2f}s "
              f"({n_tok / max(dt, 1e-9):.1f} tok/s)")
        print(f"[cluster] sample continuation ids: {outs[0][:8]}")
        if trace_path and hasattr(front, "trace_events"):
            from repro_torch.obs import write_chrome

            evs = front.trace_events()
            write_chrome(trace_path, evs)
            pids = sorted({e.get("pid") for e in evs
                           if e.get("ph") != "M"})
            print(f"[cluster] trace: {len(evs)} events from pids {pids} "
                  f"-> {trace_path} (one timeline; pid = replica id, "
                  f"pid {len(front.replicas)} = router)")
        if show_stats:
            for st in front.stats():
                if not st.metrics:
                    continue
                print(f"[cluster] replica {st.replica} metrics registry:")
                for k in sorted(st.metrics):
                    v = st.metrics[k]
                    if isinstance(v, float):
                        v = f"{v:.6g}"
                    print(f"  {k} {v}")
    finally:
        front.close()
    return 0


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
