"""Mesh construction (the port of ``repro.launch.mesh``).

Stage 1 of the paper's two-stage decomposition (§2): the domain is first
split across the distributed system (this mesh), then within each card by
the cache-conscious decomposer (stage 2, ``core.autotile``).

``make_host_mesh`` builds a ``DeviceMesh`` with axes ``("data", "model")``
over the world the process was started in: ``torchrun``'s environment when
it is there, else a one-rank world of its own.  A CUDA mesh runs on NCCL and
a CPU mesh (``device="cpu"``) on gloo; a CUDA mesh without NCCL raises --
it never drops to gloo or to the CPU.  Every world is made with a timeout,
so a rank that dies leaves the others an error, not a hang.

``make_production_mesh`` builds the reference's production meshes --
(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
"model") -- as a CPU ``DeviceMesh`` over a fake world of 256 or 512 ranks
at rank 0, the port's counterpart of XLA's forced host devices: the dry
run (``launch.dryrun``) traces each cell's step on it under
``FakeTensorMode``, with no card and no peer process.

``spawn_world`` runs a function on every rank of a fresh gloo world of
spawned processes over a ``FileStore`` (no TCP port), and kills the world
when it outlives its timeout: how the CPU tests stand up several ranks.
"""

from __future__ import annotations

import datetime
import os
import queue
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device

#: Seconds a collective may wait before the world gives up on a rank.
WORLD_TIMEOUT_S = 600

MESH_AXES = ("data", "model")


def _init_world(backend: str) -> None:
    timeout = datetime.timedelta(seconds=WORLD_TIMEOUT_S)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)


def make_host_mesh(model_axis: int = 1, device=None) -> DeviceMesh:
    """A ``(world // model_axis, model_axis)`` mesh over this process's
    world, on the card (NCCL, the default) or the CPU (gloo).  Starts the
    world first when none is running: from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or, without
    it, a one-rank world."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA mesh needs NCCL, which this torch lacks")
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        _init_world(backend)
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"world of {n} does not split into model axis "
                         f"{model_axis}")
    return init_device_mesh(dev.type, (n // model_axis, model_axis),
                            mesh_dim_names=MESH_AXES)


#: The production meshes: (shape, axis names) for one pod and for two.
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh over a fake world: (16, 16) over
    ("data", "model") -- 256 H100s, the largest NVLink domain NVIDIA's
    NVLink Switch System joins -- or (2, 16, 16) over ("pod", "data",
    "model"), two such pods over the data-centre network.

    The world is torch's fake process group (rank 0 of 256 or 512; its
    collectives move nothing), started here when none is running; a world
    of the same size is reused, a world of another size raises (one
    process holds one world: destroy it first).  ``FakeStore`` comes from
    ``torch.testing._internal.distributed.fake_pg``, a torch-internal
    module, imported here and nowhere else."""
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    n = 1
    for v in shape:
        n *= v
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(
                f"a world of {dist.get_world_size()} ranks is running; the "
                f"{'multi' if multi_pod else 'single'}-pod production mesh "
                f"needs {n} (destroy the running world first)")
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def _world_main(rank: int, world: int, store_path: str, timeout_s: float,
                fn: Callable, args: Sequence[Any], results) -> None:
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                      # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn_world(fn: Callable, world: int, store_path: str,
                args: Sequence[Any] = (), timeout_s: float = 300.0
                ) -> List[Any]:
    """Run ``fn(rank, *args)`` on each rank of a ``world``-rank gloo world
    of spawned processes, over a ``FileStore`` at ``store_path`` (a fresh
    path a world).  Returns the ranks' results in rank order; raises with
    the failing rank's traceback, or when the world outlives
    ``timeout_s`` (every process is killed first).  ``fn`` must be
    importable by name (a module-level function)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_world_main, daemon=True,
                         args=(r, world, store_path, timeout_s, fn,
                               tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    error: Optional[str] = None
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
    try:
        while len(got) < world and error is None:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                error = f"world of {world} outlived its {timeout_s} s timeout"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and len(got) < world:
                    error = (f"rank process exited with {dead[0].exitcode} "
                             "before reporting")
                continue
            if ok:
                got[rank] = out
            else:
                error = f"rank {rank} failed:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=5 if error is None else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    return [got[r] for r in range(world)]
