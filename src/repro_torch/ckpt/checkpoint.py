"""Fault-tolerant checkpointing in the reference's on-disk format (the port
of ``repro.ckpt.checkpoint``), so a checkpoint written by one package
restores in the other.

  * **Format**: ``step_N/host_k/arrays.npz`` holds every leaf under its
    path with ``/`` written ``__`` (``0__embedding``, ``1__mu__layers__ln1``
    for ``(params, OptState)``), beside ``step_N/manifest.json`` (step,
    keys, time, extra).  A bfloat16 leaf is stored by its 2-byte bits as
    ``|V2``, which is how numpy saves the reference's bfloat16 arrays;
    every other leaf as its numpy dtype.
  * **Atomicity**: writes go to ``step_N.tmp/`` and are renamed to
    ``step_N/`` only after an fsync'd manifest.
  * **Async**: ``CheckpointManager.save`` copies the tensors to host
    memory and hands serialization to a background thread; the train step
    waits only for the copy.
  * **Restore by name**: ``reshard(key, array)`` places each leaf (the
    trainer: a tensor on its device, or a DTensor distributed to the
    placements of whatever mesh the relaunch built); keep-k GC and
    ``latest_checkpoint`` auto-resume.
  * **Sharded state**: a DTensor leaf is gathered whole (``full_tensor``,
    a collective every rank joins, on the calling thread) and only rank 0
    of a running world writes, so the files are the same whatever mesh
    wrote them; a blocking save returns on every rank once they are
    written.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.tree import (
    SEP,
    tree_flatten_with_paths,
    tree_map,
    tree_map_with_path,
)

PyTree = Any


def to_host(leaf: Any) -> Any:
    """A leaf as the array the file holds: a tensor's (a DTensor's whole
    value's) host copy (bfloat16
    as its bits, ``|V2``; a copy on the CPU too, so that the async writer
    saves the values at the time of the save), anything with a dtype
    through ``np.asarray``, anything else as is."""
    if isinstance(leaf, DTensor):
        leaf = leaf.detach().full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf) if hasattr(leaf, "dtype") else leaf


def save_checkpoint(directory: str, step: int, tree: PyTree,
                    host_index: int = 0, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save. Returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    host_dir = os.path.join(tmp, f"host_{host_index}")
    os.makedirs(host_dir, exist_ok=True)

    flat = tree_flatten_with_paths(tree)
    manifest = {"step": step, "keys": sorted(flat), "time": time.time(),
                "extra": extra or {}}
    arrays = {key.replace(SEP, "__"): to_host(leaf)
              for key, leaf in flat.items()}
    np.savez(os.path.join(host_dir, "arrays.npz"), **arrays)
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            step = int(m.group(1))
            if best is None or step > best[0]:
                best = (step, os.path.join(directory, name))
    return best[1] if best else None


def to_tensor(arr: np.ndarray, device=None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A restored array as a tensor: a 2-byte leaf of no numpy number type
    (``|V2``, or ``ml_dtypes``' bfloat16) by its bits as bfloat16, any
    other as its own dtype; then on ``device`` in ``dtype`` if given."""
    arr = np.asarray(arr)
    if arr.dtype.itemsize == 2 and arr.dtype.kind not in "iuf":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def restore_checkpoint(
    path: str,
    template: PyTree,
    reshard: Optional[Callable[[str, np.ndarray], Any]] = None,
) -> PyTree:
    """Restore into the structure of ``template``; ``reshard(key, array)``
    may place each leaf (else the leaf is the numpy array)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data: Dict[str, np.ndarray] = {}
    for host in sorted(os.listdir(path)):
        if not host.startswith("host_"):
            continue
        with np.load(os.path.join(path, host, "arrays.npz")) as z:
            for k in z.files:
                data[k.replace("__", SEP)] = z[k]
    missing = [k for k in manifest["keys"] if k not in data]
    if missing:
        raise IOError(f"checkpoint {path} missing leaves: {missing[:5]}...")
    for key in tree_flatten_with_paths(template):
        if key not in data:
            raise KeyError(f"template leaf {key!r} absent from checkpoint")
    return tree_map_with_path(
        lambda key, _: reshard(key, data[key]) if reshard else data[key],
        template)


class CheckpointManager:
    """Async keep-k checkpointing with preemption-safe final save."""

    def __init__(self, directory: str, keep: int = 3, host_index: int = 0):
        self.directory = directory
        self.keep = keep
        self.host_index = host_index
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree, blocking: bool = False,
             extra: Optional[dict] = None) -> None:
        self.wait()                           # one in flight at a time
        host_tree = tree_map(to_host, tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree,
                                self.host_index, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if not dist.is_initialized() or dist.get_rank() == 0:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()              # rank 0 writes
        if blocking:
            try:
                self.wait()
            finally:
                if dist.is_initialized():
                    dist.barrier()            # the files are there for all

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        for s in sorted(steps)[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest_manifest(self) -> Optional[dict]:
        """The manifest of the latest checkpoint, None if there is none."""
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)

    def restore_latest(self, template: PyTree, reshard=None):
        path = latest_checkpoint(self.directory)
        if path is None:
            return None, None
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return restore_checkpoint(path, template, reshard), manifest
