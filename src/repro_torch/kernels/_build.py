"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` exposes a plain C interface, is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``build/repro_torch/``
(at the root of the checkout, listed in ``.gitignore``) the first time it
is needed, and is loaded with ``ctypes``.  The library's file name carries
a hash of the source, of every ``csrc/*.cuh`` header it includes and of the
flags, so an edited source or header builds anew and an unchanged one is
reused.  ``build_all`` starts one ``nvcc`` per source at once, for a run
that builds every kernel inside a time limit.  Nothing here runs at import
time.  ``sass_counts`` reads a built library's
machine code (``cuobjdump -sass``) and counts given instructions per
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: The port's CUDA sources, ``csrc/<name>.cu``.
SOURCES = ("paged_attention", "matmul_cc", "flash_attention", "ssd_scan")

#: name -> (seconds, compiler output) of the builds this process ran.
BUILD_LOG: Dict[str, Tuple[float, str]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _tool(name: str) -> str:
    path = shutil.which(name) or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found (looked on PATH and in "
                           "$CUDA_HOME/bin); it builds the port's kernels")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _headers(src: bytes) -> Tuple[Path, ...]:
    """The ``csrc`` headers a source includes, its own includes too."""
    found, todo = [], [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop()):
            path = CSRC / inc.decode()
            if path not in found:
                found.append(path)
                todo.append(path.read_bytes())
    return tuple(sorted(found))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in _headers(src):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already, and return
    the library's path.  Raises with the compiler's output on failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)    # atomic: concurrent builders agree
    return out


def build_all() -> Dict[str, Path]:
    """Build every source in ``SOURCES``, one ``nvcc`` each, all started
    together; raises with the first failure's compiler output."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = list(pool.map(build, SOURCES))
    return dict(zip(SOURCES, paths))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it first)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def sass_counts(name: str,
                opcodes: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """Kernel (mangled name) -> opcode -> the instructions of that opcode
    in the built library's machine code (``cuobjdump -sass``; an opcode
    counts with any suffix, as in ``HGMMA.64x192x16.F32.BF16``)."""
    proc = subprocess.run([_tool("cuobjdump"), "-sass", str(build(name))],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=True)
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in proc.stdout.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            current = counts.setdefault(head.group(1),
                                        {op: 0 for op in opcodes})
            continue
        if current is not None:
            for op in opcodes:
                if re.search(rf"\b{op}\b", line):
                    current[op] += 1
    return counts
