#!/usr/bin/env python3
"""Where the time of the SSD scan's tc body goes: pass 3 with parts removed.

    python3 tools/ssd_probe.py        # on a machine with a CUDA card

Copies ``src/repro_torch/csrc/ssd_scan.cu``, removes one part of its
output kernel (pass 3) per variant by a text patch -- the intra-chunk
products, the inter-chunk products, the ``lo`` halves of the split
operands, the prefetch of the next head's x and S_prev, the stores of y,
or both products -- builds each variant with nvcc, runs it at zamba2-1.2b's
mixer over 4096 tokens (1, 4096, 64 heads, 64, state 64; bf16, chunk 128)
and prints the device microseconds of each variant's pass-3 kernel
(``torch.profiler``, mean of 10 calls), with the card's ``nvidia-smi``
name and power limit.  The variants compute wrong outputs by design; the
script only times them.  Builds go under ``build/ssd_probe/``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT_DIR = os.path.join(ROOT, "build", "ssd_probe")
SHAPE = (1, 4096, 64, 64, 64)            # B, S, H, P, N
CHUNK = 128

_INTRA = ("for (int jn = 0; jn <= i_lo / 16; ++jn) {\n        float w[8];",
          "for (int jn = 0; jn < 0; ++jn) {\n        float w[8];")
_INTER = ("exp(cum_i).\n      for (int ks = 0; ks < N / 16; ++ks) {",
          "exp(cum_i).\n      for (int ks = 0; ks < 0; ++ks) {")
#: variant -> text patches of the pass-3 kernel (old, new)
VARIANTS = {
    "base": [],
    "no_intra": [_INTRA],
    "no_inter": [_INTER],
    "no_products": [_INTRA, _INTER],
    "no_lo": [],                         # see _patch_lo
    "no_prefetch": [("    if (hi + 1 < HG) prefetch(h + 1);",
                     "    if (hi + 1 < 0) prefetch(h + 1);"),
                    ("  prefetch(h0);\n", "")],
    "no_store": [("        if (i0 < nq)\n", "        if (i0 < nq && nq < 0)\n"),
                 ("        if (i1 < nq)\n", "        if (i1 < nq && nq < 0)\n")],
}


def _patch_lo(text: str) -> str:
    for acc, op in (("acc[2 * np]", "al, xb[0], xb[1]"),
                    ("acc[2 * np + 1]", "al, xb[2], xb[3]"),
                    ("acc[2 * np]", "af, sl[0], sl[1]"),
                    ("acc[2 * np + 1]", "af, sl[2], sl[3]")):
        line = f"          hopper::mma_bf16_16816({acc}, {op});\n"
        assert line in text, line
        text = text.replace(line, "")
    return text


def build(name: str) -> str:
    src = open(os.path.join(CSRC, "ssd_scan.cu")).read()
    at = src.index("ssd_out_kernel(")
    head, out = src[:at], src[at:]
    if name == "no_lo":
        out = _patch_lo(out)
    else:
        for old, new in VARIANTS[name]:
            assert old in out, (name, old)
            out = out.replace(old, new)
    d = os.path.join(OUT_DIR, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "ssd_scan.cu"), "w") as f:
        f.write(head + out)
    with open(os.path.join(d, "hopper.cuh"), "w") as f:
        f.write(open(os.path.join(CSRC, "hopper.cuh")).read())
    lib = os.path.join(d, "libssd_scan.so")
    subprocess.run([_build._tool("nvcc"), *_build.NVCC_FLAGS, "-o", lib,
                    os.path.join(d, "ssd_scan.cu")], check=True,
                   capture_output=True)
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    b, s, h, p, n = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, s, h, p, generator=gen, device="cuda").bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device="cuda")) * 0.5
    A = -torch.exp(torch.randn(h, generator=gen, device="cuda") * 0.3)
    Bm = torch.randn(b, s, n, generator=gen, device="cuda").bfloat16()
    Cm = torch.randn(b, s, n, generator=gen, device="cuda").bfloat16()
    y = torch.empty_like(x)
    nc = -(-s // CHUNK)
    states = torch.empty(b, nc, h, n, p, device="cuda")
    totals = torch.empty(b, nc, h, device="cuda")
    us = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(path).ssd_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])

        def call():
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                    totals.data_ptr(), 0, 0, b, s, h, p, n, CHUNK, 1, 1,
                    x.device.index,
                    torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        us[name] = {e.key.split("(")[0]: round(e.self_device_time_total / 10,
                                               1)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps(us, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
