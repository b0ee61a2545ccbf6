"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module holds a wrapper that launches the CUDA kernel for CUDA
tensors (or raises) and runs the plain version in ``kernels.ref`` for CPU
tensors, plus a plain-integer launch counter ``LAUNCHES``:

  * ``paged_attention`` -- paged GQA decode attention (serving)
  * ``matmul_cc``       -- cache-conscious blocked matmul (CC/SRRC orders)
  * ``flash_attention`` -- streaming-softmax attention, SMEM-sized KV blocks
  * ``ssd_scan``        -- Mamba2/SSD chunked scan, state kept on chip

Each kernel has a tensor-core body for bf16 (paged attention has two:
``split`` for GQA heads, ``mla`` for the MLA latent) and a CUDA-core
``simt`` one for float32 and the shapes the others do not take, chosen by
a pure function of the shape (``matmul_path``, ``attention_path``,
``paged_path``, ``ssd_path``), and counts launches by body:
``LAUNCHES_WGMMA`` (matmul, attention), ``LAUNCHES_SPLIT`` and
``LAUNCHES_MLA`` (paged), ``LAUNCHES_TC`` (SSD) and ``LAUNCHES_SIMT``.

``ops`` holds the public ``matmul``/``attention``/``ssd`` entry points,
exported here.  The wrappers are reached through their modules (the
package does not rebind the module names to functions, so
``kernels.matmul_cc.LAUNCHES`` stays reachable).
"""

from repro_torch.kernels.ops import attention, matmul, ssd

__all__ = ["attention", "matmul", "ssd"]
