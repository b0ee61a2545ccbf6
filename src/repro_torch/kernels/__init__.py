"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module holds a wrapper that launches the CUDA kernel for CUDA
tensors (or raises) and runs the plain version in ``kernels.ref`` for CPU
tensors, plus a plain-integer launch counter ``LAUNCHES``:

  * ``paged_attention`` -- paged GQA decode attention (serving)
  * ``matmul_cc``       -- cache-conscious blocked matmul (CC/SRRC orders)
  * ``flash_attention`` -- streaming-softmax attention, SMEM-sized KV blocks
  * ``ssd_scan``        -- Mamba2/SSD chunked scan, state kept on chip

``matmul_cc`` and ``flash_attention`` have two bodies each (tensor-core
``wgmma`` and CUDA-core ``simt``, chosen by ``matmul_path`` /
``attention_path``) and also count by body: ``LAUNCHES_WGMMA``,
``LAUNCHES_SIMT``.

``ops`` holds the public ``matmul``/``attention``/``ssd`` entry points,
exported here.  The wrappers are reached through their modules (the
package does not rebind the module names to functions, so
``kernels.matmul_cc.LAUNCHES`` stays reachable).
"""

from repro_torch.kernels.ops import attention, matmul, ssd

__all__ = ["attention", "matmul", "ssd"]
