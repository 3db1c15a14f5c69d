"""gubernator-tpu on PyTorch and CUDA.

A port of the `gubernator_tpu` rate limiter whose decide wave runs as a
CUDA kernel written by hand for Hopper (`csrc/decide_wave.cu`). The
package imports torch, numpy and the standard library only; the JAX
package beside it is the reference the port is tested against.

Main path: `service.server.V1Service` -> `runtime.engine.DeviceEngine`
-> `ops.kernels.get_kernels("fused").decide` -> `ops.cuda_decide`.
Every entry point takes an explicit device and defaults to CUDA.
"""

__version__ = "0.1.0"
