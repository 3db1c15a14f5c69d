"""Fixed-point scale and the validated input domain of the decide math.

The leaky bucket's fractional `remaining` is kept in Q44.20 fixed point
(int64, scale 2^20), so the CUDA kernel, its plain PyTorch version and
the JAX reference are bit-identical. Within the bounds below every
intermediate of the leak arithmetic fits in int64; `ops/encode.py`
clamps requests into them on the host.
"""

# Fixed-point scale for leaky-bucket fractional remaining.
FIXED_SHIFT = 20

# Validated input domain (enforced host-side in batch assembly).
MAX_ELAPSED_MS = 1 << 42  # ~139 years
MAX_DURATION_MS = 1 << 42
MAX_COUNT = (1 << 31) - 1  # limit, burst, |hits|
