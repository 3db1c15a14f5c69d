"""Slot-table layouts, request encoding and the decide wave.

All counter math is int64. Tables and batches are torch tensors; the
decide wave of the fused and narrow layouts runs as the hand-written
CUDA kernel (`cuda_decide`) on a CUDA table and as its plain PyTorch
version (`fused.decide_fused_plain`) on a CPU table; the wide and packed
layouts (`decide`, `packed`) are torch ops on either device.
"""
