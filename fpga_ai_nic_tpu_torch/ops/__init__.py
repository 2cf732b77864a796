"""Operators of the port: BFP codecs, rings over virtual ranks, the fused
CUDA kernels and the flat ZeRO-1 plumbing."""
