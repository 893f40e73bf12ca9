"""Fused LM-head cross-entropy: the CUDA kernel and its plain version."""
