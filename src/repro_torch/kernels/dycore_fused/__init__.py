"""Fused compound dycore step: plain version and CUDA kernel."""
