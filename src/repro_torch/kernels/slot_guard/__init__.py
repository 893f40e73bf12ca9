"""The serving engine's per-slot guard (validity and content digest):
plain version and CUDA kernel."""
