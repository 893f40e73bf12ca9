"""GQA flash attention: the CUDA kernel and its plain version."""
