"""The RG-LRU linear recurrence: plain version and the CUDA kernel."""
