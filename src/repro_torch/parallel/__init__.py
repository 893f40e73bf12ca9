"""repro_torch.parallel: the LM's sharding rules, activation seams and
gradient compression on a `torch.distributed` device mesh."""
