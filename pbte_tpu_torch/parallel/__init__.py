"""Domain decomposition over torch.distributed."""
