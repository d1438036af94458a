"""Domain decomposition over ranks on torch.distributed."""
