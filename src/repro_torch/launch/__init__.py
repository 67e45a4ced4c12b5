"""repro_torch.launch: the device mesh of sharded runs."""
