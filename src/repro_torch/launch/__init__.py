"""repro_torch.launch: the device mesh of sharded runs, the ``simulate``
driver and the retired ``serve`` stub."""
