"""Distribution plan of the model programs: logical-axis sharding rules
(:mod:`~repro_torch.distributed.sharding`) and compressed gradient
reductions (:mod:`~repro_torch.distributed.compression`)."""
