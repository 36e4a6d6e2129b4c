"""Context and tensor parallelism: sequence-sharded attention, parameter sharding rules."""
