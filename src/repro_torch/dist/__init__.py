"""Distribution layer of the port: gradient compression, the sharding
rules and DTensor placements (`sharding.py`), and expert parallelism over
`torch.distributed` (`expert_parallel.py`)."""
