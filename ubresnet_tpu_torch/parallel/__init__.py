"""Multi-process runs of the port: process groups and launch helpers
(distributed.py), data-parallel sharding of a training (sharding.py)."""
