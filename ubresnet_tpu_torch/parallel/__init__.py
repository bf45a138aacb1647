"""Multi-device runs of the port: process groups and launch helpers
(distributed.py), and sharding (sharding.py): the data and model axes
of a training over ranks, whole planes row-sharded over devices."""
