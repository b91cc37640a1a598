"""The sharded DEG index and the collectives it and the recsys lookup run
over ``torch.distributed`` (the port of ``src/repro/distributed/``, but
for ``sharding.py``, the training PartitionSpecs)."""
