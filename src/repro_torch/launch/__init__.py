"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``; ``launch.analytic`` (the
analytic cost model) and ``launch.mesh`` (the shard devices of the
sharded streaming data plane)."""
