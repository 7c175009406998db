"""Command-line entry points of the port: ``python -m
graphite_tpu_torch.examples.bal`` and ``python -m
graphite_tpu_torch.examples.pose_graph``."""
