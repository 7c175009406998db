"""Command-line entry points of the port: ``python -m
graphite_tpu_torch.examples.bal``, ``.pose_graph``, ``.circle`` and
``.range_bearing_slam``."""
