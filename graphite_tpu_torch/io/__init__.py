from . import bal, checkpoint, g2o, synthetic

__all__ = ["bal", "checkpoint", "g2o", "synthetic"]
