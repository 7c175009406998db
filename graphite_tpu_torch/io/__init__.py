from . import bal, g2o, synthetic

__all__ = ["bal", "g2o", "synthetic"]
