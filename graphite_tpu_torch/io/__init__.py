from . import bal, synthetic

__all__ = ["bal", "synthetic"]
