from . import bal

__all__ = ["bal"]
