from . import bal, lie, pose_graph

__all__ = ["bal", "lie", "pose_graph"]
