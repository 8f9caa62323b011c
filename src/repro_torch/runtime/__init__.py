from .ft import HeartbeatMonitor, RestartEvent, TrainSupervisor, elastic_mesh_shape
from .progress import ProgressTracker, TaskProgress
