from ofasys_torch.task.base import Task, TaskConfig
from ofasys_torch.task.traverse_task import TraverseTask
from ofasys_torch.task import tasks  # noqa: F401  (registers the task zoo)

__all__ = ["Task", "TaskConfig", "TraverseTask"]
