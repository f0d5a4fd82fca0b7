from ofasys_torch.task.base import Task, TaskConfig

__all__ = ["Task", "TaskConfig"]
