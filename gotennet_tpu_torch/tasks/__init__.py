"""Task registry (``gotennet_tpu/tasks/__init__.py``): dataset and task
names to task classes."""

from gotennet_tpu_torch.tasks.base import Task
from gotennet_tpu_torch.tasks.force_task import MD17Task, MD22Task
from gotennet_tpu_torch.tasks.molecule3d import Molecule3DTask
from gotennet_tpu_torch.tasks.qm9 import QM9Task

TASK_DICT = {
    "QM9": QM9Task,
    "rMD17": MD17Task,
    "MD17": MD17Task,
    "MD22": MD22Task,
    "Molecule3D": Molecule3DTask,
}

__all__ = ["Task", "QM9Task", "MD17Task", "MD22Task", "Molecule3DTask",
           "TASK_DICT"]
