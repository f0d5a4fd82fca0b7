"""ofasys_torch — the PyTorch/CUDA port of ofasys_tpu for NVIDIA Hopper.

Mirrors ``ofasys_tpu``'s module paths: the counterpart of
``ofasys_tpu/<path>.py`` is ``ofasys_torch/<path>.py``. The package imports
``torch`` and numpy only; it never imports ``jax``, ``flax`` or
``ofasys_tpu``. Kernels that ``ofasys_tpu`` writes in Pallas are written by
hand here (``ofasys_torch/csrc``), each beside a plain PyTorch version that
the CPU tests run.

The front door is ofasys_tpu's:

    task = Task(name="caption", instruction="[TEXT:src] -> [TEXT:tgt]")
    task.load_dataset_from_path("train.tsv")
    Trainer(cfg, device="cuda").fit(GeneralistModel(arch="base"), [task])
    hub = OFASys.from_pretrained("checkpoints/checkpoint_last", device="cuda")
    hub.inference("[TEXT:src] -> [TEXT:tgt]", data={"src": "..."})

Attention that meets the dense gate runs the hand-written dense-attention
forward and backward kernels on the card.
"""

import logging
from enum import Enum, unique

__version__ = "0.1.0"

logger = logging.getLogger("ofasys_torch")


@unique
class ModalityType(Enum):
    """The modality vocabulary of the instruction DSL (same members and
    values as ``ofasys_tpu.ModalityType``)."""

    TEXT = 1
    IMAGE = 2
    BOX = 3
    AUDIO = 4
    MOTION = 5
    PHONE = 6
    VIDEO = 7
    STRUCT = 8
    CATEGORY = 9

    @classmethod
    def parse(cls, mark: str):
        try:
            return cls[mark]
        except KeyError:
            return None


def __getattr__(name):
    # lazy exports keep `import ofasys_torch` light
    if name in ("Instruction", "Slot"):
        from ofasys_torch.preprocessor import instruction as _m

        return getattr(_m, name)
    if name == "Dictionary":
        from ofasys_torch.preprocessor.dictionary import Dictionary

        return Dictionary
    if name == "GeneralistModel":
        from ofasys_torch.model.ofa import GeneralistModel

        return GeneralistModel
    if name == "OFASys":
        from ofasys_torch.hub_interface import OFASys

        return OFASys
    if name in ("Task", "TaskConfig"):
        from ofasys_torch.task import base as _m

        return getattr(_m, name)
    if name == "Trainer":
        from ofasys_torch.engine.trainer import Trainer

        return Trainer
    if name == "TrainerConfig":
        from ofasys_torch.configure.configs import TrainerConfig

        return TrainerConfig
    if name == "InferenceServer":
        from ofasys_torch.serve import InferenceServer

        return InferenceServer
    raise AttributeError(f"module 'ofasys_torch' has no attribute {name!r}")


__all__ = [
    "ModalityType",
    "Instruction",
    "Slot",
    "Dictionary",
    "GeneralistModel",
    "OFASys",
    "InferenceServer",
    "Task",
    "TaskConfig",
    "Trainer",
    "TrainerConfig",
    "logger",
]
