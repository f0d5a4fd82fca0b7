"""Optimization config: the fields of ofasys_tpu's ``OptimizationConfig``
(ofasys_tpu/configure/configs.py) that the optimizer and the learning-rate
schedule of engine/optim.py read, with their defaults. Plain dataclasses:
the port has no config store.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class OptimizationConfig:
    max_update: int = 0
    lr: Tuple[float, ...] = (0.0001,)
    clip_norm: float = 1.0
    optimizer: str = "adam"
    lr_scheduler: str = "ofa_polynomial_decay"
    # adam/adamw
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8
    weight_decay: float = 0.01
    use_adamw: bool = True
    # polynomial decay
    warmup_updates: int = 0
    warmup_ratio: float = 0.0
    end_learning_rate: float = 0.0
    power: float = 1.0
    total_num_update: Optional[int] = None
