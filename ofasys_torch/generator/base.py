"""Generator output types (counterpart of ofasys_tpu/generator/base.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class GeneratorOutput:
    """Base class of all generator outputs."""

    extra: Optional[Dict[str, Any]] = None


@dataclass
class SequenceGeneratorOutput(GeneratorOutput):
    """Token-sequence hypothesis."""

    tokens: Optional[np.ndarray] = None
    score: float = float("-inf")
    text: Optional[str] = None
    box: Optional[np.ndarray] = None
    image: Optional[Any] = None


@dataclass
class MotionOutput(GeneratorOutput):
    """Diffusion text-to-motion output (BVH-convertible features)."""

    feature: Optional[np.ndarray] = None
    bvh: Optional[Any] = None


# one sample may return n-best lists; a batch is a list of those
MultiGeneratorOutput = List[SequenceGeneratorOutput]
BatchGeneratorOutput = List[MultiGeneratorOutput]
