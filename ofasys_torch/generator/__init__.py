from ofasys_torch.generator.base import (
    BatchGeneratorOutput,
    GeneratorOutput,
    MotionOutput,
    MultiGeneratorOutput,
    SequenceGeneratorOutput,
)
from ofasys_torch.generator.diffusion_generator import DiffusionGenerator
from ofasys_torch.generator.sequence_generator import SequenceGenerator

__all__ = [
    "GeneratorOutput", "SequenceGeneratorOutput", "MotionOutput", "MultiGeneratorOutput",
    "BatchGeneratorOutput", "SequenceGenerator", "DiffusionGenerator",
]
