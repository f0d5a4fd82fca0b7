from ofasys_torch.generator.base import (
    BatchGeneratorOutput,
    GeneratorOutput,
    MultiGeneratorOutput,
    SequenceGeneratorOutput,
)
from ofasys_torch.generator.sequence_generator import SequenceGenerator

__all__ = [
    "GeneratorOutput", "SequenceGeneratorOutput", "MultiGeneratorOutput",
    "BatchGeneratorOutput", "SequenceGenerator",
]
