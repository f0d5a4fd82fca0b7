from ofasys_torch.configure.config_store import (
    ConfigStore,
    auto_import,
    from_dict,
    register_config,
    to_dict,
    update_config,
)
from ofasys_torch.configure.configs import (
    BaseDataclass,
    CheckpointConfig,
    CommonConfig,
    DatasetConfig,
    EMAConfig,
    GenerationConfig,
    OptimizationConfig,
    ParallelConfig,
    TrainerConfig,
)

__all__ = [
    "ConfigStore",
    "register_config",
    "auto_import",
    "to_dict",
    "from_dict",
    "update_config",
    "BaseDataclass",
    "CommonConfig",
    "ParallelConfig",
    "DatasetConfig",
    "OptimizationConfig",
    "CheckpointConfig",
    "EMAConfig",
    "GenerationConfig",
    "TrainerConfig",
]
