"""Trainer config dataclass tree (counterpart of
ofasys_tpu/configure/configs.py): the same groups, fields and defaults, so
a config serialized by one package reads in the other.

The port runs on one CUDA device: ``ParallelConfig`` keeps ofasys_tpu's
mesh axes for config compatibility, and ``engine/trainer.py`` refuses any
that asks for more than one device (ROADMAP Queue A item 13).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class BaseDataclass:
    """Marker base so components can test isinstance; also hosts `.update`."""

    def update(self, **kwargs):
        from ofasys_torch.configure.config_store import update_config

        return update_config(self, **kwargs)


@dataclass
class CommonConfig(BaseDataclass):
    seed: int = 1
    # compute dtype policy: "bfloat16" | "float32"; params and optimizer
    # state are always fp32. fp16/bf16 are config-compat flags: either one
    # forces the bfloat16 policy.
    dtype: str = "bfloat16"
    fp16: bool = False
    bf16: bool = False
    log_interval: int = 100
    log_format: str = "simple"
    tensorboard_logdir: Optional[str] = None
    wandb_project: Optional[str] = None
    azureml_logging: bool = False
    # a profiler trace of the update loop (not ported: ROADMAP Queue A item 9)
    profile: bool = False
    profile_dir: str = "ofasys_torch_profile"
    # extra module directory imported before config build
    user_dir: Optional[str] = None


@dataclass
class ParallelConfig(BaseDataclass):
    """ofasys_tpu's mesh axes; the port takes one device (every axis 1,
    ``data`` -1 or 1), no ``zero1`` and no ``remat``."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    expert: int = 1
    sequence: int = 1
    pipeline: int = 1
    remat: str = "none"
    zero1: bool = False


@dataclass
class DatasetConfig(BaseDataclass):
    num_workers: int = 2           # prefetch depth of the host-side batch thread
    batch_size: int = 8
    batch_size_valid: Optional[int] = None
    # token-budget batching, resolved statically per task: batch_size =
    # max_tokens // (max_src_length + max_tgt_length), floored to
    # required_batch_size_multiple
    max_tokens: Optional[int] = None
    update_freq: int = 1           # gradient accumulation microbatches
    required_batch_size_multiple: int = 8
    train_data: str = ""
    valid_data: str = ""
    test_data: str = ""
    selected_cols: Optional[str] = None
    text_bin_length: int = 512     # record length of object-store LM streams
    disable_validation: bool = False
    validate_interval: int = 1     # validate every N epochs (epoch = first
                                   # task's iterator rollover)
    validate_interval_updates: int = 0
    fixed_validation_seed: Optional[int] = None
    max_valid_batches: Optional[int] = None


@dataclass
class OptimizationConfig(BaseDataclass):
    max_epoch: int = 0
    max_update: int = 0
    lr: Tuple[float, ...] = (0.0001,)
    stop_min_lr: float = -1.0
    clip_norm: float = 1.0
    sentence_avg: bool = False
    # drop the ragged final batch of each epoch
    skip_remainder_batch: bool = True
    optimizer: str = "adam"
    lr_scheduler: str = "ofa_polynomial_decay"
    # adam/adamw
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8
    weight_decay: float = 0.01
    use_adamw: bool = True
    # 'sum': one optimizer step per update, gradients summed across every
    # task's batch; 'round_robin': one optimizer step per task batch
    multi_task_mode: str = "sum"
    # polynomial decay
    warmup_updates: int = 0
    warmup_ratio: float = 0.0
    end_learning_rate: float = 0.0
    power: float = 1.0
    total_num_update: Optional[int] = None


@dataclass
class CheckpointConfig(BaseDataclass):
    save_dir: str = "checkpoints"
    restore_file: str = "checkpoint_last"
    finetune_from_model: Optional[str] = None
    reset_dataloader: bool = False
    reset_lr_scheduler: bool = False
    reset_meters: bool = False
    reset_optimizer: bool = False
    save_interval: int = 1
    save_interval_updates: int = 0
    keep_interval_updates: int = -1
    # update checkpoints whose update count is a multiple of this survive
    # rotation
    keep_interval_updates_pattern: int = -1
    keep_last_epochs: int = -1
    keep_best_checkpoints: int = -1
    no_save: bool = False
    no_epoch_checkpoints: bool = False
    no_last_checkpoints: bool = False
    no_save_optimizer_state: bool = False
    best_checkpoint_metric: str = "loss"
    maximize_best_checkpoint_metric: bool = False
    patience: int = -1
    async_save: bool = True        # write on a background thread


@dataclass
class EMAConfig(BaseDataclass):
    store_ema: bool = False
    ema_decay: float = 0.9999
    ema_start_update: int = 0      # shadow copies the raw params before this
    ema_update_freq: int = 1       # decay applied every N updates


@dataclass
class GenerationConfig(BaseDataclass):
    beam: int = 5
    max_len_a: float = 0.0
    max_len_b: int = 200
    min_len: int = 1
    ngram_blocker: int = 0         # no_repeat_ngram_size
    sampling: bool = False
    sampling_topk: int = -1
    sampling_topp: float = -1.0
    temperature: float = 1.0
    return_n_best: int = 1
    constraint_range: Optional[str] = None
    lenpen: float = 1.0
    unkpen: float = 0.0
    max_len: int = -1
    normalize_scores: bool = True
    match_source_len: bool = False
    search_strategy: str = "beam"    # beam | diverse_beam | diverse_siblings | lexical
    num_groups: int = 2
    diversity_strength: float = 0.5
    diversity_rate: float = 0.5


@dataclass
class TrainerConfig(BaseDataclass):
    common: CommonConfig = field(default_factory=CommonConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    ema: EMAConfig = field(default_factory=EMAConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)

    @classmethod
    def from_yaml(cls, path: str) -> "TrainerConfig":
        raise NotImplementedError(
            "TrainerConfig.from_yaml needs the YAML launcher (launch.py, cli/train.py, "
            "configure/options.py), which is not ported to ofasys_torch yet (ROADMAP Queue A "
            "item 9); build a TrainerConfig in Python or with config_store.from_dict"
        )
