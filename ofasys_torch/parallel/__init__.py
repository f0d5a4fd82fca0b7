"""Parallelism of the port (counterpart of ofasys_tpu/parallel/): the mesh,
the sharded training steps, the placement rules, the pipeline, ring
attention and expert-parallel MoE. Every module imports torch only."""

from ofasys_torch.parallel.mesh import BATCH_AXES, MESH_AXES, batch_rows, build_mesh, single_device_mesh
from ofasys_torch.parallel.api import (
    make_sharded_accumulate,
    make_sharded_apply_step,
    make_sharded_grad_step,
    make_sharded_multitask_train_step,
    make_sharded_train_step,
    put_batch,
    shard_train_state,
)
from ofasys_torch.parallel.pipeline import pipeline_stack
from ofasys_torch.parallel.sharding import DEFAULT_RULES, Layout, shard_model, shard_tree, tree_shardings

__all__ = [
    "MESH_AXES", "BATCH_AXES", "build_mesh", "single_device_mesh", "batch_rows",
    "make_sharded_train_step", "make_sharded_grad_step", "make_sharded_apply_step",
    "make_sharded_multitask_train_step",
    "make_sharded_accumulate", "put_batch", "shard_train_state", "DEFAULT_RULES", "tree_shardings",
    "shard_tree", "shard_model", "Layout", "pipeline_stack",
]
