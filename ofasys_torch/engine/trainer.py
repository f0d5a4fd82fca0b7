"""Trainer: the multi-task fit loop (counterpart of ofasys_tpu/engine/trainer.py).

    fit(model, tasks):
      build vocab -> initialize tasks (the vocab grows) -> initialize the
      model -> per-task train steps -> update loop -> validate_and_save ->
      checkpoints with the full resume state.

Multi-task scheduling (``cfg.optimization.multi_task_mode``): 'sum' (the
default) runs every task's batch through its gradient and takes one
optimizer step per update (engine/train_step.make_multitask_train_step);
'round_robin', and any single-task fit, takes one optimizer step per task
batch. Metrics are deferred: each update's metrics stay device tensors and
are fetched in one copy at log and checkpoint boundaries
(``host_syncs`` counts those copies).

Resume is exact: the checkpoint holds the parameters, the optimizer state,
the EMA and the step, and each task's train iterator records with every
batch the random state of sample processing, so a resumed run continues
with the same batches as an uninterrupted one; dropout draws are keyed by
the step (engine/train_step.dropout_generator). ofasys_tpu pops the
iterators before it restores them and restarts a resumed run's data at
epoch 1 (ROADMAP Queue C).

One CUDA device (``device="cuda"``, the default; the CPU only when asked
for): a ``ParallelConfig`` that asks for more than one device, ``zero1``,
``pipeline`` or ``sequence`` parallelism raises (ROADMAP Queue A item 13),
and ``parallel.remat`` raises through the model's UNPORTED_DEFAULTS.

``common.profile=True`` traces the update loop with torch.profiler
(utils/profiler.py) into ``common.profile_dir/trace.json``, each update
inside a ``record_function`` range named ``update <n>``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ofasys_torch.configure import ConfigStore, TrainerConfig, to_dict
from ofasys_torch.engine.optim import build_lr_schedule, build_optimizer
from ofasys_torch.engine.train_step import (
    TrainState,
    make_multitask_train_step,
    make_train_step,
    make_valid_step,
)
from ofasys_torch.io.reader.dataset import tree_index
from ofasys_torch.logging.meters import AverageMeter, MetersDict, TimeMeter
from ofasys_torch.logging.progress_bar import build_progress_bar
from ofasys_torch.model.ofa import modal_ids_of_params
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.utils import checkpoint_utils, profiler
from ofasys_torch.utils.device import resolve_device
from ofasys_torch.utils.pytree import sample_to_device

logger = logging.getLogger("ofasys_torch.trainer")

PARALLEL = "ROADMAP Queue A item 13 (parallelism)"


def check_parallel(cfg: TrainerConfig):
    """Raise for what the one-device trainer cannot run."""
    p = cfg.parallel
    many = {k: getattr(p, k) for k in ("fsdp", "tensor", "expert", "sequence", "pipeline")
            if getattr(p, k) != 1}
    if p.data not in (-1, 1):
        many["data"] = p.data
    if many or p.zero1:
        raise NotImplementedError(
            f"parallel {many or {'zero1': True}}: ofasys_torch trains on one device; "
            f"multi-device training waits for {PARALLEL}")


class Trainer:
    def __init__(self, cfg: Optional[TrainerConfig] = None,
                 device: Union[str, torch.device] = "cuda", **kwargs):
        self.cfg = cfg or TrainerConfig()
        if kwargs:
            self.cfg.update(**kwargs)
        check_parallel(self.cfg)
        self.device = resolve_device(device)
        self.meters = MetersDict()
        self.state: Optional[TrainState] = None
        self._step_fns: Dict[str, Callable] = {}
        self._fused_fn: Optional[Callable] = None
        self._valid_fns: Dict[str, Callable] = {}
        self._sum_mode = False
        self._pending: List[Any] = []  # deferred (task, device metrics, ntokens, nsentences)
        self._resume_iterators: Dict[str, Any] = {}
        self._iterators: Dict[str, Any] = {}
        self._update_freqs: Dict[str, int] = {}
        self.host_syncs = 0            # device -> host metric copies
        # validate/early-stop state
        self._best_val: Optional[float] = None
        self._patience_left = self.cfg.checkpoint.patience

    # ------------------------------------------------------------- fitting
    def fit(self, model, tasks, max_update: Optional[int] = None):
        start_update = self.setup(model, tasks, max_update)
        t_start = time.time()
        try:
            self.run_updates(start_update, self._total_updates)
            self._flush_metrics()
            if not self.cfg.checkpoint.no_save and not self.cfg.checkpoint.no_last_checkpoints:
                self.save_checkpoint("checkpoint_last", self._total_updates)
            checkpoint_utils.wait_for_async_saves()
        finally:
            self.close()
        logger.info("fit done in %.1fs", time.time() - t_start)
        return self.state

    def close(self):
        """Stop the batch streams (and their prefetch threads)."""
        for it in self._iterators.values():
            it.close()

    def setup(self, model, tasks, max_update: Optional[int] = None) -> int:
        """Vocab, model init, restore, step functions. Returns the starting
        update (non-zero after a checkpoint restore)."""
        if not isinstance(tasks, (list, tuple)):
            tasks = [tasks]
        cfg = self.cfg
        total_updates = max_update or cfg.optimization.max_update or 1000
        self._total_updates = total_updates

        # 1) the remat mode from the trainer's (an explicit model-level remat wins)
        if model.cfg.remat == "none" and cfg.parallel.remat != "none":
            model.cfg.remat = {"selective": "dots", "full": "full",
                               "dots": "dots"}[cfg.parallel.remat]
        # 2) vocab, adaptors, dtype, parameters
        self.init_model(model, tasks)
        optimizer = build_optimizer(cfg.optimization, total_num_update=total_updates)
        lr_sched = build_lr_schedule(cfg.optimization, total_updates)
        self.state = TrainState.create(model.net, optimizer, ema=cfg.ema.store_ema)
        self.model = model
        self.tasks = tasks
        self.optimizer = optimizer

        # 3) restore
        start_update = 0
        restored = self._maybe_restore()
        if restored is not None:
            start_update = restored
            if cfg.checkpoint.reset_lr_scheduler and start_update > 0:
                # the logged schedule restarts from zero while training
                # resumes at the restored update
                base_sched, off = lr_sched, int(start_update)
                lr_sched = lambda s: base_sched(max(s - off, 0))  # noqa: E731
                logger.info("reset_lr_scheduler: schedule re-zeroed at update %d", off)

        # 4) step functions
        self._sum_mode = cfg.optimization.multi_task_mode == "sum" and len(tasks) > 1
        ema_decay = cfg.ema.ema_decay if cfg.ema.store_ema else 0.0
        ema_kw = dict(ema_decay=ema_decay, lr_schedule=lr_sched,
                      ema_start_update=cfg.ema.ema_start_update,
                      ema_update_freq=cfg.ema.ema_update_freq)
        if self._sum_mode:
            self._fused_fn = make_multitask_train_step(
                model, {t.name: t.criterion for t in tasks}, optimizer,
                update_freqs={t.name: self._update_freq(t) for t in tasks}, **ema_kw)
        else:
            for task in tasks:
                self._step_fns[task.name] = make_train_step(
                    model, task.criterion, optimizer, update_freq=self._update_freq(task), **ema_kw)

        # 5) loop state
        self.progress = build_progress_bar(
            cfg.common.log_format, tensorboard_logdir=cfg.common.tensorboard_logdir,
            wandb_project=cfg.common.wandb_project,
            azureml_logging=cfg.common.azureml_logging,
        )
        self._seed = cfg.common.seed
        self._iterators = {t.name: self._task_batches(t) for t in tasks}
        if "ups" not in self.meters:
            self.meters.add_meter("ups", TimeMeter(round=2))
            self.meters.add_meter("wps", TimeMeter(round=0))
        return start_update

    def _update_freq(self, task) -> int:
        """The train iterator's accumulation factor (update_freq times the
        micro_batch_size split), recorded by the peek."""
        return self._update_freqs[task.name]

    def run_updates(self, start_update: int, end_update: int):
        """Updates ``start_update`` to ``end_update`` (under a profiler
        trace when ``common.profile``)."""
        if not self.cfg.common.profile:
            return self._run_updates(start_update, end_update)
        with profiler.profile(self.cfg.common.profile_dir):
            logger.info("torch.profiler trace -> %s", self.cfg.common.profile_dir)
            return self._run_updates(start_update, end_update)

    def _run_updates(self, start_update: int, end_update: int):
        cfg = self.cfg
        ck = cfg.checkpoint
        if getattr(self, "_wall_start", None) is None:
            self._wall_start = time.time()
        last_epoch = self._cur_epoch()
        for update in range(start_update, end_update):
            if cfg.common.profile:
                with profiler.annotate(f"update {update + 1}"):
                    self.train_one_update()
            else:
                self.train_one_update()
            self.meters["ups"].update(1)
            if cfg.common.log_interval and (update + 1) % cfg.common.log_interval == 0:
                self._print_progress(update + 1, end_update)
                lr_val = self.meters["lr"].avg if "lr" in self.meters else None
                if (cfg.optimization.stop_min_lr > 0 and lr_val is not None
                        and lr_val < cfg.optimization.stop_min_lr):
                    logger.info("stop: lr %.3g below stop_min_lr %.3g",
                                lr_val, cfg.optimization.stop_min_lr)
                    break
            if ck.save_interval_updates and (update + 1) % ck.save_interval_updates == 0:
                self.save_checkpoint(f"checkpoint_1_{update + 1}", update + 1)
            vi = cfg.dataset.validate_interval_updates
            if vi and (update + 1) % vi == 0:
                if self.validate_and_save(update + 1):
                    logger.info("early stop at update %d: %s did not improve for %d "
                                "validations (patience)", update + 1,
                                ck.best_checkpoint_metric, ck.patience)
                    break
            # epoch boundary (epoch = first task's iterator rollover)
            ep = self._cur_epoch()
            if ep != last_epoch:
                done_ep, last_epoch = last_epoch, ep
                if (not ck.no_save and not ck.no_epoch_checkpoints
                        and ck.save_interval > 0 and done_ep % ck.save_interval == 0):
                    self.save_checkpoint(f"checkpoint_e{done_ep}", update + 1,
                                         keep_epochs=ck.keep_last_epochs)
                if (cfg.dataset.validate_interval > 0 and not vi
                        and done_ep % cfg.dataset.validate_interval == 0):
                    if self.validate_and_save(update + 1):
                        logger.info("early stop after epoch %d (patience)", done_ep)
                        break
                if cfg.optimization.max_epoch and done_ep >= cfg.optimization.max_epoch:
                    logger.info("stop: reached max_epoch %d", done_ep)
                    break

    def _cur_epoch(self) -> int:
        it = self.tasks[0].iterators.get("train") if getattr(self, "tasks", None) else None
        return int(getattr(it, "epoch", 1)) if it is not None else 1

    def validate_and_save(self, num_updates: int) -> bool:
        """Validate every task that has a valid split, track the mean
        best-checkpoint metric, keep checkpoint_best, and signal
        patience-based early stop. Returns True when training should stop."""
        cfg = self.cfg
        vals = []
        for task in self.tasks:
            if task.cfg.dataset.disable_validation or "valid" not in task.datasets:
                continue
            metrics = self.validate(task, max_batches=cfg.dataset.max_valid_batches)
            for k, v in metrics.items():
                key = f"valid:{task.name}:{k}"
                if key not in self.meters:
                    self.meters.add_meter(key, AverageMeter(round=4))
                self.meters[key].update(float(v))
            key = task.cfg.evaluation.best_metric or cfg.checkpoint.best_checkpoint_metric
            if key in metrics:
                vals.append(float(metrics[key]))
        if not vals:
            return False
        score = float(np.mean(vals))
        maximize = cfg.checkpoint.maximize_best_checkpoint_metric
        better = (self._best_val is None
                  or (score > self._best_val if maximize else score < self._best_val))
        if better:
            self._best_val = score
            self._patience_left = cfg.checkpoint.patience
            if not cfg.checkpoint.no_save:
                self.save_checkpoint(f"checkpoint_1_{num_updates}", num_updates, is_best=True)
        elif cfg.checkpoint.patience > 0:
            self._patience_left -= 1
            if self._patience_left <= 0:
                return True
        return False

    def train_one_update(self):
        """One update: every task contributes one batch. No host sync:
        metrics stay on the device until a log or checkpoint boundary."""
        if self._sum_mode:
            batches, ntokens, nsent = {}, {}, {}
            for task in self.tasks:
                b = next(self._iterators[task.name])
                ntokens[task.name], nsent[task.name] = _count(b, "ntokens"), _count(b, "nsentences")
                batches[task.name] = self._device_batch(b, task)
            self.state, metrics = self._fused_fn(self.state, batches, self._seed)
            for task in self.tasks:
                self._log_metrics(task.name, metrics["tasks"][task.name],
                                  ntokens[task.name], nsent[task.name])
            self._log_metrics(None, {k: v for k, v in metrics.items() if k != "tasks"}, 0)
        else:
            for task in self.tasks:
                b = next(self._iterators[task.name])
                db = self._device_batch(b, task)
                self.state, metrics = self._step_fns[task.name](self.state, db, self._seed)
                self._log_metrics(task.name, metrics, _count(b, "ntokens"), _count(b, "nsentences"))

    # -------------------------------------------------------------- pieces
    def _device_batch(self, batch, task):
        view = batch_device_view(batch)
        uf = self._update_freq(task)
        if uf == 1:
            return sample_to_device(view, self.device)
        return [sample_to_device(tree_index(view, i), self.device) for i in range(uf)]

    def init_model(self, model, tasks, params: Optional[Dict[str, Any]] = None) -> Dictionary:
        """The one model build of training and of cli.evaluate: the tasks
        grow one dictionary, and the model is built on it with the union of
        their adaptors and the trainer's dtype, seed and device. Under
        modal_ffn the experts are those of each task's first batch, or with
        ``params`` (a checkpoint's tree, for evaluation; the tasks then
        initialize for inference) those the tree holds."""
        global_dict = Dictionary()
        for task in tasks:
            task.initialize(global_dict, is_train=params is None)
        global_dict.pad_to_multiple_(128)
        adaptors: List[str] = []
        for task in tasks:
            for a in task.required_adaptors():
                if a not in adaptors:
                    adaptors.append(a)
        common = self.cfg.common
        use_bf16 = common.dtype == "bfloat16" or common.fp16 or common.bf16
        sample_slots = modal_ids = None
        if params is None:
            sample_slots = [self._peek_batch(t)["net_input"]["slots"] for t in tasks]
        elif model.cfg.modal_ffn:
            modal_ids = modal_ids_of_params(params)
        model.initialize(global_dict, active_adaptors=tuple(adaptors),
                         dtype=torch.bfloat16 if use_bf16 else torch.float32,
                         device=self.device, seed=common.seed,
                         sample_slots=sample_slots, modal_ids=modal_ids)
        self.global_dict = global_dict
        return global_dict

    def _peek_batch(self, task):
        """The task's first batch, then a fresh iterator. The peek runs
        without the prefetch thread: a thread left running would go on
        drawing from the task's random generators."""
        it = task.get_batch_iterator("train", seed=self.cfg.common.seed)
        it.prefetch = 0
        self._update_freqs[task.name] = it.update_freq
        epochs = it.next_epoch_itr()
        batch = next(epochs)
        epochs.close()
        task.iterators.pop("train", None)
        return batch

    def _task_batches(self, task):
        """Endless stream of batches, rolling over epochs, from the restored
        iterator state when there is one."""
        it = task.get_batch_iterator(
            "train", seed=self.cfg.common.seed,
            drop_last=self.cfg.optimization.skip_remainder_batch,
        )
        if task.name in self._resume_iterators:
            it.load_state_dict(self._resume_iterators.pop(task.name))
        while True:
            yield from it.next_epoch_itr()

    def _log_metrics(self, task_name: Optional[str], metrics: Dict[str, Any], ntokens: int,
                     nsentences: int = 0):
        self._pending.append((task_name, metrics, ntokens, nsentences))
        if len(self._pending) >= 512:
            self._flush_metrics()

    def _flush_metrics(self):
        """Fetch every pending device scalar in one copy and feed the meters."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        tensors = [v for _, m, _, _ in pending for v in m.values() if isinstance(v, torch.Tensor)]
        if tensors:
            host = torch.stack([t.detach().float().reshape(()) for t in tensors]).cpu().tolist()
            self.host_syncs += 1
        it = iter(host if tensors else [])
        fetched = [{k: next(it) if isinstance(v, torch.Tensor) else float(v) for k, v in m.items()}
                   for _, m, _, _ in pending]
        for (task_name, _, ntokens, nsentences), metrics in zip(pending, fetched):
            ss = float(metrics.get("sample_size", 1.0)) or 1.0
            nt = float(metrics.get("ntokens", 0.0)) or 1.0
            if task_name is not None:
                # every *loss output into a per-task meter; nll_loss per
                # token, the rest per sample
                for key in metrics:
                    if not key.endswith("loss"):
                        continue
                    meter_key = f"{task_name}:{key}"
                    denom = nt if key == "nll_loss" else ss
                    if meter_key not in self.meters:
                        self.meters.add_meter(meter_key, AverageMeter(round=3))
                    self.meters[meter_key].update(float(metrics[key]) / denom)
            if "gnorm" in metrics:
                if "gnorm" not in self.meters:
                    self.meters.add_meter("gnorm", AverageMeter(round=3))
                self.meters["gnorm"].update(float(metrics["gnorm"]))
            if "lr" in metrics:
                if "lr" not in self.meters:
                    self.meters.add_meter("lr", AverageMeter(round=6))
                self.meters["lr"].update(float(metrics["lr"]))
            self.meters["wps"].update(ntokens)
            if task_name is not None:
                if "wpb" not in self.meters:
                    self.meters.add_meter("wpb", AverageMeter(round=1))
                    self.meters.add_meter("bsz", AverageMeter(round=1))
                if ntokens:
                    self.meters["wpb"].update(ntokens)
                if nsentences:
                    self.meters["bsz"].update(nsentences)

    def _print_progress(self, update: int, total: int):
        self._flush_metrics()
        if getattr(self, "_wall_start", None) is not None:
            if "train_wall" not in self.meters:
                self.meters.add_meter("train_wall", AverageMeter(round=0))
            self.meters["train_wall"].reset()
            self.meters["train_wall"].update(time.time() - self._wall_start)
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if "gb_free" not in self.meters:
                self.meters.add_meter("gb_free", AverageMeter(round=1))
            self.meters["gb_free"].reset()
            self.meters["gb_free"].update(free / 2**30)
        vals = self.meters.get_smoothed_values()
        if getattr(self, "progress", None) is not None:
            self.progress.log(vals, tag="train", step=update)
        else:
            logger.info("update %d/%d | %s", update, total,
                        " | ".join(f"{k} {v}" for k, v in vals.items()))

    # ----------------------------------------------------------- validate
    def validate(self, task, max_batches: Optional[int] = None) -> Dict[str, float]:
        if task.name not in self._valid_fns:
            self._valid_fns[task.name] = make_valid_step(self.model, task.criterion)
        fn = self._valid_fns[task.name]
        logs = []
        # a fresh iterator: every validation pass scores the same batches
        it = task.get_batch_iterator(
            "valid", fresh=True, seed=self.cfg.dataset.fixed_validation_seed or 1
        )
        for i, batch in enumerate(it.next_epoch_itr(shuffle=False)):
            if max_batches is not None and i >= max_batches:
                break
            out = fn(sample_to_device(batch_device_view(batch), self.device))
            logs.append({k: v.item() if isinstance(v, torch.Tensor) else v for k, v in out.items()})
        return task.criterion.reduce_metrics(logs, task_name=task.name)

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, name: str, num_updates: int, is_best: bool = False,
                        keep_epochs: int = -1):
        cfg = self.cfg
        meta = {
            "num_updates": num_updates,
            "cfg": to_dict(cfg),
            "configstore": ConfigStore().state_dict(groups=["ofasys.task", "ofasys.model"]),
            "global_dict": self.global_dict.state_dict(),
            "iterator_states": {t.name: t.iterators["train"].state_dict()
                                for t in self.tasks if "train" in t.iterators},
            "model_cfg": to_dict(self.model.cfg),
            "active_adaptors": list(self.model.net.active_adaptors),
            "meters": self.meters.state_dict(),
        }
        params_only = cfg.checkpoint.no_save_optimizer_state
        state = checkpoint_utils.train_state_dict(self.model.net, self.state,
                                                  with_optimizer=not params_only)
        if params_only:
            # params-only checkpoint: resume treats it like finetune_from_model
            meta["no_optimizer_state"] = True
        checkpoint_utils.save_checkpoint(
            cfg.checkpoint.save_dir, name, state, meta,
            keep_last=cfg.checkpoint.keep_interval_updates, is_best=is_best,
            async_save=cfg.checkpoint.async_save,
            keep_pattern=cfg.checkpoint.keep_interval_updates_pattern,
            keep_best=cfg.checkpoint.keep_best_checkpoints, best_tag=num_updates,
            keep_epochs=keep_epochs,
            mirror_last=not cfg.checkpoint.no_last_checkpoints,
        )

    def _maybe_restore(self) -> Optional[int]:
        checkpoint_utils.wait_for_async_saves()  # in-process save-then-resume
        ck = self.cfg.checkpoint
        path = os.path.join(ck.save_dir, ck.restore_file or "checkpoint_last")
        if not os.path.exists(path):
            path = None
        if path is None and ck.finetune_from_model:
            # first launch: warm-start the weights from another run; once a
            # checkpoint_last exists the usual resume takes over
            self._load_params_only(ck.finetune_from_model)
            return None
        if path is None:
            return None
        if ck.reset_optimizer:
            # the weights restore; the optimizer and the step start fresh
            self._load_params_only(path)
            if not ck.reset_dataloader:
                meta = checkpoint_utils.upgrade_state_meta(checkpoint_utils.read_meta(path)) or {}
                self._resume_iterators = dict(meta.get("iterator_states", {}))
            return None
        pre_meta = checkpoint_utils.upgrade_state_meta(checkpoint_utils.read_meta(path))
        if (pre_meta or {}).get("no_optimizer_state"):
            # params-only checkpoint: the weights restore, the optimizer starts fresh
            self._load_params_only(path)
            return int(pre_meta.get("num_updates", 0))
        state, meta = checkpoint_utils.load_checkpoint(path)
        saved_syms = (pre_meta or {}).get("global_dict", {}).get("symbols")
        cur_syms = self.global_dict.state_dict()["symbols"]
        if saved_syms is not None and saved_syms != cur_syms:
            # the vocab changed between save and resume: remap the embedding
            # rows token by token; old tokens stay bit-identical
            logger.info("vocab changed since checkpoint (%d -> %d tokens); remapping "
                        "embedding rows", len(saved_syms), len(cur_syms))
            state = checkpoint_utils.remap_vocab_rows(state, saved_syms, self.global_dict)
        checkpoint_utils.load_train_state(self.model.net, self.state, state)
        meta = checkpoint_utils.upgrade_state_meta(meta)
        if meta:
            if not ck.reset_dataloader:
                self._resume_iterators = dict(meta.get("iterator_states", {}))
            if not ck.reset_meters and meta.get("meters"):
                try:
                    self.meters.load_state_dict(meta["meters"])
                except Exception:
                    logger.warning("could not restore meters state; continuing fresh")
            return int(meta.get("num_updates", 0))
        return None

    def _load_params_only(self, path: str):
        """Restore the model weights (and the EMA if both have one) from
        ``path``; the optimizer, meters and iterators keep their fresh state."""
        state, _ = checkpoint_utils.load_checkpoint(path)
        checkpoint_utils.load_train_state(self.model.net, self.state, state, params_only=True)
        logger.info("loaded model weights (params-only) from %s", path)


def _count(batch, key: str) -> int:
    """A host count of a batch (summed over stacked microbatches)."""
    return int(np.sum(batch.get(key, 0)))


def batch_device_view(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Strip host-only keys (template strings, python ints...)."""
    return {k: v for k, v in batch.items()
            if k not in ("template", "nsentences", "ntokens", "n_valid", "prefix_tokens",
                         "dict_start", "dict_end")}
