"""Progress reporting (counterpart of ofasys_tpu/logging/progress_bar.py):
json/simple/none renderers and TensorBoard / W&B / AzureML sinks as
wrappers. A ``tensorboard_logdir`` needs ``torch.utils.tensorboard`` (the
``tensorboard`` package) or ``tensorboardX`` and raises without both;
wandb and AzureML are disabled when their packages are absent, as in
ofasys_tpu."""

from __future__ import annotations

import json
import logging
import sys
from numbers import Number
from typing import Any, Dict, Iterable, Optional

logger = logging.getLogger("ofasys_torch.progress")


class BaseProgressBar:
    def __init__(self, iterable: Optional[Iterable] = None, epoch: Optional[int] = None,
                 prefix: Optional[str] = None):
        self.iterable = iterable
        self.epoch = epoch
        self.prefix = prefix
        self.n = 0

    def __iter__(self):
        for item in self.iterable or ():
            self.n += 1
            yield item

    def log(self, stats: Dict[str, Any], tag: Optional[str] = None, step: Optional[int] = None):
        raise NotImplementedError

    def print(self, stats: Dict[str, Any], tag: Optional[str] = None, step: Optional[int] = None):
        raise NotImplementedError

    @staticmethod
    def _fmt(stats: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in stats.items():
            out[k] = round(v, 4) if isinstance(v, float) else v
        return out


class JsonProgressBar(BaseProgressBar):
    def log(self, stats, tag=None, step=None):
        obj = dict(self._fmt(stats))
        if self.epoch is not None:
            obj["epoch"] = self.epoch
        if step is not None:
            obj["num_updates"] = step
        print(json.dumps(obj), file=sys.stdout, flush=True)

    print = log


class SimpleProgressBar(BaseProgressBar):
    def log(self, stats, tag=None, step=None):
        msg = " | ".join(f"{k} {v}" for k, v in self._fmt(stats).items())
        head = f"epoch {self.epoch:03d}" if self.epoch is not None else (tag or "")
        logger.info("%s | %s", head, msg)

    print = log


class NoneProgressBar(BaseProgressBar):
    def log(self, stats, tag=None, step=None):
        pass

    print = log


def _summary_writer_cls(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            raise ImportError(
                f"tensorboard_logdir={logdir!r} needs the tensorboard package "
                "(torch.utils.tensorboard) or tensorboardX; neither is installed"
            ) from None
    return SummaryWriter


class TensorboardWrapper(BaseProgressBar):
    """Mirrors scalars into TensorBoard event files."""

    def __init__(self, inner: BaseProgressBar, logdir: str):
        super().__init__(inner.iterable, inner.epoch, inner.prefix)
        self.inner = inner
        self.logdir = logdir
        self._writers: Dict[str, Any] = {}
        self._summary_writer = _summary_writer_cls(logdir)

    def _writer(self, tag: str):
        if tag not in self._writers:
            import os

            self._writers[tag] = self._summary_writer(os.path.join(self.logdir, tag))
        return self._writers[tag]

    def log(self, stats, tag=None, step=None):
        w = self._writer(tag or "train")
        if w is not None and step is not None:
            for k, v in stats.items():
                if isinstance(v, Number):
                    w.add_scalar(k, float(v), step)
        self.inner.log(stats, tag=tag, step=step)

    def print(self, stats, tag=None, step=None):
        self.log(stats, tag=tag, step=step)


class WandBWrapper(BaseProgressBar):
    """Weights & Biases sink; requires the
    wandb package + credentials, silently disabled otherwise."""

    def __init__(self, inner: BaseProgressBar, project: str):
        super().__init__(inner.iterable, inner.epoch, inner.prefix)
        self.inner = inner
        try:
            import wandb

            self.wandb = wandb
            if wandb.run is None:
                wandb.init(project=project, reinit=False)
        except Exception:
            self.wandb = None

    def log(self, stats, tag=None, step=None):
        if self.wandb is not None:
            prefix = f"{tag}/" if tag else ""
            self.wandb.log({prefix + k: v for k, v in stats.items() if isinstance(v, Number)},
                           step=step)
        self.inner.log(stats, tag=tag, step=step)

    def print(self, stats, tag=None, step=None):
        self.log(stats, tag=tag, step=step)


class AzureMLWrapper(BaseProgressBar):
    """AzureML run-metric sink; requires the
    azureml-core package inside an AzureML run context, silently disabled
    otherwise. An explicit ``run`` object can be injected for tests."""

    def __init__(self, inner: BaseProgressBar, run=None):
        super().__init__(inner.iterable, inner.epoch, inner.prefix)
        self.inner = inner
        self.run = run
        if self.run is None:
            try:
                from azureml.core import Run

                self.run = Run.get_context(allow_offline=False)
            except Exception:
                self.run = None

    def log(self, stats, tag=None, step=None):
        if self.run is not None:
            prefix = f"{tag}/" if tag else ""
            for k, v in stats.items():
                if isinstance(v, Number):
                    self.run.log(f"{prefix}{k}", float(v))
        self.inner.log(stats, tag=tag, step=step)

    def print(self, stats, tag=None, step=None):
        self.log(stats, tag=tag, step=step)


def build_progress_bar(log_format: str = "simple", iterable=None, epoch=None,
                       tensorboard_logdir: Optional[str] = None,
                       wandb_project: Optional[str] = None,
                       azureml_logging: bool = False,
                       azureml_run=None) -> BaseProgressBar:
    cls = {"json": JsonProgressBar, "simple": SimpleProgressBar, "none": NoneProgressBar}.get(
        log_format, SimpleProgressBar
    )
    bar: BaseProgressBar = cls(iterable, epoch)
    if tensorboard_logdir:
        bar = TensorboardWrapper(bar, tensorboard_logdir)
    if wandb_project:
        bar = WandBWrapper(bar, wandb_project)
    if azureml_logging or azureml_run is not None:
        bar = AzureMLWrapper(bar, run=azureml_run)
    return bar
