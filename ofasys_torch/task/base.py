"""Task: instruction template + data + criterion (counterpart of
ofasys_tpu/task/base.py).

A Task declares what to learn (the one-line instruction DSL), owns its data
readers and batch iterators, and contributes a criterion; the shared
GeneralistModel and the Trainer do the rest. Sample processing draws from
the same generators in the same order as ofasys_tpu's: the template choice
from ``random.Random(1)`` on the train split, then each preprocessor's own
numpy generator.

``load_dataset_from_path`` reads local TSVs, remote TSVs (``scheme://``
URLs, fetched once into the cache through ``cached_path``'s registered
fetchers, utils/file_utils.py) and ``.bin`` token files (fixed blocks of
``dataset.text_bin_length`` ids, io/reader/object_store.py).

``evaluate`` generates over a split and scores the hypotheses with the
task's metrics (``evaluation.metrics``, built from the ConfigStore's
``ofasys.metric`` group). ``build_generator`` dispatches on the target
modality: an AUDIO target decodes through the AR speech generator, every
token target through ``SequenceGenerator``.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ofasys_torch import ModalityType
from ofasys_torch.configure.config_store import ConfigStore, register_config, update_config
from ofasys_torch.configure.configs import BaseDataclass, DatasetConfig, GenerationConfig
from ofasys_torch.io.reader.base_reader import BaseReader
from ofasys_torch.io.reader.dataset import EpochBatchIterator, parse_dataset_paths
from ofasys_torch.io.reader.object_store import ObjectStoreLineReader, OssTextBinReader
from ofasys_torch.io.reader.readers import (
    CachedReader,
    ConcatReader,
    HfDatasetReader,
    ListReader,
    TsvReader,
)
from ofasys_torch.preprocessor.general import DEFAULT_PREPROCESS, GeneralPreprocess
from ofasys_torch.preprocessor.instruction import Instruction

logger = logging.getLogger("ofasys_torch.task")


@dataclass
class InstructionConfig(BaseDataclass):
    template: str = ""
    decoder_prompt: Optional[str] = None


@dataclass
class EvaluationConfig(BaseDataclass):
    metrics: Tuple[str, ...] = ()
    output_dir: Optional[str] = None
    best_metric: Optional[str] = None


@dataclass
class TaskConfig(BaseDataclass):
    is_active: bool = False
    name: str = "default"
    instruction: InstructionConfig = field(default_factory=InstructionConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    criterion: str = "label_smoothed_cross_entropy"
    # per-task overrides applied onto the registered criterion config
    criterion_args: Dict[str, Any] = field(default_factory=dict)
    micro_batch_size: Optional[int] = None


@register_config("ofasys.task", "default", TaskConfig)
class Task:
    """Usable directly:
        task = Task(name="caption", instruction="[IMAGE:img] ... -> [TEXT:cap]")
        task.add_dataset(records)            # or task.load_dataset_from_path("train.tsv")
    """

    def __init__(self, cfg: Optional[TaskConfig] = None, name: Optional[str] = None,
                 instruction: Optional[str] = None, **kwargs):
        if cfg is None:
            # deep copy: nested configs would otherwise be shared by every
            # Task built from the same store node
            cfg = copy.deepcopy(ConfigStore().get("ofasys.task", self.registry_name
                                                  if hasattr(self, "registry_name") else "default").config)
        self.cfg = cfg
        if name:
            self.cfg.name = name
        if instruction:
            self.cfg.instruction.template = instruction
        if kwargs:
            self.cfg.update(**kwargs)
        self.general_preprocess: Optional[GeneralPreprocess] = None
        self.criterion = None
        self.metrics: List[Any] = []
        self.datasets: Dict[str, BaseReader] = {}
        self.iterators: Dict[str, EpochBatchIterator] = {}
        self._generator = None
        self._rng = random.Random(1)

    # ------------------------------------------------------------ identity
    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def templates(self) -> List[str]:
        return [t.strip() for t in self.cfg.instruction.template.split("|||") if t.strip()]

    # --------------------------------------------------- template analysis
    def required_preprocessors(self) -> List[str]:
        names = []
        for t in self.templates:
            for slot in Instruction(t).slots:
                n = slot.get_attr("preprocess") or DEFAULT_PREPROCESS[slot.modality]
                if n not in names:
                    names.append(n)
        return names

    def required_adaptors(self) -> List[str]:
        from ofasys_torch.adaptor.general import resolve_adaptor_name
        from ofasys_torch.utils.pytree import SlotBatch

        names = []
        for t in self.templates:
            for slot in Instruction(t).slots:
                sb = SlotBatch(slot.modality, slot.is_src, None, slot.column_name,
                               tuple(slot.attributes) if slot.attributes else None)
                n = resolve_adaptor_name(sb, slot.is_src)
                if n not in names:
                    names.append(n)
        return names

    # ------------------------------------------------------------ lifecycle
    def initialize(self, global_dict, is_train: bool = True):
        """Build the preprocessors the templates need (they grow the
        dictionary), the criterion and the metrics."""
        self.general_preprocess = GeneralPreprocess(global_dict, active=self.required_preprocessors())
        # the criterion and metric registries, even where the Trainer was never imported
        import ofasys_torch.engine.criterion  # noqa: F401
        import ofasys_torch.metric  # noqa: F401

        store = ConfigStore()
        crit_node = store.get("ofasys.criterion", self.cfg.criterion)
        crit_cfg = copy.deepcopy(crit_node.config)
        if getattr(self.cfg, "criterion_args", None):
            update_config(crit_cfg, **dict(self.cfg.criterion_args))
        self.criterion = crit_node.target_cls(crit_cfg, pad_id=global_dict.pad())
        self.criterion.global_dict = global_dict
        self.criterion.eos_id = global_dict.eos()
        self.metrics = []
        for mname in self.cfg.evaluation.metrics:
            node = store.get("ofasys.metric", mname)
            self.metrics.append(node.target_cls(copy.deepcopy(node.config)))
        self.global_dict = global_dict
        return self

    # ---------------------------------------------------------------- data
    def add_dataset(self, data, split: str = "train"):
        if isinstance(data, BaseReader):
            reader = data
        elif isinstance(data, list):
            reader = ListReader(data)
        else:  # huggingface dataset
            reader = HfDatasetReader(data)
        self.datasets[split] = reader
        return self

    def load_dataset_from_path(self, path: str, split: str = "train"):
        files = parse_dataset_paths(path)[0]

        def open_one(f):
            if f.endswith(".bin"):
                return OssTextBinReader(f, block_tokens=self.cfg.dataset.text_bin_length)
            if "://" in f:
                return TsvReader(ObjectStoreLineReader(f), selected_cols=self.cfg.dataset.selected_cols)
            return TsvReader(f, selected_cols=self.cfg.dataset.selected_cols)

        readers = [open_one(f) for f in files]
        reader = readers[0] if len(readers) == 1 else ConcatReader(readers)
        if split == "train":
            reader = CachedReader(reader, shuffle=True)
        self.datasets[split] = reader
        return self

    # ------------------------------------------------------------- samples
    def preprocess(self, data: Dict[str, Any], split: str) -> Dict[str, Any]:
        """Per-task raw-record hook."""
        return data

    def build_instruction(self, split: str) -> Instruction:
        t = self._rng.choice(self.templates) if split == "train" else self.templates[0]
        return Instruction(t, split=split)

    def process_sample(self, record: Dict[str, Any], split: str) -> Optional[Instruction]:
        data = self.preprocess(dict(record), split)
        if data is None:
            return None
        ist = self.build_instruction(split)
        open_names = set(ist.get_slot_names())
        ist = ist.format(**{k: v for k, v in data.items() if k in open_names or not open_names})
        return self.general_preprocess(ist)

    def sample_rng_state(self) -> Dict[str, Any]:
        """The random state that processing a train sample draws from: the
        template choice and each preprocessor's numpy generators (JSON-safe)."""
        version, internal, gauss = self._rng.getstate()
        pre = {}
        for name, p in self.general_preprocess.name2pre.items():
            gens = {k: v.bit_generator.state for k, v in vars(p).items()
                    if isinstance(v, np.random.Generator)}
            if gens:
                pre[name] = gens
        return {"template": [version, list(internal), gauss], "preprocess": pre}

    def set_sample_rng_state(self, state: Dict[str, Any]):
        version, internal, gauss = state["template"]
        self._rng.setstate((version, tuple(internal), gauss))
        for name, gens in state["preprocess"].items():
            p = self.general_preprocess.name2pre[name]
            for k, s in gens.items():
                getattr(p, k).bit_generator.state = s

    def max_sample_tokens(self) -> int:
        """Static per-sample token budget for max_tokens batching: the text
        preprocessor's truncation lengths."""
        pre = self.general_preprocess.name2pre.get("text")
        if pre is not None and hasattr(pre.cfg, "max_src_length"):
            return int(pre.cfg.max_src_length) + int(pre.cfg.max_tgt_length)
        return 512

    def get_batch_iterator(
        self,
        split: str = "train",
        epoch: int = 1,
        rank: int = 0,
        world_size: int = 1,
        seed: int = 1,
        fresh: bool = False,
        drop_last: Optional[bool] = None,
    ) -> EpochBatchIterator:
        if fresh:
            self.iterators.pop(split, None)
        if split in self.iterators:
            return self.iterators[split]
        if split not in self.datasets:
            path = {"train": self.cfg.dataset.train_data,
                    "valid": self.cfg.dataset.valid_data,
                    "test": self.cfg.dataset.test_data}.get(split, "")
            if not path:
                raise ValueError(f"task {self.name}: no dataset for split {split!r}")
            self.load_dataset_from_path(path, split)
        dcfg = self.cfg.dataset
        bsz = dcfg.batch_size if split == "train" else (
            dcfg.batch_size_valid or dcfg.batch_size
        )
        if split == "train" and dcfg.max_tokens:
            # token-budget batching resolved statically (shape-stable batches)
            mult = max(1, dcfg.required_batch_size_multiple)
            bsz = max(1, dcfg.max_tokens // self.max_sample_tokens())
            bsz = max(mult, (bsz // mult) * mult)
            logger.info(
                "task %s: max_tokens=%d -> static batch_size=%d "
                "(%d tokens/sample, multiple of %d)",
                self.name, dcfg.max_tokens, bsz, self.max_sample_tokens(), mult,
            )
        extra_accum = 1
        if split == "train" and self.cfg.micro_batch_size and self.cfg.micro_batch_size < bsz:
            # micro-batching: iterate in micro_batch_size chunks; the extra
            # accumulation factor folds into update_freq so the effective
            # tokens per update are unchanged
            extra_accum = -(-bsz // self.cfg.micro_batch_size)  # ceil
            bsz = self.cfg.micro_batch_size
        it = EpochBatchIterator(
            reader=self.datasets[split],
            process_fn=lambda rec, i: self.process_sample(rec, split),
            collate_fn=self.general_preprocess.collate,
            batch_size=bsz,
            update_freq=dcfg.update_freq * extra_accum if split == "train" else 1,
            shuffle=(split == "train"),
            seed=seed,
            rank=rank,
            world_size=world_size,
            drop_last=(split == "train") if drop_last is None else drop_last,
            epoch=epoch,
            prefetch=dcfg.num_workers,
            sample_rng=(self.sample_rng_state, self.set_sample_rng_state) if split == "train" else None,
        )
        self.iterators[split] = it
        return it

    # ----------------------------------------------------------- inference
    def _target_modality(self):
        """Modality and slot of the last target slot of the first template
        that has one."""
        for t in self.templates:
            tgt = [s for s in Instruction(t).slots if not s.is_src]
            if tgt:
                return tgt[-1].modality, tgt[-1]
        return None, None

    def build_speech_generator(self, model, **overrides):
        """The AR speech generator over continuous fbank targets, with the
        audio preprocessor's corpus-level CMVN stats for denormalization."""
        from ofasys_torch.generator import AutoRegressiveSpeechGenerator

        self._generator = AutoRegressiveSpeechGenerator.for_preprocess(
            model, self.general_preprocess, **overrides)
        return self._generator

    def build_generator(self, model, **overrides):
        from ofasys_torch.generator import SequenceGenerator

        # continuous AUDIO targets decode through the AR speech generator;
        # token-coded targets (text, boxes, image codes) through the beam loop
        modality, tgt_slot = self._target_modality()
        if modality == ModalityType.AUDIO and tgt_slot.get_attr("preprocess") != "image_vqgan":
            return self.build_speech_generator(model, **overrides)
        g = self.cfg.generation
        kwargs = dict(
            beam_size=g.beam, max_len_a=g.max_len_a, max_len_b=g.max_len_b,
            min_len=g.min_len, temperature=g.temperature, lenpen=g.lenpen,
            unkpen=g.unkpen, max_len=g.max_len,
            normalize_scores=g.normalize_scores,
            match_source_len=g.match_source_len,
            no_repeat_ngram_size=g.ngram_blocker, constraint_range=g.constraint_range,
            sampling=g.sampling, sampling_topk=g.sampling_topk, sampling_topp=g.sampling_topp,
            return_n_best=g.return_n_best,
            search_strategy=g.search_strategy, num_groups=g.num_groups,
            diversity_strength=g.diversity_strength, diversity_rate=g.diversity_rate,
        )
        kwargs.update(overrides)
        # a closed-set target with a built trie constrains the search to it
        if "constraint_trie" not in kwargs:
            trie = self._closed_set_trie()
            if trie is not None:
                kwargs["constraint_trie"] = trie
        self._generator = SequenceGenerator(model, self.global_dict, **kwargs)
        return self._generator

    def _closed_set_trie(self):
        """The text preprocessor's constraint trie, when any template's
        target slot is closed_set."""
        gp = getattr(self, "general_preprocess", None)
        if gp is None:
            return None
        text_pre = gp.name2pre.get("text")
        if text_pre is None or getattr(text_pre, "constraint_trie", None) is None:
            return None
        for t in self.templates:
            tgt = [s for s in Instruction(t).slots if not s.is_src]
            if tgt and tgt[-1].has_attr("closed_set"):
                return text_pre.constraint_trie
        return None

    def prepare_inference(self, model, params):
        """Load ``params`` into the model (a flax parameter tree,
        utils/jax_params.load_jax_params; None keeps the model's own) and
        run the preprocessors that hold a model on the model's device
        unless they were given one."""
        if params is not None:
            from ofasys_torch.utils.jax_params import load_jax_params

            load_jax_params(model.net, params)
        if self.general_preprocess.device is None:
            self.general_preprocess.to(model.net.device)

    def inference(self, model, params, sample, **gen_overrides):
        """Generate + postprocess. ``params`` as in ``prepare_inference``."""
        self.prepare_inference(model, params)
        if self._generator is None:
            self.build_generator(model, **gen_overrides)
        prefix = sample.get("prefix_tokens")
        if (self.cfg.instruction.decoder_prompt
                and (prefix is None or np.asarray(prefix).size == 0)):
            # decoder_prompt: force-decode these tokens before free generation
            text_pre = self.general_preprocess.name2pre.get("text")
            if text_pre is not None:
                prompt = np.asarray(
                    text_pre.encode(self.cfg.instruction.decoder_prompt), np.int32
                )[None, :]
                B = int(np.asarray(sample["target"]).shape[0]) if "target" in sample \
                    else next(iter(
                        v for s in sample["net_input"]["slots"]
                        for v in ([s.value] if not isinstance(s.value, dict) else s.value.values())
                        if hasattr(v, "shape")
                    )).shape[0]
                prefix = np.tile(prompt, (B, 1))
        has_prefix = prefix is not None and np.asarray(prefix).size
        outputs = self._generator.generate(sample, prefix_tokens=prefix if has_prefix else None)
        for hyps in outputs:
            for h in hyps:
                self.general_preprocess.postprocess([h], sample)
        return outputs

    def evaluate(self, model, params, split: str = "valid", max_batches: Optional[int] = None,
                 rank: int = 0, world_size: int = 1) -> Dict[str, float]:
        """Generate over a split and score with the task's metrics. Each
        metric takes its references from the batch's ``target_field`` when
        a preprocessor put that field there, else from the decoded target;
        a padded last batch counts its ``n_valid`` records. With
        ``evaluation.output_dir`` the hypotheses, references and metrics go
        to ``<output_dir>/<task>_<split>.json``. ``params`` as in
        ``inference``."""
        if params is not None:
            from ofasys_torch.utils.jax_params import load_jax_params

            load_jax_params(model.net, params)
        it = self.get_batch_iterator(split, rank=rank, world_size=world_size)
        text_pre = self.general_preprocess.name2pre["text"]
        hyps: List[str] = []
        fields = {m.cfg.target_field for m in self.metrics} or {"target"}
        refs_by_field: Dict[str, List[Any]] = {f: [] for f in fields}
        for i, batch in enumerate(it.next_epoch_itr(shuffle=False)):
            if max_batches is not None and i >= max_batches:
                break
            outputs = self.inference(model, None, batch)
            n_valid = batch.get("n_valid", len(outputs))
            for b, out in enumerate(outputs[:n_valid]):
                hyps.append(out[0].text if out[0].text is not None else text_pre.decode(out[0].tokens))
                decoded = None
                for name in fields:
                    raw = batch.get(name) if name != "target" else None
                    if raw is not None and b < len(raw):
                        refs_by_field[name].append(raw[b])
                    else:
                        if decoded is None:
                            decoded = text_pre.decode(np.asarray(batch["target"])[b])
                        refs_by_field[name].append(decoded)
        results: Dict[str, float] = {}
        for metric in self.metrics:
            results.update(metric.compute(hyps, refs_by_field[metric.cfg.target_field]))
        refs = refs_by_field[self.metrics[0].cfg.target_field if self.metrics else "target"]
        out_dir = self.cfg.evaluation.output_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{self.name}_{split}.json"), "w") as f:
                json.dump({"hyps": hyps, "refs": [str(r) for r in refs], "metrics": results}, f, indent=1)
        return results
