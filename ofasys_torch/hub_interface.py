"""Hub interface: load a trained checkpoint and run one-line inference
(counterpart of ofasys_tpu/hub_interface.py).

    hub = OFASys.from_pretrained("checkpoints/checkpoint_last")      # device="cuda"
    out = hub.inference("[TEXT:src] -> [TEXT:tgt]", data={"src": "..."})
    hub = OFASys.from_pretrained(["ckpt_a", "ckpt_b"])               # an ensemble
    hub = OFASys.from_trainer(trainer, tasks)                         # in-process

    hub = OFASys(model, None, global_dict, GeneralPreprocess(global_dict))
    out = hub.inference("[IMAGE:img] what does the image describe? -> [TEXT:cap]",
                        data={"img": image})      # ndarray, path, bytes, base64 or PIL;
                                                  # the model needs the image_vit adaptor

    hub.quantize()        # int8 serving in place (ops/quant.py), kernel B7

    hub.set_draft(OFASys(draft_model, None, global_dict, gp), gamma=4)
                          # greedy calls decode speculatively (same tokens)

Generation options go to ``SequenceGenerator`` (sampling, a closed-set
``constraint_trie``, ``search_strategy``, ...); ``seed`` seeds the sampling
draws. With a draft attached, calls that resolve to greedy decoding go to
``SpeculativeGenerator``. ``shard`` waits for ROADMAP Queue A item 13.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from ofasys_torch import ModalityType
from ofasys_torch.generator import SequenceGenerator, SpeculativeGenerator
from ofasys_torch.model.ofa import GeneralistModel, modal_ids_of_params
from ofasys_torch.ops.quant import is_quantized, quantize_for_serving
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.preprocessor.instruction import Instruction
from ofasys_torch.utils.device import resolve_device
from ofasys_torch.utils.jax_params import load_jax_params

# per-modality generation defaults (same as ofasys_tpu)
_GEN_DEFAULTS = {
    ModalityType.TEXT: dict(beam_size=5, max_len_b=100, no_repeat_ngram_size=3),
    ModalityType.BOX: dict(beam_size=1, max_len_b=4, min_len=4),
    ModalityType.IMAGE: dict(beam_size=5, max_len_b=1024, min_len=1024, sampling=True,
                             sampling_topk=256),
    ModalityType.MOTION: dict(),
    ModalityType.AUDIO: dict(),
}


class OFASys:
    """Inference-time wrapper around GeneralistModel + GeneralPreprocess.

    ``params`` is an ofasys_tpu flax parameter tree (nested dicts of numpy
    arrays) to load into the model, or None to serve the model's own
    parameters. The model is moved to ``device`` (CUDA by default; raises
    when CUDA is absent)."""

    def __init__(self, model: GeneralistModel, params, global_dict: Dictionary,
                 general_preprocess: GeneralPreprocess,
                 device: Union[str, torch.device] = "cuda", tasks: Optional[Dict[str, Any]] = None):
        self.device = resolve_device(device)
        net_vocab = getattr(getattr(model, "net", None), "vocab_size", None)
        if net_vocab is not None and net_vocab != len(global_dict):
            # preprocessors GROW the dictionary; a model initialized before
            # them has a smaller embedding than the vocab
            raise ValueError(
                f"model embedding was initialized for a {net_vocab}-token "
                f"vocabulary but the dictionary now has {len(global_dict)} "
                "entries — initialize the model AFTER all preprocessors/"
                "tasks have registered their symbols"
            )
        if model.net is None:
            raise ValueError("initialize the model before building the hub")
        model.net.to(self.device)
        if params is not None:
            load_jax_params(model.net, params)
        self.model = model
        self.global_dict = global_dict
        self.general_preprocess = general_preprocess
        self.tasks = tasks or {}
        self._generators: Dict[Any, SequenceGenerator] = {}
        self._ensemble: Optional[List[GeneralistModel]] = None   # models, when > 1 checkpoint
        self._draft = None                   # (draft GeneralistModel, gamma) after set_draft

    # ------------------------------------------------------------- loading
    @classmethod
    def from_pretrained(cls, path, device: Union[str, torch.device] = "cuda",
                        dtype: torch.dtype = torch.bfloat16, use_ema: bool = False) -> "OFASys":
        """Rebuild the model, dictionary and preprocessors from a checkpoint
        and its ``.meta.json`` sidecar (utils/checkpoint_utils.py).

        ``path`` may be a list of checkpoints: generation then ensembles
        them (every member shares the first's vocabulary). ``use_ema``
        serves the EMA shadow weights instead of the raw parameters."""
        if isinstance(path, (list, tuple)) and len(path) > 1:
            hubs = [cls.from_pretrained(p, device=device, dtype=dtype, use_ema=use_ema) for p in path]
            first = hubs[0]
            syms = first.global_dict.state_dict()["symbols"]
            for h in hubs[1:]:
                if h.global_dict.state_dict()["symbols"] != syms:
                    raise ValueError("ensemble members must share one vocabulary")
            first._ensemble = [h.model for h in hubs]
            return first
        if isinstance(path, (list, tuple)):
            path = path[0]
        from ofasys_torch.configure.config_store import ConfigStore, from_dict
        from ofasys_torch.model.config import GeneralistModelConfig
        from ofasys_torch.task.base import Task
        from ofasys_torch.utils import checkpoint_utils

        raw, meta = checkpoint_utils.load_checkpoint(path)
        if meta is None:
            raise ValueError(f"checkpoint {path} has no .meta.json sidecar")
        global_dict = Dictionary.from_state_dict(meta["global_dict"])
        model = GeneralistModel(cfg=from_dict(GeneralistModelConfig, meta["model_cfg"]))
        params = raw["params"] if isinstance(raw, dict) and "params" in raw else raw
        if use_ema:
            ema = raw.get("ema_params") if isinstance(raw, dict) else None
            if ema is None:
                raise ValueError(f"use_ema: checkpoint {path} has no EMA shadow "
                                 "(train with ema.store_ema=True)")
            params = ema
        model.initialize(global_dict, active_adaptors=tuple(meta["active_adaptors"]), dtype=dtype,
                         device=device, modal_ids=modal_ids_of_params(params) if model.cfg.modal_ffn else None)

        # task configs (their generation defaults and templates) back into the store
        ConfigStore().load_state_dict(meta.get("configstore", {}), activate=False)
        # preprocessors: text, and those of the checkpointed task templates
        active_pre = ["text"]
        for tcfg in meta.get("configstore", {}).get("ofasys.task", {}).values():
            template = tcfg.get("instruction", {}).get("template", "")
            for t in template.split("|||"):
                if t.strip():
                    for p in Task(instruction=t.strip()).required_preprocessors():
                        if p not in active_pre:
                            active_pre.append(p)
        gp = GeneralPreprocess(global_dict, active=active_pre)
        return cls(model, params, global_dict, gp, device=device)

    @classmethod
    def from_trainer(cls, trainer, tasks=None) -> "OFASys":
        """Wrap a live training session for in-process inference: the hub
        serves the trainer's model (its parameters as they are now, and as
        later updates leave them)."""
        gp = tasks[0].general_preprocess if tasks else GeneralPreprocess(trainer.global_dict)
        return cls(trainer.model, None, trainer.global_dict, gp, device=trainer.device,
                   tasks={t.name: t for t in (tasks or [])})

    def quantize(self, mode: str = "w8a8", **kwargs) -> "OFASys":
        """Switch to int8 serving IN PLACE (ops/quant.py): matched matmul
        weights become int8 buffers with fp32 scales (their fp32 copies are
        dropped), and ``mode`` selects 'w8a8' (int8 contraction, kernel B7)
        or 'w8' (dequantize, plain matmul). ``kwargs`` go to
        ``quantize_for_serving``. A net that is already quantized is not
        quantized again. Quantize a copy of a model that is still to be
        trained. Returns self."""
        if self._ensemble is not None:
            raise ValueError("quantize() does not support ensembles — quantize each member "
                             "before ensembling")
        net = self.model.net
        if not any(is_quantized(m) for m in net.modules()):
            quantize_for_serving(net, **kwargs)
        self.model.cfg.quant_mode = mode
        self._generators.clear()
        return self

    def set_draft(self, draft: "OFASys", gamma: int = 4) -> "OFASys":
        """Attach a DRAFT model (a smaller OFASys sharing this model's
        vocabulary) for speculative greedy decoding: ``inference`` calls
        that resolve to greedy generation (beam_size=1, no sampling, no
        n-gram blocking, no trie, no prefix) go through
        ``SpeculativeGenerator``, with identical tokens and fewer sequential
        target steps. Other calls are unaffected. ``gamma``: draft tokens
        proposed per target verification."""
        if len(draft.global_dict) != len(self.global_dict):
            raise ValueError("draft vocabulary differs from the target's "
                             f"({len(draft.global_dict)} vs {len(self.global_dict)})")
        self._draft = (draft.model, gamma)
        self._generators.clear()
        return self

    def build_generator(self, **gen_kwargs) -> SequenceGenerator:
        """The generator ``inference`` runs for these options (cached per
        target modality and options); over every member of an ensemble."""
        return SequenceGenerator(self._ensemble or self.model, self.global_dict, **gen_kwargs)

    def inference(
        self,
        instruction: Union[str, Instruction],
        data: Optional[Union[Dict[str, Any], List[Dict[str, Any]]]] = None,
        **gen_overrides,
    ):
        """Format -> preprocess -> generate -> postprocess. ``data`` may be
        one dict or a list for batch inference; returns one (or a list of)
        results, each the best hypothesis or an n-best list. ``gen_overrides``
        are SequenceGenerator options over the target modality's defaults,
        and ``seed`` (default 0) the seed of the sampling draws."""
        batched = isinstance(data, list)
        records = data if batched else [data or {}]

        ists = []
        for rec in records:
            ist = Instruction(instruction, split="test") if isinstance(instruction, str) else instruction
            ists.append(self.general_preprocess(ist.format(**rec)))
        sample = self.general_preprocess.collate(ists)

        target_modality = [s for s in sample["net_input"]["slots"] if not s.is_src][-1].modality
        seed = gen_overrides.pop("seed", 0)
        gen_kwargs = dict(_GEN_DEFAULTS.get(target_modality, {}))
        gen_kwargs.update(gen_overrides)
        prefix = sample.get("prefix_tokens")
        has_prefix = prefix is not None and prefix.size
        speculative = (
            self._draft is not None
            and self._ensemble is None
            and gen_kwargs.get("beam_size", 5) == 1
            and not gen_kwargs.get("sampling", False)
            and not gen_kwargs.get("no_repeat_ngram_size", 0)
            and "constraint_trie" not in gen_kwargs
            and not has_prefix
        )
        key = (target_modality, speculative, tuple(sorted(gen_kwargs.items())))
        if key not in self._generators:
            if speculative:
                draft_model, gamma = self._draft
                spec_kwargs = {k: v for k, v in gen_kwargs.items()
                               if k in ("max_len_a", "max_len_b", "min_len", "lenpen", "constraint_range")}
                self._generators[key] = SpeculativeGenerator(self.model, draft_model, self.global_dict,
                                                             gamma=gamma, **spec_kwargs)
            else:
                self._generators[key] = self.build_generator(**gen_kwargs)
        gen = self._generators[key]
        if speculative:
            outputs = gen.generate(sample)
        else:
            outputs = gen.generate(sample, prefix_tokens=prefix if has_prefix else None, seed=seed)
        for hyps in outputs:
            self.general_preprocess.postprocess(hyps, sample)
        results = [hyps[0] if len(hyps) == 1 else hyps for hyps in outputs]
        return results if batched else results[0]
