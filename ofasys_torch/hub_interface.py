"""Hub interface: one-line inference over a model (counterpart of
ofasys_tpu/hub_interface.py).

    hub = OFASys(model, None, global_dict, GeneralPreprocess(global_dict))
    out = hub.inference("[TEXT:src] -> [TEXT:tgt]", data={"src": "..."})
    out = hub.inference("[IMAGE:img] what does the image describe? -> [TEXT:cap]",
                        data={"img": image})      # ndarray, path, bytes, base64 or PIL;
                                                  # the model needs the image_vit adaptor

    hub.quantize()        # int8 serving in place (ops/quant.py), kernel B7

``from_pretrained`` (orbax checkpoints), ``shard`` and ``set_draft`` wait
for later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from ofasys_torch import ModalityType
from ofasys_torch.generator import SequenceGenerator
from ofasys_torch.model.ofa import GeneralistModel
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
                 device: Union[str, torch.device] = "cuda"):
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
        self._generators: Dict[Any, SequenceGenerator] = {}

    def quantize(self, mode: str = "w8a8", **kwargs) -> "OFASys":
        """Switch to int8 serving IN PLACE (ops/quant.py): matched matmul
        weights become int8 buffers with fp32 scales (their fp32 copies are
        dropped), and ``mode`` selects 'w8a8' (int8 contraction, kernel B7)
        or 'w8' (dequantize, plain matmul). ``kwargs`` go to
        ``quantize_for_serving``. A net that is already quantized is not
        quantized again. Quantize a copy of a model that is still to be
        trained. Returns self."""
        net = self.model.net
        if not any(is_quantized(m) for m in net.modules()):
            quantize_for_serving(net, **kwargs)
        self.model.cfg.quant_mode = mode
        self._generators.clear()
        return self

    def inference(
        self,
        instruction: Union[str, Instruction],
        data: Optional[Union[Dict[str, Any], List[Dict[str, Any]]]] = None,
        **gen_overrides,
    ):
        """Format -> preprocess -> generate -> postprocess. ``data`` may be
        one dict or a list for batch inference; returns one (or a list of)
        results, each the best hypothesis or an n-best list."""
        batched = isinstance(data, list)
        records = data if batched else [data or {}]

        ists = []
        for rec in records:
            ist = Instruction(instruction, split="test") if isinstance(instruction, str) else instruction
            ists.append(self.general_preprocess(ist.format(**rec)))
        sample = self.general_preprocess.collate(ists)

        target_modality = [s for s in sample["net_input"]["slots"] if not s.is_src][-1].modality
        gen_kwargs = dict(_GEN_DEFAULTS.get(target_modality, {}))
        gen_kwargs.update(gen_overrides)
        prefix = sample.get("prefix_tokens")
        has_prefix = prefix is not None and prefix.size
        key = (target_modality, tuple(sorted(gen_kwargs.items())))
        if key not in self._generators:
            self._generators[key] = SequenceGenerator(self.model, self.global_dict, **gen_kwargs)
        outputs = self._generators[key].generate(sample, prefix_tokens=prefix if has_prefix else None)
        for hyps in outputs:
            self.general_preprocess.postprocess(hyps, sample)
        results = [hyps[0] if len(hyps) == 1 else hyps for hyps in outputs]
        return results if batched else results[0]
