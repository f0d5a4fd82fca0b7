"""Image-as-codes preprocessor (counterpart of
ofasys_tpu/preprocessor/image_vqgan.py, ``image_vqgan``).

Registers ``num_codes`` ``<code>_i`` tokens, tokenizes images into code
sequences with the GumbelVQ tokenizer (model/vqgan.py) and decodes
generated code tokens back to images. The tokenizer runs on ``device``:
the hub and the trainer hand it theirs (``GeneralPreprocess.to``), since
training calls it from the prefetch thread; unset, it is CUDA. Code runs
go through the text group's bos/eos wrap and truncation, so a target holds
at most ``max_tgt_length`` codes (256 by default, as in ofasys_tpu: set it
to ``codes_per_image`` for whole images).

Best-of-N rerank: ``rerank_scores`` takes a pluggable ``rerank_scorer``
((N, H, W, 3) images in [0, 1], text) -> (N,) scores, higher is better.
Without one, ``rerank='clip'`` loads CLIP through ``transformers`` from
the local directory ``clip_model`` or $OFA_CLIP_PATH onto the tokenizer's
device (and raises where it cannot), ``'auto'`` does the same but, where
no such directory is set or ``transformers`` is missing, degrades to no
rerank, and ``'none'`` never reranks.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, List, Optional, Union

import numpy as np
import torch

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.preprocessor.image import load_image, resize_image
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.preprocessor.text import TextPreprocess, TextPreprocessConfig

logger = logging.getLogger(__name__)


@dataclass
class ImageVqganPreprocessConfig(TextPreprocessConfig):
    code_image_size: int = 256
    num_codes: int = 8192
    vqgan_weights: Optional[str] = None
    constraint_decoding: bool = True
    rerank: str = "auto"            # 'clip' | 'auto' | 'none'
    clip_model: Optional[str] = None


@register_config("ofasys.preprocess", "image_vqgan", ImageVqganPreprocessConfig)
class ImageVqganPreprocess(TextPreprocess):
    def __init__(self, global_dict, cfg: ImageVqganPreprocessConfig):
        super().__init__(global_dict, cfg)
        self.code_start, self.code_end = global_dict.add_namespace("<code>", cfg.num_codes)
        self.device: Optional[torch.device] = None
        self._tokenizer = None
        self.rerank_scorer = None
        self._clip = None

    def to(self, device: Union[str, torch.device]) -> "ImageVqganPreprocess":
        """Run the tokenizer on ``device`` (moved there if already built)."""
        self.device = torch.device(device)
        if self._tokenizer is not None:
            self._tokenizer.to(self.device)
        if self._clip:
            self._clip[0].to(self.device)
        return self

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            from ofasys_torch.model.vqgan import VQGANTokenizer

            self._tokenizer = VQGANTokenizer(
                code_image_size=self.cfg.code_image_size, n_embed=self.cfg.num_codes,
                weights_path=self.cfg.vqgan_weights, device=self.device or "cuda",
            )
        return self._tokenizer

    @property
    def constraint_range(self) -> Optional[str]:
        """The decode-time sub-vocabulary of the ``<code>_*`` tokens;
        ``constraint_decoding=False`` opts out."""
        if not self.cfg.constraint_decoding:
            return None
        return f"{self.code_start},{self.code_end}"

    def encode_image(self, value: Any) -> np.ndarray:
        arr = resize_image(load_image(value), self.cfg.code_image_size) / 255.0
        codes = self.tokenizer.encode(arr[None])[0]
        return (codes + self.code_start).astype(np.int32)

    def map(self, slot: Slot) -> Slot:
        if not slot.is_src and slot.value is None:
            return self.dummy_slot(slot)
        if isinstance(slot.value, dict) and "inputs" in slot.value:
            return slot
        v = slot.value
        if not (isinstance(v, np.ndarray) and v.dtype.kind == "i"):     # else code tokens already
            v = self.encode_image(v)
        slot.value = v
        return TextPreprocess.map(self, slot)

    def _codes(self, tokens: np.ndarray) -> np.ndarray:
        """The code ids of a hypothesis's ``<code>`` tokens, zero-padded or
        cut to one image."""
        t = np.asarray(tokens).reshape(-1)
        codes = (t[(t >= self.code_start) & (t < self.code_end)] - self.code_start).astype(np.int32)
        n = self.tokenizer.codes_per_image
        if len(codes) < n:
            codes = np.concatenate([codes, np.zeros(n - len(codes), np.int32)])
        return codes[:n]

    def decode(self, tokens: np.ndarray, **kwargs) -> np.ndarray:
        return self.tokenizer.decode(self._codes(tokens)[None])[0]

    def decode_batch(self, tokens_list: List[np.ndarray]) -> np.ndarray:
        """Every hypothesis's codes in one VQGAN pass: (N, H, W, 3)."""
        return self.tokenizer.decode(np.stack([self._codes(t) for t in tokens_list]))

    def rerank_scores(self, images: np.ndarray, text: str) -> Optional[np.ndarray]:
        """Scores of N candidate images for the query text, or None where no
        scorer is available (no rerank)."""
        if self.rerank_scorer is not None:
            return np.asarray(self.rerank_scorer(images, text), np.float32)
        if self.cfg.rerank == "none":
            return None
        clip = self._load_clip()
        if clip is None:
            return None
        model, proc = clip
        device = next(model.parameters()).device
        pil = [np.clip(im * 255.0, 0, 255).astype(np.uint8) for im in images]
        inputs = proc(text=[str(text)], images=pil, return_tensors="pt", padding=True)
        with torch.no_grad():
            out = model(**{k: v.to(device) for k, v in inputs.items()})
        return out.logits_per_image[:, 0].float().cpu().numpy()

    def _load_clip(self):
        """(CLIPModel on the tokenizer's device, CLIPProcessor), or None
        under 'auto' where no weights directory is set or ``transformers``
        is missing. Weights that are there but do not load raise."""
        if self._clip is None:
            path = self.cfg.clip_model or os.environ.get("OFA_CLIP_PATH")
            try:
                if not path or not os.path.isdir(path):
                    raise FileNotFoundError(f"no CLIP weights directory (clip_model or "
                                            f"OFA_CLIP_PATH: {path!r})")
                from transformers import CLIPModel, CLIPProcessor
            except (FileNotFoundError, ImportError) as e:
                if self.cfg.rerank == "clip":
                    raise
                logger.info("image_vqgan: no CLIP rerank (%s)", e)
                self._clip = False            # 'auto': no rerank, decided once
                return None
            model = CLIPModel.from_pretrained(path, local_files_only=True)
            self._clip = (model.to(self.device or torch.device("cuda")).eval(),
                          CLIPProcessor.from_pretrained(path, local_files_only=True))
        return self._clip or None

    def postprocess(self, outputs, sample):
        outs = outputs if isinstance(outputs, list) else [outputs]
        with_tokens = [o for o in outs if getattr(o, "tokens", None) is not None]
        if with_tokens:
            for o, im in zip(with_tokens, self.decode_batch([o.tokens for o in with_tokens])):
                o.image = im
        return outputs
