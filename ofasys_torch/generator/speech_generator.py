"""Autoregressive speech (TTS) generator (counterpart of
ofasys_tpu/generator/speech_generator.py).

An eager frame loop over ``decode_prepare`` and ``decode_step``: frame 0 is
a zero "go" frame; each step feeds the last frame (B, 1, M) through the
decoder (the prenet adaptor) and keeps the postnet-refined frame and an EOS
probability. A sample stops at the first step where sigmoid(eos) passes
``eos_prob_threshold``; a sample that never does has length ``max_iter``.
The loop ends when every sample has stopped, which is one host read of the
"all done" flag a step, or after ``max_iter`` steps. The prenet's dropout
stays on, drawn from a ``torch.Generator`` seeded with ``seed`` (ofasys_tpu
draws it from ``jax.random``, so the numbers differ). The frames are
gcmvn-denormalized when stats are given; so are the target features the
batch carries, each cut to its length.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ofasys_torch.generator.base import SpeechGeneratorOutput
from ofasys_torch.utils.pytree import SlotBatch, slots_to_device


class AutoRegressiveSpeechGenerator:
    def __init__(
        self,
        model,
        num_mels: int = 80,
        n_frames_per_step: int = 1,
        max_iter: int = 512,
        eos_prob_threshold: float = 0.5,
        gcmvn_stats: Optional[Any] = None,
    ):
        self.model = model
        self.num_mels = num_mels
        self.out_dim = num_mels * n_frames_per_step
        self.max_iter = max_iter
        self.eos_prob_threshold = eos_prob_threshold
        # corpus-level CMVN denormalization: (mean, std) arrays of shape
        # (num_mels,), or the path of an .npz holding them
        self.gcmvn_mean = self.gcmvn_std = None
        if gcmvn_stats is not None:
            if isinstance(gcmvn_stats, str):
                stats = np.load(gcmvn_stats)
                gcmvn_stats = (stats["mean"], stats["std"])
            self.gcmvn_mean = np.asarray(gcmvn_stats[0], np.float32)
            self.gcmvn_std = np.asarray(gcmvn_stats[1], np.float32)
        # the decoder reads positions 0..max_iter of its target adaptor
        rows = model.cfg.max_target_positions + 2
        if max_iter + 1 > rows:
            raise ValueError(f"max_iter={max_iter} needs {max_iter + 1} position rows; the "
                             f"decoder has {rows} (max_target_positions + 2)")

    @classmethod
    def for_preprocess(cls, model, general_preprocess=None, **kwargs) -> "AutoRegressiveSpeechGenerator":
        """The generator with the audio preprocessor's corpus-level CMVN
        stats for denormalization, unless ``kwargs`` gives ``gcmvn_stats``."""
        if "gcmvn_stats" not in kwargs and general_preprocess is not None:
            pre = general_preprocess.name2pre.get("audio")
            stats = pre.gcmvn_stats() if hasattr(pre, "gcmvn_stats") else None
            if stats is not None:
                kwargs["gcmvn_stats"] = stats
        return cls(model, **kwargs)

    def gcmvn_denormalize(self, frames: np.ndarray) -> np.ndarray:
        """x * std + mean over the mel axis; frames may be packed
        (T, num_mels * n_frames_per_step)."""
        if self.gcmvn_mean is None:
            return frames
        shape = frames.shape
        x = frames.reshape(-1, self.num_mels)
        x = x * self.gcmvn_std[None, :] + self.gcmvn_mean[None, :]
        return x.reshape(shape)

    @torch.no_grad()
    def decode(self, sample: Dict[str, Any], seed: int = 0):
        """(frames (B, max_iter, M), eos probabilities (B, max_iter),
        lengths (B,)) on the model's device; rows past a sample's stop keep
        the frames decoded after it."""
        net = self.model.net
        device = net.device
        slots = sample["net_input"]["slots"]
        src = slots_to_device([s for s in slots if s.is_src], device)
        tgt_slot = SlotBatch.target_slot(slots)
        enc = net.encode(src)
        B = enc.x.shape[0]
        T = self.max_iter
        dummy = dataclasses.replace(
            tgt_slot, value={"inputs": torch.zeros((B, T + 1, self.out_dim), device=device)})
        bias_spec, cross_bias, cache = net.decode_prepare([dummy], enc, T + 1)
        generator = torch.Generator(device=device).manual_seed(seed)

        frames = torch.zeros((B, T + 1, self.out_dim), dtype=torch.float32, device=device)
        eos_probs = torch.zeros((B, T + 1), dtype=torch.float32, device=device)
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        lengths = torch.full((B,), T, dtype=torch.long, device=device)
        step = 0
        while step < T and not bool(done.all()):
            mel, extra, cache = net.decode_step(frames[:, step:step + 1], step, enc, bias_spec,
                                                cross_bias, cache, tgt_slot, noise_generator=generator)
            eos_p = torch.sigmoid(extra["eos_logits"][:, -1].float())
            newly_done = (eos_p > self.eos_prob_threshold) & torch.logical_not(done)
            lengths = torch.where(newly_done, torch.full_like(lengths, step + 1), lengths)
            frames[:, step + 1] = mel[:, -1].float()
            eos_probs[:, step + 1] = eos_p
            done = done | newly_done
            step += 1
        return frames[:, 1:], eos_probs[:, 1:], lengths

    def generate(self, sample: Dict[str, Any], seed: int = 0) -> List[SpeechGeneratorOutput]:
        frames, eos_probs, lengths = self.decode(sample, seed)
        frames, eos_probs, lengths = frames.cpu().numpy(), eos_probs.cpu().numpy(), lengths.cpu().numpy()
        # the batch's ground-truth features ride along for comparison,
        # denormalized and cut to each sample's length
        targ = sample.get("target")
        targ = None if targ is None else np.asarray(targ.cpu() if torch.is_tensor(targ) else targ)
        targ_lens = sample.get("target_lengths")
        targ_lens = None if targ_lens is None else np.asarray(
            targ_lens.cpu() if torch.is_tensor(targ_lens) else targ_lens)
        outs = []
        for b in range(frames.shape[0]):
            L = int(lengths[b])
            tf = None
            if targ is not None and targ.ndim >= 3:
                tl = int(targ_lens[b]) if targ_lens is not None else targ.shape[1]
                tf = self.gcmvn_denormalize(targ[b, :tl])
            outs.append(SpeechGeneratorOutput(
                feature=self.gcmvn_denormalize(frames[b, :L]),
                eos_prob=eos_probs[b, :L],
                targ_feature=tf,
            ))
        return outs
