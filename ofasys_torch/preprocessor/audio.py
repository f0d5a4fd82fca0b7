"""Audio preprocessors (counterpart of ofasys_tpu/preprocessor/audio.py).

``audio`` — source side (ASR input): waveform -> log-mel fbank -> CMVN ->
SpecAugment (train split, from the preprocessor's own numpy generator) ->
(T, n_mels) float frames, padded per batch. Target side (TTS output):
fbank frames packed ``n_frames_per_step`` a row, with their lengths;
``decode`` inverts them with Griffin-Lim.

``audio_embed`` — precomputed dense audio feature embeddings cut to a
fixed-length window.

Host-side numpy throughout, the same operations in the same order as
ofasys_tpu's, so a sample's arrays are bit for bit the same.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.preprocessor.base import (
    BasePreprocess,
    CollateOutput,
    PreprocessConfig,
    PreprocessSkipException,
)
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.preprocessor.utils import collate_arrays
from ofasys_torch.utils.audio_utils import (
    apply_cmvn,
    griffin_lim,
    load_wav,
    logmel_fbank,
    spec_augment,
)


@dataclass
class AudioPreprocessConfig(PreprocessConfig):
    sample_rate: int = 16000
    num_mels: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    specaugment: bool = True
    cmvn: str = "utterance"       # 'utterance' | 'global' | 'none'
    # corpus-level CMVN stats: .npz with 'mean' and 'std' arrays of shape (num_mels,)
    gcmvn_stats_path: Optional[str] = None
    max_frames: int = 1024
    n_frames_per_step: int = 1    # TTS frame packing
    seed: int = 1
    pad_to_fixed: bool = False    # pad every batch to max_frames


@register_config("ofasys.preprocess", "audio", AudioPreprocessConfig)
class AudioPreprocess(BasePreprocess):
    def __init__(self, global_dict, cfg: AudioPreprocessConfig):
        super().__init__(global_dict, cfg)
        self.rng = np.random.default_rng(cfg.seed)
        self.gcmvn_mean: Optional[np.ndarray] = None
        self.gcmvn_std: Optional[np.ndarray] = None
        if cfg.cmvn == "global":
            if not cfg.gcmvn_stats_path:
                raise ValueError("cmvn='global' requires gcmvn_stats_path (.npz with mean/std)")
            stats = np.load(cfg.gcmvn_stats_path)
            self.gcmvn_mean = np.asarray(stats["mean"], np.float32)
            self.gcmvn_std = np.asarray(stats["std"], np.float32)

    def gcmvn_stats(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(mean, std) of the corpus-level CMVN, or None."""
        if self.gcmvn_mean is None:
            return None
        return self.gcmvn_mean, self.gcmvn_std

    def extract(self, value: Any) -> np.ndarray:
        """A wav (path, bytes, (samples, rate) or 1-D array) or a
        precomputed (T, n_mels) fbank -> normalized (T, n_mels) frames."""
        if isinstance(value, np.ndarray) and value.ndim == 2:
            feats = value.astype(np.float32)      # precomputed fbank
        else:
            wav, sr = load_wav(value)
            feats = logmel_fbank(
                wav, sr, self.cfg.num_mels, self.cfg.frame_length_ms, self.cfg.frame_shift_ms
            )
        if self.cfg.cmvn == "utterance":
            feats = apply_cmvn(feats)
        elif self.cfg.cmvn == "global":
            feats = (feats - self.gcmvn_mean) / self.gcmvn_std
        return feats[: self.cfg.max_frames]

    def map(self, slot: Slot) -> Slot:
        if not slot.is_src and slot.value is None:
            # open TTS target: no frame yet
            n = self.cfg.num_mels * self.cfg.n_frames_per_step
            slot.value = {"inputs": np.zeros((0, n), np.float32)}
            return slot
        if isinstance(slot.value, dict) and "inputs" in slot.value:
            return slot
        feats = self.extract(slot.value)
        if slot.is_src and slot.split == "train" and self.cfg.specaugment:
            feats = spec_augment(feats, self.rng)
        k = self.cfg.n_frames_per_step
        if not slot.is_src and k > 1:
            T = (feats.shape[0] // k) * k
            feats = feats[:T].reshape(T // k, self.cfg.num_mels * k)
        slot.value = {"inputs": feats}
        return slot

    def collate(self, slots: List[Slot]) -> CollateOutput:
        """Frames padded with 0.0 (the mean after utterance CMVN) to the
        batch's longest, rounded up to ``pad_to_multiple``, with the true
        lengths."""
        feats = [s.value["inputs"] for s in slots]
        fixed = self.cfg.max_frames if self.cfg.pad_to_fixed else None
        batch = collate_arrays(feats, pad_value=0.0,
                               pad_to_multiple=self.cfg.pad_to_multiple,
                               pad_to_length=fixed)
        lengths = np.asarray([f.shape[0] for f in feats], np.int32)
        value = {"inputs": batch, "lengths": lengths}
        sb = self.to_slot_batch(slots[0], value)
        if slots[0].is_src:
            return CollateOutput(sb)
        # TTS target: feature regression target + eos supervision
        extra = {
            "target": batch,
            "target_lengths": lengths,
            "ntokens": int(lengths.sum()),
        }
        return CollateOutput(sb, sb, extra)

    def decode(self, feature: np.ndarray, **kwargs) -> np.ndarray:
        """Mel frames -> waveform through Griffin-Lim."""
        k = self.cfg.n_frames_per_step
        if k > 1:
            feature = feature.reshape(-1, self.cfg.num_mels)
        return griffin_lim(
            feature, self.cfg.sample_rate, self.cfg.num_mels,
            self.cfg.frame_length_ms, self.cfg.frame_shift_ms,
        )

    def postprocess(self, outputs, sample):
        for out in outputs if isinstance(outputs, list) else [outputs]:
            if getattr(out, "feature", None) is not None:
                out.waveform = self.decode(np.asarray(out.feature))
        return outputs


@dataclass
class AudioEmbedPreprocessConfig(PreprocessConfig):
    audio_feature_dim: int = 439
    audio_feature_length: int = 384


@register_config("ofasys.preprocess", "audio_embed", AudioEmbedPreprocessConfig)
class AudioEmbedPreprocess(BasePreprocess):
    """Precomputed dense audio feature embeddings: the slot carries either
    a (T, dim) float array or {'data': base64 of big-endian float32,
    'start_index': i}; a fixed-length (audio_feature_length, dim) window is
    cut and zero-padded, then batches stack to (B, L, dim)."""

    def _unpack(self, value: Any) -> Tuple[np.ndarray, int]:
        if isinstance(value, dict):
            raw = value["data"]
            buf = base64.b64decode(raw) if isinstance(raw, (str, bytes)) else raw
            dim = self.cfg.audio_feature_dim
            m_len = len(buf) // dim // 4
            feats = np.frombuffer(buf, dtype=">f4", count=m_len * dim).reshape(m_len, dim)
            return feats.astype(np.float32), int(value.get("start_index", 0))
        feats = np.asarray(value, np.float32)
        if feats.ndim != 2:
            raise PreprocessSkipException(
                f"audio_embed expects (T, dim) features, got shape {feats.shape}")
        return feats, 0

    def map(self, slot: Slot) -> Slot:
        if isinstance(slot.value, dict) and "inputs" in slot.value:
            return slot
        feats, start = self._unpack(slot.value)
        L = self.cfg.audio_feature_length
        feats = feats[start: start + L]
        if feats.shape[0] < L:
            feats = np.concatenate(
                [feats, np.zeros((L - feats.shape[0], feats.shape[1]), np.float32)])
        slot.value = {"inputs": feats}
        return slot

    def collate(self, slots: List[Slot]) -> CollateOutput:
        batch = np.stack([s.value["inputs"] for s in slots])   # (B, L, dim)
        lengths = np.full((batch.shape[0],), batch.shape[1], np.int32)
        return CollateOutput(self.to_slot_batch(slots[0], {"inputs": batch, "lengths": lengths}))
