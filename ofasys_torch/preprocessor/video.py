"""Video preprocessor (counterpart of ofasys_tpu/preprocessor/video.py;
reference ofasys/preprocessor/default/video.py, 575 LoC).

Decodes to a fixed number of frames (uniform clip sampling), applies the
image pipeline per frame, emits (N, H, W, 3). Sources: ndarray (T,H,W,3),
list of PIL/arrays, GIF bytes/path via PIL, or .npy path. A video file
decodes through OpenCV or pyav where one is installed, else raises
ImportError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.preprocessor.base import CollateOutput, PreprocessSkipException
from ofasys_torch.preprocessor.image import ImagePreprocess, ImagePreprocessConfig, resize_image
from ofasys_torch.preprocessor.instruction import Slot


@dataclass
class VideoPreprocessConfig(ImagePreprocessConfig):
    num_frames: int = 8
    sample_mode: str = "uniform"    # 'uniform' | 'random' clip offsets
    # train-time augmentation (reference utils/video/{rand_augment,
    # random_erasing}.py): one RandAugment policy per clip (consistent
    # across frames) + per-frame random erasing
    video_rand_augment: bool = False
    random_erasing_prob: float = 0.0
    random_erasing_area: tuple = (0.02, 0.2)


@register_config("ofasys.preprocess", "video", VideoPreprocessConfig)
class VideoPreprocess(ImagePreprocess):
    def load_frames(self, value: Any) -> List[np.ndarray]:
        from PIL import Image

        if isinstance(value, np.ndarray) and value.ndim == 4:
            return [value[i] for i in range(value.shape[0])]
        if isinstance(value, (list, tuple)):
            from ofasys_torch.preprocessor.image import load_image

            return [load_image(v) for v in value]
        if isinstance(value, str) and value.endswith(".npy"):
            arr = np.load(value)
            return [arr[i] for i in range(arr.shape[0])]
        if isinstance(value, str) and value.lower().endswith(
            (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v")
        ):
            return self._decode_video(value)
        # animated image (GIF) path/bytes
        import io as _io

        img = Image.open(value if isinstance(value, str) else _io.BytesIO(value))
        frames = []
        try:
            for i in range(10000):
                img.seek(i)
                frames.append(np.asarray(img.convert("RGB"), np.float32))
        except EOFError:
            pass
        if not frames:
            raise PreprocessSkipException("no decodable frames")
        return frames

    def _decode_video(self, path: str) -> List[np.ndarray]:
        """Codec decode of a video file (reference
        preprocessor/default/video.py:104-170 uses decord/pyav). OpenCV's
        ffmpeg backend is the hermetic decoder here; pyav is the fallback
        when cv2 is unavailable. Frames return as RGB float32 HWC."""
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            cap = cv2.VideoCapture(path)
            if not cap.isOpened():
                raise PreprocessSkipException(f"cannot open video {path}")
            frames = []
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                frames.append(bgr[:, :, ::-1].astype(np.float32))
            cap.release()
            if not frames:
                raise PreprocessSkipException(f"no decodable frames in {path}")
            return frames
        try:
            import av
        except ImportError as e:
            raise ImportError(
                "video codec decode needs opencv-python (cv2) or pyav; "
                "neither is installed. Pre-extract frames to .npy / frame "
                "lists for fully hermetic pipelines."
            ) from e
        with av.open(path) as container:
            frames = [
                np.asarray(f.to_image(), np.float32)
                for f in container.decode(video=0)
            ]
        if not frames:
            raise PreprocessSkipException(f"no decodable frames in {path}")
        return frames

    def sample_frames(self, frames: List[np.ndarray], split: str) -> List[np.ndarray]:
        n = self.cfg.num_frames
        T = len(frames)
        if T >= n:
            if self.cfg.sample_mode == "random" and split == "train":
                offsets = sorted(self.rng.choice(T, size=n, replace=False))
            else:
                offsets = np.linspace(0, T - 1, n).round().astype(int)
        else:
            offsets = list(range(T)) + [T - 1] * (n - T)
        return [frames[int(i)] for i in offsets]

    def map(self, slot: Slot) -> Slot:
        if isinstance(slot.value, dict):
            return slot
        frames = self.sample_frames(self.load_frames(slot.value), slot.split)
        size = self.cfg.patch_image_size
        train = slot.split == "train"
        clip_aug = None
        if train and self.cfg.video_rand_augment:
            from ofasys_torch.utils.vision_helper import OPS

            # one sampled policy applied to EVERY frame of the clip so the
            # augmentation is temporally consistent
            names = self.rng.choice(list(OPS), size=2, replace=True)
            clip_aug = [OPS[n] for n in names]
        out = []
        for f in frames:
            f = resize_image(f, size, self.cfg.interpolation)
            if clip_aug is not None:
                for op in clip_aug:
                    f = op(f, 9)
            if train and self.cfg.random_erasing_prob > 0 and \
                    self.rng.random() < self.cfg.random_erasing_prob:
                f = self._random_erase(f)
            f = f / 255.0
            f = (f - np.asarray(self.cfg.mean, np.float32)) / np.asarray(self.cfg.std, np.float32)
            out.append(f.astype(np.float32))
        slot.value = {"inputs": np.stack(out)}     # (N, H, W, 3)
        return slot

    def _random_erase(self, f: np.ndarray) -> np.ndarray:
        h, w = f.shape[:2]
        lo, hi = self.cfg.random_erasing_area
        area = float(self.rng.uniform(lo, hi)) * h * w
        side = max(1, int(np.sqrt(area)))
        y = int(self.rng.integers(0, max(h - side, 1)))
        x = int(self.rng.integers(0, max(w - side, 1)))
        f = f.copy()
        f[y:y + side, x:x + side] = self.rng.normal(128.0, 32.0, (min(side, h - y), min(side, w - x), f.shape[2]))
        return f

    def collate(self, slots: List[Slot]) -> CollateOutput:
        videos = np.stack([s.value["inputs"] for s in slots])  # (B, N, H, W, 3)
        return CollateOutput(self.to_slot_batch(slots[0], {"inputs": videos}))
