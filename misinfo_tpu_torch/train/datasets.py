"""Training data pipeline — host copy of ``misinfo_tpu/train/datasets.py``
(numpy and PIL only; held to the original by tests/test_torch_host.py).

Re-designs the reference's `MisinfoDataset` (misinformation_dataset.py) as a
numpy batch iterator feeding fixed-shape arrays to the train steps:

  * dual tokenization (CLIP 77 + RoBERTa, both fixed length, reference
    :142-170)
  * train-time image augmentations — horizontal flip, color jitter,
    gaussian blur (p=0.3), and random JPEG re-compression quality 40-80
    (the reference's RandomJPEGCompression, :18-57) — vs clean eval
    transforms (:128-136)
  * video → 3 equidistant frames (:191-251)
  * zero-fill for missing/failed media (:280,288,189,251)

Augmentations run on the host with numpy/PIL; normalization runs on the
device (ops/image_ops.py). Batches are yielded as uint8 NHWC + int32
tokens.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from misinfo_tpu_torch.preprocess.image import load_image_rgb, resize_squash
from misinfo_tpu_torch.preprocess.tokenizer import _Batcher


def random_jpeg_compress(img_arr: np.ndarray, rng: np.random.Generator,
                         q_low: int = 40, q_high: int = 80) -> np.ndarray:
    """JPEG round-trip augmentation (reference misinformation_dataset.py:
    18-57): re-encode at a random quality to simulate social-media
    recompression artifacts."""
    from PIL import Image

    q = int(rng.integers(q_low, q_high + 1))
    buf = io.BytesIO()
    Image.fromarray(img_arr).save(buf, format="JPEG", quality=q)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"), dtype=np.uint8)


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2) -> np.ndarray:
    x = img.astype(np.float32)
    b = 1.0 + rng.uniform(-brightness, brightness)
    x = x * b
    c = 1.0 + rng.uniform(-contrast, contrast)
    mean = x.mean()
    x = (x - mean) * c + mean
    s = 1.0 + rng.uniform(-saturation, saturation)
    gray = x.mean(axis=2, keepdims=True)
    x = gray + (x - gray) * s
    return np.clip(x, 0, 255).astype(np.uint8)


def gaussian_blur(img: np.ndarray, rng: np.random.Generator,
                  p: float = 0.3) -> np.ndarray:
    if rng.uniform() >= p:
        return img
    from PIL import Image, ImageFilter

    radius = float(rng.uniform(0.1, 2.0))
    return np.asarray(Image.fromarray(img).filter(
        ImageFilter.GaussianBlur(radius)), dtype=np.uint8)


def train_augment(img: np.ndarray, rng: np.random.Generator,
                  jpeg: bool = True) -> np.ndarray:
    """Reference train transform stack (misinformation_dataset.py:104-125)."""
    if rng.uniform() < 0.5:
        img = img[:, ::-1]  # horizontal flip
    img = color_jitter(img, rng)
    img = gaussian_blur(img, rng)
    if jpeg:
        img = random_jpeg_compress(img, rng)
    return np.ascontiguousarray(img)


@dataclass
class Sample:
    text: str = ""
    image_path: Optional[str] = None
    video_path: Optional[str] = None
    label: int = 0


class MisinfoDataset:
    """Multimodal sample set with reference-equivalent item semantics."""

    def __init__(self, samples: Sequence[Sample],
                 roberta_tokenizer: _Batcher, clip_tokenizer: _Batcher,
                 image_size: int = 224, roberta_len: int = 77,
                 clip_len: int = 77, train: bool = True,
                 num_video_frames: int = 3, seed: int = 0):
        # NB: the reference tokenizes BOTH streams at max_length=77 during
        # training (misinformation_dataset.py:148,162)
        self.samples = list(samples)
        self.rt = roberta_tokenizer
        self.ct = clip_tokenizer
        self.image_size = image_size
        self.roberta_len = roberta_len
        self.clip_len = clip_len
        self.train = train
        self.num_video_frames = num_video_frames
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def _load_image(self, path: Optional[str]) -> np.ndarray:
        """Zero-fill on missing/unreadable media (reference :186-189)."""
        size = self.image_size
        if not path or not os.path.exists(str(path)):
            return np.zeros((size, size, 3), np.uint8)
        try:
            img = resize_squash(load_image_rgb(path), size)
        except Exception:
            return np.zeros((size, size, 3), np.uint8)
        if self.train:
            img = train_augment(img, self.rng)
            img = resize_squash(load_image_rgb(img), size)
        return img

    def _load_video(self, path: Optional[str]) -> np.ndarray:
        size, F = self.image_size, self.num_video_frames
        out = np.zeros((F, size, size, 3), np.uint8)
        if not path or not os.path.exists(str(path)):
            return out
        from misinfo_tpu_torch.preprocess.video import equidistant_frames

        frames = equidistant_frames(path, F)
        if frames is None:
            return out
        for i, f in enumerate(frames):
            if f is not None:
                out[i] = resize_squash(f, size)
        return out

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_remainder: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.samples))
        if shuffle:
            self.rng.shuffle(idx)
        for start in range(0, len(idx), batch_size):
            chunk = idx[start:start + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                break
            texts = [self.samples[i].text or "" for i in chunk]
            rb_ids, rb_mask = self.rt.batch(texts, self.roberta_len)
            cl_ids, cl_mask = self.ct.batch(texts, self.clip_len)
            images = np.stack([self._load_image(self.samples[i].image_path)
                               for i in chunk])
            batch = {
                "input_ids": rb_ids, "attention_mask": rb_mask,
                "clip_ids": cl_ids, "clip_mask": cl_mask,
                "images_u8": images,
                "labels": np.asarray([self.samples[i].label for i in chunk],
                                     np.int32),
            }
            if any(self.samples[i].video_path for i in chunk):
                batch["videos_u8"] = np.stack(
                    [self._load_video(self.samples[i].video_path) for i in chunk])
            yield batch

    def packed_batches(self, n_rows: int, n_slots: int,
                       shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Text-only batches packed to a static [n_rows, roberta_len] shape
        with up to n_slots requests (preprocess/packing.StreamPacker); for
        the packed text-head train step. Tokenization runs in chunks to
        amortize the tokenizer's batch call."""
        from misinfo_tpu_torch.preprocess.packing import StreamPacker, trim_padded

        pad_id = 1  # RoBERTa <pad>
        packer = StreamPacker(self.roberta_len, pad_id, n_rows, n_slots)
        idx = np.arange(len(self.samples))
        if shuffle:
            self.rng.shuffle(idx)

        def emit(out):
            packed, metas = out
            labels = np.zeros(n_slots, np.int32)
            valid = np.zeros(n_slots, np.float32)
            labels[: len(metas)] = metas
            valid[: len(metas)] = 1.0
            return {"input_ids": packed.ids,
                    "attention_mask": packed.mask,
                    "position_ids": packed.position_ids,
                    "segment_ids": packed.segment_ids,
                    "cls_rows": packed.cls_rows, "cls_cols": packed.cls_cols,
                    "labels": labels, "slot_valid": valid}

        CHUNK = 64
        for start in range(0, len(idx), CHUNK):
            chunk = idx[start:start + CHUNK]
            texts = [self.samples[i].text or "" for i in chunk]
            ids, mask = self.rt.batch(texts, self.roberta_len)
            for seq, i in zip(trim_padded(ids, mask), chunk):
                out = packer.add(seq, int(self.samples[i].label))
                if out is not None:
                    yield emit(out)
        tail = packer.flush()
        if tail is not None:
            yield emit(tail)


def prefetch(batch_iter, depth: int = 2):
    """Background-thread prefetcher: overlaps host-side augmentation /
    JPEG round-trips / tokenization with device compute. (The reference
    runs all DataLoaders with num_workers=0 — strictly serial host work,
    SURVEY.md §2.5.)"""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in batch_iter:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item


def pad_batch_to(batch: Dict[str, np.ndarray], size: int) -> Dict[str, np.ndarray]:
    """Pad a trailing partial batch up to `size` (static shapes)."""
    n = len(batch["labels"])
    if n == size:
        return batch
    out = {}
    for k, v in batch.items():
        pad = np.zeros((size - n,) + v.shape[1:], v.dtype)
        out[k] = np.concatenate([v, pad], axis=0)
    out["_valid"] = np.concatenate(
        [np.ones(n, np.bool_), np.zeros(size - n, np.bool_)])
    return out
