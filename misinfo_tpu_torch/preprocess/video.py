"""Video frame sampling (host side).

Host copy of ``misinfo_tpu/preprocess/video.py``, importable without JAX,
OpenCV or Pillow (both load inside the functions); held to the original
by tests/test_torch_video.py.

Replicates the reference's sampling policy (analyze_video, reference
misinfo_forensics.py:508-556): frame stride = round(fps · stride_seconds)
with an fps fallback of 25, up to `max_frames` sampled frames. The frames
then become a *batch axis* of the video signal program instead of a Python
loop of per-frame model calls (SURVEY.md §7 design move 3).
"""

from __future__ import annotations

from typing import List

import numpy as np


def sample_video_frames(video_path: str, max_frames: int = 12,
                        stride_seconds: float = 1.0,
                        fps_fallback: float = 25.0):
    """→ (list of PIL RGB frames [≤max_frames], frame_valid bool [max_frames])."""
    try:
        import cv2
    except ImportError as e:  # same hard requirement as the reference (:502-506)
        raise RuntimeError(
            "opencv-python is required for video analysis") from e
    from PIL import Image

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"Could not open video: {video_path}")

    fps = cap.get(cv2.CAP_PROP_FPS)
    if not fps or fps <= 0:
        fps = fps_fallback
    frame_stride = max(1, int(round(fps * max(0.1, float(stride_seconds)))))

    frames: List = []
    frame_idx = 0
    while len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        if frame_idx % frame_stride == 0:
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames.append(Image.fromarray(rgb))
        frame_idx += 1
    cap.release()

    if not frames:
        raise RuntimeError("No frames could be read from the video.")

    valid = np.zeros((max_frames,), np.bool_)
    valid[: len(frames)] = True
    return frames, valid


def equidistant_frames(video_path: str, num_frames: int = 3):
    """Training-dataset variant: `num_frames` equidistant frames via
    linspace over the frame count (reference misinformation_dataset.py:
    191-251). Returns zeros-shaped placeholder list on failure (zero-fill
    contract, reference :251)."""
    try:
        import cv2
        from PIL import Image
    except ImportError:
        return None
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return None
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        cap.release()
        return None
    idxs = np.linspace(0, max(0, total - 1), num_frames).astype(int)
    frames = []
    for i in idxs:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, frame = cap.read()
        if not ok:
            frames.append(None)
            continue
        frames.append(Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)))
    cap.release()
    return frames
