"""Image frontend: host-side decode/resize, device-side normalize.

Host copy of ``misinfo_tpu/preprocess/image.py``, importable without JAX,
Pillow or OpenCV: both libraries load at first use, and an ndarray input
is taken as decoded pixels, so a uint8 ``size x size x 3`` array passes
through with neither (squash and center-crop at equal size are
identities). Held to the original by tests/test_torch_host.py.

Split per SURVEY.md §7 design move 6 — decode and resize stay on host
(PIL), while float conversion + per-channel normalization run on device
as the first fused stage of the signal program, in NHWC layout (TPU conv
native layout).

Two resize flavors replicate the reference exactly:

* **EfficientNet path** — `Resize((224,224))` bilinear squash + ImageNet
  stats (reference misinfo_forensics.py:249-253).
* **CLIP path** — shortest-edge 224 bicubic + center-crop 224 + CLIP stats
  (HF CLIPProcessor behavior invoked at reference misinfo_forensics.py:386).

The CIFAKE trainer's CLIP-stat variant for EfficientNet inputs (reference
train_cifake_forensics.py:44,50) is covered by passing ``stats='clip'``.
"""

from __future__ import annotations

import os

import numpy as np


def _pil():
    """PIL's ``Image`` module, imported at first use; None when absent."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        return None
    return Image


def _cv():
    """The ``cv2`` module, imported at first use; None when absent."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return None
    return cv2

# Host resize backend. PIL replicates torchvision/CLIPProcessor antialiased
# filters exactly but is several times slower than cv2 on one core, enough
# to cap end-to-end serving throughput below the device program's. cv2
# diverges slightly at the pixel level (INTER_AREA downscale ≈
# antialiased). "auto" → cv2 when importable. Pin "pil" for bit-exact
# reference preprocessing (the parity harness feeds raw arrays and is
# unaffected either way).
_BACKEND = os.environ.get("MISINFO_TPU_IMAGE_BACKEND", "auto")


def set_image_backend(name: str) -> None:
    """'auto' | 'pil' | 'cv2' (module-wide; engine honors config)."""
    global _BACKEND
    if name not in ("auto", "pil", "cv2"):
        raise ValueError(name)
    _BACKEND = name


def _use_cv2() -> bool:
    return (_cv() is not None) if _BACKEND == "auto" else _BACKEND == "cv2"


# Opt-in DCT-domain reduced JPEG decode (libjpeg 1/2^n scaled decode via
# cv2.IMREAD_REDUCED_COLOR_* or PIL's Image.draft). On a host with few
# cores the serving ceiling can be the JPEG decode itself; decoding
# frames whose short side stays ≥ _FAST_DECODE_FLOOR pixels keeps every
# later resize a ≥2× antialiased downscale to the 224px targets.
# Documented divergence from the reference's full decode (PIL-level pixel
# deltas only on large frames); off by default.
_FAST_DECODE = os.environ.get("MISINFO_TPU_FAST_DECODE", "0") == "1"
_FAST_DECODE_FLOOR = 448  # 2 × the 224px model inputs


def set_fast_decode(on: bool) -> None:
    """Module-wide default for :func:`decode_rgb`'s ``fast`` argument
    (engine honors ``ServingConfig.fast_decode`` per call instead)."""
    global _FAST_DECODE
    _FAST_DECODE = bool(on)


def _reduced_factor(path, floor: int = _FAST_DECODE_FLOOR) -> int:
    """Largest k in {8,4,2} keeping the JPEG's short side ≥ ``floor`` after
    a 1/k scaled decode; 1 for non-JPEG files, small frames, or unreadable
    headers (PIL's lazy open reads only the header)."""
    Image = _pil()
    if Image is None:
        return 1
    try:
        with Image.open(str(path)) as im:
            if im.format != "JPEG":
                return 1
            w, h = im.size
    except Exception:
        return 1
    for k in (8, 4, 2):
        if min(w, h) >= floor * k:
            return k
    return 1

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def load_image_rgb(image_or_path) -> "Image.Image":
    """PIL load + RGB convert (reference misinfo_forensics.py:255-258)."""
    Image = _pil()
    if Image is None:
        raise RuntimeError("Pillow is required for image decoding")
    if isinstance(image_or_path, Image.Image):
        return image_or_path.convert("RGB")
    if isinstance(image_or_path, np.ndarray):
        return Image.fromarray(image_or_path).convert("RGB")
    return Image.open(str(image_or_path)).convert("RGB")


def resize_squash(img: "Image.Image", size: int = 224) -> np.ndarray:
    """torchvision `Resize((size,size))` semantics → uint8 HWC."""
    Image = _pil()
    return np.asarray(img.resize((size, size), Image.BILINEAR), dtype=np.uint8)


def _hf_resize_dims(w: int, h: int, size: int):
    """HF ``get_resize_output_image_size`` (shortest_edge mode): the long
    edge is the TRUNCATING ``int(size * long / short)`` — not a rounded
    scale multiply, which differs by one pixel for many aspect ratios and
    shifts every pixel of the resize + crop window."""
    short, long_ = (w, h) if w <= h else (h, w)
    new_long = int(size * long_ / short)
    return (size, new_long) if w <= h else (new_long, size)


def resize_center_crop(img: "Image.Image", size: int = 224) -> np.ndarray:
    """CLIPProcessor semantics: shortest edge → `size` (bicubic), center crop."""
    Image = _pil()
    w, h = img.size
    nw, nh = _hf_resize_dims(w, h, size)
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, dtype=np.uint8)


def decode_rgb(image_or_path, fast: bool | None = None) -> np.ndarray:
    """Decode once to uint8 HWC RGB (backend-aware). Feed the result to
    image_to_array for each resize flavor to avoid double decoding.

    ``fast=True`` (default from ``MISINFO_TPU_FAST_DECODE`` /
    :func:`set_fast_decode`) enables the reduced JPEG decode for path
    inputs — see :func:`_reduced_factor`; arrays/PIL images and non-JPEG
    files always take the exact full decode."""
    fast = _FAST_DECODE if fast is None else fast
    if isinstance(image_or_path, np.ndarray):
        return _to_rgb_array(image_or_path)   # pixels: no decoder needed
    if fast and isinstance(image_or_path, (str, os.PathLike)):
        k = _reduced_factor(image_or_path)
        if k > 1:
            return _decode_reduced(image_or_path, k)
    if _use_cv2():
        return _to_rgb_array(image_or_path)
    return np.asarray(load_image_rgb(image_or_path), dtype=np.uint8)


def _decode_reduced(path, k: int) -> np.ndarray:
    """1/k scaled JPEG decode (k ∈ {2,4,8}): libjpeg downsamples in the
    DCT domain during entropy decode — ~k× cheaper than full decode and an
    ideal low-pass, the standard thumbnailing fast path."""
    if _use_cv2():
        cv2 = _cv()
        flag = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
                8: cv2.IMREAD_REDUCED_COLOR_8}[k]
        bgr = cv2.imread(str(path), flag)
        if bgr is None:
            raise FileNotFoundError(f"cannot decode image: {path}")
        return np.ascontiguousarray(bgr[..., ::-1])
    img = _pil().open(str(path))
    img.draft("RGB", (max(1, img.size[0] // k), max(1, img.size[1] // k)))
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def _to_rgb_array(image_or_path) -> np.ndarray:
    """Decode to uint8 HWC RGB without PIL when the cv2 backend is active."""
    if isinstance(image_or_path, np.ndarray):
        a = image_or_path
        if a.ndim == 2:
            a = np.stack([a] * 3, axis=-1)
        return np.ascontiguousarray(a[..., :3], dtype=np.uint8)
    Image = _pil()
    if Image is not None and isinstance(image_or_path, Image.Image):
        return np.asarray(image_or_path.convert("RGB"), dtype=np.uint8)
    cv2 = _cv()
    bgr = cv2.imread(str(image_or_path), cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(f"cannot decode image: {image_or_path}")
    return np.ascontiguousarray(bgr[..., ::-1])


def _cv2_squash(arr: np.ndarray, size: int) -> np.ndarray:
    cv2 = _cv()
    h, w = arr.shape[:2]
    interp = cv2.INTER_AREA if (h > size or w > size) else cv2.INTER_LINEAR
    return cv2.resize(arr, (size, size), interpolation=interp)


def _cv2_center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    cv2 = _cv()
    h, w = arr.shape[:2]
    nw, nh = _hf_resize_dims(w, h, size)
    interp = cv2.INTER_AREA if size < min(w, h) else cv2.INTER_CUBIC
    r = cv2.resize(arr, (nw, nh), interpolation=interp)
    left, top = (nw - size) // 2, (nh - size) // 2
    return np.ascontiguousarray(r[top:top + size, left:left + size])


def image_to_array(
    image_or_path,
    mode: str = "effnet",
    size: int = 224,
) -> np.ndarray:
    """Decode+resize one image → uint8 [size,size,3] (normalization is
    done on-device by :func:`misinfo_tpu_torch.ops.image_ops.normalize_images`)."""
    if mode not in ("effnet", "clip"):
        raise ValueError(mode)
    if (isinstance(image_or_path, np.ndarray) and image_or_path.ndim == 3
            and image_or_path.shape == (size, size, 3)
            and image_or_path.dtype == np.uint8):
        return image_or_path.copy()   # both resize flavors are identities
    if _use_cv2():
        arr = _to_rgb_array(image_or_path)
        return (_cv2_squash(arr, size) if mode == "effnet"
                else _cv2_center_crop(arr, size))
    img = load_image_rgb(image_or_path)
    if mode == "effnet":
        return resize_squash(img, size)
    return resize_center_crop(img, size)


def resize_param_row(h: int, w: int, out_size: int = 224) -> np.ndarray:
    """Per-image scalar inputs for the on-device resize
    (:mod:`misinfo_tpu_torch.ops.resize`): valid extents plus scale/offset
    per flavor. The CLIP flavor's intermediate dims use the exact
    truncating integer semantics of HF's shortest-edge resize
    (:func:`_hf_resize_dims`), computed here on host so the device sees
    only f32 scalars."""
    h, w = max(1, int(h)), max(1, int(w))
    nw, nh = _hf_resize_dims(w, h, out_size)
    top, left = (nh - out_size) // 2, (nw - out_size) // 2
    return np.array([h, w, h / out_size, w / out_size,
                     h / nh, top, w / nw, left], np.float32)


def shrink_to_staging(arr: np.ndarray, staging: int) -> np.ndarray:
    """Host pre-shrink for images exceeding the largest staging bucket:
    aspect-preserving area downscale so the frame fits ``staging`` on both
    sides. The subsequent on-device resize then runs on the shrunk frame —
    a two-stage resample (documented divergence from the single PIL pass;
    only frames beyond the last ``image_staging_buckets`` entry pay it)."""
    h, w = arr.shape[:2]
    if h <= staging and w <= staging:
        return arr
    sc = staging / max(h, w)
    nh, nw = max(1, int(h * sc)), max(1, int(w * sc))
    if _use_cv2():
        return _cv().resize(arr, (nw, nh), interpolation=_cv().INTER_AREA)
    Image = _pil()
    if Image is None:
        raise RuntimeError("Pillow or OpenCV is required to shrink an "
                           "image into its staging bucket")
    return np.asarray(
        Image.fromarray(arr).resize((nw, nh), Image.BILINEAR), np.uint8)


def stage_image_batch(arrays, staging: int, out_size: int = 224,
                      prep_map=None):
    """Decoded frames → (staged uint8 [N, staging, staging, 3],
    resize_params f32 [N, 8]) for :func:`ops.resize.device_resize_pair`.

    Each frame sits in the top-left corner, zero-padded; ``None`` entries
    (missing media) stage as all-zero frames with identity params, so the
    device resize reproduces the zero-fill contract exactly (reference
    misinformation_dataset.py:186-189). Frames larger than ``staging`` are
    pre-shrunk on host (:func:`shrink_to_staging`).

    ``prep_map(fn, items)`` (the engine's thread pool) parallelizes the
    per-image shrink + buffer copy across host cores — rows are disjoint,
    and cv2/PIL/large numpy copies release the GIL."""
    n = len(arrays)
    staged = np.zeros((n, staging, staging, 3), np.uint8)
    params = np.tile(resize_param_row(out_size, out_size, out_size), (n, 1))

    def place(item):
        i, a = item
        if a is None:
            return
        a = shrink_to_staging(a, staging)
        h, w = a.shape[:2]
        staged[i, :h, :w] = a
        params[i] = resize_param_row(h, w, out_size)

    items = list(enumerate(arrays))
    if prep_map is None:
        for it in items:
            place(it)
    else:
        prep_map(place, items)
    return staged, params


def choose_staging_bucket(max_dim: int, buckets) -> int:
    """Smallest staging bucket covering ``max_dim`` (last bucket if none —
    oversize frames are then host-shrunk into it)."""
    for b in buckets:
        if max_dim <= b:
            return b
    return buckets[-1]


def batch_images(arrays, size: int = 224) -> np.ndarray:
    """Stack uint8 HWC arrays → [B,size,size,3]; None entries become zeros
    (missing-media zero-fill contract, reference misinformation_dataset.py:186-189)."""
    out = np.zeros((len(arrays), size, size, 3), dtype=np.uint8)
    for i, a in enumerate(arrays):
        if a is not None:
            out[i] = a
    return out
