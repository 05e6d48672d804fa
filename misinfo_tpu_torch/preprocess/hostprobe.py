"""Host-prep capacity probe: the image-prep half of
``misinfo_tpu/preprocess/hostprobe.py``.

Image-bearing requests pay a host cost before the device program runs:
the decode and two 224 px resizes of every image. ``probe_host_prep``
measures THIS host once (a synthetic 1080p JPEG through the exact serving
prep path, exact and reduced ``fast_decode``) and ``recommend`` turns the
numbers into a recommendation, surfaced in the engine's verbose banner and
``/metrics`` (``host_prep``).

Not carried (ROADMAP.md M15): the host↔device link probe and the
``MISINFO_TPU_HOST_POLICY=auto`` policy built on it.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np

# module-level cache: the probe measures the host, not the engine, so one
# result serves every engine in the process
_cache: Optional[Dict] = None


def probe_host_prep(res: int = 1080, trials: int = 3,
                    image_size: int = 224) -> Dict:
    """Measure this host's per-image serving prep (JPEG decode + both 224
    px resizes, the engine's ``_image_batch`` path) at ``res``p, for the
    exact and the reduced (``fast_decode``) decode. Returns per-image ms
    and the whole-host images/s ceilings (cores × 1/per-image). Cached per
    process (~0.3 s on one core)."""
    global _cache
    if _cache is not None and _cache["probe_resolution"] == res:
        return _cache
    from misinfo_tpu_torch.preprocess.image import decode_rgb, image_to_array

    h, w = res, res * 16 // 9
    y = np.linspace(0, 255, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 255, w, dtype=np.float32)[None, :]
    rgb = np.stack([y + 0 * x, 0 * y + x, (y + x) / 2], -1).astype(np.uint8)
    rgb ^= np.random.default_rng(0).integers(0, 16, rgb.shape).astype(
        np.uint8)
    fd, path = tempfile.mkstemp(suffix=".jpg", prefix=f"hostprobe_{res}_")
    os.close(fd)
    try:
        from PIL import Image
        Image.fromarray(rgb).save(path, quality=90)

        def one(fast: bool, resize: bool = True) -> float:
            best = float("inf")
            for _ in range(trials):
                t0 = time.perf_counter()
                arr = decode_rgb(path, fast=fast)
                if resize:
                    image_to_array(arr, "effnet", image_size)
                    image_to_array(arr, "clip", image_size)
                best = min(best, time.perf_counter() - t0)
            return best * 1000.0

        one(False)  # warm caches/allocators outside the timed trials
        exact_ms = one(False)
        fast_ms = one(True)
        decode_ms = one(False, resize=False)
    finally:
        try:
            os.remove(path)
        except OSError:
            pass

    cores = os.cpu_count() or 1
    _cache = {
        "cores": cores,
        "probe_resolution": res,
        "exact_ms_per_image": round(exact_ms, 2),
        "fast_ms_per_image": round(fast_ms, 2),
        # decode-only split: (exact - decode) is the per-image host resize
        # work that device_resize moves onto the card
        "decode_ms_per_image": round(decode_ms, 2),
        # the engine's prep pool threads across cores (forensics._prep_map)
        "exact_ceiling_images_per_s": round(cores * 1000.0 / exact_ms, 1),
        "fast_ceiling_images_per_s": round(cores * 1000.0 / fast_ms, 1),
    }
    return _cache


# the rate the card takes full-modality requests at: the port's full
# b32/S512 batch with CUDA graphs ran 228.73-349.06 verdicts/s on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 26, PERF.md §6);
# the bar the host must clear for the card to stay the binding constraint
DEVICE_IMAGES_PER_S = 300.0


def recommend(probe: Optional[Dict] = None,
              device_images_per_s: float = DEVICE_IMAGES_PER_S) -> Dict:
    """Turn a probe into a policy: is THIS host the serving ceiling for
    image traffic, and which knobs close the gap. A pure function of the
    probe."""
    p = probe or probe_host_prep()
    exact = p["exact_ceiling_images_per_s"]
    fast = p["fast_ceiling_images_per_s"]
    host_bound = exact < device_images_per_s
    rec = {
        "host_bound_at_probe_res": host_bound,
        "fast_decode_recommended": bool(host_bound and fast > exact * 1.3),
        "probe": p,
    }
    if not host_bound:
        rec["summary"] = (
            f"host prep ceiling ~{exact:.0f} images/s ≥ device "
            f"~{device_images_per_s:.0f} — host is not the serving "
            "constraint at the probe resolution")
        return rec
    hints = []
    if rec["fast_decode_recommended"]:
        hints.append(
            f"MISINFO_TPU_FAST_DECODE=1 lifts it to ~{fast:.0f} "
            "(reduced JPEG decode; ≤480p frames decode bit-identically)")
    hints.append(
        "MISINFO_TPU_DEVICE_RESIZE=1 moves the two resizes per image "
        "onto the card")
    rec["summary"] = (
        f"host prep ceiling ~{exact:.0f} images/s on {p['cores']} core(s) "
        f"< device ~{device_images_per_s:.0f} — image traffic is "
        f"HOST-bound at {p['probe_resolution']}p. " + "; ".join(hints))
    return rec
