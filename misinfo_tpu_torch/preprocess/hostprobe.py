"""Host-prep capacity probe and the serving auto-policy: the port of
``misinfo_tpu/preprocess/hostprobe.py``.

Image-bearing requests pay a host cost before the device program runs:
the decode and two 224 px resizes of every image. ``probe_host_prep``
measures THIS host once (a synthetic 1080p JPEG through the exact serving
prep path, exact and reduced ``fast_decode``) and ``recommend`` turns the
numbers into a recommendation, surfaced in the engine's verbose banner and
``/metrics`` (``host_prep``).

``device_resize``'s trade also depends on the host→card LINK, so
``probe_link`` measures that: the cost per image of copying one staged
S² uint8 frame from pinned host memory, against the two 224² crops it
replaces. ``auto_policy`` is the ``MISINFO_TPU_HOST_POLICY=auto``
decision: ``fast_decode`` on for host-bound image prep, ``device_resize``
on only when the link's extra copy is under half the host resize work it
saves (a 2× margin). Explicit ``MISINFO_TPU_FAST_DECODE`` /
``MISINFO_TPU_DEVICE_RESIZE`` always win (core/config.py::from_env).
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


_link_cache: Optional[Dict] = None


def _device_platform() -> str:
    """The platform the engine boots on by default: "cuda" where a card is
    usable (``MisinfoForensics(device="cuda")``), else "cpu"."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def probe_link(staging: int = 640, image_size: int = 224,
               iters: int = 16) -> Optional[Dict]:
    """Measure THIS host→card link's side of the device_resize trade: the
    cost per image of one staged ``staging``² uint8 frame against the two
    ``image_size``² crops it replaces, each copied the way the engine
    copies a request's input (pinned, then an asynchronous copy:
    engine/forensics.py::_stage, ops/graphs.py::Runner.copy_in), over
    ``iters`` images. One element of every copied buffer goes into a
    single device sum that is read back once, so the time closes on the
    data having arrived. Cached per process; None without a CUDA
    device."""
    global _link_cache
    if _link_cache is not None:
        return _link_cache
    import torch
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda", torch.cuda.current_device())

    def amortized_ms(shape) -> float:
        rng = np.random.default_rng(0)
        arrs = [torch.from_numpy(rng.integers(0, 255, shape).astype(np.uint8))
                for _ in range(iters)]
        # warm one copy and read outside the timing
        float(arrs[0].pin_memory().to(dev, non_blocking=True).sum())
        t0 = time.perf_counter()
        xs = [a.pin_memory().to(dev, non_blocking=True) for a in arrs]
        float(torch.stack([x.reshape(-1)[0] for x in xs]).sum())  # one read
        return (time.perf_counter() - t0) / iters * 1000.0

    staged_ms = amortized_ms((staging, staging, 3))
    crops_ms = amortized_ms((2, image_size, image_size, 3))
    _link_cache = {
        "platform": "cuda",
        "staging": staging,
        "staged_h2d_ms_per_image": round(staged_ms, 3),
        "crops_h2d_ms_per_image": round(crops_ms, 3),
        "delta_ms_per_image": round(staged_ms - crops_ms, 3),
    }
    return _link_cache


def auto_policy(allow_fast_decode: bool = True,
                allow_device_resize: bool = True) -> Dict:
    """The MISINFO_TPU_HOST_POLICY=auto decision: probe the host (and, where
    the engine runs on a CUDA card, the host→card link) once and return
    the ServingConfig field overrides to apply. ``fast_decode`` flips on
    for host-bound image prep; ``device_resize`` flips on only when the
    measured extra copy of staged frames is under HALF the host resize
    work it eliminates. Explicit env vars suppress the corresponding knob
    via the allow_* flags (core/config.from_env)."""
    rec = recommend()
    out = {}
    if allow_fast_decode and rec["fast_decode_recommended"]:
        out["fast_decode"] = True
    if allow_device_resize:
        p = rec["probe"]
        resize_ms = max(p["exact_ms_per_image"]
                        - p.get("decode_ms_per_image", 0.0), 0.0)
        link = None
        if _device_platform() == "cuda" and resize_ms > 0:
            link = probe_link()
        if link is not None and link["delta_ms_per_image"] < 0.5 * resize_ms:
            out["device_resize"] = True
    return out
