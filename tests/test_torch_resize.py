"""The port's on-device resize (ops/resize.py) and its host staging
(preprocess/image.py) held to the JAX package on the CPU.

``device_resize_pair`` against the jitted JAX function on the same staged
frames: identity (224 → 224) and all-zero pad frames equal bit for bit;
resized frames within one uint8 level (two where the bicubic flavor
upscales more than 4×), on at most ``resize.TIE_SHARE`` of the pixels
(two f32 sum orders at a rounding tie: the share is measured and
asserted per flavor). The staging host functions bit for bit under
both host backends. The engine's staged path: at the model's own size the
device resize is an identity, so a ``device_resize`` engine scores as the
host path does, under the bf16 policy as under f32.
"""

import concurrent.futures
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from misinfo_tpu.ops import resize as j_resize
from misinfo_tpu.preprocess import image as j_image

from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine.forensics import MisinfoForensics as TEngine
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops import resize as t_resize
from misinfo_tpu_torch.preprocess import image as t_image

# a 640×360 video frame, down- and upscales, extreme aspects, 1×1
GEOMETRIES = [(360, 640), (480, 640), (640, 480), (100, 150), (31, 900),
              (257, 256), (1, 1), (223, 225), (16, 16), (224, 224)]


def _arrays(seed, geometries):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in geometries]


def _both(staged, params, out_size=224):
    """(JAX's jitted pair, the port's pair) as numpy arrays."""
    want = jax.jit(j_resize.device_resize_pair, static_argnums=2)(
        staged, params, out_size)
    got = t_resize.device_resize_pair(torch.from_numpy(staged),
                                      torch.from_numpy(params), out_size)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


def test_identity_and_zero_frames_equal_jax():
    """A frame at the output size resamples to itself bit for bit in both
    flavors (one-hot weight rows), and a missing frame stages as zeros
    with identity params and resamples to zeros."""
    a = _arrays(1, [(224, 224)] * 2)
    staged, params = t_image.stage_image_batch(a + [None], 256, 224)
    (je, jc), (te, tc) = _both(staged, params)
    for flavor in (te, tc):
        np.testing.assert_array_equal(flavor[:2], np.stack(a))
        assert not flavor[2].any()
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tc, jc)


def test_resized_frames_within_one_level_of_jitted_jax():
    """One level at most, but where the bicubic flavor upscales a short
    side more than 4× (31 → 224): there an intermediate pixel one level
    off weighs on several output rows, and one pixel of this input is two
    levels off (the JAX package's own test allows two against PIL)."""
    staged, params = t_image.stage_image_batch(_arrays(0, GEOMETRIES), 900,
                                               224)
    (je, jc), (te, tc) = _both(staged, params)
    for name, want, got in (("effnet", je, te), ("clip", jc, tc)):
        diff = np.abs(got.astype(int) - want.astype(int))
        share = float((diff > 0).mean())
        for i, (h, w) in enumerate(GEOMETRIES):
            steep = name == "clip" and 4 * min(h, w) < 224 < h * w
            assert diff[i].max() <= (2 if steep else 1), (name, h, w)
        assert (diff == 2).sum() <= 1
        # measured on this input: effnet 3.6e-4, clip 3.0e-5
        assert share <= t_resize.TIE_SHARE, (name, share)
        # the identity frame, last, is exact
        np.testing.assert_array_equal(got[-1], want[-1])


def test_resize_at_another_output_size():
    """The engine's tiny configurations resize to 64 px."""
    staged, params = t_image.stage_image_batch(
        _arrays(2, [(64, 96), (40, 40), (64, 64), (200, 90)]), 320, 64)
    (je, jc), (te, tc) = _both(staged, params, 64)
    for want, got in ((je, te), (jc, tc)):
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= t_resize.TIE_SHARE
        np.testing.assert_array_equal(got[2], want[2])


def test_axis_weights_and_rounding_match_jax():
    """The filter planes within an f32 ulp of XLA's (XLA fuses the Keys
    polynomial into FMAs and sums the window in another order); the PIL
    rounding bit for bit, ties and clamps included."""
    _, params = t_image.stage_image_batch(_arrays(3, GEOMETRIES), 900, 224)
    p, pt = jax.numpy.asarray(params), torch.from_numpy(params)
    for kind, scale, off in (("bilinear", 2, None), ("bicubic", 4, 5)):
        def jw(p):
            return j_resize._axis_weights(
                224, 900, p[:, 0], p[:, scale],
                p[:, off] if off else p[:, 0] * 0, kind)
        want = np.asarray(jax.jit(jw)(p))
        got = t_resize._axis_weights(
            224, 900, pt[:, 0], pt[:, scale],
            pt[:, off] if off else torch.zeros_like(pt[:, 0]), kind).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    x = np.array([-3.0, -0.5, 0.49999997, 0.5, 1.5, 2.5, 254.5, 255.4,
                  255.5, 300.0], np.float32)
    np.testing.assert_array_equal(
        t_resize._round_u8(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(j_resize._round_u8)(x)))
    assert t_resize.PARAM_FIELDS == j_resize.PARAM_FIELDS


@contextlib.contextmanager
def _backend(name):
    for m in (j_image, t_image):
        m.set_image_backend(name)
    try:
        yield
    finally:
        for m in (j_image, t_image):
            m.set_image_backend("auto")


@pytest.mark.parametrize("backend", ["cv2", "pil"])
def test_staging_host_functions_identical(backend):
    pytest.importorskip("cv2" if backend == "cv2" else "PIL")
    arrs = _arrays(4, [(700, 900), (90, 1400), (300, 200), (12, 7)])
    with _backend(backend):
        for h, w in ((1, 1), (360, 640), (640, 360), (224, 224), (31, 900)):
            for out in (224, 64):
                np.testing.assert_array_equal(
                    t_image.resize_param_row(h, w, out),
                    j_image.resize_param_row(h, w, out))
        for a in arrs:
            for s in (256, 640, 1280):
                np.testing.assert_array_equal(
                    t_image.shrink_to_staging(a, s),
                    j_image.shrink_to_staging(a, s))
        items = arrs + [None]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            def prep_map(fn, xs):
                return list(pool.map(fn, xs))
            for s in (320, 640):
                want = j_image.stage_image_batch(items, s, 224)
                got = t_image.stage_image_batch(items, s, 224,
                                                prep_map=prep_map)
                for x, y in zip(got, want):
                    np.testing.assert_array_equal(x, y)
    for m in (1, 320, 321, 640, 641, 9999):
        assert (t_image.choose_staging_bucket(m, (320, 640, 1280))
                == j_image.choose_staging_bucket(m, (320, 640, 1280)))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_device_resize_engine_at_model_size_equals_host_path(tmp_path,
                                                             precision):
    """Images at the model's input size: the host resize and the device
    resize are both identities, so the staged engine gives the host
    engine's scores exactly, in bf16 serving as in f32 (the resize runs
    in f32 whatever the policy)."""
    det = DetectorConfig.tiny()
    params = detector_init(0, det)
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(3)]
    reqs = ([{"text": "a claim about a photo", "image": imgs[0]}]
            + [{"image": im} for im in imgs[1:]])
    prec = (t_config.PrecisionConfig.highest() if precision == "float32"
            else t_config.PrecisionConfig())
    out = []
    for dr in (False, True):
        cfg = t_config.ForensicsConfig(
            verbose=False, precision=prec,
            paths=t_config.ModelPaths(vault_path=str(tmp_path / "none.npz")),
            seq=t_config.SequenceConfig(roberta_max_len=32, image_size=64),
            serving=dataclasses.replace(t_config.ServingConfig(),
                                        device_resize=dr))
        eng = TEngine(config=cfg, det_cfg=det, params=params, device="cpu")
        if dr:
            batch = eng._image_batch(imgs, 4)
            assert set(batch) == {"image_staged", "resize_params"}
            assert batch["image_staged"].shape == (4, 320, 320, 3)
        out.append(eng.analyze_batch(reqs))
    for a, b in zip(*out):
        assert a["scores"] == b["scores"]
