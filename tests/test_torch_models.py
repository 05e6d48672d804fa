"""The port's models held to the JAX package in f32 at tiny configs.

The port's seeded init as a numpy tree is handed to the JAX functions
as it is and bridged into the port (checkpoints/from_jax.py); the same
numpy inputs go through both. Tolerance 1e-4 on every output
(f32 parity mode on the CPU: sums run in another order, nothing else
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.models import clip as j_clip
from misinfo_tpu.models import roberta as j_roberta
from misinfo_tpu.models.detector import DetectorConfig, detector_init
from misinfo_tpu.models.efficientnet import effnet_apply as j_effnet
from misinfo_tpu.models.fusion import fusion_apply as j_fusion
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.preprocess.packing import pack_token_rows

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.models import clip as t_clip
from misinfo_tpu_torch.models import roberta as t_roberta
from misinfo_tpu_torch.models import detector as t_detector
from misinfo_tpu_torch.models.efficientnet import effnet_apply as t_effnet
from misinfo_tpu_torch.models.fusion import fusion_apply as t_fusion
from misinfo_tpu_torch.ops.common import Policy as TPolicy

TOL = 1e-4
CFG = DetectorConfig.tiny()
JP, TP = JPolicy(JPrecision.highest()), TPolicy(TPrecision.highest())


@pytest.fixture(scope="module")
def params():
    mine = t_detector.detector_init(0, t_detector.DetectorConfig.tiny())
    jp = jax.tree.map(lambda t: t.numpy(), mine)
    return jp, params_from_jax(jp)


def _close(a, b):
    a = np.asarray(a, np.float32)
    b = b.float().numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL)


def test_roberta_dense_matches(params):
    jp, tp = params
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, (3, 20)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 12:] = 0
    ids[1, 12:] = 1
    a = j_roberta.dual_head_logits(
        jp["roberta"], jp["ai_head"], jp["misinfo_head"], jnp.asarray(ids),
        jnp.asarray(mask), CFG.roberta, JP)
    b = t_roberta.dual_head_logits(
        tp["roberta"], tp["ai_head"], tp["misinfo_head"],
        torch.from_numpy(ids), torch.from_numpy(mask), CFG.roberta, TP)
    for x, y in zip(a, b):
        _close(x, y)


def test_roberta_packed_matches(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    seqs = [rng.integers(3, 1000, n).astype(np.int32) for n in (7, 12, 4, 9)]
    pk = pack_token_rows(seqs, 16, CFG.roberta.pad_token_id, n_slots=4)
    args = [pk.ids, pk.mask]
    kw = dict(position_ids=pk.position_ids, segment_ids=pk.segment_ids)
    a = j_roberta.roberta_encode(
        jp["roberta"], *map(jnp.asarray, args), CFG.roberta, JP,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    b = t_roberta.roberta_encode(
        tp["roberta"], *map(torch.from_numpy, args), CFG.roberta, TP,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(a, b)
    cls_j = np.asarray(a)[pk.cls_rows, pk.cls_cols]
    _close(j_roberta.head_apply(jp["ai_head"], jnp.asarray(cls_j),
                                policy=JP),
           t_roberta.head_apply(tp["ai_head"], torch.from_numpy(cls_j), TP))


def test_clip_towers_match(params):
    jp, tp = params
    rng = np.random.default_rng(2)
    c = CFG.clip
    ids = rng.integers(1, 500, (2, c.max_text_len)).astype(np.int32)
    ids[0, 9] = ids[0, 20] = c.eos_token_id        # pool at the FIRST eos
    ids[1, -1] = c.eos_token_id
    mask = np.ones_like(ids)
    mask[0, 21:] = 0
    _close(j_clip.clip_text_features(jp["clip"], jnp.asarray(ids),
                                     jnp.asarray(mask), c, JP),
           t_clip.clip_text_features(tp["clip"], torch.from_numpy(ids),
                                     torch.from_numpy(mask), c, TP))
    img = rng.normal(size=(2, c.image_size, c.image_size, 3)).astype(
        np.float32)
    _close(j_clip.clip_image_features(jp["clip"], jnp.asarray(img), c, JP),
           t_clip.clip_image_features(tp["clip"], torch.from_numpy(img), c,
                                      TP))


def test_efficientnet_and_fusion_match(params):
    jp, tp = params
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    a, _ = j_effnet(jp["efficientnet"], jnp.asarray(img), policy=JP)
    b, none = t_effnet(tp["efficientnet"], torch.from_numpy(img), policy=TP)
    assert none is None
    _close(a, b)
    s = rng.random((4, 5)).astype(np.float32)
    _close(j_fusion(jp["fusion"], jnp.asarray(s)),
           t_fusion(tp["fusion"], torch.from_numpy(s)))


def test_seeded_init_mirrors_jax_tree():
    """The port's own init has the JAX tree's names, shapes and dtypes, so
    the bridge and the port's init are interchangeable."""
    jp = jax.eval_shape(lambda: detector_init(jax.random.PRNGKey(0), CFG))
    mine = t_detector.detector_init(0, t_detector.DetectorConfig.tiny())
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [k for k, _ in flat_j] == [k for k, _ in flat_t]
    for (k, x), (_, y) in zip(flat_j, flat_t):
        assert tuple(x.shape) == tuple(y.shape), k
        assert y.dtype == torch.float32, k
    again = t_detector.detector_init(0, t_detector.DetectorConfig.tiny())
    assert torch.equal(again["clip"]["vision"]["patch_embedding"],
                       mine["clip"]["vision"]["patch_embedding"])
