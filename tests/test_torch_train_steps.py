"""The port's training steps, optimizer and losses held to the JAX
package's (misinfo_tpu/train/{losses,optim,steps}.py).

- losses within 1e-6, accuracies exact;
- ``make_optimizer`` against optax over 20 steps on a seeded tree with
  seeded gradients, some steps over the clip norm and one frozen branch:
  the learning rate at every count within 1e-6 relative, every leaf
  within 1e-6 absolute, frozen leaves ``torch.equal`` to their start;
- each of the six steps (and the AI-head freeze) after 3 steps with
  dropout off (``hidden_dropout=0``; ``rng=None`` for the EfficientNet and
  fusion steps; ``FUSION_DROPOUT`` patched to 0 for the full step): loss
  and accuracy within 1e-5, every leaf within 1e-5 absolute, the
  EfficientNet running statistics included; the CLIP step leaves every
  leaf but the projections and ``logit_scale`` exactly unchanged;
- one bf16 text step's loss within 1e-2 of JAX's bf16 step;
- dropout: keep share, 1/keep scale, same seed same mask, identity when
  deterministic, and the heads' dropout dead in ``dual_head_logits``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.models import fusion as j_fusion
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.preprocess.packing import StreamPacker
from misinfo_tpu.train import losses as j_losses
from misinfo_tpu.train import optim as j_optim
from misinfo_tpu.train import steps as j_steps
from misinfo_tpu.train.clip_detective import (
    clip_trainable_mask as j_clip_mask)

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig
from misinfo_tpu_torch.models import fusion as t_fusion
from misinfo_tpu_torch.models import roberta as t_roberta
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops.common import Policy, dropout
from misinfo_tpu_torch.train import losses as t_losses
from misinfo_tpu_torch.train import optim as t_optim
from misinfo_tpu_torch.train import steps as t_steps
from misinfo_tpu_torch.train.clip_detective import clip_trainable_mask
from misinfo_tpu_torch.utils.tree import leaves_with_paths, tree_map


def _no_dropout(cfg):
    return dataclasses.replace(cfg, roberta=dataclasses.replace(
        cfg.roberta, hidden_dropout=0.0))


TDET = _no_dropout(DetectorConfig.tiny())
JDET = _no_dropout(JDetectorConfig.tiny())
B = 4


def _policies(dtype="float32"):
    return (JPolicy(JPrecision(compute_dtype=dtype, gelu_mode="erf")),
            Policy(PrecisionConfig(compute_dtype=dtype, gelu_mode="erf")))


@pytest.fixture(scope="module")
def tree():
    """The port's seeded tiny detector as numpy: both packages start
    from copies of it."""
    return tree_map(lambda t: t.numpy(), detector_init(3, TDET))


def _jax(np_tree):
    return jax.tree.map(lambda a: jnp.array(a), np_tree)


def _flat_jax(jtree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jtree)]


def _assert_trees_close(jtree, ttree, atol, what):
    t_pairs = leaves_with_paths(ttree)
    j_leaves = _flat_jax(jtree)
    assert len(j_leaves) == len(t_pairs)
    worst = max(
        ((float(np.max(np.abs(a - t.numpy()), initial=0.0)), p)
         for a, (p, t) in zip(j_leaves, t_pairs)), key=lambda x: x[0])
    assert worst[0] <= atol, (what, worst)


# ---------------------------------------------------------------- losses

def test_losses_equal_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(9, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, 9).astype(np.int32)
    w = (rng.uniform(size=9) > 0.3).astype(np.float32)
    ie = rng.normal(size=(6, 16)).astype(np.float32)
    te = rng.normal(size=(6, 16)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (j_losses.cross_entropy(logits, labels),
         t_losses.cross_entropy(t(logits), t(labels))),
        (j_losses.clip_contrastive_loss(ie, te, jnp.float32(2.6592)),
         t_losses.clip_contrastive_loss(t(ie), t(te), torch.tensor(2.6592))),
        (j_losses.weighted_cross_entropy(logits, labels, w),
         t_losses.weighted_cross_entropy(t(logits), t(labels), t(w)))]
    for a, b in pairs:
        assert abs(float(a) - float(b)) <= 1e-6, (float(a), float(b))
    bin_logits, bin_labels = logits[:, :2], labels % 2
    for n in (8, 9):                    # even and odd counts for the median
        sims = rng.uniform(-0.2, 0.6, n).astype(np.float32)
        lab = rng.integers(0, 2, n).astype(np.int32)
        exact = [
            (j_losses.median_threshold_accuracy(sims, lab),
             t_losses.median_threshold_accuracy(t(sims), t(lab))),
            (j_losses.fixed_threshold_accuracy(sims, lab),
             t_losses.fixed_threshold_accuracy(t(sims), t(lab)))]
        for a, b in exact:
            assert float(a) == float(b)
    assert float(j_losses.binary_accuracy(bin_logits, bin_labels)) == float(
        t_losses.binary_accuracy(t(bin_logits), t(bin_labels)))
    assert float(j_losses.weighted_accuracy(logits, labels, w)) == float(
        t_losses.weighted_accuracy(t(logits), t(labels), t(w)))


# ------------------------------------------------------------- optimizer

OPT_CASES = {
    "warmup_cosine_clip": dict(lr=1e-2, weight_decay=0.01,
                               warmup_fraction=0.2, total_steps=20,
                               clip_norm=1.0),
    "cosine_no_clip": dict(lr=1e-2, weight_decay=0.05, warmup_fraction=0.0,
                           total_steps=20, clip_norm=None),
    "constant_no_decay": dict(lr=3e-3, weight_decay=0.0, warmup_fraction=0.0,
                              total_steps=20, clip_norm=0.5,
                              schedule="constant"),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = OPT_CASES[case]
    rng = np.random.default_rng(1)
    np_tree = {"a": {"w": rng.normal(size=(5, 7)).astype(np.float32),
                     "b": rng.normal(size=(7,)).astype(np.float32)},
               "frozen": {"w": rng.normal(size=(3, 3)).astype(np.float32)},
               "layers": [{"k": rng.normal(size=(4,)).astype(np.float32)}
                          for _ in range(3)]}
    branches = ["a", "layers"]
    j_tx = j_optim.make_optimizer(j_optim.OptimConfig(**kw),
                                  j_optim.branch_mask(np_tree, branches))
    t_tx = t_optim.make_optimizer(t_optim.OptimConfig(**kw),
                                  t_optim.branch_mask(np_tree, branches))
    jp = _jax(np_tree)
    j_state = j_tx.init(jp)
    tp = params_from_jax(np_tree)
    frozen0 = tp["frozen"]["w"].clone()
    t_state = t_tx.init(tp)
    j_sched = j_optim.make_schedule(j_optim.OptimConfig(**kw))
    over = 0
    for step in range(20):
        want = float(j_sched(step)) if callable(j_sched) else j_sched
        got = t_tx.schedule(step)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30), (step, got,
                                                                  want)
        # seeded gradients; every third step large enough to clip
        scale = 5.0 if step % 3 == 0 else 0.05
        g_np = tree_map(lambda a: (rng.normal(size=a.shape) * scale
                                   ).astype(np.float32), np_tree)
        over += float(optax.global_norm({k: g_np[k] for k in branches})) > 1
        updates, j_state = j_tx.update(_jax(g_np), j_state, jp)
        jp = optax.apply_updates(jp, updates)
        grads = [torch.from_numpy(np.array(a)) for p, a in
                 leaves_with_paths(g_np) if p[0] in branches]
        t_state.step(grads)
        _assert_trees_close(jp, tp, 1e-6, (case, step))
    assert over >= 6
    assert torch.equal(tp["frozen"]["w"], frozen0)
    assert t_state.count == 20


# ------------------------------------------------------------- the steps

def _text_batch(rng, S=16):
    ids = rng.integers(3, TDET.roberta.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for i, n in enumerate((S, S - 5, 9, 3)):
        mask[i, n:] = 0
        ids[i, n:] = TDET.roberta.pad_token_id
    return {"input_ids": ids, "attention_mask": mask,
            "labels": np.asarray([0, 1, 1, 0], np.int32)}


def _clip_ids(rng, S=12):
    ids = rng.integers(1, TDET.clip.vocab_size - 2, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for i, n in enumerate((S, 7, 5, 10)):
        ids[i, n - 1] = TDET.clip.eos_token_id
        mask[i, n:] = 0
    return ids, mask


def _images(rng):
    s = TDET.clip.image_size
    return rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)


def _packed_batch(rng):
    packer = StreamPacker(row_len=24, pad_id=TDET.roberta.pad_token_id,
                          n_rows=2, n_slots=8)
    for n, lab in ((7, 0), (5, 1), (9, 1), (4, 0), (11, 1), (6, 0)):
        seq = rng.integers(3, TDET.roberta.vocab_size, n).astype(np.int32)
        assert packer.add(seq, lab) is None
    packed, metas = packer.flush()
    labels = np.zeros(8, np.int32)
    valid = np.zeros(8, np.float32)
    labels[:len(metas)] = metas
    valid[:len(metas)] = 1.0
    return {"input_ids": packed.ids, "attention_mask": packed.mask,
            "position_ids": packed.position_ids,
            "segment_ids": packed.segment_ids, "cls_rows": packed.cls_rows,
            "cls_cols": packed.cls_cols, "labels": labels,
            "slot_valid": valid}


def _batch(kind, rng):
    if kind in ("text", "ai_head"):
        return _text_batch(rng)
    if kind == "packed":
        return _packed_batch(rng)
    if kind == "effnet":
        return {"images_u8": _images(rng),
                "labels": np.asarray([0, 1, 1, 0], np.int32)}
    if kind == "clip":
        ids, mask = _clip_ids(rng)
        return {"input_ids": ids, "attention_mask": mask,
                "images_u8": _images(rng)}
    if kind == "fusion":
        return {"score_vectors": rng.uniform(size=(8, 5)).astype(np.float32),
                "labels": rng.integers(0, 2, 8).astype(np.int32)}
    ids, mask = _clip_ids(rng)
    return {**_text_batch(rng), "clip_ids": ids, "clip_mask": mask,
            "images_u8": _images(rng)}


# each step's optimizer as its trainer sets it, without warmup so that
# each of the three steps updates. AdamW divides each gradient element by
# its own running magnitude, so an element whose gradient sits at the
# rounding floor of both packages (the key bias's is zero in exact
# arithmetic) moves by up to lr either way: at the text trainers' 2e-5
# that stays inside 1e-5. EfficientNet's gradients agree with JAX's to
# ~6e-5 of each leaf's largest (16 BatchNorms over batch statistics, XLA's
# convolutions against oneDNN's), so every element below that floor would
# flip its sign-like first update; its step runs AdamW with eps 1e-2,
# which keeps those elements' updates proportional to their gradients
# (the optimizer itself is held to optax at eps 1e-8 above)
RECIPES = {
    "text": dict(lr=2e-5, weight_decay=0.01, clip_norm=1.0),
    "packed": dict(lr=2e-5, weight_decay=0.01, clip_norm=1.0),
    "ai_head": dict(lr=1e-3, weight_decay=0.01, clip_norm=1.0),
    "effnet": dict(lr=1e-4, weight_decay=0.0, clip_norm=None,
                   schedule="constant", eps=1e-2),
    "clip": dict(lr=1e-4, weight_decay=0.01, clip_norm=1.0),
    "fusion": dict(lr=1e-3, weight_decay=0.01, clip_norm=None),
    "full": dict(lr=2e-5, weight_decay=0.01, clip_norm=1.0),
}


def _make(kind, np_tree, jpol, tpol):
    """(JAX tx, port tx, JAX step, port step, JAX rng or None)."""
    cfg = dict(warmup_fraction=0.0, total_steps=10, **RECIPES[kind])
    branches = {"text": ["roberta", "ai_head", "misinfo_head"],
                "packed": ["roberta", "ai_head", "misinfo_head"],
                "ai_head": ["ai_head"], "effnet": ["efficientnet"],
                "fusion": ["fusion"]}
    if kind == "clip":
        jm, tm = j_clip_mask(_jax(np_tree)), clip_trainable_mask(np_tree)
    elif kind == "full":
        jm = tm = None
    else:
        jm = j_optim.branch_mask(np_tree, branches[kind])
        tm = t_optim.branch_mask(np_tree, branches[kind])
    jtx = j_optim.make_optimizer(j_optim.OptimConfig(**cfg), jm)
    ttx = t_optim.make_optimizer(t_optim.OptimConfig(**cfg), tm)
    key = jax.random.PRNGKey(0)
    head = "ai_head" if kind == "ai_head" else "misinfo_head"
    if kind in ("text", "ai_head"):
        return (jtx, ttx,
                j_steps.make_text_head_step(jtx, JDET, jpol, head=head),
                t_steps.make_text_head_step(ttx, TDET, tpol, head=head), key)
    if kind == "packed":
        return (jtx, ttx, j_steps.make_packed_text_head_step(jtx, JDET, jpol),
                t_steps.make_packed_text_head_step(ttx, TDET, tpol), key)
    if kind == "effnet":
        return (jtx, ttx, j_steps.make_effnet_step(jtx, jpol),
                t_steps.make_effnet_step(ttx, tpol), None)
    if kind == "clip":
        return (jtx, ttx, j_steps.make_clip_step(jtx, JDET, jpol),
                t_steps.make_clip_step(ttx, TDET, tpol), key)
    if kind == "fusion":
        return (jtx, ttx, j_steps.make_fusion_step(jtx),
                t_steps.make_fusion_step(ttx), None)
    return (jtx, ttx, j_steps.make_full_step(jtx, JDET, jpol),
            t_steps.make_full_step(ttx, TDET, tpol), key)


STEP_KINDS = ["text", "ai_head", "packed", "effnet", "clip", "fusion",
              "full"]


@pytest.mark.parametrize("kind", STEP_KINDS)
def test_step_matches_jax_after_three_steps(tree, kind, monkeypatch):
    monkeypatch.setattr(j_fusion, "FUSION_DROPOUT", 0.0)
    monkeypatch.setattr(t_fusion, "FUSION_DROPOUT", 0.0)
    jpol, tpol = _policies()
    jtx, ttx, jstep, tstep, key = _make(kind, tree, jpol, tpol)
    jp, tp = _jax(tree), params_from_jax(tree)
    start = params_from_jax(tree)
    js, ts = jtx.init(jp), ttx.init(tp)
    rng = np.random.default_rng(7)
    metric = "mean_matched_sim" if kind == "clip" else "accuracy"
    for i in range(3):
        batch = _batch(kind, rng)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, key)
        tp, ts, tm = tstep(tp, ts, t_steps.batch_to(batch, "cpu"), None)
        for k in ("loss", metric):
            assert abs(float(jm[k]) - float(tm[k])) <= 1e-5, (kind, i, k,
                                                              float(jm[k]),
                                                              float(tm[k]))
    _assert_trees_close(jp, tp, 1e-5, kind)
    moved = [p for (p, a), (_, b) in zip(leaves_with_paths(start),
                                          leaves_with_paths(tp))
             if not torch.equal(a, b)]
    assert moved
    if kind == "clip":
        assert {p[:2] for p in moved} <= {
            ("clip", "text_projection"), ("clip", "visual_projection"),
            ("clip", "logit_scale")}, moved
    elif kind == "effnet":
        bn = [p for p in moved if p[-2] == "bn" and p[-1] in ("mean", "var")]
        assert len(bn) > 20
        assert {p[0] for p in moved} == {"efficientnet"}
    elif kind in ("ai_head", "fusion"):
        assert {p[0] for p in moved} == {kind}


def test_bf16_text_step_loss_close_to_jax(tree):
    jpol, tpol = _policies("bfloat16")
    jtx, ttx, jstep, tstep, key = _make("text", tree, jpol, tpol)
    jp, tp = _jax(tree), params_from_jax(tree)
    js, ts = jtx.init(jp), ttx.init(tp)
    rng = np.random.default_rng(8)
    for _ in range(2):
        batch = _batch("text", rng)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, key)
        tp, ts, tm = tstep(tp, ts, t_steps.batch_to(batch, "cpu"), None)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-2
    # the master weights stay f32 leaves
    assert all(t.dtype == torch.float32 for _, t in leaves_with_paths(tp)
               if t.is_floating_point())


# --------------------------------------------------------------- dropout

def test_dropout_statistics_and_determinism():
    x = torch.ones(200_000)
    for rate in (0.1, 0.3):
        y = dropout(torch.Generator().manual_seed(4), x, rate, False)
        keep = 1.0 - rate
        share = float((y != 0).float().mean())
        assert abs(share - keep) < 4 * (keep * rate / x.numel()) ** 0.5
        assert torch.allclose(y[y != 0], torch.tensor(1.0 / keep))
        again = dropout(torch.Generator().manual_seed(4), x, rate, False)
        assert torch.equal(y, again)
        other = dropout(torch.Generator().manual_seed(5), x, rate, False)
        assert not torch.equal(y, other)
        assert dropout(None, x, rate, True) is x
    assert dropout(None, x, 0.0, False) is x
    xb = torch.randn(64, generator=torch.Generator().manual_seed(0)).bfloat16()
    assert dropout(torch.Generator().manual_seed(1), xb, 0.5,
                   False).dtype == torch.bfloat16


def test_head_dropout_dead_in_dual_head_logits(tree):
    """JAX's dual_head_logits never hands the heads a key, so their 0.3
    dropout never runs in training; with hidden dropout 0 a training
    forward equals the inference one, while head_apply itself drops."""
    cfg = TDET.roberta
    assert cfg.head_dropout == 0.3
    tp = params_from_jax(tree)
    batch = t_steps.batch_to(_text_batch(np.random.default_rng(2)), "cpu")
    _, tpol = _policies()
    args = (tp["roberta"], tp["ai_head"], tp["misinfo_head"],
            batch["input_ids"], batch["attention_mask"], cfg, tpol)
    train = t_roberta.dual_head_logits(
        *args, gen=torch.Generator().manual_seed(0), deterministic=False)
    infer = t_roberta.dual_head_logits(*args)
    for a, b in zip(train, infer):
        assert torch.equal(a, b)
    pooled = torch.randn(4, cfg.hidden_size,
                         generator=torch.Generator().manual_seed(1))
    dropped = t_roberta.head_apply(tp["ai_head"], pooled, tpol,
                                   gen=torch.Generator().manual_seed(2),
                                   deterministic=False)
    assert not torch.equal(dropped, t_roberta.head_apply(tp["ai_head"],
                                                         pooled, tpol))
    # with hidden dropout on, the generator changes the training forward
    hot = dataclasses.replace(cfg, hidden_dropout=0.1)
    a = t_roberta.dual_head_logits(*args[:5], hot, tpol,
                                   gen=torch.Generator().manual_seed(0),
                                   deterministic=False)
    assert not torch.equal(a[0], infer[0])


def test_training_dropout_in_fusion_and_effnet(tree):
    tp = params_from_jax(tree)
    vec = torch.rand(16, 5, generator=torch.Generator().manual_seed(0))
    base = t_fusion.fusion_apply(tp["fusion"], vec)
    assert torch.equal(base, t_fusion.fusion_apply(tp["fusion"], vec,
                                                   deterministic=False))
    assert not torch.equal(base, t_fusion.fusion_apply(
        tp["fusion"], vec, gen=torch.Generator().manual_seed(1),
        deterministic=False))
    from misinfo_tpu_torch.models.efficientnet import effnet_train_apply
    imgs = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    _, tpol = _policies()
    plain, _ = effnet_train_apply(tp["efficientnet"], imgs, tpol)
    a, _ = effnet_train_apply(tp["efficientnet"], imgs, tpol,
                              gen=torch.Generator().manual_seed(3))
    b, _ = effnet_train_apply(tp["efficientnet"], imgs, tpol,
                              gen=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, plain)
