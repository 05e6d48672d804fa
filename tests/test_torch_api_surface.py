"""The port's public surface held to the JAX package's (faults F15-F17).

* F15: every public function that both packages define in a shared
  module takes JAX's positional parameters in JAX's order and its
  keyword-only names, with the same plain defaults. The deliberate
  differences are listed here: PRNG arguments (``key``/``rng`` → a
  ``torch.Generator`` ``gen``, or an int ``seed``), torch's ``dim`` for
  JAX's ``axis``, extra trailing parameters (``device=``, a
  transcriber, int4 row scales), and the host probe's device rate (the
  card's, not the TPU's). JAX-form calls of the functions F15
  names (``effnet_apply``, ``resolve_quant``, ``fusion_apply(policy=)``,
  ``make_full_step(jit=)``, ``multi_head_attention`` positionally) run
  and match JAX's results in f32 within 1e-5.
* F16: every name a JAX sub-package's ``__init__`` exports imports from
  the port's; the transcript worker's import stays torch-free.
* F17: ``Policy`` carries JAX's attributes for both default configs; a
  bf16-accumulation ``dense`` and attention context match jitted JAX
  within one bf16 rounding step (2^-8 relative, plus 1e-6); the fused
  attention kernel K3 refuses a non-f32 ``accum`` by name.
"""

import dataclasses
import importlib
import inspect
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.ops import attention as j_attn
from misinfo_tpu.ops import common as j_common

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.ops import attention as t_attn
from misinfo_tpu_torch.ops import common as t_common
from misinfo_tpu_torch.ops import serving as t_serving

MODULES = ("core.mesh", "parallel.sharding", "ops.common", "ops.attention",
           "ops.serving", "ops.quant", "ops.image_ops",
           "models.efficientnet", "models.fusion", "models.roberta",
           "models.clip", "models.detector", "vault.search", "vault.store",
           "vault.int4", "vault.ivf", "engine.signals", "train.steps",
           "serve.transcript", "preprocess.packing", "preprocess.image",
           "preprocess.tokenizer", "preprocess.hostprobe",
           "preprocess.native_bpe", "utils.tracing", "utils.timing")

# JAX parameter name → the port's (PRNG keys become torch generators or
# int seeds; JAX's ``axis`` is torch's ``dim``)
RENAMES = {"key": ("gen", "seed"), "rng": ("gen",), "axis": ("dim",)}
# (module, function) → parameters the port adds (each with a default)
EXTRAS = {
    ("ops.serving", "resolve_quant"): {"device"},
    ("vault.ivf", "build_ivf"): {"device"},
    ("vault.search", "sharded_vault_sims"): {"row_scale"},
    ("serve.transcript", "merge_into_caption"): {"transcriber"},
    ("serve.transcript", "extract_transcript"): {"transcriber"},
    # JAX's **kw forwards these to roberta_encode
    ("models.roberta", "dual_head_logits"): {"use_pallas", "gen",
                                             "deterministic"},
}
# plain defaults that are the port's own: the device rate the host-bound
# verdict is judged against is the card's (preprocess/hostprobe.py), not
# the TPU's
OWN_DEFAULTS = {("preprocess.hostprobe", "recommend"): {"device_images_per_s"}}
# JAX functions the port does not carry, by design (ROADMAP.md M15):
# the TPU top-k modes (``topk_first`` is exact for all of them) and the
# plain-XLA int4 product (the port's plain versions are K10's)
ABSENT = {("vault.search", "topk_chunked"), ("vault.search", "topk_iterative"),
          ("vault.search", "topk_approx"), ("vault.int4", "int4_sims_reference")}

_POS = (inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _same_name(j: str, t: str) -> bool:
    return j == t or t in RENAMES.get(j, ())


def _plain(v):
    return isinstance(v, (int, float, str, bool, type(None)))


@pytest.mark.parametrize("mod", MODULES)
def test_public_signatures_match_jax(mod):
    jm = importlib.import_module("misinfo_tpu." + mod)
    tm = importlib.import_module("misinfo_tpu_torch." + mod)
    checked = 0
    for name, f in vars(jm).items():
        if (name.startswith("_") or not inspect.isfunction(f)
                or f.__module__ != jm.__name__ or (mod, name) in ABSENT):
            continue
        g = getattr(tm, name, None)
        assert callable(g), f"{mod}.{name} is missing from the port"
        extras = EXTRAS.get((mod, name), set())
        jp = list(inspect.signature(f).parameters.values())
        tp = [p for p in inspect.signature(g).parameters.values()]
        j_pos = [p for p in jp if p.kind in _POS]
        t_pos = [p for p in tp if p.kind in _POS]
        where = f"{mod}.{name}"
        assert len(t_pos) >= len(j_pos), where
        for a, b in zip(j_pos, t_pos):
            assert _same_name(a.name, b.name), (where, a.name, b.name)
        j_kw = [p for p in jp if p.kind == inspect.Parameter.KEYWORD_ONLY]
        # a trailing positional the port adds is an extra, or one of
        # JAX's keyword-only parameters (a JAX-form call names it)
        for b in t_pos[len(j_pos):]:
            assert (b.name in extras
                    or any(_same_name(a.name, b.name) for a in j_kw)), \
                (where, b.name)
        t_kw = {p.name: p for p in tp
                if p.kind == inspect.Parameter.KEYWORD_ONLY}
        t_named = set(t_kw) | {p.name for p in t_pos}
        for a in j_kw:
            assert any(_same_name(a.name, n) for n in t_named), \
                (where, a.name)
        named = {p.name for p in tp}
        assert named - {n for a in jp for n in named
                        if _same_name(a.name, n)} <= extras, where
        # plain defaults (numbers, strings, flags, None) are JAX's
        tdef = {p.name: p.default for p in tp}
        own = OWN_DEFAULTS.get((mod, name), set())
        for a in j_pos + j_kw:
            b = next(n for n in named if _same_name(a.name, n))
            if (a.default is not inspect.Parameter.empty
                    and _plain(a.default) and a.name not in own):
                assert tdef[b] == a.default, (where, a.name)
        checked += 1
    assert checked or mod in ("vault.store",), mod


@pytest.fixture(scope="module")
def effnet_tree():
    from misinfo_tpu_torch.models.efficientnet import effnet_b0_init
    return effnet_b0_init(torch.Generator().manual_seed(3))


def test_effnet_apply_jax_call_form(effnet_tree):
    """``logits, _ = effnet_apply(p, imgs, policy=policy)`` at B = 2 gives
    JAX's (logits, None); ``train=True`` routes to the training forward."""
    from misinfo_tpu.models.efficientnet import effnet_apply as j_eff
    from misinfo_tpu_torch.models.efficientnet import (
        effnet_apply, effnet_train_apply)
    jp = jax.tree.map(lambda t: t.numpy(), effnet_tree)
    img = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want, none_j = j_eff(jp, jnp.asarray(img),
                         policy=j_common.Policy(JPrecision.highest()))
    f32 = t_common.Policy(TPrecision.highest())
    logits, none_t = effnet_apply(effnet_tree, torch.from_numpy(img),
                                  policy=f32)
    assert none_j is None and none_t is None
    assert logits.shape == (2, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    got, stats = effnet_apply(effnet_tree, torch.from_numpy(img), train=True,
                              policy=f32, dropout_rate=0.0)
    ref, ref_stats = effnet_train_apply(effnet_tree, torch.from_numpy(img),
                                        f32, dropout_rate=0.0)
    assert torch.equal(got, ref) and len(stats) == len(ref_stats)


def test_resolve_quant_jax_forms():
    bf16, f32 = t_common.Policy(), t_common.Policy(TPrecision.highest())
    jbf16 = j_common.Policy()
    from misinfo_tpu.ops import serving as j_serving
    # JAX's two-argument call (bench.py's form) and its mesh rule
    assert t_serving.resolve_quant("auto", bf16) in ("none", "int8_ffn")
    assert (t_serving.resolve_quant("auto", bf16, mesh=object())
            == j_serving.resolve_quant("auto", jbf16, mesh=object())
            == "none")
    assert t_serving.resolve_quant("int8", bf16, mesh=object()) == "int8"
    # the port's positional device form
    assert t_serving.resolve_quant("auto", bf16, "cuda") == "int8_ffn"
    assert t_serving.resolve_quant("auto", bf16,
                                   torch.device("cpu")) == "none"
    assert t_serving.resolve_quant("auto", f32, device="cuda") == "none"


def test_fusion_policy_and_full_step_jit_are_taken():
    from misinfo_tpu.models.fusion import fusion_apply as j_fusion
    from misinfo_tpu_torch.models.fusion import fusion_apply, fusion_init
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.train.optim import OptimConfig, make_optimizer
    from misinfo_tpu_torch.train.steps import make_full_step
    p = fusion_init(torch.Generator().manual_seed(1))
    s = np.random.default_rng(2).random((3, 5)).astype(np.float32)
    got = fusion_apply(p, torch.from_numpy(s), policy=t_common.Policy())
    want = j_fusion(jax.tree.map(lambda t: t.numpy(), p), jnp.asarray(s),
                    policy=j_common.Policy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert callable(make_full_step(make_optimizer(OptimConfig()),
                                   DetectorConfig.tiny(), t_common.Policy(),
                                   jit=True))


def test_attention_positional_jax_order():
    """``multi_head_attention(p, x, H, mask, causal, kv, policy, ...)``:
    JAX's positional tail, cross-attention included."""
    rng = np.random.default_rng(6)
    B, S, T, D, H = 2, 5, 7, 16, 4
    p = {n: {"kernel": rng.normal(size=(D, D)).astype(np.float32) * 0.2,
             "bias": rng.normal(size=(D,)).astype(np.float32) * 0.1}
         for n in ("q", "k", "v", "o")}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    kv = rng.normal(size=(B, T, D)).astype(np.float32)
    jp = j_common.Policy(JPrecision.highest())
    tp = t_common.Policy(TPrecision.highest())
    want = j_attn.multi_head_attention(p, jnp.asarray(x), H, None, False,
                                       jnp.asarray(kv), jp)
    got = t_attn.multi_head_attention(params_from_jax(p), torch.from_numpy(x),
                                      H, None, False, torch.from_numpy(kv),
                                      tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------------ F16

JAX_INITS = ("checkpoints", "core", "engine", "models", "ops", "parallel",
             "preprocess", "train", "utils", "vault")


@pytest.mark.parametrize("pkg", JAX_INITS)
def test_jax_init_names_import_from_the_port(pkg):
    src = open(importlib.import_module(f"misinfo_tpu.{pkg}").__file__).read()
    names = [n for n in dir(importlib.import_module(f"misinfo_tpu.{pkg}"))
             if not n.startswith("_") and n in src
             and f"misinfo_tpu.{pkg}." not in n]
    mods = {n for n in names
            if inspect.ismodule(getattr(importlib.import_module(
                f"misinfo_tpu.{pkg}"), n))}
    port = importlib.import_module(f"misinfo_tpu_torch.{pkg}")
    missing = [n for n in names if n not in mods and not hasattr(port, n)]
    assert not missing, (pkg, missing)


def test_engine_and_vault_front_doors():
    from misinfo_tpu_torch.engine import MisinfoForensics, SignalPrograms
    from misinfo_tpu_torch.vault import TruthVault
    from misinfo_tpu_torch.core import make_mesh
    assert MisinfoForensics.__module__.endswith("engine.forensics")
    assert SignalPrograms.__module__.endswith("engine.signals")
    assert TruthVault.__module__.endswith("vault.store")
    assert make_mesh.__module__.endswith("core.mesh")


def test_worker_import_stays_torch_free():
    """What the transcript worker imports loads neither torch nor JAX, the
    package ``__init__`` files' exports notwithstanding."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, misinfo_tpu_torch.preprocess.audio, "
         "misinfo_tpu_torch.core.config; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'jax', 'misinfo_tpu')))"],
        capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------------ F17

@pytest.mark.parametrize("which", ["default", "highest"])
def test_policy_attributes_match_jax(which):
    jc = JPrecision() if which == "default" else JPrecision.highest()
    tc = TPrecision() if which == "default" else TPrecision.highest()
    jp, tp = j_common.Policy(jc), t_common.Policy(tc)
    for attr in ("compute", "param", "accum", "softmax", "score"):
        assert str(getattr(tp, attr)).removeprefix("torch.") == \
            jnp.dtype(getattr(jp, attr)).name, attr
    assert tp.gelu_mode == jp.gelu_mode
    assert tp.precision == jp.precision.name.lower()
    assert tp.quant_pallas == jp.quant_pallas
    x = torch.ones(2, dtype=torch.float64)
    assert tp.cast(x).dtype == tp.compute


def _bf16_band(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_bf16_accumulation_dense_matches_jitted_jax(compute):
    """``accum_dtype="bfloat16"``: the product rounded to bf16 and the bias
    added in bf16, as jitted JAX; held within one bf16 step."""
    jp = j_common.Policy(dataclasses.replace(
        JPrecision(compute_dtype=compute), accum_dtype="bfloat16"))
    tp = t_common.Policy(dataclasses.replace(
        TPrecision(compute_dtype=compute), accum_dtype="bfloat16"))
    rng = np.random.default_rng(9)
    p = {"kernel": rng.normal(size=(48, 24)).astype(np.float32) * 0.3,
         "bias": rng.normal(size=(24,)).astype(np.float32)}
    x = rng.normal(size=(4, 48)).astype(np.float32)
    want = jax.jit(lambda pp, xx: j_common.dense(pp, xx, jp))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = t_common.dense(params_from_jax(p), torch.from_numpy(x), tp)
    assert got.dtype == tp.compute
    _bf16_band(got.float().numpy(), want)
    # and it is not the f32 accumulation: the bf16 rounding shows
    f32 = t_common.dense(params_from_jax(p), torch.from_numpy(x),
                         t_common.Policy(TPrecision(compute_dtype=compute)))
    if compute == "float32":
        assert not torch.equal(got, f32)


def test_bf16_accumulation_attention_and_the_kernel_refusal():
    rng = np.random.default_rng(10)
    B, S, D, H = 2, 6, 16, 4
    p = {n: {"kernel": rng.normal(size=(D, D)).astype(np.float32) * 0.2,
             "bias": rng.normal(size=(D,)).astype(np.float32) * 0.1}
         for n in ("q", "k", "v", "o")}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    jp = j_common.Policy(dataclasses.replace(JPrecision.highest(),
                                             accum_dtype="bfloat16"))
    tp = t_common.Policy(dataclasses.replace(TPrecision.highest(),
                                             accum_dtype="bfloat16"))
    want = jax.jit(lambda pp, xx: j_attn.multi_head_attention(
        pp, xx, H, policy=jp))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = t_attn.multi_head_attention(params_from_jax(p), torch.from_numpy(x),
                                      H, policy=tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)
    with pytest.raises(NotImplementedError, match="K3"):
        t_attn.multi_head_attention(params_from_jax(p), torch.from_numpy(x),
                                    H, policy=tp, use_pallas=True)
