"""The port's native C++ BPE encoder held to the JAX package's Python
tokenizer.

``misinfo_tpu_torch/csrc/bpe_encoder.cpp`` is built here with the host
C++ compiler (g++) into build/misinfo_tpu_torch/ at first use.
``NativeRobertaTokenizer.batch`` must give ids and masks ``np.array_equal``
to ``misinfo_tpu.preprocess.tokenizer.RobertaTokenizer.batch`` on two
vocabularies: the one tests/test_native_bpe.py trains with ``tokenizers``,
and chip_smoke.py's seeded, library-free RoBERTa-form assets at a small
size. Texts: tests/test_native_bpe.py's, non-ASCII rows among ASCII ones
(order kept), empty text, a NUL, truncation at max_length 2, 3 and 512
and rows over 512 tokens; at 1 and 8 threads; and printable ASCII drawn
by hypothesis. ``load_roberta_tokenizer`` takes the native encoder where
assets and a compiler exist, the Python one without a compiler, the hash
stand-in without assets, and raises with the compiler's text on a
planted compile error. A tiny engine gives the same reports on either
encoder.
"""

import os
import string

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from misinfo_tpu.preprocess import native_bpe as j_native
from misinfo_tpu.preprocess.tokenizer import RobertaTokenizer as JRoberta
from misinfo_tpu_torch.ops import cuda_build
from misinfo_tpu_torch.preprocess import native_bpe
from misinfo_tpu_torch.preprocess.native_bpe import (
    NativeRobertaTokenizer, build_native_library)
from misinfo_tpu_torch.preprocess.tokenizer import (
    HashTokenizer, RobertaTokenizer, load_roberta_tokenizer)
from tests.test_native_bpe import TEXTS
from tests.test_tokenizers import CORPUS

MIXED = ["caffè latte ☕", "ascii only here", "naïve — «Zürich» 東京 😀",
         "plain text again, 42 times", "", "a\x00b c", "\x00",
         "Ünïcödé café — naïve façade 2024 #tag @user"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    pytest.importorskip("tokenizers")
    from tokenizers import ByteLevelBPETokenizer
    tmp = tmp_path_factory.mktemp("trained")
    corpus = tmp / "corpus.txt"
    corpus.write_text("\n".join(CORPUS))
    tok = ByteLevelBPETokenizer()
    tok.train([str(corpus)], vocab_size=600, min_frequency=1,
              special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    tok.save_model(str(tmp))
    return str(tmp), CORPUS


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    return chip_smoke.seeded_bpe_assets(
        str(tmp_path_factory.mktemp("seeded")), n_vocab=3000)


@pytest.fixture(params=["trained", "seeded"])
def assets(request):
    return request.getfixturevalue(request.param)


def _files(d):
    return os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")


def _texts(words):
    """TEXTS, the mixed rows and seeded corpus rows, some over 512 tokens,
    a non-ASCII row every third."""
    long = [" ".join(words[:400]), "word " * 700]
    return (TEXTS + MIXED + long
            + chip_smoke.corpus_texts(7, list(words), 12, 30,
                                      non_ascii_every=3))


def _same(got, want):
    assert got[0].dtype == want[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("max_length", [2, 3, 512])
@pytest.mark.parametrize("threads", [1, 8])
def test_native_batch_equals_jax_python(assets, threads, max_length):
    d, words = assets
    native = NativeRobertaTokenizer(*_files(d), num_threads=threads)
    assert native.native_available and native.num_threads == threads
    texts = _texts(words)
    assert any(not t.isascii() for t in texts)
    ids, mask = native.batch(texts, max_length)
    _same((ids, mask), JRoberta(*_files(d)).batch(texts, max_length))
    if max_length == 512:           # some rows truncated, some padded
        assert mask.sum(1).max() == 512 and mask.sum(1).min() < 512


def test_threads_give_equal_output(seeded):
    d, words = seeded
    texts = chip_smoke.corpus_texts(11, list(words), 64, 200)
    one, eight = (NativeRobertaTokenizer(*_files(d), num_threads=n)
                  for n in (1, 8))
    _same(one.batch(texts, 512), eight.batch(texts, 512))
    _same(one.batch(texts, 512), eight.batch(texts, 512))   # cached words


def test_raw_tsvs_equal_jax(assets, tmp_path):
    d, _ = assets
    a, b = tmp_path / "port", tmp_path / "jax"
    a.mkdir(), b.mkdir()
    got = native_bpe._export_raw_tsvs(RobertaTokenizer(*_files(d)).bpe,
                                      str(a))
    want = j_native._export_raw_tsvs(JRoberta(*_files(d)).bpe, str(b))
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        with open(g) as fg, open(w) as fw:
            assert fg.read() == fw.read()


@pytest.mark.parametrize("which", ["trained", "seeded"])
@settings(max_examples=200, deadline=None)
@given(texts=st.lists(st.text(alphabet=string.printable, max_size=120),
                      min_size=1, max_size=4))
def test_printable_ascii_equals_jax_python(request, which, texts):
    d, _ = request.getfixturevalue(which)
    native = NativeRobertaTokenizer(*_files(d), num_threads=2)
    _same(native.batch(texts, 64), JRoberta(*_files(d)).batch(texts, 64))


def test_loader_picks_native_python_or_hash(seeded, tmp_path, monkeypatch):
    d, _ = seeded
    tok = load_roberta_tokenizer(d)
    assert isinstance(tok, NativeRobertaTokenizer) and tok.native_available
    assert tok.parity_grade
    for missing in (None, str(tmp_path)):
        assert isinstance(load_roberta_tokenizer(missing), HashTokenizer)
    monkeypatch.setattr(cuda_build, "host_compiler", lambda: None)
    tok = load_roberta_tokenizer(d)
    assert type(tok) is RobertaTokenizer
    native = NativeRobertaTokenizer(*_files(d))
    assert not native.native_available
    _same(native.batch(MIXED, 16), JRoberta(*_files(d)).batch(MIXED, 16))
    logs = []
    assert not build_native_library(log=logs.append)
    assert "no host C++ compiler" in logs[0]


def test_planted_compile_error_raises(seeded, tmp_path, monkeypatch):
    d, _ = seeded
    src = (cuda_build.CSRC / "bpe_encoder.cpp").read_text()
    broken = tmp_path / "csrc"
    broken.mkdir()
    (broken / "bpe_encoder.cpp").write_text(
        src.replace("int32_t bpe_vocab_size(void* handle) {",
                    "int32_t bpe_vocab_size(void* handle) { planted_fault;"))
    monkeypatch.setattr(cuda_build, "CSRC", broken)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="planted_fault"):
        load_roberta_tokenizer(d)
    logs = []
    assert not build_native_library(log=logs.append)
    assert "planted_fault" in logs[0]
    assert not list((tmp_path / "build").iterdir())     # nothing left


def test_build_is_cached_and_keyed_by_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    assert build_native_library(log=pytest.fail)
    built = sorted(p.name for p in tmp_path.iterdir())
    assert len(built) == 1 and built[0].startswith("bpe_encoder_")
    _, log = cuda_build.build_host("bpe_encoder")
    assert log == "" and sorted(p.name for p in tmp_path.iterdir()) == built


def test_tiny_engine_reports_equal_on_both_encoders(tmp_path):
    from misinfo_tpu_torch.core import config as C
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.vault.store import TruthVault
    det = DetectorConfig.tiny()
    d, words = chip_smoke.seeded_bpe_assets(str(tmp_path / "bpe"),
                                            n_vocab=det.roberta.vocab_size)
    rng = np.random.default_rng(5)
    dim = det.clip.projection_dim
    TruthVault(rng.normal(size=(6, dim)).astype(np.float32),
               [{"title": f"article {i}", "url": f"u{i}", "date": "2024"}
                for i in range(6)],
               rng.normal(size=(6, dim)).astype(np.float32)).save(
                   str(tmp_path / "vault.npz"))
    cfg = C.ForensicsConfig(
        verbose=False, precision=C.PrecisionConfig.highest(),
        paths=C.ModelPaths(vault_path=str(tmp_path / "vault.npz"),
                           roberta_tokenizer_dir=d),
        seq=C.SequenceConfig(roberta_max_len=32, image_size=64))
    eng = MisinfoForensics(cfg, det, device="cpu")
    assert isinstance(eng.roberta_tokenizer, NativeRobertaTokenizer)
    image = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    texts = chip_smoke.corpus_texts(9, list(words), 6, 20, non_ascii_every=2)
    reqs = ([{"text": t, "image": image} for t in texts[:3]]
            + [{"text": t} for t in texts[3:]])
    native = eng.analyze_batch(reqs)
    single = eng.analyze(texts[1], image, verbose=False)
    eng.roberta_tokenizer = RobertaTokenizer(*_files(d))
    assert eng.analyze_batch(reqs) == native
    assert eng.analyze(texts[1], image, verbose=False) == single
