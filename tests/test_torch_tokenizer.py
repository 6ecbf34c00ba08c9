"""Port BPE tokenizers and native BPE core vs the JAX package's.

Ids must equal the reference's: BPETokenizer on the shipped test vocab
(examples/llm-server/vocab.test.json) and its golden vectors,
ByteLevelBPETokenizer on the reference tests' fixtures, on a tokenizer.json
trained here with `tokenizers` (whose own ids it must equal too) and on the
tiktoken form of the same vocab. The port's pre-tokenizer split (stdlib
`re` over classes built from unicodedata) must equal the `regex` package's
on a corpus; the code points this Python's unicodedata leaves unassigned
are kept out of it, where the two databases may disagree (the port
documents that caveat). The native core must equal the Python merge loop.
"""

import base64
import json
import os
import pathlib
import random

import pytest

from gofr_tpu.models import tokenizer as jt
from gofr_tpu_torch import native
from gofr_tpu_torch.models import tokenizer as tt

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOCAB_PATH = str(ROOT / "examples" / "llm-server" / "vocab.test.json")
TEXTS = ["hello world", "held", "hell", "who would", "droll", "hexyz",
         "hello  world\n", ""]


def _both(cls_name, *args, **kw):
    return (getattr(jt, cls_name)(*args, **kw),
            getattr(tt, cls_name)(*args, **kw))


def test_bpe_golden_vectors_and_jax_ids():
    ref = jt.BPETokenizer.from_file(VOCAB_PATH)
    bpe = tt.BPETokenizer.from_file(VOCAB_PATH)
    assert bpe.encode("hello world") == [0, 14, 7, 17]
    assert bpe.encode("hello world", bos=False, eos=True) == [14, 7, 17, 1]
    assert bpe.encode("held", bos=False) == [11, 18]
    assert bpe.encode("hell", bos=False) == [13]
    assert (bpe.BOS, bpe.EOS, bpe.vocab_size) == (ref.BOS, ref.EOS,
                                                  ref.vocab_size)
    for text in TEXTS:
        assert bpe.encode(text) == ref.encode(text), text
        ids = ref.encode(text, eos=True)
        assert bpe.decode(ids) == ref.decode(ids)
        assert [bpe.decode_token(i) for i in ids] == [
            ref.decode_token(i) for i in ids]


def test_native_core_is_built_outside_the_package():
    assert native.available(), "the host C++ compiler could not build it"
    assert native.target().exists()
    assert native.target().parent == ROOT / "build" / "torch_native"
    assert "gofr_tpu_torch native" in native.version()


def test_bpe_native_loop_matches_python():
    bpe = tt.BPETokenizer.from_file(VOCAB_PATH)
    assert bpe._native is not None
    with open(VOCAB_PATH, encoding="utf-8") as fp:
        data = json.load(fp)
    python_only = tt.BPETokenizer(data["vocab"], data["merges"])
    python_only._native = None
    for text in TEXTS + ["hello world " * 40]:
        assert bpe.encode(text) == python_only.encode(text), text


def test_native_core_rank_order_and_ties():
    core = native.BPECore([(0, 1, 3), (3, 2, 4)])
    assert core.encode([0, 1, 2]) == [4]
    assert core.encode([0, 1, 0, 1]) == [3, 3]
    assert core.encode([2, 0]) == [2, 0]
    assert core.encode([]) == []
    # rank 0 = (b, c) fires before rank 1 = (a, b)
    assert native.BPECore([(1, 2, 5), (0, 1, 3)]).encode([0, 1, 2]) == [0, 5]
    # a pair listed twice takes its last rank, as the reference's core
    assert native.BPECore([(0, 1, 3), (1, 2, 5), (0, 1, 3)]).encode(
        [0, 1, 2]) == [0, 5]


def test_bpe_gates_as_the_reference():
    vocab = {"x": 0, "y": 1}
    ref, tok = _both("BPETokenizer", vocab, ["x y"])
    assert tok._native is None            # 'xy' is not in the vocab
    assert tok.encode("xy", bos=False) == ref.encode("xy", bos=False)
    vocab = {ch: i for i, ch in enumerate("abcdef")}
    vocab.update({"ab": 6, "cd": 7, "abcd": 8, "ef": 9, "<s>": 10,
                  "</s>": 11})
    ref, tok = _both("BPETokenizer", vocab, ["a b", "c d", "ab cd", "e f"])
    for text in ["abcdef", "abcabc", "abzab", "aabbccddeeff", "abcd" * 50]:
        assert tok.encode(text, bos=False) == ref.encode(text, bos=False)


def _mini_byte_level():
    """tests/test_tokenizer_vocab.py's real-format byte-level fixture."""
    b2u = tt.bytes_to_unicode()
    used = bytes(range(32, 127)) + "\xe9".encode("utf-8")
    chars = sorted({b2u[b] for b in used})
    vocab = {c: i for i, c in enumerate(chars)}
    merges = ["h e", "l l", "he ll", "hell o",
              f"{b2u[ord(' ')]} w", "o r", "or l",
              f"{b2u[ord(' ')]}w orl", f"{b2u[ord(' ')]}worl d"]
    for m in merges:
        left, _, right = m.partition(" ")
        vocab.setdefault(left + right, len(vocab))
    specials = {"<|begin_of_text|>": len(vocab),
                "<|end_of_text|>": len(vocab) + 1}
    return vocab, merges, specials


@pytest.mark.parametrize("parse_special", [False, True])
def test_byte_level_matches_jax(parse_special):
    vocab, merges, specials = _mini_byte_level()
    ref, tok = _both("ByteLevelBPETokenizer", vocab, merges,
                     special_tokens=specials)
    assert tok._native is not None
    assert tt.bytes_to_unicode() == jt.bytes_to_unicode()
    for text in ["hello world", "hello<|end_of_text|>", "caf\xe9 worlds",
                 "hello  world\n\nhello", ""]:
        kw = dict(bos=True, eos=True, parse_special=parse_special)
        ids = tok.encode(text, **kw)
        assert ids == ref.encode(text, **kw), text
        assert tok.decode(ids) == ref.decode(ids)
        assert tok._encode_text(text, native=False) == ref._encode_text(text)


def test_pair_keyed_merges_and_tiktoken_ranks_as_jax():
    vocab = {c: i for i, c in enumerate(["a", "b", "c", "bc", "ab", "abc"])}
    for merges in (["b c", "a b", "ab c"], None):
        ref, tok = _both("ByteLevelBPETokenizer", vocab, merges,
                         special_tokens={})
        assert tok.encode("abc", bos=False) == ref.encode("abc", bos=False)
    # a pair listed twice keeps its FIRST rank here: the native core must
    # see it so too
    merges = ["a b", "b c", "a b"]
    ref, tok = _both("ByteLevelBPETokenizer", vocab, merges,
                     special_tokens={})
    assert tok._native is not None
    assert tok.encode("abc", bos=False) == ref.encode("abc", bos=False)


def test_byte_level_streaming_as_jax():
    vocab, merges, specials = _mini_byte_level()
    ref, tok = _both("ByteLevelBPETokenizer", vocab, merges,
                     special_tokens=specials)
    ids = tok.encode("\xe9 hello \xe9", bos=True)
    dec, ref_dec = tt.StreamingDecoder(tok), jt.StreamingDecoder(ref)
    assert [dec.push(i) for i in ids] == [ref_dec.push(i) for i in ids]
    assert dec.flush() == ref_dec.flush()
    bpe = tt.BPETokenizer.from_file(VOCAB_PATH)
    sd = tt.StreamingDecoder(bpe)
    assert "".join(sd.push(t) for t in bpe.encode("hello world")) == \
        "hello world"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(tokenizers.Tokenizer, path of its tokenizer.json) trained here
    with the Llama-3 split, as tests/test_hf_parity.py:181 does."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import Regex, decoders, models, pre_tokenizers, trainers

    tok = tokenizers.Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(jt._LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=600, special_tokens=["<|begin_of_text|>",
                                        "<|end_of_text|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = (ROOT / "README.md").read_text(encoding="utf-8").splitlines()
    corpus += ["çok güzel ünicode — résumé naïve 日本語 テスト",
               "it's the model's 123 4567 tokens"]
    tok.train_from_iterator(corpus, trainer)
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return tok, str(path)


SAMPLES = ["the quick brown fox", "hello hello world", "aaaa aaaa bbbb",
           "résumé 日本語", "it's 12345 tokens", "tabs\tand\nnewlines  x",
           "The port's `chip_smoke.py` runs 7 streams + 1 request.", ""]


def test_tokenizer_json_matches_tokenizers_and_jax(trained):
    hf, path = trained
    ours = tt.ByteLevelBPETokenizer.from_tokenizer_json(path)
    ref = jt.ByteLevelBPETokenizer.from_tokenizer_json(path)
    assert ours._native is not None
    assert (ours.BOS, ours.EOS, ours.vocab_size) == (ref.BOS, ref.EOS,
                                                     ref.vocab_size)
    for text in SAMPLES:
        want = hf.encode(text).ids
        got = ours.encode(text, bos=False)
        assert got == want, text
        assert got == ref.encode(text, bos=False)
        assert ours.decode(got) == hf.decode(want, skip_special_tokens=False)


def test_tiktoken_form_matches_jax(trained, tmp_path):
    """The trained vocab written one `base64(bytes) rank` per line."""
    _, path = trained
    with open(path, encoding="utf-8") as fp:
        vocab = json.load(fp)["model"]["vocab"]
    u2b = {c: b for b, c in tt.bytes_to_unicode().items()}
    lines = [f"{base64.b64encode(bytes(u2b[c] for c in piece)).decode()} "
             f"{rank}" for piece, rank in sorted(vocab.items(),
                                                key=lambda kv: kv[1])]
    tik = tmp_path / "tokenizer.model"
    tik.write_text("\n".join(lines) + "\n")
    ours = tt.ByteLevelBPETokenizer.from_tiktoken(str(tik))
    ref = jt.ByteLevelBPETokenizer.from_tiktoken(str(tik))
    assert ours._native is None              # rank mode has no merges
    assert ours.BOS == ref.BOS == len(vocab)
    for text in SAMPLES:
        assert ours.encode(text) == ref.encode(text), text


def test_native_core_equals_python_loop_on_a_long_prompt(trained):
    _, path = trained
    tok = tt.ByteLevelBPETokenizer.from_tokenizer_json(path)
    text = (ROOT / "README.md").read_text(encoding="utf-8")[:20000]
    assert tok._encode_text(text) == tok._encode_text(text, native=False)


def test_split_pattern_is_the_reference_one():
    assert tt._LLAMA3_SPLIT == jt._LLAMA3_SPLIT


def _corpus():
    rng = random.Random(0)
    texts = (ROOT / "README.md").read_text(encoding="utf-8").split("\n\n")
    texts += ["çok güzel ünicode — résumé naïve 日本語 テスト Ünïcödé ½ ²³ "
              "١٢٣ ४५६ Ⅻ", "it's THE MODEL'S 'LL 'Re\r\n\r\n  x\t\ty",
              "\x1c\x1d\x1e\x1f a\x85b\xa0c d　e 1234567"]
    for n in range(600):
        chars = []
        while len(chars) < 1 + n % 60:
            c = chr(rng.randrange(0, 0xA000))
            if tt.unicodedata.category(c) not in ("Cn", "Cs"):
                chars.append(c)
        texts.append("".join(chars))
    return texts


def test_stdlib_split_equals_regex_on_a_corpus():
    regex = pytest.importorskip("regex")
    ref = regex.compile(jt._LLAMA3_SPLIT)
    ours = tt._compile_split()
    bad = [t for t in _corpus() if ours.findall(t) != ref.findall(t)]
    assert not bad, bad[:3]


def test_port_modules_never_import_regex():
    src = (ROOT / "gofr_tpu_torch" / "models" / "tokenizer.py").read_text()
    assert "import regex" not in src
    assert os.path.exists(VOCAB_PATH)
