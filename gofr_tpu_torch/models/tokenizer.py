r"""Serving tokenizers: byte-level, the debug-vocab round-trip, the BPE
tokenizers, and the streaming UTF-8 decoder.

Copies of ``ByteTokenizer``, ``DebugTokenizer`` and ``StreamingDecoder``
from ``gofr_tpu/models/tokenizer.py`` (with the pure-Python
``utf8_complete_prefix`` of ``gofr_tpu/native``), and, ROADMAP A13, its
``BPETokenizer``, ``bytes_to_unicode``, ``_byte_maps``, ``_LLAMA3_SPLIT``
and ``ByteLevelBPETokenizer`` (``from_tokenizer_json``,
``from_tiktoken``). Two differences, both giving the reference's ids:

- The pre-tokenizer split. The reference compiles ``_LLAMA3_SPLIT`` with
  the ``regex`` package (``\p{L}``, ``\p{N}``) and falls back to
  ``\s+|\S+`` (other ids) without it. The card's machine has no
  ``regex``, so ``_compile_split`` builds ``\p{L}``, ``\p{N}`` and ``\s``
  (``regex``'s White_Space, which leaves out U+001C-U+001F that the stdlib
  counts) as explicit classes from ``unicodedata`` and compiles the pattern
  with the stdlib ``re``. It equals ``regex``'s split where the two Unicode
  databases agree: a code point assigned after this Python's
  ``unicodedata`` version (15.0.0 for Python 3.12; U+1C8A, say) is no
  letter here.
- The native BPE core (``gofr_tpu_torch/native``) runs the merge loop of
  ``BPETokenizer`` as in the reference (when every merge is
  id-representable), and also that of ``ByteLevelBPETokenizer`` when it has
  explicit merges that all are (the reference's byte-level class always
  loops in Python): the core is given each pair at its first rank, as the
  byte-level class ranks pairs, and merges every piece of the split apart,
  in one call per text (when every byte of the text is in the vocab).
  Otherwise, and without a C++ compiler, the Python loop runs.
"""

from __future__ import annotations

import json
import re
import unicodedata
from typing import Dict, List, Optional, Sequence


class ByteTokenizer:
    """256 byte tokens + specials. vocab: [bytes 0..255, <pad>, <bos>, <eos>]."""

    PAD = 256
    BOS = 257
    EOS = 258

    vocab_size = 259

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def decode_token(self, token: int) -> str:
        """Single-token streaming decode; multibyte UTF-8 may yield ''."""
        if 0 <= token < 256:
            return bytes([token]).decode("utf-8", errors="ignore")
        return ""


def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte<->unicode table: every byte value maps to a printable
    char; printable ASCII/latin ranges map to themselves, the rest shift
    past 255 in discovery order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_B2U = None
_U2B = None


def _byte_maps():
    global _B2U, _U2B
    if _B2U is None:
        _B2U = bytes_to_unicode()
        _U2B = {c: b for b, c in _B2U.items()}
    return _B2U, _U2B


class DebugTokenizer:
    """Round-trip tokenizer for synthetic model vocabularies (random-weight
    presets). Every non-special id decodes to exactly one printable char:
    ids 0..255 through the GPT-2 byte table (printable ASCII maps to
    itself, so prompt text encodes as ByteTokenizer would), PAD/BOS/EOS to
    "", ids 259..vocab_size-1 to the Unicode private use area (U+E000 +
    id)."""

    PAD = 256
    BOS = 257
    EOS = 258

    _PUA = 0xE000

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 259:
            raise ValueError("DebugTokenizer needs vocab_size >= 259")
        self.vocab_size = vocab_size
        b2u, _ = _byte_maps()
        self._id2ch = {i: b2u[i] for i in range(256)}
        for i in range(259, vocab_size):
            self._id2ch[i] = chr(self._PUA + i)
        self._ch2id = {c: i for i, c in self._id2ch.items()}

    def encode(self, text: str, bos: bool = True,
               eos: bool = False) -> List[int]:
        ids = []
        for ch in text:
            known = self._ch2id.get(ch)
            if known is not None:
                ids.append(known)
            else:
                # unmapped chars fall back to their UTF-8 bytes
                ids.extend(ch.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self._id2ch.get(i, "") for i in ids)

    def decode_token(self, token: int) -> str:
        return self._id2ch.get(token, "")


def utf8_complete_prefix(buf: bytes) -> int:
    """Bytes of `buf` that form whole UTF-8 codepoints: back up over at most
    three continuation bytes; an incomplete-but-valid tail sequence is cut,
    anything invalid counts as complete (replacement char on decode)."""
    if not buf:
        return 0
    i = len(buf) - 1
    back = 0
    while i > 0 and (buf[i] & 0xC0) == 0x80 and back < 3:
        i -= 1
        back += 1
    lead = buf[i]
    if (lead & 0x80) == 0:
        need = 1
    elif (lead & 0xE0) == 0xC0:
        need = 2
    elif (lead & 0xF0) == 0xE0:
        need = 3
    elif (lead & 0xF8) == 0xF0:
        need = 4
    else:
        return len(buf)
    return len(buf) if i + need <= len(buf) else i


class StreamingDecoder:
    """Accumulates byte tokens and yields complete UTF-8 characters — what the
    SSE token stream sends so clients never see broken codepoints.
    Byte-level BPE pieces are raw bytes that can split a codepoint, so they
    buffer like byte tokens; tokenizers whose ids are whole strings
    (DebugTokenizer, BPETokenizer) decode token by token."""

    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer or ByteTokenizer()
        self._buf = bytearray()
        self._byte_pieces = hasattr(self.tokenizer, "decode_token_bytes")
        self._piecewise = (not self._byte_pieces
                           and not isinstance(self.tokenizer, ByteTokenizer))

    def push(self, token: int) -> str:
        if self._piecewise:
            return self.tokenizer.decode_token(token)
        if self._byte_pieces:
            self._buf.extend(self.tokenizer.decode_token_bytes(token))
        elif not (0 <= token < 256):
            return ""
        else:
            self._buf.append(token)
        n = utf8_complete_prefix(bytes(self._buf))
        if n == 0:
            return ""
        text = bytes(self._buf[:n]).decode("utf-8", errors="replace")
        del self._buf[:n]
        return text

    def flush(self) -> str:
        text = self._buf.decode("utf-8", errors="replace")
        self._buf.clear()
        return text


class BPETokenizer:
    """Greedy byte-pair tokenizer over a {token_string: id} vocab + ranked
    merges. File format: JSON {"vocab": {...}, "merges": ["a b", ...]}."""

    def __init__(self, vocab: Dict[str, int], merges: List[str],
                 bos_token: str = "<s>", eos_token: str = "</s>"):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {tuple(m.split(" ")): i for i, m in enumerate(merges)}
        self.bos_id = vocab.get(bos_token)
        self.eos_id = vocab.get(eos_token)
        self.vocab_size = max(vocab.values()) + 1 if vocab else 0
        self._native = _native_core(vocab, merges, first_rank=False)

    # ByteTokenizer-compatible special-token surface (-1 = no such token,
    # which never matches a generated id)
    @property
    def BOS(self) -> int:
        return self.bos_id if self.bos_id is not None else -1

    @property
    def EOS(self) -> int:
        return self.eos_id if self.eos_id is not None else -1

    def decode_token(self, token: int) -> str:
        """Single-token streaming decode: BPE pieces are whole strings."""
        if token in (self.bos_id, self.eos_id):
            return ""
        return self.inv_vocab.get(token, "")

    @classmethod
    def from_file(cls, path: str, **kw) -> "BPETokenizer":
        with open(path, "r", encoding="utf-8") as fp:
            data = json.load(fp)
        return cls(data["vocab"], data.get("merges", []), **kw)

    def _bpe(self, word: List[str]) -> List[str]:
        while len(word) > 1:
            pairs = [(self.ranks.get((word[i], word[i + 1]), float("inf")), i)
                     for i in range(len(word) - 1)]
            best_rank, best_i = min(pairs)
            if best_rank == float("inf"):
                break
            word = (word[:best_i] + [word[best_i] + word[best_i + 1]]
                    + word[best_i + 2:])
        return word

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        ids: List[int] = []
        if bos and self.bos_id is not None:
            ids.append(self.bos_id)
        char_ids = ([self.vocab[ch] for ch in text]
                    if self._native is not None and
                    all(ch in self.vocab for ch in text) else None)
        if char_ids is not None:
            ids.extend(self._native.encode(char_ids))
        else:
            for piece in self._bpe(list(text)):
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                else:
                    ids.extend(self.vocab.get(ch, 0) for ch in piece)
        if eos and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.inv_vocab.get(i, "") for i in ids
                       if i not in (self.bos_id, self.eos_id))


def _native_core(vocab: Dict[str, int], merges: Sequence[str],
                 first_rank: bool):
    """The native merge loop when every merge (left, right and the merged
    piece) is in the vocab and the core builds, else None. first_rank: a
    pair listed twice keeps its first rank (the byte-level class's ranks)
    instead of its last (BPETokenizer's, and the core's own rule)."""
    from .. import native

    if not merges or not native.available():
        return None
    triples, seen = [], set()
    for m in merges:
        left, _, right = m.partition(" ")
        lid, rid = vocab.get(left), vocab.get(right)
        mid = vocab.get(left + right)
        if lid is None or rid is None or mid is None:
            return None
        if first_rank:
            if (lid, rid) in seen:
                # a dead rank: the loop never sees a pair of ids past the
                # vocab's
                lid = rid = -1
            seen.add((lid, rid))
        triples.append((lid, rid, mid))
    try:
        return native.BPECore(triples)
    except RuntimeError:
        return None


# Llama-3's pre-tokenizer split pattern (the tiktoken cl100k family), as
# the reference writes it for the `regex` package; _compile_split builds it
# for the stdlib `re` (the module docstring)
_LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                 r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                 r"|\s+(?!\S)|\s+")
_SPLIT = None


def _ranges(pred) -> str:
    """The code points matching pred as a character-class body of
    \\U escapes and ranges."""
    out, start = [], None
    for c in range(0x110001):
        hit = c < 0x110000 and pred(c)
        if hit and start is None:
            start = c
        elif not hit and start is not None:
            out.append(f"\\U{start:08x}" if start == c - 1
                       else f"\\U{start:08x}-\\U{c - 1:08x}")
            start = None
    return "".join(out)


def _compile_split():
    """_LLAMA3_SPLIT for the stdlib `re`: \\p{L}, \\p{N} and \\s as
    explicit classes from unicodedata (built once, ~1 s)."""
    global _SPLIT
    if _SPLIT is None:
        cat = unicodedata.category
        letters = _ranges(lambda c: cat(chr(c))[0] == "L")
        numbers = _ranges(lambda c: cat(chr(c))[0] == "N")
        # regex's \\s: Unicode White_Space, without U+001C-U+001F
        space = _ranges(lambda c: chr(c).isspace() and not 0x1C <= c <= 0x1F)
        pattern = (_LLAMA3_SPLIT
                   .replace(r"[^\s\p{L}\p{N}]", f"[^{space}{letters}{numbers}]")
                   .replace(r"[^\r\n\p{L}\p{N}]", f"[^\\r\\n{letters}{numbers}]")
                   .replace(r"\p{L}", f"[{letters}]")
                   .replace(r"\p{N}", f"[{numbers}]")
                   .replace(r"\S", f"[^{space}]")
                   .replace(r"\s", f"[{space}]"))
        _SPLIT = re.compile(pattern)
    return _SPLIT


class ByteLevelBPETokenizer:
    """Byte-level BPE over a real model vocabulary (Llama-3/GPT-2 family).

    vocab keys are strings in the byte-unicode space (bytes_to_unicode);
    merges rank adjacent-pair fusions. When merges are absent (tiktoken-
    format vocabs) the token id IS the rank. Encoding: text -> the
    pre-tokenizer split -> per-piece UTF-8 bytes -> byte-unicode chars ->
    greedy lowest-rank merges -> ids. Special tokens are matched exactly
    before the split when the caller asks (parse_special)."""

    def __init__(self, vocab: Dict[str, int], merges: Optional[List[str]] = None,
                 special_tokens: Optional[Dict[str, int]] = None,
                 bos_token: str = "<|begin_of_text|>",
                 eos_token: str = "<|end_of_text|>"):
        self.vocab = vocab
        self.special_tokens = dict(special_tokens or {})
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.inv_special = {v: k for k, v in self.special_tokens.items()}
        # merge lookup keyed by the (left, right) PAIR (HF BPE semantics);
        # tiktoken rank-mode merges any adjacent pair whose fusion is in
        # the vocab, ranked by the fused piece's id
        if merges:
            self._pair_ranks: Optional[Dict[tuple, int]] = {}
            for i, m in enumerate(merges):
                left, _, right = m.partition(" ")
                self._pair_ranks.setdefault((left, right), i)
        else:
            self._pair_ranks = None
        self._fused_ranks = dict(vocab)
        self.bos_id = self.special_tokens.get(bos_token, vocab.get(bos_token))
        self.eos_id = self.special_tokens.get(eos_token, vocab.get(eos_token))
        all_ids = list(vocab.values()) + list(self.special_tokens.values())
        self.vocab_size = max(all_ids) + 1 if all_ids else 0
        self._split = _compile_split()
        self._special_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.special_tokens,
                                         key=len, reverse=True)))
            if self.special_tokens else None)
        self._native = _native_core(vocab, merges or [], first_rank=True)

    # ByteTokenizer-compatible surface
    @property
    def BOS(self) -> int:
        return self.bos_id if self.bos_id is not None else -1

    @property
    def EOS(self) -> int:
        return self.eos_id if self.eos_id is not None else -1

    def _bpe(self, chars: List[str]) -> List[str]:
        """Greedy lowest-rank adjacent merge until no fusable pair remains."""
        pair_ranks = self._pair_ranks
        fused_ranks = self._fused_ranks
        word = chars
        while len(word) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(word) - 1):
                if pair_ranks is not None:
                    r = pair_ranks.get((word[i], word[i + 1]))
                else:
                    r = fused_ranks.get(word[i] + word[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i < 0:
                break
            word = (word[:best_i] + [word[best_i] + word[best_i + 1]]
                    + word[best_i + 2:])
        return word

    def _encode_text(self, text: str, native: bool = True) -> List[int]:
        """native=False forces the Python merge loop (for comparisons)."""
        b2u, _ = _byte_maps()
        vocab = self.vocab
        pieces = [[b2u[b] for b in piece.encode("utf-8")]
                  for piece in self._split.findall(text)]
        core = self._native if native else None
        if core is not None and all(c in vocab for p in pieces for c in p):
            return [i for out in core.encode_pieces(
                [[vocab[c] for c in p] for p in pieces]) for i in out]
        ids: List[int] = []
        for mapped in pieces:
            for tok in self._bpe(mapped):
                tid = vocab.get(tok)
                if tid is None:
                    # byte-level vocabs hold every single byte; this only
                    # triggers on truncated vocab fixtures
                    ids.extend(vocab.get(c, 0) for c in tok)
                else:
                    ids.append(tid)
        return ids

    def encode(self, text: str, bos: bool = True, eos: bool = False,
               parse_special: bool = False) -> List[int]:
        """parse_special=False (the default) treats special-token strings in
        `text` as plain text, the safe mode for untrusted prompts."""
        ids: List[int] = []
        if bos and self.bos_id is not None:
            ids.append(self.bos_id)
        if self._special_re is None or not parse_special:
            ids.extend(self._encode_text(text))
        else:
            pos = 0
            for m in self._special_re.finditer(text):
                if m.start() > pos:
                    ids.extend(self._encode_text(text[pos:m.start()]))
                ids.append(self.special_tokens[m.group()])
                pos = m.end()
            if pos < len(text):
                ids.extend(self._encode_text(text[pos:]))
        if eos and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    def decode_token_bytes(self, token: int) -> bytes:
        """Raw bytes of one token (StreamingDecoder buffers these)."""
        if token in self.inv_special or token in (self.bos_id, self.eos_id):
            return b""
        piece = self.inv_vocab.get(token)
        if piece is None:
            return b""
        _, u2b = _byte_maps()
        return bytes(u2b[c] for c in piece)

    def decode_token(self, token: int) -> str:
        return self.decode_token_bytes(token).decode("utf-8", errors="ignore")

    def decode(self, ids: Sequence[int]) -> str:
        data = b"".join(self.decode_token_bytes(i) for i in ids)
        return data.decode("utf-8", errors="replace")

    @classmethod
    def from_tokenizer_json(cls, path: str, data: Optional[dict] = None,
                            **kw) -> "ByteLevelBPETokenizer":
        """Load an HF `tokenizer.json`: model.vocab + model.merges ("a b"
        strings or [a, b] pairs) + added_tokens. `data` skips the re-parse
        when the caller already loaded the file."""
        if data is None:
            with open(path, "r", encoding="utf-8") as fp:
                data = json.load(fp)
        model = data.get("model", {})
        vocab = model.get("vocab", {})
        merges = [m if isinstance(m, str) else " ".join(m)
                  for m in model.get("merges", [])]
        specials = {t["content"]: t["id"]
                    for t in data.get("added_tokens", [])
                    if t.get("special", True)}
        return cls(vocab, merges, special_tokens=specials, **kw)

    @classmethod
    def from_tiktoken(cls, path: str,
                      special_tokens: Optional[Dict[str, int]] = None,
                      **kw) -> "ByteLevelBPETokenizer":
        """Load a tiktoken-format vocab (one `base64(token_bytes) rank`
        pair per line), re-keyed into the byte-unicode space. Merge ranks
        are the ids themselves."""
        import base64

        b2u, _ = _byte_maps()
        vocab: Dict[str, int] = {}
        with open(path, "r", encoding="utf-8") as fp:
            for line in fp:
                line = line.strip()
                if not line:
                    continue
                b64, _, rank = line.partition(" ")
                piece = "".join(b2u[b] for b in base64.b64decode(b64))
                vocab[piece] = int(rank)
        if special_tokens is None:
            # Meta's llama-3 special-token layout: specials start right
            # after the base vocab
            n = len(vocab)
            special_tokens = {
                "<|begin_of_text|>": n, "<|end_of_text|>": n + 1,
                "<|finetune_right_pad_id|>": n + 4,
                "<|start_header_id|>": n + 6, "<|end_header_id|>": n + 7,
                "<|eom_id|>": n + 8, "<|eot_id|>": n + 9,
                "<|python_tag|>": n + 10,
            }
        return cls(vocab, None, special_tokens=special_tokens, **kw)
