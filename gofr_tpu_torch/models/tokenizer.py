"""Serving tokenizers: byte-level, the debug-vocab round-trip, and the
streaming UTF-8 decoder.

Copies of ``ByteTokenizer``, ``DebugTokenizer`` and ``StreamingDecoder``
from ``gofr_tpu/models/tokenizer.py`` (with ``bytes_to_unicode`` and the
pure-Python ``utf8_complete_prefix`` of ``gofr_tpu/native``). The BPE
tokenizers and the native C++ core are not ported yet (ROADMAP A13).
"""

from __future__ import annotations

from typing import Dict, List, Sequence


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
        b2u = bytes_to_unicode()
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
    SSE token stream sends so clients never see broken codepoints. Tokenizers
    whose ids are whole pieces (DebugTokenizer) decode token by token."""

    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer or ByteTokenizer()
        self._buf = bytearray()
        self._piecewise = not isinstance(self.tokenizer, ByteTokenizer)

    def push(self, token: int) -> str:
        if self._piecewise:
            return self.tokenizer.decode_token(token)
        if not (0 <= token < 256):
            return ""
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
