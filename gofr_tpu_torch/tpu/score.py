"""Post-hoc model passes: per-token logprobs (OpenAI `logprobs`) and
sequence embeddings (`/v1/embeddings`).

Ports ``gofr_tpu/tpu/score.py`` whole: ``_window_pass``, ``make_score_fn``,
``make_embed_fn``, ``_SCORE_K``, ``score_tokens``, ``embed_tokens`` and
``warmup_post_hoc``. The distribution at completion position i conditions
only on the tokens before it, so a teacher-forced forward over prompt +
completion reproduces the decode-time distributions, and one program family
beside serving gives chosen-token logprobs and the top-K alternatives with
no change to the serving programs.

Both passes share one windowed-cache driver (``_window_pass``): W = gcd(S,
128) tokens per dispatch against a bucket-sized cache (S the bucket of the
sequence), so the scoring pass's logits are [W, V], not [S, V], and the
embedding pass makes no logits at all. The top-K is reduced on the device;
per window only [W, 1 + 2K] floats (or one [D] row) cross to the host.

Each (bucket, window) program is one program of the engine's executor,
named as the reference names it (``score-{S}x{W}``, ``embed-{S}x{W}``): on
the card one CUDA graph. Its static inputs are the window's tokens, targets
and positions ([3, W] int64, one upload per window) and the [L, 1, Hkv, dh,
S] caches, which a bucket's two programs share: in the model dtype, whatever
the serving kv_dtype (an int8 engine scores in bf16). A pass does not clear
them: a window writes its positions before it reads them, and the causal
mask hides what an earlier pass left past them. At S <= 128 the window is
the whole bucket (T = W = S), so its attention is flash under
attn_impl="flash"; above, the plain masked read over the cache, as the
reference's XLA path.

A pass may be called from any thread while the engine's loop serves. It
takes the engine's ``_post_hoc_lock`` (one pass at a time: a bucket's
programs share their buffers) and, on the card, runs on a stream of its
own: its programs are captured there (under the executor's lock, in
thread-local capture mode) and replayed there, from a graph memory pool of
their own (tpu/executor.py), and they read the weights and nothing of the
engine's state. So the decode streams being served come out unchanged, and
serving does not pause for a pass, whose windows share the card with it.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.llama import init_kv_cache, llama_forward, llama_forward_hidden
from .executor import next_bucket


class _PostHoc:
    """The passes' device state on one engine: their stream (None on the
    CPU) and, per bucket, the static inputs of its programs."""

    def __init__(self, engine):
        self.stream = (torch.cuda.Stream(engine.device)
                       if engine.device.type == "cuda" else None)
        self._inputs = {}

    def stream_ctx(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def inputs(self, engine, S: int, W: int):
        """(rows [3, W] int64: tokens, targets, positions; k, v caches [L,
        1, Hkv, dh, S] in the model dtype) of bucket S, made zeroed at first
        use on the pass's stream."""
        bufs = self._inputs.get(S)
        if bufs is None:
            rows = torch.zeros((3, W), dtype=torch.long, device=engine.device)
            k, v = init_kv_cache(engine.cfg, 1, S, device=engine.device)
            bufs = self._inputs[S] = (rows, k, v)
        return bufs


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of `t` on the host (a program's output is overwritten by its
    next call)."""
    return t.detach().to("cpu", copy=True).numpy()


def _window_pass(engine, length: int, family: str, make_fn, fill, collect,
                 work_length=None) -> None:
    """Shared windowed-cache driver for the post-hoc passes.

    Owns what both passes must agree on: the bucket, W (it must divide S:
    buckets are configured, and a bucket like 192 would put the last
    128-wide window past the cache; gcd(S, 128) always divides S and
    power-of-two buckets keep W = 128), the cache independent of the
    serving kv_dtype, W-sized zero-padded windows, positions, and the
    program per (bucket, W) through the engine's executor.

    make_fn(cfg, W) builds the window program fn(params, rows, k, v) ->
    output; fill(w0, n, host) writes the window's tokens (and targets) into
    host [3, W] int64 rows 0 and 1 for the window starting at w0 with n
    live tokens; collect(w0, n, W, out) receives the output on the device.
    Padded positions produce garbage the collectors slice away: causality
    keeps it from earlier positions. work_length < length skips trailing
    windows whose outputs no one reads (scoring: position L - 1 has no
    target)."""
    S = next_bucket(length, engine.prefill_buckets)
    W = math.gcd(S, 128)
    with engine._post_hoc_lock, torch.no_grad():
        if engine._post_hoc is None:
            engine._post_hoc = _PostHoc(engine)
        state = engine._post_hoc
        with state.stream_ctx():
            rows, k, v = state.inputs(engine, S, W)
            fn = make_fn(engine.cfg, W)
            params = engine.params
            program = engine.executor.compile(
                f"{family}-{S}x{W}", lambda r, kc, vc: fn(params, r, kc, vc),
                (rows, k, v), stream=state.stream)
            for w0 in range(0, work_length or length, W):
                n = min(W, length - w0)
                host = np.zeros((3, W), dtype=np.int64)
                fill(w0, n, host)
                host[2] = np.arange(w0, w0 + W)
                rows.copy_(torch.from_numpy(host))
                collect(w0, n, W, program())


def make_score_fn(cfg, W: int, K: int):
    """Window program: forward W tokens against the running cache (written
    in place), then emit [W, 1 + 2K] float32: the target's logprob, the
    top-K logprobs, the top-K ids (as floats, exact below 2**24). rows[1,
    j] is the NEXT token after window position j (what the model was asked
    to predict there)."""

    def fn(params, rows, k, v):
        logits = llama_forward(params, cfg, rows[0:1], rows[2:3], k, v)[0]
        lsm = torch.log_softmax(logits[0].float(), dim=-1)
        top_lps, top_ids = torch.topk(lsm, K, dim=-1)
        chosen = torch.gather(lsm, 1, rows[1][:, None])
        return torch.cat([chosen, top_lps, top_ids.float()], dim=1)

    return fn


def make_embed_fn(cfg, W: int):
    """Window program for embeddings: forward W tokens against the running
    cache, emit the final-norm hidden states [W, D] (llama_forward_hidden);
    the host takes the last live position's row. No vocab projection: the
    [W, V] logits never exist on this pass."""

    def fn(params, rows, k, v):
        return llama_forward_hidden(params, cfg, rows[0:1], rows[2:3],
                                    k, v)[0][0]

    return fn


# every scoring program computes the MAXIMUM top-K and the host slices to
# the requested `top`: the extra lanes cost nothing next to the forward,
# and it keeps the program family keyed by bucket alone — so one warm-up
# pass per bucket covers every client top value
_SCORE_K = 20


def score_tokens(engine, prompt_tokens: Sequence[int],
                 completion_tokens: Sequence[int], top: int = 5,
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-token logprobs for `completion_tokens` given `prompt_tokens`.

    Returns (chosen_lp [C], top_ids [C, top], top_lps [C, top]) as numpy.
    One program per (cache bucket, window) pair through the engine's
    executor — bounded like every other program family."""
    if not completion_tokens:
        raise ValueError("completion_tokens must be non-empty")
    if not 1 <= top <= _SCORE_K:
        raise ValueError(f"top must be in [1, {_SCORE_K}], got {top}")
    seq = list(prompt_tokens) + list(completion_tokens)
    P, L = len(prompt_tokens), len(seq)
    if P < 1:
        raise ValueError("prompt_tokens must be non-empty")
    if L > engine.prefill_buckets[-1]:
        raise ValueError(f"prompt+completion of {L} tokens exceeds the "
                         f"largest scoring bucket "
                         f"({engine.prefill_buckets[-1]})")
    parts: List[np.ndarray] = []

    def fill(w0, n, host):
        host[0, :n] = seq[w0:w0 + n]
        m = min(len(host[1]), L - 1 - w0)  # positions with a real target
        host[1, :m] = seq[w0 + 1:w0 + 1 + m]

    def collect(w0, n, W, out):
        m = min(W, L - 1 - w0)
        if m > 0:
            parts.append(_host(out)[:m])

    _window_pass(engine, L, "score",
                 lambda cfg, W: make_score_fn(cfg, W, _SCORE_K),
                 fill, collect, work_length=L - 1)
    got = np.concatenate(parts)[P - 1:L - 1]
    chosen = got[:, 0]
    lps = got[:, 1:1 + top]
    ids = got[:, 1 + _SCORE_K:1 + _SCORE_K + top].astype(np.int64)
    return chosen, ids, lps


def embed_tokens(engine, tokens: Sequence[int],
                 normalize: bool = True) -> np.ndarray:
    """Sequence embedding: the final-norm hidden state at the LAST
    position (the causal summary of the whole sequence), optionally
    L2-normalized (the OpenAI /v1/embeddings convention). Returns float32
    [D]."""
    if not tokens:
        raise ValueError("tokens must be non-empty")
    L = len(tokens)
    if L > engine.prefill_buckets[-1]:
        raise ValueError(f"input of {L} tokens exceeds the largest "
                         f"embedding bucket ({engine.prefill_buckets[-1]})")
    out = {}

    def fill(w0, n, host):
        host[0, :n] = tokens[w0:w0 + n]

    def collect(w0, n, W, hidden):
        if w0 + W >= L:  # the window holding position L-1
            out["last"] = _host(hidden[L - 1 - w0].float())

    _window_pass(engine, L, "embed", make_embed_fn, fill, collect)
    last = out["last"]
    if normalize:
        norm = float(np.linalg.norm(last))
        if norm > 0.0:
            last = last / norm
    return last


def warmup_post_hoc(engine, embeddings: bool = True) -> int:
    """Make the scoring (and optionally embedding) program families — one
    window program per cache bucket — so the first client logprobs /
    embeddings request never waits for a capture. Covers every client `top`
    value (the scoring program always computes _SCORE_K lanes). Returns the
    number of passes run."""
    ran = 0
    for S in engine.prefill_buckets:
        score_tokens(engine, [1] * max(1, S - 1), [1])
        ran += 1
        if embeddings:
            embed_tokens(engine, [1] * S)
            ran += 1
    return ran
