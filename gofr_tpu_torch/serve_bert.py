"""BERT /embed over the port: token rows, dynamic batching by length bucket.

Counterpart of ``examples/bert-embed/main.py``: the same route, bodies,
answers and 400s, over HTTP and gRPC, on the port's ``App`` with a
``tpu/scheduler.DynamicBatcher`` (``seq_axis=0``, ``pad_value=pad_id``) in
front of ``models/bert.bert_embed`` (random weights from seed 0, as the
reference's).

    POST /embed {"text": "..."} (byte-level ids + 1, so 0 stays the pad
    id, cut to the largest bucket) or {"tokens": [ids]} (1 <= id < vocab,
    1..max_len of them) -> {"embedding": [D floats rounded to 6 places],
    "dim": D}; anything else is a 400.

Each request enqueues its token row; the batcher pads the rows to the
batch's (batch, sequence) buckets and runs one program per pair (a CUDA
graph on the card); masked mean pooling makes the padding numerically
invisible. The reference warms up nothing here, and neither does this
server: a pair's program is captured at its first batch (``app.batcher.
warmup`` captures ahead).

The same handler serves gRPC ``EmbedService/Embed`` on GRPC_PORT (default
9000; 0 picks a free port; JSON messages, grpcx/), as the reference's
does: the same bodies and answers, a 400's InvalidParam as
INVALID_ARGUMENT. The device client, the job and the config keys are
``serve_mnist``'s (``batcher_app``), plus BERT_PRESET (debug | base,
default debug; any other value is debug, as in the reference), SEQ_BUCKETS
("16,32,64,128"), MAX_BATCH (32), BATCH_WINDOW_S (0.003 s) and GRPC_PORT.

Run: ``python -m gofr_tpu_torch.serve_bert`` (config from .env files under
GOFR_CONFIGS_DIR, the process environment over them; ``device="cpu"`` only
through ``build_app``).
"""

from __future__ import annotations

import numpy as np

from .app import App
from .grpcx import GenericService
from .http.errors import InvalidParam
from .models.bert import BertConfig, bert_embed, bert_init
from .serve_mnist import (APP_INERT, APP_NOT_PORTED, APP_PORTED,
                          batcher_app)
from .tpu.scheduler import DynamicBatcher

PORTED = ("MAX_BATCH", "BATCH_WINDOW_S", "BERT_PRESET", "SEQ_BUCKETS",
          "GRPC_PORT") + APP_PORTED
NOT_PORTED = APP_NOT_PORTED
INERT = APP_INERT


def _encode(text: str, max_len: int) -> np.ndarray:
    # byte-level ids shifted by +1 so 0 stays the BERT pad id
    ids = [b + 1 for b in text.encode("utf-8")][: max_len]
    return np.asarray(ids or [1], dtype=np.int32)


def build_app(env=None, device=None, params=None) -> App:
    """The App with POST /embed and gRPC EmbedService/Embed; the batcher
    rides on ``app.batcher``, the config and params on ``app.bert_cfg`` /
    ``app.params``, and the App's shutdown stops the batcher. env: a Config, a mapping, or None (.env
    files under GOFR_CONFIGS_DIR and the process environment). params: a
    BERT_PRESET params tree on `device` to serve (default: bert_init, seed
    0)."""
    app, dev, executor = batcher_app(env, device, NOT_PORTED)
    preset = app.config.get_or_default("BERT_PRESET", "debug")
    cfg = BertConfig.base() if preset == "base" else BertConfig.debug()
    if params is None:
        params = bert_init(cfg, seed=0, device=dev)
    seq_buckets = tuple(int(s) for s in app.config.get_or_default(
        "SEQ_BUCKETS", "16,32,64,128").split(","))
    batcher = DynamicBatcher(
        lambda toks: bert_embed(params, cfg, toks), executor=executor,
        max_batch=app.config.get_int("MAX_BATCH", 32),
        window_s=app.config.get_float("BATCH_WINDOW_S", 0.003),
        seq_axis=0, seq_buckets=seq_buckets, pad_value=cfg.pad_id,
        name="bert-embed", logger=app.logger)
    batcher.start()
    app.batcher, app.bert_cfg, app.params = batcher, cfg, params
    app.on_shutdown(batcher.stop)

    max_len = min(cfg.max_seq_len, seq_buckets[-1])

    def embed(ctx):
        body = ctx.bind()
        if isinstance(body, dict) and "tokens" in body:
            try:
                tokens = np.asarray(body["tokens"], dtype=np.int32)
            except (ValueError, TypeError):
                raise InvalidParam(["tokens"])
            if tokens.ndim != 1 or tokens.size == 0 or tokens.size > max_len:
                raise InvalidParam(["tokens"])
            if (tokens < 1).any() or (tokens >= cfg.vocab_size).any():
                raise InvalidParam(["tokens"])
        elif isinstance(body, dict) and "text" in body:
            tokens = _encode(str(body["text"]), max_len)
        else:
            raise InvalidParam(["text"])
        vec = batcher.infer(tokens, timeout_s=ctx.remaining())
        return {"embedding": [round(float(v), 6) for v in vec],
                "dim": int(vec.shape[-1])}

    app.post("/embed", embed)
    app.register_grpc_service(GenericService("EmbedService",
                                             {"Embed": embed}))
    return app


def main() -> None:
    build_app().run()


if __name__ == "__main__":
    main()
