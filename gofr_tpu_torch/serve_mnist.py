"""MNIST MLP inference over the port: single examples, dynamic batching.

Counterpart of ``examples/mnist-server/main.py``: the same route, body,
answer and 400, on the port's ``App`` with a ``tpu/scheduler.DynamicBatcher``
in front of ``models/mlp.mlp_forward`` (random weights from seed 0, as the
reference's).

    POST /predict {"image": [784 floats]} -> {"digit": argmax,
    "probs": softmax rounded to 4 places}; an "image" that is not a list of
    784 numbers is a 400.

The handler enqueues the image and blocks on its future (until the
request's deadline); the batcher pads the batch to a power-of-two bucket
and runs one program per bucket (a CUDA graph on the card). At boot the
reference's warm-up sizes (1, 8, 64) are captured, so the first requests
pay no capture.

Config keys, as ``serve.py`` accounts for the llm-server's: every key the
reference server reads (its own, its App's constructor, its container's and
tracer's, and its device client's) is served (PORTED), refused at boot
naming the ROADMAP item that waits (NOT_PORTED), or inert with its reason
(INERT). MAX_BATCH (64) and BATCH_WINDOW_S (0.003 s) size the batcher.

Run: ``python -m gofr_tpu_torch.serve_mnist`` (config from .env files under
GOFR_CONFIGS_DIR, the process environment over them; ``device="cpu"`` only
through ``build_app``).
"""

from __future__ import annotations

import numpy as np

from .app import App
from .http.errors import InvalidParam
from .models.mlp import MLPConfig, mlp_forward, mlp_init
from .serve import INERT as LLM_INERT
from .serve import NOT_PORTED as LLM_NOT_PORTED
from .serve import check_config
from .tpu.device import register_metrics, resolve_device
from .tpu.executor import Executor
from .tpu.scheduler import DynamicBatcher

# the keys every batcher server reads through its App, container and tracer
# and datasources
APP_PORTED = ("HTTP_PORT", "METRICS_PORT", "REQUEST_TIMEOUT",
              "MAX_CONCURRENT_REQUESTS", "LOG_LEVEL", "APP_NAME",
              "APP_VERSION", "TRACE_EXPORTER", "TRACER_URL",
              "GOFR_CONFIGS_DIR", "DB_DIALECT", "DB_PATH", "KV_STORE",
              "KV_ENABLED", "PUBSUB_BACKEND")
# the container's level poller, refused as the llm-server refuses it
APP_NOT_PORTED = tuple(entry for entry in LLM_NOT_PORTED if entry[0] in (
    "REMOTE_LOG_URL",)) + (
    # the llm-server joins a job for its tensor-parallel engine; a batcher
    # server has no sharded model to serve over one
    ("JAX_COORDINATOR_ADDR", lambda e: bool(e.get("JAX_COORDINATOR_ADDR")),
     "a multi-process job for the batcher servers waits in ROADMAP A18b"),)
APP_INERT = tuple(entry for entry in LLM_INERT if entry[0] in (
    "TPU_ENABLED", "MODEL_NAME", "REMOTE_LOG_FETCH_INTERVAL")) + (
    ("TPU_PLATFORM", "picks the JAX platform of the reference's device "
     "client; the port's entry points take their device from the caller "
     "(tpu/device.py)"),)

PORTED = ("MAX_BATCH", "BATCH_WINDOW_S") + APP_PORTED
NOT_PORTED = APP_NOT_PORTED
INERT = APP_INERT + (
    ("GRPC_PORT", "the MNIST server registers no gRPC service, here as in "
     "the reference, so nothing binds it"),)

# the reference's warm-up batch sizes
WARMUP_SIZES = (1, 8, 64)


def batcher_app(env, device, not_ported):
    """(App, its device, an Executor there) for a batcher server: the
    config checked against `not_ported`, the app_tpu_* series registered on
    the App's metrics manager. device: None = the CUDA card (raises
    without one); "cpu" for tests."""
    app = App(config=env)
    check_config(app.config, not_ported)
    dev = resolve_device(device)
    if app.container.metrics_manager is not None:
        register_metrics(app.container.metrics_manager)
    executor = Executor(dev)
    executor.metrics = app.container.metrics_manager
    return app, dev, executor


def build_app(env=None, device=None, params=None) -> App:
    """The App with POST /predict; the batcher rides on ``app.batcher`` and
    the params on ``app.params``, and the App's shutdown stops the batcher.
    env: a Config, a mapping, or None (.env files under GOFR_CONFIGS_DIR and
    the process environment). params: an MLP params tree on `device` to
    serve (default: mlp_init, seed 0)."""
    app, dev, executor = batcher_app(env, device, NOT_PORTED)
    cfg = MLPConfig()
    if params is None:
        params = mlp_init(cfg, seed=0, device=dev)
    batcher = DynamicBatcher(lambda x: mlp_forward(params, x),
                             executor=executor,
                             max_batch=app.config.get_int("MAX_BATCH", 64),
                             window_s=app.config.get_float("BATCH_WINDOW_S",
                                                           0.003),
                             name="mnist-mlp", logger=app.logger)
    # warm the common buckets so first requests don't pay the capture
    batcher.warmup(WARMUP_SIZES, np.zeros((cfg.in_dim,), dtype=np.float32))
    batcher.start()
    app.batcher, app.params = batcher, params
    app.on_shutdown(batcher.stop)

    @app.post("/predict")
    def predict(ctx):
        body = ctx.bind()
        image = body.get("image")
        if not isinstance(image, list) or len(image) != cfg.in_dim:
            raise InvalidParam(["image"])
        logits = batcher.infer(np.asarray(image, dtype=np.float32),
                               timeout_s=ctx.remaining())
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        return {"digit": int(np.argmax(logits)),
                "probs": [round(float(p), 4) for p in probs]}

    return app


def main() -> None:
    build_app().run()


if __name__ == "__main__":
    main()
