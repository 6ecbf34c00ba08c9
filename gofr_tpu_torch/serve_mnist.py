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

The device client (tpu/device.CUDAClient, the reference's ``TPUClient``)
is injected with ``App.add_tpu``, as the reference's server does: ``tpu``
in /.well-known/health with the card's memory, the app_tpu_hbm_* series at
every scrape; the batcher runs on its device (TPU_PLATFORM=cpu asks for the
CPU, as a ``device="cpu"`` argument does). A multi-process job
(JAX_COORDINATOR_ADDR with JAX_NUM_PROCESSES, JAX_PROCESS_ID and the other
JAX_* keys, parallel/multihost.py) is joined through the container before
the first device query (``batcher_app``): one process per card, each
serving its own card and its own HTTP port, joined over gloo (a batcher
runs no collective, and two ranks may then share a card); the App's
shutdown leaves the job.

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
from .parallel.multihost import leave
from .serve import check_config
from .tpu.device import CUDAClient, requested_device
from .tpu.executor import Executor
from .tpu.scheduler import DynamicBatcher

# the keys every batcher server reads through its App, container, tracer,
# datasources, device client and job
APP_PORTED = ("HTTP_PORT", "METRICS_PORT", "REQUEST_TIMEOUT",
              "MAX_CONCURRENT_REQUESTS", "LOG_LEVEL", "APP_NAME",
              "APP_VERSION", "TRACE_EXPORTER", "TRACER_URL",
              "GOFR_CONFIGS_DIR", "DB_DIALECT", "DB_PATH", "KV_STORE",
              "KV_ENABLED", "PUBSUB_BACKEND", "REMOTE_LOG_URL",
              "REMOTE_LOG_FETCH_INTERVAL", "TPU_ENABLED", "MODEL_NAME",
              "TPU_PLATFORM", "JAX_COORDINATOR_ADDR")
APP_NOT_PORTED = ()
APP_INERT = ()

PORTED = ("MAX_BATCH", "BATCH_WINDOW_S") + APP_PORTED
NOT_PORTED = APP_NOT_PORTED
INERT = APP_INERT + (
    ("GRPC_PORT", "the MNIST server registers no gRPC service, here as in "
     "the reference, so nothing binds it"),)

# the reference's warm-up batch sizes
WARMUP_SIZES = (1, 8, 64)


def batcher_app(env, device, not_ported):
    """(App, its device, an Executor there) for a batcher server: the
    config checked against `not_ported`; the job of JAX_COORDINATOR_ADDR
    joined (gloo, before the first device query; the App's shutdown leaves
    it); the device client injected (``App.add_tpu``) on this rank's card
    or the device asked for, the app_tpu_* series with it. device: None =
    TPU_PLATFORM's, by default the CUDA card (raises without one); "cpu"
    for tests."""
    app = App(config=env, device=device)
    check_config(app.config, not_ported)
    want = requested_device(app.config.get_or_default("TPU_PLATFORM", ""),
                            device)
    joined = app.container.join_job(want, backend="gloo")
    if joined is not None:
        app.on_shutdown(leave)
    app.add_tpu(CUDAClient(app.config,
                           device=joined[1] if joined else device))
    dev = app.container.tpu.device
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
