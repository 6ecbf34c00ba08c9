"""The port's MLP and BERT, its dynamic batcher and its two batcher servers.

``mlp_forward`` and BERT's ``bert_encode`` / ``bert_embed`` /
``bert_pool_cls`` against the JAX package on the same bridged weights
(``params_from_numpy``: the MLP's layers are a list), BERT's padding
invariance, row independence and unit norm (tests/test_bert.py's twins),
``DynamicBatcher`` (tests/test_tpu_runtime.py's batcher twins: bucketing and
demux, sequence padding, a failing model, stop; plus the oversized
refusal, the unknown class, ``infer``'s timeout and, with the capture stub
of tests/test_torch_prefill_graphs.py's kind, one program per (batch,
sequence) bucket and no capture after warm-up), and ``serve_mnist`` /
``serve_bert`` over HTTP on the CPU against the JAX forwards.

Tolerances: f32 forwards 1e-5 absolute (unit-scale outputs, the same math
in other summation orders); the served answers as the reference rounds
them (probs to 4 places, embeddings to 6) plus 1e-5; padding invariance and
row independence 1e-5, as the reference's tests hold them.
"""

import concurrent.futures
import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models import bert as jb
from gofr_tpu.models import mlp as jmlp
from gofr_tpu_torch import serve_bert, serve_mnist, tree
from gofr_tpu_torch.http.errors import InvalidParam
from gofr_tpu_torch.models import bert as tb
from gofr_tpu_torch.models import mlp as tmlp
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu.executor import Executor
from gofr_tpu_torch.tpu.scheduler import DynamicBatcher

from _torch_env import INCIDENT_DIR


@pytest.fixture(scope="module")
def mlp():
    jp = jmlp.mlp_init(jmlp.MLPConfig(), seed=0)
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def bert():
    jcfg = jb.BertConfig.debug()
    jp = jb.bert_init(jcfg, seed=0)
    return (jcfg, jp, tb.BertConfig.debug(),
            params_from_numpy(jax.device_get(jp), "cpu"))


# -- models ----------------------------------------------------------------------
def test_mlp_matches_jax(mlp):
    jp, tp = mlp
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 3
    x = np.random.default_rng(0).standard_normal((5, 784), dtype=np.float32)
    want = np.asarray(jmlp.mlp_forward(jp, x))
    got = tmlp.mlp_forward(tp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (5, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_mlp_init_recipe():
    cfg = tmlp.MLPConfig()
    assert cfg == tmlp.MLPConfig(784, (512, 256), 10, "float32")
    p = tmlp.mlp_init(cfg, seed=0, device="cpu")
    want = jax.tree.leaves(jmlp.mlp_init(jmlp.MLPConfig(), seed=0))
    assert [tuple(t.shape) for t in tree.leaves(p)] == [w.shape for w in want]
    assert all(float(layer["b"].abs().sum()) == 0 for layer in p["layers"])
    assert abs(float(p["layers"][0]["w"].std()) - 784 ** -0.5) < 2e-3


def test_bert_matches_jax(bert):
    jcfg, jp, tcfg, tp = bert
    assert tcfg == tb.BertConfig(**jcfg.__dict__)
    for preset in ("debug", "base", "large"):
        assert (getattr(tb.BertConfig, preset)().param_count()
                == getattr(jb.BertConfig, preset)().param_count())
    toks = np.random.default_rng(1).integers(1, 512, (3, 12)).astype(np.int32)
    toks[1, 7:] = 0
    toks[2, :] = 0                       # an all-pad row stays finite
    tt = torch.from_numpy(toks)
    for jfn, tfn in ((jb.bert_encode, tb.bert_encode),
                     (jb.bert_embed, tb.bert_embed),
                     (jb.bert_pool_cls, tb.bert_pool_cls)):
        want = np.asarray(jfn(jp, jcfg, toks))
        got = tfn(tp, tcfg, tt).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert sum(t.numel() for t in tree.leaves(tp)) == tcfg.param_count()
    init = tb.bert_init(tcfg, seed=0, device="cpu")
    assert ([tuple(t.shape) for t in tree.leaves(init)]
            == [tuple(t.shape) for t in tree.leaves(tp)])


def test_bert_embeddings_unit_norm_and_padding_invariant(bert):
    _, _, cfg, params = bert
    emb = tb.bert_embed(params, cfg, torch.tensor([[5, 6, 7, 8, 0, 0]]))
    assert torch.allclose(emb.norm(dim=-1), torch.ones(1), atol=1e-5)
    short = torch.tensor([[9, 10, 11]])
    padded = torch.zeros((1, 16), dtype=torch.int64)
    padded[0, :3] = short[0]
    np.testing.assert_allclose(tb.bert_embed(params, cfg, short).numpy(),
                               tb.bert_embed(params, cfg, padded).numpy(),
                               atol=1e-5)


def test_bert_batch_row_independence(bert):
    _, _, cfg, params = bert
    a = torch.tensor([[3, 4, 5, 0]])
    b = torch.tensor([[7, 8, 9, 10]])
    ea = tb.bert_embed(params, cfg, a)[0]
    eboth = tb.bert_embed(params, cfg, torch.cat([a, b]))[0]
    np.testing.assert_allclose(ea.numpy(), eboth.numpy(), atol=1e-5)


# -- the batcher -------------------------------------------------------------------
def _stub_capture():
    """A capture for Executor("cpu", capture=...): the eager callable, as a
    replay of a graph would compute it."""
    def capture(fn, inputs):
        return lambda: fn(*inputs)
    return capture


def test_batcher_batches_and_demuxes():
    seen = []

    def model(batch):                    # [B, D] -> [B]
        seen.append(tuple(batch.shape))
        return batch.sum(dim=-1)

    batcher = DynamicBatcher(model, executor=Executor("cpu"), max_batch=8,
                             window_s=0.05, name="sum")
    batcher.start()
    try:
        futures = [batcher.submit(np.full((4,), float(i), dtype=np.float32))
                   for i in range(5)]
        results = [f.result(timeout=30) for f in futures]
        assert [float(r) for r in results] == [0.0, 4.0, 8.0, 12.0, 16.0]
        # 5 requests -> padded batches of a bucket, not 5 separate calls
        assert all(shape[0] in (1, 2, 4, 8) for shape in seen)
        assert sum(batcher.batches.values()) <= 3
        assert all(name.startswith("sum-") for name in batcher.batches)
    finally:
        batcher.stop()


def test_batcher_variable_seq_padding():
    got = []

    def model(batch):                    # [B, T] -> [B]
        got.append(tuple(batch.shape))
        return batch.sum(dim=-1)

    batcher = DynamicBatcher(model, executor=Executor("cpu"), max_batch=4,
                             window_s=0.05, seq_axis=0, seq_buckets=(8, 16),
                             pad_value=0, name="varlen")
    batcher.start()
    try:
        f1 = batcher.submit(np.ones((3,), dtype=np.float32))
        f2 = batcher.submit(np.ones((7,), dtype=np.float32))
        assert float(f1.result(timeout=30)) == 3.0
        assert float(f2.result(timeout=30)) == 7.0
        assert all(shape[1] == 8 for shape in got)
        # an oversized payload is refused at submit, never batched
        with pytest.raises(ValueError, match="largest bucket"):
            batcher.submit(np.ones((17,), dtype=np.float32))
        # an unknown class is the typed 400
        with pytest.raises(InvalidParam):
            batcher.submit(np.ones((2,), dtype=np.float32),
                           qos_class="gold-tier")
    finally:
        batcher.stop()


def test_batcher_model_error_fails_futures():
    def model(batch):
        raise RuntimeError("device on fire")

    batcher = DynamicBatcher(model, executor=Executor("cpu"), max_batch=2,
                             window_s=0.01)
    batcher.start()
    try:
        future = batcher.submit(np.ones((2,), dtype=np.float32))
        with pytest.raises(RuntimeError, match="device on fire"):
            future.result(timeout=30)
    finally:
        batcher.stop()


def test_batcher_stop_fails_queued_and_infer_times_out():
    gate = threading.Event()

    def model(batch):
        gate.wait(10)
        return batch

    batcher = DynamicBatcher(lambda b: b, executor=Executor("cpu"))
    future = batcher.submit(np.ones((1,), dtype=np.float32))  # never started
    batcher.stop()
    with pytest.raises(RuntimeError):
        future.result(timeout=5)
    with pytest.raises(RuntimeError):
        batcher.submit(np.ones((1,), dtype=np.float32))
    slow = DynamicBatcher(model, executor=Executor("cpu"), window_s=0.001)
    slow.start()
    try:
        with pytest.raises(concurrent.futures.TimeoutError):
            slow.infer(np.ones((1,), dtype=np.float32), timeout_s=0.05)
    finally:
        gate.set()
        slow.stop()


def test_batcher_one_program_per_bucket_and_none_after_warmup():
    """Each (batch, sequence) bucket is one captured program, named by the
    batcher and the shape; after warm-up of the shapes traffic reaches, no
    batch captures."""
    ex = Executor("cpu", capture=_stub_capture())
    batcher = DynamicBatcher(lambda b: b.sum(dim=-1), executor=ex,
                             max_batch=4, window_s=0.02, seq_axis=0,
                             seq_buckets=(8, 16), name="emb")
    example = np.zeros((8,), dtype=np.int32)
    assert batcher.warmup((1, 2, 4), example) == 3
    assert batcher.warmup((1, 2, 4), np.zeros((16,), dtype=np.int32)) == 3
    assert sorted(ex.cache_info()) == ["emb-1x16", "emb-1x8", "emb-2x16",
                                       "emb-2x8", "emb-4x16", "emb-4x8"]
    captured = ex.captures
    batcher.start()
    try:
        futures = [batcher.submit(np.ones((n,), dtype=np.int32))
                   for n in (3, 9, 5, 2, 16, 1)]
        assert [int(f.result(timeout=30)) for f in futures] == [
            3, 9, 5, 2, 16, 1]
        assert ex.captures == captured
        assert set(batcher.batches) <= set(ex.cache_info())
    finally:
        batcher.stop()


# -- the servers over HTTP -----------------------------------------------------------
def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


ENV = {"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0",
       "LOG_LEVEL": "WARN", "REQUEST_TIMEOUT": "60",
       "INCIDENT_DIR": INCIDENT_DIR}


def _concurrently(fn, args):
    with concurrent.futures.ThreadPoolExecutor(len(args)) as pool:
        return list(pool.map(fn, args))


def test_mnist_server_predicts_as_the_jax_mlp(mlp):
    jp, tp = mlp
    app = serve_mnist.build_app({**ENV, "MAX_BATCH": "8",
                                 "BATCH_WINDOW_S": "0.02"}, device="cpu",
                                params=tp)
    app.start()
    try:
        # the reference's warm-up sizes, captured (here: made) at boot
        assert sorted(app.batcher.executor.cache_info()) == [
            "mnist-mlp-1x784", "mnist-mlp-64x784", "mnist-mlp-8x784"]
        images = np.random.default_rng(2).random((6, 784), dtype=np.float32)
        answers = _concurrently(lambda img: _post(
            app.http_port, "/predict", {"image": img.tolist()}), list(images))
        logits = np.asarray(jmlp.mlp_forward(jp, images))
        for (status, body), row in zip(answers, logits):
            assert status == 201, body
            probs = np.exp(row - row.max())
            probs /= probs.sum()
            assert body["data"]["digit"] == int(np.argmax(row))
            np.testing.assert_allclose(body["data"]["probs"], probs,
                                       atol=5e-5 + 1e-5)
        assert max(int(k.split("-")[-1].split("x")[0])
                   for k in app.batcher.batches) >= 2
        for bad in ({}, {"image": [0.0] * 783}, {"image": "x"}):
            assert _post(app.http_port, "/predict", bad)[0] == 400
    finally:
        app.shutdown()
    assert app.batcher._thread is None


def test_bert_server_embeds_as_the_jax_encoder(bert):
    jcfg, jp, _, tp = bert
    app = serve_bert.build_app({**ENV, "BERT_PRESET": "debug",
                                "MAX_BATCH": "8", "SEQ_BUCKETS": "16,32",
                                "BATCH_WINDOW_S": "0.02"}, device="cpu",
                               params=tp)
    app.start()
    try:
        texts = ["hello tpu", "a somewhat longer text to embed", "x",
                 "mixed lengths go to one batch"]
        answers = _concurrently(lambda t: _post(
            app.http_port, "/embed", {"text": t}), texts)
        for (status, body), text in zip(answers, texts):
            assert status == 201, body
            ids = np.asarray([[b + 1 for b in text.encode()]], dtype=np.int32)
            want = np.asarray(jb.bert_embed(jp, jcfg, ids))[0]
            assert body["data"]["dim"] == 64
            np.testing.assert_allclose(body["data"]["embedding"], want,
                                       atol=5e-7 + 1e-5)
        status, body = _post(app.http_port, "/embed", {"tokens": [5, 6, 7]})
        assert status == 201
        want = np.asarray(jb.bert_embed(jp, jcfg, np.asarray([[5, 6, 7]])))[0]
        np.testing.assert_allclose(body["data"]["embedding"], want, atol=2e-5)
        for bad in ({}, {"tokens": []}, {"tokens": [0, 1]},
                    {"tokens": [600]}, {"tokens": list(range(1, 40))},
                    {"tokens": "abc"}):
            assert _post(app.http_port, "/embed", bad)[0] == 400, bad
        # a text longer than the largest bucket is cut, never refused
        assert _post(app.http_port, "/embed", {"text": "y" * 100})[0] == 201
    finally:
        app.shutdown()


def test_servers_refuse_unported_keys_and_need_a_device():
    # no key waits any more: the keys once refused (bert's GRPC_PORT, the
    # REMOTE_LOG_URL poller) boot and are served
    assert serve_bert.NOT_PORTED == serve_mnist.NOT_PORTED == ()
    app = serve_bert.build_app(ENV, device="cpu")
    try:
        assert [s.__grpc_service_name__ for s in app._grpc_services] == [
            "EmbedService"]
    finally:
        app.shutdown()
    app = serve_mnist.build_app({**ENV, "REMOTE_LOG_URL": "http://127.0.0.1:9",
                                 "REMOTE_LOG_FETCH_INTERVAL": "30"},
                                device="cpu")
    poller = app.container._level_poller
    assert poller is not None and poller.is_alive()
    app.shutdown()
    assert not poller.is_alive()
    if not torch.cuda.is_available():
        from gofr_tpu_torch.models import moe as tm

        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_mnist.build_app(ENV)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_bert.build_app(ENV)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DynamicBatcher(lambda b: b)
        for init, cfg in ((tmlp.mlp_init, tmlp.MLPConfig()),
                          (tb.bert_init, tb.BertConfig.debug()),
                          (tm.moe_llama_init, tm.MoELlamaConfig.debug())):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                init(cfg)


def test_batcher_records_its_metrics():
    from gofr_tpu_torch.metrics import Manager
    from gofr_tpu_torch.tpu.device import register_metrics

    metrics = Manager()
    register_metrics(metrics)
    batcher = DynamicBatcher(lambda b: b * 2, executor=Executor("cpu"),
                             max_batch=4, window_s=0.01, metrics=metrics)
    batcher.start()
    try:
        out = batcher.infer(np.ones((3,), dtype=np.float32), timeout_s=30)
        np.testing.assert_array_equal(out, np.full((3,), 2.0))
    finally:
        batcher.stop()
    text = metrics.expose()
    assert "app_tpu_batch_size" in text and "app_tpu_queue_depth" in text
