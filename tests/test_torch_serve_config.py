"""The port's server config against the reference llm-server's.

Every key examples/llm-server/main.py and examples/openai-server/main.py
read, and every App-level key of gofr_tpu/app.py, gofr_tpu/container/,
gofr_tpu/tracing/ and gofr_tpu/tpu/faults.py (taken from their text, not by
importing them), must be
served (serve.PORTED, and read by the port's server, App or container),
refused at boot naming its ROADMAP item (NOT_PORTED) or inert with a
stated reason (INERT); a new key there fails this file until it is
accounted for. build_engine boots from WEIGHTS_PATH (file, directory,
sharded), WEIGHT_DTYPE=int8 (with and without WEIGHTS_PATH) and VOCAB_PATH
(tokenizer.json, tiktoken, {vocab, merges}) in the four configurations,
and its greedy streams equal the JAX engines' on the same weights;
HBM_BUDGET_BYTES plans as the reference's engine does; DRAIN_TIMEOUT
drains as the reference's (tests/test_tpu_runtime.py:568): the active
stream finishes, new and queued requests get 503.
"""

import base64
import dataclasses
import http.client
import inspect
import json
import os
import pathlib
import re
import sys
import threading
import time

import jax
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.models import weights as jw
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch import serve
from gofr_tpu_torch.models import tokenizer as tt
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu.engine import EngineDrainingError, LLMEngine
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

from _torch_env import INCIDENT_DIR

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAIN = ROOT / "examples" / "llm-server" / "main.py"
# the other sources whose config keys the port's servers account for
KEY_SOURCES = [ROOT / "examples" / "openai-server" / "main.py",
               ROOT / "gofr_tpu" / "app.py",
               ROOT / "gofr_tpu" / "container" / "__init__.py",
               ROOT / "gofr_tpu" / "tracing" / "__init__.py",
               ROOT / "gofr_tpu" / "tpu" / "faults.py"]
BASE = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "MAX_BATCH": "4",
        "GRPC_PORT": "0",
        "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8",
        "WARMUP": "false", "REQUEST_TIMEOUT": "120",
        "INCIDENT_DIR": INCIDENT_DIR}
CONFIGS = {
    "paged": {},
    "paged-int8": {"KV_DTYPE": "int8"},
    "dense": {"PAGED": "false", "DECODE_ATTN": "kernel"},
    "dense-int8": {"PAGED": "false", "DECODE_ATTN": "kernel",
                   "KV_DTYPE": "int8"},
}
PROMPTS = [[5, 6, 7], list(range(20, 33)), [1, 2]]


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


def _reference_keys():
    keys = set()
    for path in [MAIN] + KEY_SOURCES:
        # config.get_*("KEY") and the App's cfg = self.config reads
        keys.update(re.findall(
            r'(?:config|cfg)\.get(?:_\w+)?\(\s*"([A-Z0-9_]+)"',
            path.read_text()))
    # the App's config directory comes from the process environment
    keys.update(re.findall(r'environ\.get\(\s*"([A-Z0-9_]+)"',
                           KEY_SOURCES[1].read_text()))
    return sorted(keys)


def test_every_llm_server_key_is_accounted_for():
    keys = _reference_keys()
    assert len(keys) >= 85
    assert {"METRICS_PORT", "LOG_LEVEL", "APP_NAME", "APP_VERSION",
            "TRACE_EXPORTER", "TRACER_URL", "REMOTE_LOG_URL",
            "MAX_CONCURRENT_REQUESTS", "GOFR_CONFIGS_DIR",
            "GRPC_PORT"} <= set(keys)
    ported = set(serve.PORTED)
    refused = {k for k, _, _ in serve.NOT_PORTED}
    inert = {k for k, _ in serve.INERT}
    assert not (ported & refused) and not (ported & inert) \
        and not (refused & inert)
    missing = [k for k in keys if k not in ported | refused | inert]
    assert not missing, f"unaccounted llm-server keys: {missing}"
    # and nothing listed that the reference does not read
    assert not (ported | refused | inert) - set(keys)


def test_only_the_waiting_keys_stay_refused_or_inert():
    """No key waits any more: the remote log level, gRPC and the device
    client are served (A18b parts 5-6), so nothing is refused, and the one
    inert key is the one with no analogue (the XLA program cache), with
    its reason."""
    assert serve.NOT_PORTED == ()
    assert {k for k, _ in serve.INERT} == {"PROGRAM_CACHE_DIR"}
    assert "CUDA graphs" in dict(serve.INERT)["PROGRAM_CACHE_DIR"]
    assert {"GRPC_PORT", "TPU_ENABLED", "MODEL_NAME", "REMOTE_LOG_URL",
            "REMOTE_LOG_FETCH_INTERVAL"} <= set(serve.PORTED)
    serve.check_config({"REMOTE_LOG_URL": "http://127.0.0.1:9/level"})


@pytest.mark.parametrize("key", serve.PORTED)
def test_ported_keys_are_read_by_the_server(key):
    from gofr_tpu_torch import app, container, tracing
    from gofr_tpu_torch.tpu import faults

    src = "".join(inspect.getsource(f) for f in (
        serve.build_engine, serve.build_app, serve.app_for,
        serve._warmup_mode, app.App, container.Container,
        tracing.exporter_from_config, faults.plane_from_config))
    assert f'"{key}"' in src


@pytest.mark.parametrize("key", [k for k, _ in serve.INERT])
def test_inert_keys_boot_and_change_nothing(key, served):
    """Set to a value the reference would act on, an inert key boots and
    serves the same greedy tokens as without it."""
    reason = dict(serve.INERT)[key]
    assert len(reason) > 20
    env = {**BASE, key: "false" if key in (
        "FLIGHT_RECORDER", "FLIGHT_TRACE_EXPORT", "ENGINE_SNAPSHOT",
        "STEP_LEDGER", "TIMELINE", "HOSTPROF", "INCIDENT_AUTOPSY",
        "CAPACITY") else "/tmp/x" if key == "PROGRAM_CACHE_DIR" else "3"}
    eng = serve.build_engine(env, device="cpu", params=served["float"][1])
    try:
        assert [eng.generate(p, max_new_tokens=6) for p in PROMPTS] == \
            served["float"][2]["paged"]
    finally:
        eng.stop()


# the QoS plane's tuning keys (App.enable_qos) and a value each
QOS_TUNING = {"QOS_INTERACTIVE_RESERVED_SLOTS": "2",
              "QOS_BATCH_PAGE_FRACTION": "0.25",
              "QOS_DEADLINE_INTERACTIVE_S": "1.5",
              "QOS_DEADLINE_STANDARD_S": "4", "QOS_DEADLINE_BATCH_S": "30",
              "QOS_SHED_TRACKS": "ttft, availability",
              "QOS_ESCALATE_HOLD_S": "7", "QOS_RECOVER_HOLD_S": "11",
              "QOS_EVAL_S": "0.5", "QOS_SHED_RETRY_AFTER_S": "4"}
QOS_LANE_KEYS = ("QOS_LANE", "QOS_LANE_CRON", "QOS_LANE_MAX_INFLIGHT",
                 "QOS_BATCH_TOPIC", "QOS_BATCH_RESULT_TOPIC")


def _controller_settings(ctl) -> dict:
    snap = ctl.snapshot()
    return {"quotas": snap["quotas"],
            "deadlines": {c: v["deadline_s"]
                          for c, v in snap["classes"].items()},
            "tracks": snap["ladder"]["shed_tracks"],
            "holds": (ctl.escalate_hold_s, ctl.recover_hold_s),
            "retry_after_s": ctl.retry_after_s}


@pytest.mark.parametrize("tuned", [False, True], ids=["defaults", "tuned"])
def test_qos_keys_tune_the_controller_as_the_reference(served, tuned):
    """QOS=true, with its defaults and with every tuning key set: the
    port's controller holds the settings the reference's App.enable_qos
    gives it from the same config, its eval thread runs at QOS_EVAL_S and
    stops at shutdown; the batch lane's keys are served, and without a
    pub/sub broker (no PUBSUB_BACKEND) neither App starts a lane."""
    import types

    from gofr_tpu.app import App as JApp
    from gofr_tpu.config import MockConfig

    env = {**BASE, "QOS": "true", **(QOS_TUNING if tuned else {})}
    assert set(QOS_TUNING) | {"QOS"} <= set(serve.PORTED)
    assert set(QOS_LANE_KEYS) <= set(serve.PORTED)
    app = serve.build_app({**env, "QOS_LANE": "true"},
                          engine=serve.build_engine(
                              env, device="cpu", params=served["float"][1]))
    ref = JApp(config=MockConfig({**env, "HTTP_PORT": "0",
                                  "METRICS_PORT": "0"}))
    stub = types.SimpleNamespace(recorder=None)
    try:
        ctl = app.engine.qos
        want = ref.enable_qos(stub)
        assert _controller_settings(ctl) == _controller_settings(want)
        assert ctl._eval_thread is not None and ctl._eval_thread.is_alive()
        assert ctl.lane is None and want.lane is None
        if tuned:
            assert ctl.interactive_reserved_slots == 2
            assert ctl.shed_tracks == ("ttft", "availability")
    finally:
        app.shutdown()
        want.stop()
        ref.shutdown()
    assert ctl._eval_thread is None


def test_build_engine_serves_a_cut_tree_at_its_depth(served):
    """A params tree of the preset's first layer: build_engine serves it at
    that depth and the preset's width, with the JAX engine's greedy
    streams on the same cut tree."""
    jtree, ttree = served["float"][0], served["float"][1]
    cut_j = {**jtree, "layers": {k: v[:1] for k, v in jtree["layers"].items()}}
    cut_t = {**ttree, "layers": {k: v[:1] for k, v in ttree["layers"].items()}}
    want = _jax_goldens(cut_j, {"n_layers": 1}, True)
    eng = serve.build_engine(BASE, device="cpu", params=cut_t)
    try:
        assert eng.cfg.n_layers == 1 and eng.cfg.dim == 64
        assert [eng.generate(p, max_new_tokens=6) for p in PROMPTS] == want
    finally:
        eng.stop()


def test_elastic_warm_boot_refused_naming_a11(served):
    """The warm boot is served now (ROADMAP A11f): ELASTIC_WARM_BOOT=true
    boots ``warming`` and then serves the JAX engine's streams; what stays
    refused names its ROADMAP item. The Redis cold tier under the KV tier
    and the pub/sub hand-off transport are served now (A18b parts 2-3),
    and so is the remote log-level poller (A18b part 5): the engine's
    container polls REMOTE_LOG_URL until it is closed."""
    eng = serve.build_engine({**BASE, "ELASTIC_WARM_BOOT": "true"},
                             device="cpu", params=served["float"][1])
    try:
        eng.warm_boot_thread.join(timeout=60)
        assert eng.lifecycle.state == "serving"
        assert eng.warm_boot_s is not None and eng.prewarmed_pages == 0
        assert [eng.generate(p, max_new_tokens=6) for p in PROMPTS] == \
            served["float"][2]["paged"]
    finally:
        eng.stop()
    for env in ({"KV_HOST_TIER_BYTES": "1048576", "KV_REDIS_TIER": "true"},
                {"DISAGG_MODE": "both", "DISAGG_TRANSPORT": "pubsub"}):
        serve.check_config({**BASE, **env})
    eng = serve.build_engine({**BASE, "REMOTE_LOG_URL": "http://127.0.0.1:9"},
                             device="cpu", params=served["float"][1])
    poller = eng.container._level_poller
    try:
        assert poller.is_alive()
    finally:
        eng.stop()
        eng.container.close()
    assert not poller.is_alive()
    serve.check_config({"ELASTIC_WARM_BOOT": "false"})
    serve.check_config({"KV_REDIS_TIER": "true"})   # no tier: nothing asked
    serve.check_config({"DISAGG_MODE": "both", "DISAGG_TRANSPORT": "queue"})


@pytest.mark.parametrize("extra", [
    {"DISAGG_MODE": "both"},
    {"KV_HOST_TIER_BYTES": "1048576", "CONVERSATION_PIN_S": "30"},
    {"DISAGG_MODE": "both", "KV_HOST_TIER_BYTES": "1048576",
     "DISAGG_PREFILL_SLOTS": "2", "DISAGG_QUEUE_DEPTH": "8",
     "DISAGG_HANDOFF_TIMEOUT_S": "5", "DISAGG_TRANSPORT": "queue"},
], ids=["pair", "tier", "pair-tier"])
def test_disagg_pair_and_kv_tier_boot_and_serve(served, extra):
    """DISAGG_MODE=both (two engines over one params tree, the router in
    front, GET /debug/disagg) and KV_HOST_TIER_BYTES boot through
    build_app and serve the JAX engine's streams; the pair hands every
    request off with no prefill on the decode pool."""
    env = {**BASE, **extra}
    app = serve.build_app(env, engine=serve.build_engine(
        env, device="cpu", params=served["float"][1]))
    try:
        eng = app.engine
        got = [app.submitter.submit(p, max_new_tokens=6).result(timeout_s=60)
               for p in PROMPTS]
        assert got == served["float"][2]["paged"]
        router = eng.disagg_router
        if "DISAGG_MODE" in env:
            pre = router.prefill_engine
            assert app.submitter is router and eng.disagg_role == "decode"
            assert pre.params is eng.params and pre.disagg_role == "prefill"
            assert pre.n_slots == int(env.get("DISAGG_PREFILL_SLOTS", 4))
            assert router.handoff_timeout_s == float(
                env.get("DISAGG_HANDOFF_TIMEOUT_S", 10))
            assert pre.handoffs_total == len(PROMPTS)
            assert eng.prefill_dispatches + eng.prefix_dispatches == 0
            assert pre.recorder is not None and pre.recorder is not \
                eng.recorder
            assert any(r.pattern == "/debug/disagg"
                       for r in app.router._routes)
        else:
            assert router is None and app.submitter is eng
        if "KV_HOST_TIER_BYTES" in env:
            assert eng.kv_tier.capacity_bytes == 1048576
            assert eng.conversation_pin_s == float(
                env.get("CONVERSATION_PIN_S", 600))
    finally:
        app.shutdown()


def test_disagg_mode_values_and_paged_only():
    with pytest.raises(ValueError, match="off|prefill|decode|both"):
        serve.build_engine({**BASE, "DISAGG_MODE": "split"}, device="cpu")
    with pytest.raises(ValueError, match="PAGED=true"):
        serve.build_engine({**BASE, "DISAGG_MODE": "both", "PAGED": "false",
                            "DECODE_ATTN": "kernel"}, device="cpu")


def test_weight_dtype_other_than_int8_refused():
    with pytest.raises(ValueError, match="WEIGHT_DTYPE must be int8"):
        serve.build_engine({"WEIGHT_DTYPE": "fp8"}, device="cpu")


def _jax_goldens(params, cfg_changes, paged):
    cfg = dataclasses.replace(jl.LlamaConfig.debug(), **cfg_changes)
    kw = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16))
    eng = (JPaged(params, cfg, page_size=8, logger=_QuietLogger(), **kw)
           if paged else JEngine(params, cfg, logger=_QuietLogger(), **kw))
    eng.start()
    try:
        return [eng.generate(p, max_new_tokens=6, temperature=0.0)
                for p in PROMPTS]
    finally:
        eng.stop()


_JAX_CFG = {"paged": {}, "paged-int8": {"kv_dtype": "int8"},
            "dense": {"decode_attn": "kernel"},
            "dense-int8": {"decode_attn": "kernel", "kv_dtype": "int8"}}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{"float" | "int8": (JAX tree, port tree, {config: JAX greedy
    streams})} and "ckpt": the JAX export of the float tree, as a file,
    a directory and a sharded index."""
    fp = jl.llama_init(jl.LlamaConfig.debug(), seed=0)
    q = jl.quantize_weights(jl.llama_init(jl.LlamaConfig.debug(), seed=0))
    out = {}
    for name, tree in (("float", fp), ("int8", q)):
        out[name] = (tree, params_from_numpy(jax.device_get(tree),
                                             device="cpu"),
                     {c: _jax_goldens(tree, _JAX_CFG[c], c.startswith("paged"))
                      for c in CONFIGS})
    d = tmp_path_factory.mktemp("ckpt")
    (d / "file").mkdir()
    (d / "sharded").mkdir()
    whole = str(d / "file" / "model.safetensors")
    jw.export_llama_safetensors(fp, whole)
    f = jw.SafetensorsFile(whole)
    names = sorted(f.keys())
    weight_map = {}
    for i, members in enumerate((names[:len(names) // 2],
                                 names[len(names) // 2:])):
        fname = f"model-0000{i + 1}-of-00002.safetensors"
        jw.write_safetensors(str(d / "sharded" / fname),
                             {n: f.tensor(n) for n in members})
        weight_map.update({n: fname for n in members})
    with open(d / "sharded" / "model.safetensors.index.json", "w") as fp_:
        json.dump({"weight_map": weight_map}, fp_)
    out["ckpt"] = {"file": whole, "directory": str(d / "file"),
                   "sharded": str(d / "sharded" /
                                  "model.safetensors.index.json")}
    return out


# (WEIGHTS_PATH form or None, WEIGHT_DTYPE): the weight sources
SOURCES = {
    "file": ("file", None), "directory": ("directory", None),
    "sharded": ("sharded", None), "file-int8": ("file", "int8"),
    "sharded-int8": ("sharded", "int8"), "init-int8": (None, "int8"),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_build_engine_boots_from_weights(served, config, source):
    form, dtype = SOURCES[source]
    env = {**BASE, **CONFIGS[config]}
    if form:
        env["WEIGHTS_PATH"] = served["ckpt"][form]
    if dtype:
        env["WEIGHT_DTYPE"] = dtype
    eng = serve.build_engine(env, device="cpu")
    try:
        assert isinstance(eng, PagedLLMEngine) == config.startswith("paged")
        want = served["int8" if dtype else "float"]
        if form is None:    # llama_init_quantized: the port's own draw
            from gofr_tpu_torch.models import llama as tl

            assert eng.params["layers"]["wq"].dtype == torch.int8
            assert tl.params_nbytes(eng.params) < tl.params_nbytes(
                tl.llama_init(tl.LlamaConfig.debug(), 0, "cpu"))
            return
        got = [eng.generate(p, max_new_tokens=6) for p in PROMPTS]
        assert got == want[2][config]
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    """{format: path}: a trained byte-level tokenizer.json, its tiktoken
    form, and the shipped {vocab, merges} test vocab."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import Regex, models, pre_tokenizers, trainers

    tok = tokenizers.Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(tt._LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.train_from_iterator(
        (ROOT / "README.md").read_text(encoding="utf-8").splitlines(),
        trainers.BpeTrainer(
            vocab_size=400, special_tokens=["<|begin_of_text|>",
                                            "<|end_of_text|>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    d = tmp_path_factory.mktemp("vocab")
    tok.save(str(d / "tokenizer.json"))
    vocab = json.loads((d / "tokenizer.json").read_text())["model"]["vocab"]
    u2b = {c: b for b, c in tt.bytes_to_unicode().items()}
    (d / "tokenizer.model").write_text("".join(
        f"{base64.b64encode(bytes(u2b[c] for c in p)).decode()} {r}\n"
        for p, r in sorted(vocab.items(), key=lambda kv: kv[1])))
    return {"tokenizer.json": str(d / "tokenizer.json"),
            "tiktoken": str(d / "tokenizer.model"),
            "vocab-json": str(ROOT / "examples" / "llm-server" /
                              "vocab.test.json")}


def _reference_loader():
    import importlib.util

    spec = importlib.util.spec_from_file_location("example_llm_server_c2",
                                                  str(MAIN))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._load_tokenizer


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read().decode(), dict(resp.getheaders())


@pytest.mark.parametrize("fmt", ["tokenizer.json", "tiktoken", "vocab-json"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_vocab_path_serves(served, vocab_files, fmt, config):
    path = vocab_files[fmt]
    ref = _reference_loader()(path)
    env = {**BASE, **CONFIGS[config], "VOCAB_PATH": path,
           "WEIGHT_DTYPE": "int8"}
    eng = serve.build_engine(env, device="cpu", params=served["int8"][1])
    app = serve.build_app(env, engine=eng)
    app.start()
    try:
        tok = eng.tokenizer
        assert type(tok).__name__ == type(ref).__name__
        text = "hello world's 12"
        assert tok.encode(text) == ref.encode(text)
        # min_tokens: the lengths do not hang on whether the random model
        # samples the tokenizer's EOS
        status, body, _ = _post(app.http_port, {"prompt": text,
                                                "max_tokens": 6,
                                                "min_tokens": 6,
                                                "stream": False})
        assert status == 201, body
        assert json.loads(body)["data"]["tokens"] == 6
        status, body, _ = _post(app.http_port, {"prompt": text,
                                                "max_tokens": 4,
                                                "min_tokens": 4})
        events = [json.loads(line[6:]) for line in body.splitlines()
                  if line.startswith("data: ")]
        assert status == 200 and events[-1]["tokens"] == 4
    finally:
        app.shutdown()


def test_model_vocab_too_small_refused(tmp_path):
    path = tmp_path / "v.json"
    path.write_text(json.dumps({"vocab": {"a": 0, "<s>": 1, "</s>": 600},
                                "merges": []}))
    with pytest.raises(ValueError, match="too small for tokenizer"):
        serve.build_engine({"VOCAB_PATH": str(path)}, device="cpu")


@pytest.mark.parametrize("paged", [True, False])
def test_hbm_budget_plans_as_the_reference(served, paged):
    env = {**BASE, "MAX_BATCH": "8", "MAX_SEQ_LEN": "256",
           "PREFILL_BUCKETS": "8,64", "HBM_BUDGET_BYTES": str(1 << 21)}
    if not paged:
        env["PAGED"] = "false"
    eng = serve.build_engine(env, device="cpu", params=served["float"][1])
    try:
        kw = dict(n_slots=8, max_seq_len=256, prefill_buckets=(8, 64),
                  budget_bytes=1 << 21, logger=_QuietLogger())
        ref = (JPaged(served["float"][0], jl.LlamaConfig.debug(),
                      page_size=8, **kw) if paged else
               JEngine(served["float"][0], jl.LlamaConfig.debug(), **kw))
        assert eng.plan is not None and eng.plan.clamped
        assert (eng.n_slots, eng.max_seq_len, eng.prefill_buckets) == (
            ref.n_slots, ref.max_seq_len, ref.prefill_buckets)
        assert eng.generate([5, 6, 7], max_new_tokens=3)
    finally:
        eng.stop()


@pytest.mark.parametrize("budget", ["-1", "0", None])
def test_no_plan_without_a_budget_on_the_cpu(served, budget):
    env = dict(BASE)
    if budget is not None:
        env["HBM_BUDGET_BYTES"] = budget
    eng = serve.build_engine(env, device="cpu", params=served["float"][1])
    try:
        assert eng.plan is None
    finally:
        eng.stop()


def _gated(engine):
    """Hold the engine's decode dispatches until the returned event is
    set, so a request stays active while the test sets up the drain; once
    the engine is stopping, the held dispatch fails instead."""
    go = threading.Event()
    real = engine._dispatch_decode

    def gated():
        go.wait(timeout=60)
        if engine._stop.is_set():
            raise RuntimeError("stopped while held")
        real()

    engine._dispatch_decode = gated
    return go


def _wait(cond, what):
    deadline = time.monotonic() + 60
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


@pytest.mark.parametrize("cls", [PagedLLMEngine, LLMEngine])
def test_drain_finishes_active_and_fails_queued_and_new(served, cls):
    from gofr_tpu_torch.models.llama import LlamaConfig

    kw = dict(page_size=8) if cls is PagedLLMEngine else {}
    eng = cls(served["float"][1], LlamaConfig.debug(), n_slots=1,
              max_seq_len=64, prefill_buckets=(8, 16), device="cpu", **kw)
    go = _gated(eng)
    eng.start()
    try:
        active = eng.submit([1, 2, 3], max_new_tokens=24)
        _wait(lambda: any(s.request is active for s in eng.slots),
              "never admitted")
        queued = eng.submit([4, 5], max_new_tokens=4)
        result = {}
        drainer = threading.Thread(
            target=lambda: result.update(ok=eng.drain(timeout_s=60)))
        drainer.start()
        _wait(lambda: eng._draining, "drain never began")
        with pytest.raises(EngineDrainingError) as exc:
            eng.submit([6, 7], max_new_tokens=4)
        assert exc.value.status_code == 503
        go.set()
        drainer.join(timeout=90)
        assert result == {"ok": True}
        assert len(active.result(timeout_s=10)) == 24
        with pytest.raises(EngineDrainingError):
            queued.result(timeout_s=10)
        eng.stop()
        eng.start()         # a drained engine may be restarted
        assert len(eng.generate([7, 8, 9], max_new_tokens=3)) == 3
    finally:
        go.set()
        eng.stop()


def test_drain_times_out_and_stop_fails_the_rest(served):
    from gofr_tpu_torch.models.llama import LlamaConfig

    eng = PagedLLMEngine(served["float"][1], LlamaConfig.debug(), n_slots=1,
                         max_seq_len=64, prefill_buckets=(8,), page_size=8,
                         device="cpu")
    go = _gated(eng)
    eng.start()
    try:
        active = eng.submit([1, 2, 3], max_new_tokens=24)
        _wait(lambda: any(s.request is active for s in eng.slots),
              "never admitted")
        assert eng.drain(timeout_s=0.2) is False
        stopper = threading.Thread(target=eng.stop)
        stopper.start()
        _wait(eng._stop.is_set, "stop never began")
        go.set()
        stopper.join(timeout=60)
        with pytest.raises(RuntimeError, match="engine stopped"):
            active.result(timeout_s=10)
    finally:
        go.set()
        eng.stop()


def test_shutdown_drains_with_503_over_http(served):
    env = {**BASE, "MAX_BATCH": "1", "DRAIN_TIMEOUT": "60"}
    eng = serve.build_engine(env, device="cpu", params=served["float"][1])
    go = _gated(eng)
    app = serve.build_app(env, engine=eng)
    app.start()
    port = app.http_port
    replies = {}
    try:
        first = threading.Thread(target=lambda: replies.update(
            active=_post(port, {"prompt": "hello", "max_tokens": 20})))
        first.start()
        _wait(lambda: any(s.active for s in eng.slots), "never admitted")
        second = threading.Thread(target=lambda: replies.update(
            queued=_post(port, {"prompt": "queued", "max_tokens": 4,
                                "stream": False})))
        second.start()
        _wait(lambda: eng.queue_depth() == 1, "never queued")
        stopper = threading.Thread(target=app.shutdown)
        stopper.start()
        _wait(lambda: eng._draining, "drain never began")
        replies["new"] = _post(port, {"prompt": "late", "max_tokens": 4})
        go.set()
        for t in (first, second, stopper):
            t.join(timeout=90)
    finally:
        go.set()
        app.shutdown()
    status, body, _ = replies["active"]
    events = [json.loads(line[6:]) for line in body.splitlines()
              if line.startswith("data: ")]
    assert status == 200 and events[-1] == {**events[-1], "done": True,
                                            "tokens": 20}
    for key in ("queued", "new"):
        status, body, headers = replies[key]
        assert status == 503, (key, body)
        assert "draining" in body
        assert headers.get("Retry-After") in ("1", "1.0")


def test_module_docstring_names_every_ported_key():
    doc = serve.__doc__
    for key in serve.PORTED:
        assert key in doc, key
    assert os.path.exists(MAIN)


# -- the batcher servers (serve_mnist, serve_bert) ---------------------------------
def _app_ctor_keys():
    """The keys the reference App's constructor reads (the batcher servers
    enable none of its planes, whose keys the rest of app.py reads)."""
    import ast

    src = KEY_SOURCES[1].read_text()
    app_cls = next(n for n in ast.parse(src).body
                   if isinstance(n, ast.ClassDef) and n.name == "App")
    init = next(n for n in app_cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    text = ast.get_source_segment(src, init)
    return set(re.findall(r'(?:config|cfg)\.get(?:_\w+)?\(\s*"([A-Z0-9_]+)"',
                          text)) | set(re.findall(
                              r'environ\.get\(\s*"([A-Z0-9_]+)"', text))


def _batcher_server_keys(example: str):
    """Every key the reference batcher server reads: its main.py, its App's
    constructor, its container's and tracer's, and its device client's."""
    keys = _app_ctor_keys()
    for path in (ROOT / "examples" / example / "main.py",
                 KEY_SOURCES[2], KEY_SOURCES[3],
                 ROOT / "gofr_tpu" / "tpu" / "device.py"):
        keys.update(re.findall(
            r'(?:config|cfg)\.get(?:_\w+)?\(\s*"([A-Z0-9_]+)"',
            path.read_text()))
    return keys


@pytest.mark.parametrize("example,module", [("mnist-server", "serve_mnist"),
                                            ("bert-embed", "serve_bert")])
def test_every_batcher_server_key_is_accounted_for(example, module):
    from gofr_tpu_torch import serve_bert, serve_mnist

    mod = {"serve_mnist": serve_mnist, "serve_bert": serve_bert}[module]
    keys = _batcher_server_keys(example)
    assert {"MAX_BATCH", "BATCH_WINDOW_S", "HTTP_PORT", "GRPC_PORT",
            "TPU_ENABLED", "TPU_PLATFORM", "GOFR_CONFIGS_DIR"} <= keys
    if module == "serve_bert":
        assert {"BERT_PRESET", "SEQ_BUCKETS"} <= keys
    ported = set(mod.PORTED)
    refused = {k for k, _, _ in mod.NOT_PORTED}
    inert = {k for k, _ in mod.INERT}
    assert not (ported & refused) and not (ported & inert) \
        and not (refused & inert)
    missing = sorted(keys - (ported | refused | inert))
    assert not missing, f"unaccounted {example} keys: {missing}"
    # and nothing listed that the reference server does not read
    assert not (ported | refused | inert) - keys
    assert all(len(why) > 20 for _, why in mod.INERT)
    # every served key is read by the server, its App, container or tracer
    from gofr_tpu_torch import app, container, tracing

    src = "".join(inspect.getsource(f) for f in (
        mod.build_app, serve_mnist.batcher_app, app.App, container.Container,
        tracing.exporter_from_config))
    for key in ported:
        assert f'"{key}"' in src, key
    doc = mod.__doc__
    for key in set(mod.PORTED) - set(serve_mnist.APP_PORTED):
        assert key in doc, key


# -- tensor-parallel serving (TP_SHARDS, the JAX_* keys) ----------------------
@pytest.mark.parametrize("config", ["paged", "dense"])
def test_tp_shards_boots_serves_and_stops_its_follower(served, config):
    """TP_SHARDS=2 on the CPU: this process is rank 0 of a local gloo job
    and starts rank 1 (spawned) over a TCPStore; both load the same
    checkpoint, each holds its KV heads, rank 1 replays rank 0's waves,
    the greedy streams equal the JAX single-device engine's, /generate
    answers on rank 0 only, and the App's shutdown stops the follower."""
    env = {**BASE, **CONFIGS[config], "TP_SHARDS": "2",
           "WEIGHTS_PATH": served["ckpt"]["file"], "LOG_LEVEL": "WARN"}
    app = serve.build_app(env, device="cpu")
    eng = app.engine
    (follower,) = eng.followers
    try:
        assert follower.is_alive() and eng.tp_size == 2
        assert eng._plane.is_leader
        kv = eng.k_cache if config == "paged" else eng.k_cache[0]
        assert kv.shape[-3 if config == "dense" else 2] == 1  # 2 KV heads / 2
        got = [eng.generate(p, max_new_tokens=6, temperature=0.0)
               for p in PROMPTS]
        assert got == served["float"][2][config]
        app.start()
        status, body, _ = _post(app.http_port, {"prompt": "hello",
                                                "max_tokens": 4,
                                                "stream": False})
        assert status == 201 or status == 200, body
        assert json.loads(body)["data"]["tokens"] == 4
    finally:
        app.shutdown()
    follower.join(timeout=30)
    assert not follower.is_alive() and follower.exitcode == 0


def test_tp_shards_above_the_visible_cards_refused_at_boot(monkeypatch):
    """Two ranks never share a card and no smaller TP is served instead:
    with one card visible, TP_SHARDS=2 raises before any process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="TP_SHARDS=2 needs 2 cards, 1 "
                                         "visible"):
        serve.build_engine({**BASE, "TP_SHARDS": "2"})


def test_tp_shards_must_match_the_job(monkeypatch):
    """Under an operator's job (JAX_COORDINATOR_ADDR) the job is one tp
    group: TP_SHARDS other than JAX_NUM_PROCESSES is refused."""
    import gofr_tpu_torch.container as container_mod
    from gofr_tpu_torch.parallel.multihost import MultiHostSpec

    monkeypatch.setattr(
        container_mod.Container, "join_job",
        lambda self, device=None, config=None: (
            MultiHostSpec.from_config(config), torch.device("cpu")))
    with pytest.raises(ValueError, match="TP_SHARDS=1 but the job has 2"):
        serve.build_engine({**BASE, "JAX_COORDINATOR_ADDR": "127.0.0.1:1",
                            "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "0"},
                           device="cpu")


# -- the datasources, pub/sub and the batch lane under serving ----------------
def _lane_results(broker, n, timeout_s=120.0):
    """{job_id: result} from the lane's result topic, read by a group of
    the test's own."""
    out = {}
    deadline = time.monotonic() + timeout_s
    while len(out) < n and time.monotonic() < deadline:
        msg = broker.subscribe("qos.batch.results", "test", timeout_s=0.5)
        if msg is None:
            continue
        payload = json.loads(msg.value.decode())
        out[payload.get("job_id")] = payload
        msg.commit()
    return out


@pytest.mark.parametrize("config", ["paged", "dense"])
def test_served_pubsub_qos_starts_the_batch_lane(served, config):
    """PUBSUB_BACKEND=inproc with QOS=true: the App starts the batch lane
    over the container's broker, with its keys' settings, on either
    engine. Jobs published to QOS_BATCH_TOPIC come back on
    QOS_BATCH_RESULT_TOPIC with the JAX engine's greedy streams, in
    arrival order; /debug/qos carries the lane and the scrape sets
    app_tpu_qos_lane_depth; the cron drain kick runs on a crontab tick;
    the shutdown stops the lane."""
    env = {**BASE, **CONFIGS[config], "QOS": "true",
           "PUBSUB_BACKEND": "inproc", "QOS_LANE_MAX_INFLIGHT": "2",
           "QOS_BATCH_TOPIC": "jobs", "QOS_LANE_CRON": "*/1 * * * *"}
    app = serve.build_app(env, engine=serve.build_engine(
        env, device="cpu", params=served["float"][1]))
    app.start()
    broker = app.container.pubsub
    lane = app.engine.qos.lane
    decoded = []
    tokenizer = app.engine.tokenizer
    try:
        assert lane is not None and lane.topic == "jobs"
        assert lane.result_topic == "qos.batch.results"
        assert lane.max_inflight == 2 and lane._thread.is_alive()
        for i, prompt in enumerate(PROMPTS):
            broker.publish("jobs", json.dumps(
                {"tokens": prompt, "max_tokens": 6, "tenant": "acme",
                 "job_id": i}).encode())
        results = _lane_results(broker, len(PROMPTS))
        assert sorted(results) == list(range(len(PROMPTS))), lane.stats()
        for i, prompt in enumerate(PROMPTS):
            assert results[i]["ok"] and results[i]["tokens"] == 6
            decoded.append(results[i]["text"])
        assert decoded == [tokenizer.decode(s)
                           for s in served["float"][2][config]]
        # every job committed: nothing redelivers to the lane's group
        assert broker.subscribe("jobs", lane.group, timeout_s=0.1) is None
        stats = lane.stats()
        assert stats["completed"] == len(PROMPTS) and stats["failed"] == 0
        assert _get(app.http_port, "/debug/qos")["data"]["lane"][
            "completed"] == len(PROMPTS)
        # the ticker kicks at the first minute it sees (and at each new
        # one); one more tick by hand runs the kick again
        deadline = time.monotonic() + 10
        while lane.cron_ticks == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        ticks = lane.cron_ticks
        assert ticks >= 1
        app._cron._tick(time.localtime())
        while lane.cron_ticks == ticks and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lane.cron_ticks > ticks
        app.container.refresh_runtime_metrics()
        assert "app_tpu_qos_lane_depth 0" in \
            app.container.metrics_manager.expose()
    finally:
        app.shutdown()
    assert lane._thread is None


def _get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def test_served_pair_over_pubsub_equals_colocated(served):
    """DISAGG_TRANSPORT=pubsub with PUBSUB_BACKEND=inproc: the pair ships
    every hand-off over the container's broker, and its greedy streams
    equal the colocated JAX engine's."""
    from gofr_tpu_torch.tpu.disagg import PubSubTransport

    env = {**BASE, "DISAGG_MODE": "both", "DISAGG_TRANSPORT": "pubsub",
           "PUBSUB_BACKEND": "inproc"}
    app = serve.build_app(env, engine=serve.build_engine(
        env, device="cpu", params=served["float"][1]))
    try:
        router = app.engine.disagg_router
        assert isinstance(router.transport, PubSubTransport)
        assert router.transport.broker is app.container.pubsub
        got = [app.submitter.submit(p, max_new_tokens=6).result(timeout_s=60)
               for p in PROMPTS]
        assert got == served["float"][2]["paged"]
        assert router.prefill_engine.handoffs_total == len(PROMPTS)
        assert app.engine.prefill_dispatches + \
            app.engine.prefix_dispatches == 0
    finally:
        app.shutdown()


class _FakeRedis:
    """redis-py's surface over one dict shared by every client, so two
    engines share the cold store as two replicas share a Redis."""

    data = {}
    px = []

    def __init__(self, host=None, port=None, db=0, decode_responses=False):
        self.kwargs = dict(host=host, port=port, db=db)

    def ping(self):
        return True

    def set(self, key, value, ex=None, px=None):
        _FakeRedis.px.append(px)
        _FakeRedis.data[key] = str(value)

    def get(self, key):
        return _FakeRedis.data.get(key)

    def delete(self, *keys):
        return sum(1 for k in keys if _FakeRedis.data.pop(k, None) is not None)

    def info(self, section=None):
        return {"total_commands_processed": 0}

    def close(self):
        pass


def test_kv_redis_tier_spills_to_and_restores_from_redis(served,
                                                         monkeypatch):
    """KV_REDIS_TIER=true over a fake `redis` module: a host tier of ~1.5
    page blobs pushes the spills on to the Redis cold tier (with
    KV_REDIS_TTL_S as the entries' expiry), and a second engine over the
    same Redis restores the first's prompt from it, bit-equal to the
    first's cold prefill."""
    import types

    _FakeRedis.data, _FakeRedis.px = {}, []
    monkeypatch.setitem(sys.modules, "redis",
                        types.SimpleNamespace(Redis=_FakeRedis))
    system = list(range(1, 33)) + [40, 41]
    env = {**BASE, "MAX_SEQ_LEN": "128", "PREFILL_BUCKETS": "8,32,64",
           "N_PAGES": "10", "KV_HOST_TIER_BYTES": "6144",
           "KV_REDIS_TIER": "true", "KV_REDIS_TTL_S": "30"}
    engines = [serve.build_engine(env, device="cpu",
                                  params=served["float"][1])
               for _ in range(2)]
    a, b = engines
    try:
        cold = a.kv_tier.cold
        assert cold is not None and cold.ttl_s == 30.0
        golden = a.generate(system, max_new_tokens=8, temperature=0.0)
        for i in range(12):   # churn the trunk out of the pool and host RAM
            a.generate([(200 + 5 * i + j) % 250 + 1 for j in range(17)],
                       max_new_tokens=6, temperature=0.0)
        deadline = time.monotonic() + 30
        while cold.stats()["stored"] < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert cold.stats()["stored"] >= 4
        assert any(k.startswith("gofr:kvpage:") for k in _FakeRedis.data)
        assert set(_FakeRedis.px) == {30000}
        assert b.generate(system, max_new_tokens=8,
                          temperature=0.0) == golden
        assert b._kv_restored > 0 and b.kv_tier.cold.stats()["hits"] > 0
    finally:
        for eng in engines:
            eng.stop()
