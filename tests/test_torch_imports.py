"""The port stands alone: no jax, no gofr_tpu, and no silent CPU fallback.

- every gofr_tpu_torch module (native/, the observability planes, the
  incident plane, the KV tier, the disaggregated pair, migration,
  service/, loadgen/, datasource/, pubsub/, the subscriber, cron, fleet/,
  the router server, grpcx/, logging/remote.py and the device client
  included) and chip_smoke.py imports in a fresh interpreter where `jax`,
  `jaxlib`, `gofr_tpu` and the packages the card's machine lacks
  (`ml_dtypes`, `regex`, `safetensors`, `transformers`, `tokenizers`) are
  blocked, and so are `grpc`, `google.protobuf`, `cryptography` and
  `requests`, which the port imports only where a gRPC server or client,
  or a JWKS key set, is made (and never `requests`);
- an AST scan finds no import of them anywhere in the package or script;
- the port's LlamaConfig presets equal the JAX ones field for field;
- with no card and no explicit device, the entry points raise.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "gofr_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "gofr_tpu", "ml_dtypes", "regex",
             "safetensors", "transformers", "tokenizers")
# imported only inside the functions that need them: absent at import time
LAZY = ("grpc", "google.protobuf", "cryptography", "requests")


def _module_names():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_imports_with_jax_and_gofr_tpu_blocked():
    mods = list(_module_names()) + ["chip_smoke"]
    assert {"gofr_tpu_torch.native", "gofr_tpu_torch.models.weights",
            "gofr_tpu_torch.models.tokenizer",
            "gofr_tpu_torch.tpu.capacity"} <= set(mods)
    # the observability planes
    assert {"gofr_tpu_torch.tpu.ownership", "gofr_tpu_torch.tpu.stepledger",
            "gofr_tpu_torch.tpu.utilization",
            "gofr_tpu_torch.tpu.flightrecorder",
            "gofr_tpu_torch.tpu.journey", "gofr_tpu_torch.tpu.timeline",
            "gofr_tpu_torch.tpu.hostprof", "gofr_tpu_torch.tpu.migrate",
            "gofr_tpu_torch.fleet.affinity", "gofr_tpu_torch.loadgen.trace",
            "gofr_tpu_torch.loadgen.capture"} <= set(mods)
    # crash-only serving and the incident plane
    assert {"gofr_tpu_torch.tpu.faults", "gofr_tpu_torch.tpu.incidents",
            "gofr_tpu_torch.tpu.meter",
            "gofr_tpu_torch.tpu.profiler"} <= set(mods)
    # the KV tier, the disaggregated pair, migration and the peer client
    # (bf16 blob planes without ml_dtypes, which FORBIDDEN blocks)
    assert {"gofr_tpu_torch.tpu.kvtier", "gofr_tpu_torch.tpu.disagg",
            "gofr_tpu_torch.tpu.migrate",
            "gofr_tpu_torch.service"} <= set(mods)
    # parallelism (the mesh, sharding, the multi-process job, the explicit
    # collectives, sequence parallelism) and the admission plane
    assert {"gofr_tpu_torch.parallel", "gofr_tpu_torch.parallel.mesh",
            "gofr_tpu_torch.parallel.multihost",
            "gofr_tpu_torch.parallel.sharding",
            "gofr_tpu_torch.parallel.collectives",
            "gofr_tpu_torch.parallel.longcontext",
            "gofr_tpu_torch.ops.ring_attention",
            "gofr_tpu_torch.ops.ulysses",
            "gofr_tpu_torch.tpu.admission"} <= set(mods)
    # sharded training: GPipe beside the step and the conjugate collectives
    assert {"gofr_tpu_torch.parallel.pipeline",
            "gofr_tpu_torch.train"} <= set(mods)
    # the open-loop load client, the datasources, pub/sub, the subscriber
    # and cron (their gated drivers import only when a backend asks)
    assert {"gofr_tpu_torch.loadgen", "gofr_tpu_torch.loadgen.__main__",
            "gofr_tpu_torch.loadgen.synth", "gofr_tpu_torch.loadgen.scorecard",
            "gofr_tpu_torch.loadgen.generator",
            "gofr_tpu_torch.loadgen.status", "gofr_tpu_torch.loadgen.knee",
            "gofr_tpu_torch.datasource", "gofr_tpu_torch.datasource.kvstore",
            "gofr_tpu_torch.datasource.sql",
            "gofr_tpu_torch.datasource.kvredis",
            "gofr_tpu_torch.datasource.docstore",
            "gofr_tpu_torch.datasource.mongostore", "gofr_tpu_torch.pubsub",
            "gofr_tpu_torch.pubsub.inproc", "gofr_tpu_torch.pubsub.filebroker",
            "gofr_tpu_torch.pubsub.external", "gofr_tpu_torch.subscriber",
            "gofr_tpu_torch.cron"} <= set(mods)
    # the fleet tier and the router server
    assert {"gofr_tpu_torch.fleet", "gofr_tpu_torch.fleet.registry",
            "gofr_tpu_torch.fleet.policy", "gofr_tpu_torch.fleet.proxy",
            "gofr_tpu_torch.fleet.debug", "gofr_tpu_torch.fleet.journey",
            "gofr_tpu_torch.fleet.timeline", "gofr_tpu_torch.fleet.slo",
            "gofr_tpu_torch.fleet.capacity", "gofr_tpu_torch.fleet.elastic",
            "gofr_tpu_torch.serve_router"} <= set(mods)
    # the serving surfaces and the device client
    assert {"gofr_tpu_torch.grpcx", "gofr_tpu_torch.logging.remote",
            "gofr_tpu_torch.tpu.device", "gofr_tpu_torch.http.middleware",
            "gofr_tpu_torch.serve_bert",
            "gofr_tpu_torch.serve_mnist"} <= set(mods)
    code = (
        "import sys, importlib\n"
        f"for name in {FORBIDDEN + LAZY!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
        "print('ok', len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_gofr_tpu_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("preset", ["debug", "llama1b", "llama3_8b",
                                    "llama3_70b"])
def test_llama_config_presets_match_jax(preset):
    from gofr_tpu.models.llama import LlamaConfig as JConfig
    from gofr_tpu_torch.models.llama import LlamaConfig

    assert ([f.name for f in dataclasses.fields(LlamaConfig)]
            == [f.name for f in dataclasses.fields(JConfig)])
    assert (dataclasses.asdict(getattr(LlamaConfig, preset)())
            == dataclasses.asdict(getattr(JConfig, preset)()))
    cfg = getattr(LlamaConfig, preset)()
    jcfg = getattr(JConfig, preset)()
    assert (cfg.head_dim, cfg.q_per_kv, cfg.param_count()) == (
        jcfg.head_dim, jcfg.q_per_kv, jcfg.param_count())


def test_entry_points_without_a_device_raise_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    import numpy as np

    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.models.weights import params_from_numpy
    from gofr_tpu_torch import serve_openai
    from gofr_tpu_torch.serve import build_engine
    from gofr_tpu_torch.tpu.device import resolve_device
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    cfg = LlamaConfig.debug()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama_init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(2, dtype=np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedLLMEngine(llama_init(cfg, device="cpu"), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_openai.build_app({"METRICS_PORT": "0"})
    assert resolve_device("cpu").type == "cpu"
