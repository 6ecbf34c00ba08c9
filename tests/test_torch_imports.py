"""The port stands alone: no jax, no gofr_tpu, and no silent CPU fallback.

- every gofr_tpu_torch module (and chip_smoke.py) imports in a fresh
  interpreter where `jax`, `jaxlib` and `gofr_tpu` are blocked;
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
FORBIDDEN = ("jax", "jaxlib", "gofr_tpu")


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
    code = (
        "import sys, importlib\n"
        f"for name in {FORBIDDEN!r}:\n"
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
    assert resolve_device("cpu").type == "cpu"
