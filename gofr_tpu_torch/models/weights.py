"""Weights: the numpy bridge and HF-layout safetensors checkpoints.

Ports from ``gofr_tpu/models/weights.py``: ``SafetensorsFile``,
``CheckpointReader`` (a single file, a directory, or a
``*.safetensors.index.json`` of shards), ``write_safetensors``,
``_LAYER_MAP``, ``_expected_shapes``, ``load_llama_safetensors`` (the
preflight of every shape before any bytes are read, naming the offending
tensor) and ``export_llama_safetensors``; ``_stack_layers`` becomes the
per-layer placement below. Beside them ``params_from_numpy``, the bridge
that carries a JAX params tree across (``jax.device_get`` of a
``llama_init`` tree gives numpy leaves, bf16 as ml_dtypes' ``bfloat16``),
one copy per leaf: every parity test uses it (dicts, lists and tuples, as
the MLP's list of layers), and ``adam_state_from_numpy``, which carries
optax's adam state across into the port's optimizer state.

Pure numpy and torch: no ``safetensors`` package and no ``ml_dtypes`` (the
reference decodes BF16 through ml_dtypes, which the card's machine lacks).
A tensor is read from its byte range straight into a CPU torch tensor,
whose dtypes include bf16, and the writer writes a tensor's bytes as they
are, so a bf16 round trip is bit-exact.

Placement, one layer at a time: each HF tensor is read on the host, copied
to the device, cast to the config's dtype there, transposed from HF's
[out, in] into the port's [in, out] by the copy into its slot of the
stacked leaf, or, under ``weight_dtype="int8"``, quantized there
(``models.llama._quantized``: the same per-output-channel scales as
quantizing the stacked float leaf, since each scale reduces within one
layer) into the column-major int8 storage the port's products read. The
float temporary is one layer's, where the reference's ``place`` holds a
whole stacked leaf; the peak is the device tree plus one layer. Tied
embeddings give ``lm_head = tok_emb.T``. The writer streams: it writes the
header from shapes alone, then moves one tensor at a time to the host, so
exporting a tree on the card never holds a host copy of the whole tree.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..tpu.device import resolve_device

# safetensors dtype tag <-> torch dtype
_DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TAGS = {dt: tag for tag, dt in _DTYPES.items()}


def params_from_numpy(tree: Any, device=None, dtype=None) -> Any:
    """The same nested dicts, lists and tuples with every numpy leaf as a
    torch tensor on `device` (None = the CUDA card, as every entry point),
    cast to `dtype` when given."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev, dtype) for v in tree)
    t = _as_tensor(tree)
    return (t if dtype is None else t.to(dtype)).to(dev)


def adam_state_from_numpy(count, mu, nu, device=None):
    """optax's adam state (``ScaleByAdamState``'s count, mu and nu, as
    ``jax.device_get`` gives them) as the port's ``train.AdamWState`` on
    `device`: the count an int32 0-d tensor, the moments in their own
    dtypes."""
    from ..train import AdamWState

    dev = resolve_device(device)
    return AdamWState(
        count=torch.as_tensor(np.array(count), dtype=torch.int32).to(dev),
        mu=params_from_numpy(mu, dev), nu=params_from_numpy(nu, dev))


def _as_tensor(x) -> torch.Tensor:
    """A torch tensor (any device) as it is, or a numpy array (bf16 as
    ml_dtypes' type, read by its name) as a CPU tensor over its memory, or
    a copy's where it is not C-contiguous and writable (jax.device_get
    hands out read-only arrays)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    # require() makes a 0-d array 1-d; the reshape keeps its shape
    a = np.require(a, requirements=["C", "W"]).reshape(a.shape)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class SafetensorsFile:
    """Lazy reader over one .safetensors container: the header is parsed
    once; ``tensor(name)`` reads exactly that tensor's byte range into a
    CPU torch tensor."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fp:
            (header_len,) = struct.unpack("<Q", fp.read(8))
            if header_len > 100 * 1024 * 1024:
                raise ValueError(f"{path}: implausible header size {header_len}")
            header = json.loads(fp.read(header_len).decode("utf-8"))
        self.metadata: Dict[str, str] = header.pop("__metadata__", {})
        self._entries: Dict[str, Tuple[str, Tuple[int, ...], int, int]] = {}
        data_start = 8 + header_len
        for name, ent in header.items():
            begin, end = ent["data_offsets"]
            self._entries[name] = (ent["dtype"], tuple(ent["shape"]),
                                   data_start + begin, data_start + end)

    def keys(self) -> Iterable[str]:
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def info(self, name: str) -> Tuple[str, Tuple[int, ...]]:
        dtype, shape, _, _ = self._entries[name]
        return dtype, shape

    def tensor(self, name: str) -> torch.Tensor:
        dtype, shape, begin, end = self._entries[name]
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported safetensors dtype {dtype!r}")
        tdt = _DTYPES[dtype]
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = count * torch.empty((), dtype=tdt).element_size()
        if nbytes != end - begin:
            raise ValueError(
                f"{self.path}:{name}: byte range {end - begin} != "
                f"shape/dtype size {nbytes}")
        if count == 0:
            return torch.empty(shape, dtype=tdt)
        buf = bytearray(nbytes)
        with open(self.path, "rb") as fp:
            fp.seek(begin)
            if fp.readinto(buf) != nbytes:
                raise ValueError(f"{self.path}:{name}: file ends inside the "
                                 f"tensor's byte range")
        return torch.frombuffer(buf, dtype=tdt).reshape(shape)


class CheckpointReader:
    """Uniform view over a single file OR a sharded HF checkpoint: a
    .safetensors file, a .safetensors.index.json file, or a directory
    holding ``model.safetensors``, ``model.safetensors.index.json`` or a
    single .safetensors file."""

    def __init__(self, path: str):
        index_path = None
        if os.path.isdir(path):
            single = os.path.join(path, "model.safetensors")
            index = os.path.join(path, "model.safetensors.index.json")
            if os.path.exists(index):
                index_path = index
            elif os.path.exists(single):
                path = single
            else:
                sts = sorted(f for f in os.listdir(path)
                             if f.endswith(".safetensors"))
                if len(sts) == 1:
                    path = os.path.join(path, sts[0])
                else:
                    raise FileNotFoundError(
                        f"{path}: no model.safetensors[.index.json] "
                        f"({len(sts)} .safetensors files)")
        elif path.endswith(".index.json"):
            index_path = path

        self._files: Dict[str, SafetensorsFile] = {}
        self._where: Dict[str, str] = {}
        if index_path:
            base = os.path.dirname(index_path)
            with open(index_path, "r", encoding="utf-8") as fp:
                weight_map = json.load(fp)["weight_map"]
            for name, fname in weight_map.items():
                self._where[name] = os.path.join(base, fname)
        else:
            f = SafetensorsFile(path)
            self._files[path] = f
            for name in f.keys():
                self._where[name] = path

    def keys(self) -> Iterable[str]:
        return self._where.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def _file(self, name: str) -> SafetensorsFile:
        path = self._where[name]
        if path not in self._files:
            self._files[path] = SafetensorsFile(path)
        return self._files[path]

    def info(self, name: str) -> Tuple[str, Tuple[int, ...]]:
        return self._file(name).info(name)

    def tensor(self, name: str) -> torch.Tensor:
        return self._file(name).tensor(name)


def write_safetensors(path: str, tensors: Dict[str, Any],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Serialize {name: tensor or numpy array} to one safetensors
    container, little-endian C-contiguous, in sorted-name order (the same
    bytes as the reference's writer for the same tree). Tensors may lie on
    the card and be views: each is made contiguous and brought to the host
    only when its bytes are written."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    order = sorted(tensors)
    items = [_as_tensor(tensors[name]) for name in order]
    offset = 0
    for name, t in zip(order, items):
        if t.dtype not in _TAGS:
            raise ValueError(f"cannot serialize dtype {t.dtype} to "
                             f"safetensors")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    hbytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        fp.write(struct.pack("<Q", len(hbytes)))
        fp.write(hbytes)
        for t in items:
            if t.numel():
                host = t.detach().contiguous().cpu().reshape(-1)
                fp.write(host.view(torch.uint8).numpy())
    os.replace(tmp, path)  # atomic publish


# ---------------------------------------------------------------------------
# HF-layout llama loading
# ---------------------------------------------------------------------------

# stacked-leaf name -> (HF per-layer name, transpose?)
_LAYER_MAP = {
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
    "attn_norm": ("input_layernorm.weight", False),
    "ffn_norm": ("post_attention_layernorm.weight", False),
}


def _expected_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    L, D, H, Hkv, dh, F, V = (cfg.n_layers, cfg.dim, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
                              cfg.vocab_size)
    return {
        "tok_emb": (V, D),
        "wq": (L, D, H * dh), "wk": (L, D, Hkv * dh), "wv": (L, D, Hkv * dh),
        "wo": (L, H * dh, D),
        "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D),
        "attn_norm": (L, D), "ffn_norm": (L, D),
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def _preflight(reader: CheckpointReader, cfg, path: str, tied: bool) -> None:
    """Every tensor present with the right shape, before any bytes are
    read; raises ValueError naming the first offenders."""
    exp = _expected_shapes(cfg)
    problems: List[str] = []

    def check(hf_name: str, want: Tuple[int, ...]):
        if hf_name not in reader:
            problems.append(f"missing {hf_name}")
            return
        _, shape = reader.info(hf_name)
        if tuple(shape) != tuple(want):
            problems.append(f"{hf_name}: shape {shape} != expected {want}")

    check("model.embed_tokens.weight", exp["tok_emb"])
    check("model.norm.weight", exp["final_norm"])
    if not tied:
        check("lm_head.weight", (cfg.vocab_size, cfg.dim))
    for leaf, (suffix, transpose) in _LAYER_MAP.items():
        want = exp[leaf][1:]
        per_layer = tuple(reversed(want)) if transpose else want
        for l in range(cfg.n_layers):
            check(f"model.layers.{l}.{suffix}", per_layer)
    if problems:
        head = "; ".join(problems[:5])
        more = f" (+{len(problems) - 5} more)" if len(problems) > 5 else ""
        raise ValueError(f"checkpoint {path!r} does not match config: "
                         f"{head}{more}")


def load_llama_safetensors(cfg, path: str,
                           weight_dtype: Optional[str] = None,
                           logger=None, device=None) -> Dict[str, Any]:
    """Load an HF-layout Llama checkpoint into the serving params tree.

    cfg: LlamaConfig, whose shapes are validated against the checkpoint's
    header before any bytes are read. weight_dtype: None keeps cfg.dtype
    storage; "int8" quantizes each layer on the device as it loads
    (models.llama's per-output-channel scales), so the peak is the int8
    tree plus one float layer. device: None = the CUDA card. Returns the
    same tree as llama_init / quantize_weights (the module docstring)."""
    from .llama import DTYPES, _QUANT_AXES, _quantized

    dev = resolve_device(device)
    if weight_dtype not in (None, "int8"):
        raise ValueError(f"weight_dtype must be int8 or None, "
                         f"got {weight_dtype!r}")
    reader = CheckpointReader(path)
    tied = "lm_head.weight" not in reader
    _preflight(reader, cfg, path, tied)
    quantize = weight_dtype == "int8"
    dtype = DTYPES[cfg.dtype]

    def log(msg, *args):
        if logger is not None:
            logger.debugf(msg, *args)

    def fetch(name: str) -> torch.Tensor:
        return reader.tensor(name).to(dev).to(dtype)

    layers: Dict[str, Any] = {}
    for leaf, (suffix, transpose) in _LAYER_MAP.items():
        shape = (cfg.n_layers, *_expected_shapes(cfg)[leaf][1:])
        axis = _QUANT_AXES.get(leaf) if quantize else None
        if axis is None:
            out = torch.empty(shape, dtype=dtype, device=dev)
        else:
            out = torch.empty((shape[0], shape[2], shape[1]),
                              dtype=torch.int8, device=dev).transpose(-1, -2)
            scales = torch.empty((shape[0], shape[2]), dtype=torch.float32,
                                 device=dev)
        for l in range(cfg.n_layers):
            w = fetch(f"model.layers.{l}.{suffix}")
            w = w.t() if transpose else w
            if axis is None:
                out[l].copy_(w)
            else:
                out[l], scales[l] = _quantized(w, axis)
            del w
        layers[leaf] = out
        if axis is not None:
            layers[leaf + "_s"] = scales
        log("loaded layers.%s %s %s", leaf, out.dtype, tuple(out.shape))

    emb = fetch("model.embed_tokens.weight")
    head = emb if tied else fetch("lm_head.weight")
    params: Dict[str, Any] = {}
    if quantize:
        params["tok_emb"], params["tok_emb_s"] = _quantized(emb, -1)
    else:
        params["tok_emb"] = emb
    params["layers"] = layers
    params["final_norm"] = fetch("model.norm.weight")
    if quantize:
        params["lm_head"], params["lm_head_s"] = _quantized(head.t(), -2)
    else:
        params["lm_head"] = head.t().contiguous()
    del emb, head
    log("loaded tok_emb, final_norm, lm_head (tied=%s)", tied)
    return params


def export_llama_safetensors(params, path: str,
                             metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a float params tree in HF layout (the inverse of
    load_llama_safetensors for float trees). Rejects int8 trees: HF layout
    has no scale-tensor convention."""
    if "lm_head_s" in params:
        raise ValueError("export_llama_safetensors handles float trees only")
    tensors: Dict[str, Any] = {
        "model.embed_tokens.weight": params["tok_emb"],
        "model.norm.weight": params["final_norm"],
        "lm_head.weight": _as_tensor(params["lm_head"]).t(),
    }
    layers = params["layers"]
    n_layers = layers["wq"].shape[0]
    for leaf, (suffix, transpose) in _LAYER_MAP.items():
        stacked = _as_tensor(layers[leaf])
        for l in range(n_layers):
            t = stacked[l]
            tensors[f"model.layers.{l}.{suffix}"] = t.t() if transpose else t
    write_safetensors(path, tensors, metadata)
