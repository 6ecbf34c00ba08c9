"""Port checkpoints vs the JAX package's (and transformers').

The two packages' safetensors writers and readers must agree byte for byte
and value for value in both directions; the port's load_llama_safetensors
must give JAX's tree leaf for leaf, in float and in int8 (JAX's int8 tree
is jitted JAX's quantization, whose f32 scales the port's equal bit for
bit); the reader must refuse a corrupt range, a config mismatch and a
missing tensor by name; tied and sharded checkpoints load as the
reference's do; and a checkpoint written by transformers' save_pretrained
gives transformers' logits (f32, within the reference's own tolerance:
rtol 1e-3, atol 2e-4, tests/test_hf_parity.py:74).
"""

import dataclasses
import json
import os
import struct

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.models import weights as jw
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models import weights as tw

CFG_J = jl.LlamaConfig.debug()
CFG_T = tl.LlamaConfig.debug()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.uint16).numpy()
        return x.contiguous().numpy()
    a = np.asarray(jax.device_get(x))
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_tree(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for name in w:
        np.testing.assert_array_equal(_np(g[name]), _np(w[name]),
                                      err_msg=name)


TENSORS = {
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
    "f16": np.linspace(-2, 2, 8, dtype=np.float16),
    "bf16": np.linspace(-1, 1, 6).astype(ml_dtypes.bfloat16).reshape(2, 3),
    "i8": np.arange(-5, 5, dtype=np.int8),
    "i64": np.array([2 ** 40, -7], dtype=np.int64),
    "scalar": np.float32(7.5).reshape(()),
}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_safetensors_round_trip_across_packages(tmp_path, writer):
    """Each package reads what the other writes, and both writers write
    the same bytes."""
    paths = {w: str(tmp_path / f"{w}.safetensors") for w in ("port", "jax")}
    tw.write_safetensors(paths["port"], TENSORS, metadata={"format": "pt"})
    jw.write_safetensors(paths["jax"], TENSORS, metadata={"format": "pt"})
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    port, ref = tw.SafetensorsFile(paths[writer]), jw.SafetensorsFile(
        paths[writer])
    assert port.metadata == ref.metadata == {"format": "pt"}
    assert set(port.keys()) == set(TENSORS)
    for name, want in TENSORS.items():
        got = port.tensor(name)
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(_np(got), _np(ref.tensor(name)))
        np.testing.assert_array_equal(_np(got), _np(want))


def test_writer_takes_torch_tensors_and_views(tmp_path):
    """Transposed views and bf16 tensors are written contiguous, as the
    reference writes the same values as numpy arrays."""
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    b = torch.linspace(-1, 1, 6).to(torch.bfloat16).reshape(2, 3)
    tw.write_safetensors(str(tmp_path / "t.safetensors"), {"t": t.t(), "b": b})
    ref = jw.SafetensorsFile(str(tmp_path / "t.safetensors"))
    np.testing.assert_array_equal(ref.tensor("t"), t.t().numpy())
    np.testing.assert_array_equal(_np(ref.tensor("b")), _np(b))


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_reader_rejects_corrupt_range(tmp_path, reader):
    path = str(tmp_path / "t.safetensors")
    tw.write_safetensors(path, {"a": np.zeros(4, np.float32)})
    raw = bytearray(open(path, "rb").read())
    (hlen,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + hlen])
    header["a"]["shape"] = [8]  # lies about the shape
    hb = json.dumps(header).encode()
    with open(path, "wb") as fp:
        fp.write(struct.pack("<Q", len(hb)))
        fp.write(hb)
        fp.write(raw[8 + hlen:])
    mod = tw if reader == "port" else jw
    with pytest.raises(ValueError, match="byte range"):
        mod.SafetensorsFile(path).tensor("a")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(path of JAX's export of llama_init(debug, seed 2), the JAX tree)."""
    path = str(tmp_path_factory.mktemp("ckpt") / "model.safetensors")
    params = jl.llama_init(CFG_J, seed=2)
    jw.export_llama_safetensors(params, path)
    return path, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exports_are_byte_identical(tmp_path, dtype):
    cfg = dataclasses.replace(CFG_J, dtype=dtype)
    params = jl.llama_init(cfg, seed=3)
    jw.export_llama_safetensors(params, str(tmp_path / "j.safetensors"))
    tw.export_llama_safetensors(
        tw.params_from_numpy(jax.device_get(params), device="cpu"),
        str(tmp_path / "t.safetensors"))
    with open(tmp_path / "j.safetensors", "rb") as a, \
            open(tmp_path / "t.safetensors", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("weight_dtype", [None, "int8"])
def test_load_equals_jax_leaf_for_leaf(checkpoint, weight_dtype):
    path, _ = checkpoint
    want = jw.load_llama_safetensors(CFG_J, path, weight_dtype=weight_dtype)
    got = tw.load_llama_safetensors(CFG_T, path, weight_dtype=weight_dtype,
                                    device="cpu")
    _same_tree(got, want)
    if weight_dtype == "int8":
        # the int8 products' column-major storage
        assert got["layers"]["w_gate"].transpose(-1, -2).is_contiguous()
        assert got["lm_head"].t().is_contiguous()


def test_load_int8_equals_quantize_weights(checkpoint):
    path, _ = checkpoint
    got = tw.load_llama_safetensors(CFG_T, path, weight_dtype="int8",
                                    device="cpu")
    want = tl.quantize_weights(tw.load_llama_safetensors(CFG_T, path,
                                                         device="cpu"))
    g, w = dict(_flat(got)), dict(_flat(want))
    assert list(g) == list(w)
    for name in w:
        assert torch.equal(g[name], w[name]), name
        assert g[name].stride() == w[name].stride(), name


def test_bf16_checkpoint_loads_bit_exact(tmp_path):
    cfg_j = dataclasses.replace(CFG_J, dtype="bfloat16")
    cfg_t = dataclasses.replace(CFG_T, dtype="bfloat16")
    params = jl.llama_init(cfg_j, seed=4)
    path = str(tmp_path / "model.safetensors")
    tw.export_llama_safetensors(
        tw.params_from_numpy(jax.device_get(params), device="cpu"), path)
    _same_tree(tw.load_llama_safetensors(cfg_t, path, device="cpu"), params)


def test_f32_checkpoint_into_a_bf16_config_rounds_as_jax(checkpoint):
    """The cast to the config's dtype: round to nearest even in both."""
    path, _ = checkpoint
    cfg_j = dataclasses.replace(CFG_J, dtype="bfloat16")
    cfg_t = dataclasses.replace(CFG_T, dtype="bfloat16")
    _same_tree(tw.load_llama_safetensors(cfg_t, path, device="cpu"),
               jw.load_llama_safetensors(cfg_j, path))


def test_loaded_logits_equal_the_in_memory_tree(checkpoint):
    path, params = checkpoint
    mem = tw.params_from_numpy(jax.device_get(params), device="cpu")
    disk = tw.load_llama_safetensors(CFG_T, path, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, CFG_T.vocab_size, (2, 16)))
    assert torch.equal(tl.llama_forward_nocache(disk, CFG_T, toks),
                       tl.llama_forward_nocache(mem, CFG_T, toks))


def _rewrite_without(path, drop):
    f = tw.SafetensorsFile(path)
    tensors = {n: f.tensor(n) for n in f.keys() if n != drop}
    tw.write_safetensors(path, tensors)


@pytest.mark.parametrize("weight_dtype", [None, "int8"])
def test_tied_embeddings(tmp_path, weight_dtype):
    """No lm_head.weight in the file: lm_head = tok_emb.T, as JAX's."""
    path = str(tmp_path / "model.safetensors")
    jw.export_llama_safetensors(jl.llama_init(CFG_J, seed=5), path)
    _rewrite_without(path, "lm_head.weight")
    got = tw.load_llama_safetensors(CFG_T, path, weight_dtype=weight_dtype,
                                    device="cpu")
    _same_tree(got, jw.load_llama_safetensors(CFG_J, path,
                                              weight_dtype=weight_dtype))
    if weight_dtype is None:
        assert torch.equal(got["lm_head"], got["tok_emb"].t())


@pytest.mark.parametrize("form", ["directory", "index file"])
def test_sharded_index_checkpoint(tmp_path, form):
    params = jl.llama_init(CFG_J, seed=6)
    whole = str(tmp_path / "whole.safetensors")
    jw.export_llama_safetensors(params, whole)
    f = tw.SafetensorsFile(whole)
    names = sorted(f.keys())
    half = len(names) // 2
    shards = {"model-00001-of-00002.safetensors": names[:half],
              "model-00002-of-00002.safetensors": names[half:]}
    weight_map = {}
    for fname, members in shards.items():
        tw.write_safetensors(str(tmp_path / fname),
                             {n: f.tensor(n) for n in members})
        weight_map.update({n: fname for n in members})
    index = tmp_path / "model.safetensors.index.json"
    with open(index, "w") as fp:
        json.dump({"weight_map": weight_map}, fp)
    os.remove(whole)
    where = str(tmp_path) if form == "directory" else str(index)
    _same_tree(tw.load_llama_safetensors(CFG_T, where, device="cpu"),
               jw.load_llama_safetensors(CFG_J, where))


def test_directory_form(tmp_path):
    jw.export_llama_safetensors(jl.llama_init(CFG_J, seed=7),
                                str(tmp_path / "model.safetensors"))
    _same_tree(tw.load_llama_safetensors(CFG_T, str(tmp_path), device="cpu"),
               jw.load_llama_safetensors(CFG_J, str(tmp_path)))


def test_config_mismatch_fails_fast(checkpoint, monkeypatch):
    path, _ = checkpoint
    wrong = dataclasses.replace(CFG_T, ffn_dim=CFG_T.ffn_dim * 2)
    # no tensor's bytes are read before the shapes are checked
    monkeypatch.setattr(tw.SafetensorsFile, "tensor",
                        lambda *a: pytest.fail("read before the preflight"))
    with pytest.raises(ValueError, match="does not match config") as exc:
        tw.load_llama_safetensors(wrong, path, device="cpu")
    with pytest.raises(ValueError) as ref:
        jw.load_llama_safetensors(
            dataclasses.replace(CFG_J, ffn_dim=CFG_J.ffn_dim * 2), path)
    assert str(exc.value) == str(ref.value)


def test_missing_tensor_named_in_error(tmp_path):
    path = str(tmp_path / "model.safetensors")
    jw.export_llama_safetensors(jl.llama_init(CFG_J, seed=8), path)
    _rewrite_without(path, "model.layers.1.mlp.up_proj.weight")
    with pytest.raises(ValueError, match="missing model.layers.1.mlp.up_proj"):
        tw.load_llama_safetensors(CFG_T, path, device="cpu")


def test_export_rejects_quantized_tree(tmp_path):
    q = tl.quantize_weights(tl.llama_init(CFG_T, seed=0, device="cpu"))
    with pytest.raises(ValueError, match="float trees only"):
        tw.export_llama_safetensors(q, str(tmp_path / "x.safetensors"))


def test_weight_dtype_other_than_int8_refused(checkpoint):
    with pytest.raises(ValueError, match="int8 or None"):
        tw.load_llama_safetensors(CFG_T, checkpoint[0], weight_dtype="fp8",
                                  device="cpu")


# -- transformers as the oracle (tests/test_hf_parity.py) ---------------------
DIM, LAYERS, HEADS, KV_HEADS, FFN, VOCAB = 64, 2, 4, 2, 160, 256


def _hf_checkpoint(tmp_path, tie: bool):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=DIM, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=KV_HEADS, max_position_embeddings=128,
        rms_norm_eps=1e-5, rope_theta=500000.0, attention_bias=False,
        mlp_bias=False, tie_word_embeddings=tie)
    torch.manual_seed(7)
    model = transformers.LlamaForCausalLM(hf_cfg).to(torch.float32).eval()
    ckpt = tmp_path / "ckpt"
    model.save_pretrained(ckpt, safe_serialization=True)
    return model, str(ckpt)


def _our_cfg(cls):
    return cls(vocab_size=VOCAB, dim=DIM, n_layers=LAYERS, n_heads=HEADS,
               n_kv_heads=KV_HEADS, ffn_dim=FFN, max_seq_len=128,
               rope_theta=500000.0, rms_eps=1e-5, dtype="float32")


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_logits_match_transformers(tmp_path, tie):
    model, ckpt = _hf_checkpoint(tmp_path, tie)
    params = tw.load_llama_safetensors(_our_cfg(tl.LlamaConfig), ckpt,
                                       device="cpu")
    _same_tree(params, jw.load_llama_safetensors(_our_cfg(jl.LlamaConfig),
                                                 ckpt))
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        1, VOCAB, size=(2, 24)))
    with torch.no_grad():
        ref = model(tokens).logits.numpy()
    got = tl.llama_forward_nocache(params, _our_cfg(tl.LlamaConfig),
                                   tokens).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-4)


def test_int8_load_of_a_transformers_checkpoint(tmp_path):
    """Quantize-on-load equals loading float then quantize_weights, and
    JAX's quantize-on-load, on a checkpoint transformers wrote."""
    _, ckpt = _hf_checkpoint(tmp_path, False)
    cfg = _our_cfg(tl.LlamaConfig)
    got = tw.load_llama_safetensors(cfg, ckpt, weight_dtype="int8",
                                    device="cpu")
    post = tl.quantize_weights(tw.load_llama_safetensors(cfg, ckpt,
                                                         device="cpu"))
    g, p = dict(_flat(got)), dict(_flat(post))
    assert all(torch.equal(g[k], p[k]) for k in p)
    _same_tree(got, jw.load_llama_safetensors(_our_cfg(jl.LlamaConfig), ckpt,
                                              weight_dtype="int8"))


def test_entry_points_without_a_card_raise_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.llama_init_quantized(CFG_T)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.load_llama_safetensors(CFG_T, "/nonexistent.safetensors")
