"""The port's checkpoint store vs the JAX package's, on the CPU.

Twins of every test in tests/test_checkpoint.py (round trip, named tuples
through like=, structure mismatch, gc, no torn checkpoint, resume
equivalence, the artifact store's versions and watermarked upgrades, int
keys, the crash between the renames, overwrite, no phantom version) on
torch trees, and a tree written by either package restored by the other:
the same leaves bit for bit (bf16 included) and the same manifest paths,
shapes and dtypes. The resume twin steps the port's default AdamW and
holds the resumed run equal to the uninterrupted one to 1e-6 relative (the
reference's tolerance; on the CPU the two runs do the same arithmetic).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import checkpoint as jckpt
from gofr_tpu.models import llama as jl
from gofr_tpu_torch import tree
from gofr_tpu_torch.checkpoint import ArtifactStore, CheckpointManager
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.train import AdamWState, adamw, make_train_step


def _tree():
    return {"emb": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
            "layers": [{"w": torch.ones((2, 2), dtype=torch.bfloat16)},
                       {"w": torch.zeros((2, 2), dtype=torch.bfloat16)}],
            "scale": torch.tensor(2.5, dtype=torch.float32)}


def test_save_restore_dict_tree_without_like(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _tree(), metadata={"note": "hi"})
    assert mgr.latest_step() == 7
    out = mgr.restore()
    np.testing.assert_array_equal(out["emb"]["w"].numpy(),
                                  np.arange(12, dtype=np.float32).reshape(3, 4))
    assert isinstance(out["layers"], list) and len(out["layers"]) == 2
    assert out["layers"][0]["w"].dtype == torch.bfloat16
    assert torch.equal(out["layers"][0]["w"], torch.ones((2, 2),
                                                         dtype=torch.bfloat16))
    assert float(out["scale"]) == 2.5
    assert mgr.manifest()["metadata"]["note"] == "hi"


def test_restore_with_like_handles_namedtuples(tmp_path):
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    opt = adamw(1e-3)
    opt_state = opt.init(params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params, "opt": opt_state})
    with pytest.raises(ValueError, match="like="):
        mgr.restore()  # named-tuple nodes need a target
    like = {"params": params, "opt": opt.init(params)}
    out = mgr.restore(like=like)
    assert type(out["opt"]) is AdamWState
    assert out["opt"].count.dtype == torch.int32
    np.testing.assert_array_equal(out["params"]["w"].numpy(), np.ones((4, 4)))


def test_structure_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(like={"a": torch.ones(3), "b": torch.ones(3)})


def test_gc_keeps_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"x": torch.ones(2)})
    assert mgr.steps() == [3, 4]


def test_no_torn_checkpoint_on_disk(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree())
    entries = os.listdir(str(tmp_path))
    assert entries == ["ckpt_0000000005"]
    assert sorted(os.listdir(tmp_path / "ckpt_0000000005")) == [
        "arrays.npz", "manifest.json"]


def test_train_resume_equivalence(tmp_path):
    """Save at step k, restore into fresh tensors, continue: identical to
    the uninterrupted run."""
    def fwd(params, tokens):
        return torch.einsum("bt,vd->btd", tokens.float() * 0 + 1.0,
                            params["emb"])[:, :, :8]

    gen = torch.Generator().manual_seed(0)
    params = {"emb": torch.randn((3, 8), generator=gen)}
    init_opt, step = make_train_step(fwd, remat=False)
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    targets = torch.ones((2, 4), dtype=torch.int64)

    # uninterrupted: two steps
    p_ref = tree.tree_map(torch.clone, params)
    s_ref = init_opt(p_ref)
    for _ in range(2):
        p_ref, s_ref, _ = step(p_ref, s_ref, tokens, targets)

    # interrupted: one step, checkpoint, restore, one step
    p1 = tree.tree_map(torch.clone, params)
    p1, s1, _ = step(p1, init_opt(p1), tokens, targets)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": p1, "opt": s1})
    fresh = {"emb": torch.zeros((3, 8))}
    restored = mgr.restore(like={"params": fresh, "opt": init_opt(fresh)})
    assert int(restored["opt"].count) == 1
    p2, _, _ = step(restored["params"], restored["opt"], tokens, targets)
    np.testing.assert_allclose(p2["emb"].numpy(), p_ref["emb"].numpy(),
                               rtol=1e-6)


# -- artifact store -----------------------------------------------------------
def test_artifact_publish_load_versions(tmp_path):
    store = ArtifactStore(str(tmp_path))
    v1 = store.publish("mlp", {"w": torch.ones((2, 2))}, {"dim": 2})
    v2 = store.publish("mlp", {"w": torch.full((2, 2), 2.0)}, {"dim": 2})
    assert (v1, v2) == (1, 2)
    params, meta = store.load("mlp")  # latest
    np.testing.assert_array_equal(params["w"].numpy(), np.full((2, 2), 2.0))
    assert meta["config"] == {"dim": 2}
    params1, _ = store.load("mlp", version=1)
    np.testing.assert_array_equal(params1["w"].numpy(), np.ones((2, 2)))
    with pytest.raises(ValueError, match="already published"):
        store.publish("mlp", {}, {}, version=2)


def test_artifact_upgrades_watermarked(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.publish("m", {"w": torch.ones((2,))}, {})
    upgrades = {
        1: lambda p, cfg: {"w": p["w"] * 2},
        2: lambda p, cfg: {"w": p["w"] + 1},
    }
    assert store.apply_upgrades("m", upgrades) == [1, 2]
    params, meta = store.load("m")
    np.testing.assert_array_equal(params["w"].numpy(), np.full((2,), 3.0))
    assert meta["upgrades_applied"] == [1, 2]
    # rerun is a no-op; a later upgrade applies incrementally
    assert store.apply_upgrades("m", upgrades) == []
    upgrades[3] = lambda p, cfg: {"w": p["w"] * 10}
    assert store.apply_upgrades("m", upgrades) == [3]
    params, _ = store.load("m")
    np.testing.assert_array_equal(params["w"].numpy(), np.full((2,), 30.0))


def test_artifact_missing_name(tmp_path):
    store = ArtifactStore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        store.load("ghost")
    with pytest.raises(ValueError):
        store.publish("../evil", {}, {})


def test_int_keyed_dicts_survive_like_free_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree_ = {"layers": {0: {"w": torch.ones(2)}, 1: {"w": torch.zeros(2)}},
             "stack": [torch.ones(1), torch.zeros(1)]}
    mgr.save(1, tree_)
    out = mgr.restore()
    assert isinstance(out["layers"], dict)  # int-KEYED dict, not a list
    np.testing.assert_array_equal(out["layers"][0]["w"].numpy(), np.ones(2))
    assert isinstance(out["stack"], list)


def test_crash_between_renames_recovers(tmp_path):
    """A .old left by a crash mid-save must be healed on next access."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": torch.ones(2)})
    # simulate the crash window: old moved aside, replacement never landed
    os.rename(tmp_path / "ckpt_0000000003", tmp_path / "ckpt_0000000003.old")
    assert mgr.latest_step() == 3
    out = mgr.restore(3)
    np.testing.assert_array_equal(out["w"].numpy(), np.ones(2))


def test_save_over_existing_step_never_drops_data(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": torch.ones(2)})
    mgr.save(0, {"w": torch.full((2,), 7.0)})
    out = mgr.restore(0)
    np.testing.assert_array_equal(out["w"].numpy(), np.full((2,), 7.0))
    assert os.listdir(tmp_path) == ["ckpt_0000000000"]


def test_artifact_missing_version_leaves_no_phantom(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.publish("m", {"w": torch.ones(2)}, {})
    with pytest.raises(FileNotFoundError, match="no version 5"):
        store.load("m", version=5)
    assert store.versions("m") == [1]  # no phantom v5 directory
    params, _ = store.load("m")  # latest still resolves to v1
    np.testing.assert_array_equal(params["w"].numpy(), np.ones(2))


# -- across the packages ----------------------------------------------------------
def _jax_tree():
    """A bf16 Llama tree beside f32, int and list leaves (int-keyed too)."""
    params = jl.llama_init(dataclasses.replace(jl.LlamaConfig.debug(),
                                               dtype="bfloat16"), seed=3)
    return {"params": params,
            "extra": [jnp.arange(5, dtype=jnp.int32),
                      {7: jnp.full((2, 3), 1.5, dtype=jnp.float32)}],
            "step": jnp.float32(4.0)}


def _same_manifest(a, b):
    for key in ("n_leaves", "paths", "shapes", "dtypes", "rebuildable"):
        assert a[key] == b[key], key


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    want = _jax_tree()
    jckpt.CheckpointManager(str(tmp_path / "j")).save(2, want)
    mgr = CheckpointManager(str(tmp_path / "j"))
    got = mgr.restore()
    leaves, wleaves = tree.leaves(got), jax.tree.leaves(want)
    assert len(leaves) == len(wleaves)
    for a, b in zip(leaves, wleaves):
        assert str(a.dtype)[len("torch."):] == str(b.dtype)
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(),
                np.asarray(b).view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got["params"]["layers"]["wq"].dtype == torch.bfloat16
    assert isinstance(got["extra"][1], dict) and 7 in got["extra"][1]
    # and the port writes the same manifest for the same tree
    CheckpointManager(str(tmp_path / "t")).save(2, got)
    _same_manifest(CheckpointManager(str(tmp_path / "t")).manifest(),
                   mgr.manifest())


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree = _jax_tree()
    ttree = params_from_numpy(jax.device_get(jtree), "cpu")
    ttree["extra"][1] = {7: ttree["extra"][1][7]}
    CheckpointManager(str(tmp_path)).save(9, ttree, metadata={"by": "port"})
    mgr = jckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 9 and mgr.manifest()["metadata"] == {
        "by": "port"}
    got = mgr.restore()
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # a port optimizer state restores in JAX given a like= of its shape
    state = adamw(1e-3).init({"w": torch.ones(3, dtype=torch.bfloat16)})
    CheckpointManager(str(tmp_path / "opt")).save(1, state)
    like = AdamWState(count=jnp.zeros([], jnp.int32),
                      mu={"w": jnp.zeros(3, jnp.bfloat16)},
                      nu={"w": jnp.zeros(3, jnp.bfloat16)})
    back = jckpt.CheckpointManager(str(tmp_path / "opt")).restore(like=like)
    assert back.mu["w"].dtype == jnp.bfloat16


def test_restore_like_places_leaves():
    """like= tensors give each restored leaf its device and dtype."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root)
        mgr.save(1, {"w": torch.arange(4, dtype=torch.float32)})
        out = mgr.restore(like={"w": torch.zeros(4, dtype=torch.float64)})
    assert out["w"].dtype == torch.float64
    assert torch.equal(out["w"], torch.arange(4, dtype=torch.float64))
    # the port's llama tree keeps its layout and dtypes through a round trip
    cfg = tl.LlamaConfig.debug()
    params = tl.llama_init(cfg, seed=1, device="cpu")
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root)
        mgr.save(0, params)
        back = mgr.restore(like=params)
    for a, b in zip(tree.leaves(back), tree.leaves(params)):
        assert torch.equal(a, b)
