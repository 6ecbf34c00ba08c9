"""The port's mesh, sharding rules and multi-process launch against the
reference's (gofr_tpu/parallel/), in one spawned 8-rank gloo world.

- The twins of tests/test_parallel.py:17 (factorize), :25 (all five axes,
  a plan that is not the world refused), :352 (the JAX_* spec parsing)
  and :376 (process_local_batch: here each rank's own rows);
- the port's spec trees equal the reference's PartitionSpecs, leaf by
  leaf (llama_param_specs with and without MoE, serving_param_specs bf16
  and int8, the cache, scale and batch specs, unsharded_like);
- the port's rank-r block of every leaf (shard_params) equals the JAX
  array's shard on device r of the same mesh, for the float tree under
  llama_param_specs and serving_param_specs and the int8 tree under
  serving_param_specs(quantized=True), whose matrices stay column-major.
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from gofr_tpu.config import MockConfig as JMockConfig
from gofr_tpu.models import llama as jl
from gofr_tpu.parallel import MeshPlan as JMeshPlan
from gofr_tpu.parallel import make_mesh as jax_make_mesh
from gofr_tpu.parallel import sharding as js
from gofr_tpu.parallel.multihost import MultiHostSpec as JSpec
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.parallel import MeshPlan, sharding as ts
from gofr_tpu_torch.parallel.mesh import AXES
from gofr_tpu_torch.parallel.multihost import (MultiHostSpec,
                                               initialize_from_config)

import torch_dist
import torch_dist_workers as workers

CFG = jl.LlamaConfig.debug()


def test_mesh_plan_factorize():
    assert MeshPlan.factorize(8) == MeshPlan(dp=2, sp=2, tp=2)
    assert MeshPlan.factorize(4) == MeshPlan(sp=2, tp=2)
    assert MeshPlan.factorize(2) == MeshPlan(tp=2)
    assert MeshPlan.factorize(1) == MeshPlan()
    assert MeshPlan.factorize(6).n_devices == 6
    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        assert (MeshPlan.factorize(n).axis_sizes()
                == JMeshPlan.factorize(n).axis_sizes())
    from gofr_tpu.parallel.mesh import AXES as JAXES

    assert AXES == JAXES


def _pairs(port, ref, path=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    else:
        yield path, port, ref


@pytest.mark.parametrize("name,args", [
    ("llama_param_specs", ()), ("llama_param_specs", (True,)),
    ("serving_param_specs", ()), ("serving_param_specs", (True,)),
    ("kv_cache_spec", ()), ("kv_cache_layer_spec", ()),
    ("kv_scale_layer_spec", ()), ("kv_scale_pool_spec", ()),
    ("batch_spec", ())])
def test_spec_trees_equal_the_reference(name, args):
    port = getattr(ts, name)(*args)
    ref = getattr(js, name)(*args)
    for path, p, r in _pairs(port, ref):
        assert isinstance(p, tuple) and not hasattr(p, "_partitions"), path
        assert p == tuple(r), (path, p, r)


def test_unsharded_like_is_replicated_everywhere():
    tree = {"a": 1, "b": {"c": 2}}
    assert ts.unsharded_like(tree) == {"a": (), "b": {"c": ()}}
    assert tuple(js.unsharded_like(tree)["b"]["c"]) == ()


def test_multihost_spec_parsing():
    # unconfigured -> no-op (single-process path)
    assert MultiHostSpec.from_config(MockConfig({})) is None
    assert initialize_from_config(MockConfig({})) is None
    keys = {"JAX_COORDINATOR_ADDR": "10.0.0.1:1234",
            "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2",
            "JAX_LOCAL_DEVICE_IDS": "0, 1", "JAX_COORDINATOR_TIMEOUT_S": "5"}
    spec = MultiHostSpec.from_config(MockConfig(keys))
    ref = JSpec.from_config(JMockConfig(keys))
    assert (spec.coordinator, spec.num_processes, spec.process_id,
            spec.local_device_ids, spec.timeout_s) == (
        ref.coordinator, ref.num_processes, ref.process_id,
        ref.local_device_ids, ref.timeout_s)
    assert spec.host_port() == ("10.0.0.1", 1234)
    with pytest.raises(ValueError, match="out of range"):
        MultiHostSpec.from_config(MockConfig({
            "JAX_COORDINATOR_ADDR": "x:1", "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": "2"}))


def test_initialize_without_a_card_raises():
    """A configured rank on the card path with no card visible fails at
    boot instead of serving on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_from_config(MockConfig({
            "JAX_COORDINATOR_ADDR": "127.0.0.1:1", "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": "1"}))


@pytest.fixture(scope="module")
def world():
    jparams = jl.llama_init(CFG, seed=0)
    jq8 = jl.quantize_weights(jl.llama_init(CFG, seed=0))
    batch = np.arange(4 * 8, dtype=np.int32).reshape(4, 8)
    results = torch_dist.run_world(
        workers.mesh_and_blocks, 8, jax.device_get(jparams),
        jax.device_get(jq8), batch, timeout=240)
    return jparams, jq8, batch, results


def test_make_mesh_all_axes_present(world):
    for r in world[3]:
        assert r["names"] == list(AXES)
        assert r["sizes"] == {"dp": 2, "pp": 1, "sp": 2, "tp": 2, "ep": 1}
        assert "needs 16 devices, have 8" in r["refused"]


def _shard_on(arr, spec, device_index):
    mesh = jax_make_mesh(JMeshPlan(dp=2, sp=2, tp=2))
    placed = jax.device_put(arr, NamedSharding(mesh, spec))
    dev = mesh.devices.flat[device_index]
    return next(np.asarray(s.data) for s in placed.addressable_shards
                if s.device == dev)


@pytest.mark.parametrize("tree,specs", [
    ("float", "llama_param_specs"), ("float", "serving_param_specs"),
    ("int8", "serving_param_specs")])
def test_rank_blocks_equal_the_jax_shards(world, tree, specs):
    jparams, jq8, _, results = world
    ref_tree = jparams if tree == "float" else jq8
    ref_specs = (js.llama_param_specs() if specs == "llama_param_specs"
                 else js.serving_param_specs(quantized=tree == "int8"))
    key = {"llama_param_specs": "train", "serving_param_specs": "serve"}[
        specs] + ("_q8" if tree == "int8" else "")
    for rank, r in enumerate(results):
        for path, spec, leaf in _pairs(ref_specs, jax.device_get(ref_tree)):
            got = r[key]
            for k in path.strip("/").split("/"):
                got = got[k]
            want = _shard_on(leaf, spec, rank)
            np.testing.assert_array_equal(got, want, err_msg=path)
        if tree == "int8":
            assert r["q8_column_major"]


def test_process_local_batch_holds_the_ranks_rows(world):
    batch, results = world[2], world[3]
    for rank, r in enumerate(results):
        from jax.sharding import PartitionSpec

        want = _shard_on(batch, PartitionSpec("dp", "sp"), rank)
        np.testing.assert_array_equal(r["local_batch"], want)
        c = r["global_coords"]
        np.testing.assert_array_equal(
            r["local_batch"], batch[c["dp"] * 2:(c["dp"] + 1) * 2,
                                    c["sp"] * 4:(c["sp"] + 1) * 4])
