"""Mesh parallelism: dp/tp/sp/pp/ep over torch.distributed.

Ports ``gofr_tpu/parallel/__init__.py``'s exports. The reference picks a
mesh, annotates, and lets XLA insert psum / all-gather / reduce-scatter /
ppermute, with shard_map only where the schedule is the algorithm (ring
attention, pipeline microbatching). PyTorch runs one process per card, so
here each rank holds its own block of every sharded tensor
(sharding.shard_params) and the collectives are explicit
(collectives.py): the Megatron all-reduces and the vocab all-gather in
models/llama.py, the ring's ppermute and Ulysses' all-to-alls in ops/.
``shard_map`` (a JAX version shim in the reference) has no counterpart.
The training half (ROADMAP A14b): the conjugate collectives
(collectives.py), ``mesh_llama_forward`` / ``make_mesh_forward``
(sharding.py: the reference's annotation-sharded forward, this rank's
block), GPipe (pipeline.py: ``gpipe``, ``pipelined_llama_forward``) and the
sharded step (``train.make_train_step(..., mesh=)``).
"""

from .longcontext import make_sp_forward, sp_llama_forward
from .mesh import MeshPlan, make_mesh
from .pipeline import gpipe, pipelined_llama_forward
from .sharding import (batch_spec, kv_cache_layer_spec, kv_cache_spec,
                       llama_param_specs, make_mesh_forward,
                       mesh_llama_forward, serving_param_specs, shard_params,
                       unsharded_like)

__all__ = ["MeshPlan", "make_mesh", "batch_spec", "llama_param_specs",
           "serving_param_specs", "kv_cache_spec", "kv_cache_layer_spec",
           "shard_params", "unsharded_like", "sp_llama_forward",
           "make_sp_forward", "gpipe", "pipelined_llama_forward",
           "mesh_llama_forward", "make_mesh_forward"]
