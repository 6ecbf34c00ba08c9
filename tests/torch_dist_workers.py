"""Worker functions of the port's spawned-world tests (tests/torch_dist.py).

Each runs in a process of a gloo world, imports only the port (never jax
or gofr_tpu), takes numpy inputs and returns numpy arrays and plain
values. The test processes compute the JAX side and compare.
"""

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


def _tree(np_tree):
    from gofr_tpu_torch.models.weights import params_from_numpy

    return params_from_numpy(np_tree, device="cpu")


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def _coords(mesh):
    from gofr_tpu_torch.parallel.mesh import AXES

    return {a: mesh.get_local_rank(a) for a in AXES}


# -- mesh, specs, blocks -------------------------------------------------------
def mesh_and_blocks(rank, world, np_params, np_q8, batch):
    """The mesh twins (all axes present, a plan that is not the world
    refused), this rank's blocks of a float tree under llama_param_specs
    and serving_param_specs, of an int8 tree under
    serving_param_specs(quantized), and process_local_batch."""
    from gofr_tpu_torch.parallel import (MeshPlan, llama_param_specs,
                                         make_mesh, serving_param_specs,
                                         shard_params)
    from gofr_tpu_torch.parallel.multihost import (global_mesh,
                                                   process_local_batch)

    mesh = make_mesh(MeshPlan(dp=2, sp=2, tp=2), device="cpu")
    out = {"names": list(mesh.mesh_dim_names),
           "sizes": {a: mesh.size(i)
                     for i, a in enumerate(mesh.mesh_dim_names)},
           "coords": _coords(mesh)}
    try:
        make_mesh(MeshPlan(dp=16), device="cpu")
        out["refused"] = None
    except ValueError as exc:
        out["refused"] = str(exc)
    params = _tree(np_params)
    out["train"] = _tree_np(shard_params(params, mesh, llama_param_specs()))
    out["serve"] = _tree_np(shard_params(params, mesh,
                                         serving_param_specs()))
    q8 = _tree(np_q8)
    # the port's int8 producers store the matrices column-major
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w = q8["layers"][k]
        q8["layers"][k] = w.transpose(-1, -2).contiguous().transpose(-1, -2)
    blocks = shard_params(q8, mesh, serving_param_specs(quantized=True))
    out["serve_q8"] = _tree_np(blocks)
    # the int8 matrices stay column-major (the product's fast layout)
    out["q8_column_major"] = all(
        blocks["layers"][k].stride(-2) == 1
        for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    gmesh = global_mesh(dp=2, sp=2, tp=2, device="cpu")
    out["local_batch"] = _np(process_local_batch(batch, gmesh))
    out["global_coords"] = _coords(gmesh)
    return out


# -- tensor-parallel forwards ----------------------------------------------------
def tp_forwards(rank, world, cases):
    """llama_forward_nocache for each case (numpy params, cfg, tokens,
    (dp, sp, tp)) with the llama_param_specs blocks and the batch split by
    batch_spec: this rank's logits block and its mesh coordinates."""
    from gofr_tpu_torch.models.llama import llama_forward_nocache
    from gofr_tpu_torch.parallel import (MeshPlan, batch_spec,
                                         llama_param_specs, make_mesh,
                                         shard_params)
    from gofr_tpu_torch.parallel.multihost import process_local_batch
    from gofr_tpu_torch.parallel.sharding import shard_config

    res = []
    for np_params, cfg, tokens, (dp, sp, tp) in cases:
        mesh = make_mesh(MeshPlan(dp=dp, sp=sp, tp=tp), device="cpu")
        local = shard_params(_tree(np_params), mesh, llama_param_specs())
        toks = process_local_batch(tokens, mesh, batch_spec()).long()
        with torch.no_grad():
            logits = llama_forward_nocache(
                local, shard_config(cfg, mesh, sp=True), toks)
        res.append((_coords(mesh), _np(logits)))
    return res


def _q8_forward(mesh, np_q8, cfg, tokens, drop_max):
    """The serving-spec int8 forward at the mesh's tp, with the MAX
    all-reduce of the row absmax taken out when drop_max (the mutation the
    test must catch)."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.parallel import serving_param_specs, shard_params
    from gofr_tpu_torch.parallel.sharding import shard_config

    real = llama.all_reduce
    if drop_max:
        def no_max(x, axis, op="sum"):
            return x if op == "max" else real(x, axis, op)

        llama.all_reduce = no_max
    try:
        local = shard_params(_tree(np_q8), mesh,
                             serving_param_specs(quantized=True))
        with torch.no_grad():
            return _np(llama.llama_forward_nocache(
                local, shard_config(cfg, mesh),
                torch.from_numpy(tokens).long()))
    finally:
        llama.all_reduce = real


def tp2_suite(rank, world, np_params, np_q8, cfg, tokens, q8_tokens,
              engine_kw, requests, sampled):
    """Everything of test_torch_tp.py at tp = world: the float forward
    (llama_param_specs), the int8 forward (serving specs) on q8_tokens with
    and without the absmax MAX and on tokens, and the paged and dense engines (requests queued
    before the loop starts, so every rank dispatches the same programs in
    the same order): their greedy streams, and the paged engine's streams
    of `sampled` (temperature > 0) requests."""
    from gofr_tpu_torch.parallel import MeshPlan, make_mesh
    from gofr_tpu_torch.tpu.engine import LLMEngine
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    out = {"forward": tp_forwards(rank, world, [
        (np_params, cfg, tokens, (1, 1, world))])[0][1]}
    mesh = make_mesh(MeshPlan(tp=world), device="cpu")
    out["q8"] = _q8_forward(mesh, np_q8, cfg, q8_tokens, drop_max=False)
    out["q8_no_max"] = _q8_forward(mesh, np_q8, cfg, q8_tokens,
                                   drop_max=True)
    out["q8_wide"] = _q8_forward(mesh, np_q8, cfg, tokens, drop_max=False)
    params = _tree(np_params)
    for name, cls, extra in (("paged", PagedLLMEngine, {"page_size": 8}),
                             ("dense", LLMEngine, {})):
        eng = cls(params, cfg, device="cpu", mesh=mesh,
                  **dict(engine_kw, **extra))
        reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0)
                for p, n in requests]
        if name == "paged":
            reqs += [eng.submit(p, max_new_tokens=n, temperature=t)
                     for p, n, t in sampled]
        eng.start()
        try:
            got = [r.result(timeout_s=120) for r in reqs]
        finally:
            eng.stop()
        out[name] = got[:len(requests)]
        if name == "paged":
            out["sampled"] = got[len(requests):]
            out["kv_heads"] = int(eng.k_cache.shape[2])
    return out


# -- live traffic over a job's store --------------------------------------------
def live_admission(rank, world, port, np_params, cfg, prompts, budgets,
                   cancel_index):
    """One rank of a 2-process job joined through the JAX_* keys: the dense
    engine at tp=2 behind an admission plane over the job's TCPStore.
    Rank 0 takes staggered submits and cancels one stream after its 2nd
    token; rank 1 mirrors the waves. Returns the leader's streams or the
    follower's shadow streams in id order, and the KV heads per rank."""
    import threading
    import time

    import torch.distributed as dist

    from gofr_tpu_torch.config import as_config
    from gofr_tpu_torch.parallel import MeshPlan, make_mesh
    from gofr_tpu_torch.parallel.multihost import initialize_from_config
    from gofr_tpu_torch.tpu.admission import AdmissionPlane
    from gofr_tpu_torch.tpu.engine import LLMEngine

    spec = initialize_from_config(as_config({
        "JAX_COORDINATOR_ADDR": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank),
        "JAX_COORDINATOR_TIMEOUT_S": "60"}), device="cpu")
    assert spec is not None and dist.get_rank() == rank
    mesh = make_mesh(MeshPlan(tp=world), device="cpu")
    plane = AdmissionPlane()
    shadows = []
    if rank:
        plane.on_shadow = shadows.append
    eng = LLMEngine(_tree(np_params), cfg, device="cpu", n_slots=4,
                    max_seq_len=128, prefill_buckets=(8,),
                    decode_block_size=4, mesh=mesh, admission_plane=plane)
    out = {"kv_heads": int(eng.k_cache[0].shape[1])}
    eng.start()
    try:
        if rank == 0:
            requests = []

            def submitter():
                for p, budget in zip(prompts, budgets):
                    requests.append(eng.submit(p, max_new_tokens=budget,
                                               temperature=0.0))
                    time.sleep(0.15)   # arrivals land across live waves

            t = threading.Thread(target=submitter)
            t.start()
            t.join()
            victim = requests[cancel_index]
            got_victim = []
            for tok in victim.stream(timeout_s=120):
                got_victim.append(tok)
                if len(got_victim) == 2:
                    victim.cancel()
            out["served"] = [got_victim if i == cancel_index
                             else r.result(timeout_s=120)
                             for i, r in enumerate(requests)]
        else:
            deadline = time.time() + 180
            while time.time() < deadline:
                if plane.closed and len(shadows) == len(prompts) and all(
                        s.finished_at is not None for s in shadows):
                    break
                time.sleep(0.05)
            assert len(shadows) == len(prompts), len(shadows)
            out["mirrored"] = [list(s.stream(timeout_s=5))
                               for s in sorted(shadows, key=lambda s: s.id)]
    finally:
        eng.stop()   # the leader's publishes the stop sentinel
    # rank 0 serves the store: it leaves only after the follower is done
    dist.barrier()
    dist.destroy_process_group()
    return out


# -- sequence parallelism ---------------------------------------------------------
def _chunk(x, axis, dim=1):
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n)


def _attend_grads(fn, axis, q, k, v):
    """fn over this rank's chunks of q, k, v; (out chunk, the grads of the
    global sum(out ** 2) w.r.t. the three chunks)."""
    leaves = [_chunk(torch.from_numpy(x), axis).clone().requires_grad_()
              for x in (q, k, v)]
    out = fn(*leaves, axis)
    (out.float() ** 2).sum().backward()
    return _np(out), [_np(t.grad) for t in leaves]


def sp_suite(rank, world, data, np_params, cfg):
    """Every sequence-parallel twin in one 8-rank world (test_torch_sp.py):
    ring and Ulysses at sp=8 in value and gradient, Ulysses against ring at
    sp=4 x dp=2, the indivisible-heads refusal, sp_llama_forward (ring and
    Ulysses) at dp=2 x sp=4 against the dense forward, and the indivisible
    sequence refusal."""
    from gofr_tpu_torch.ops.ring_attention import ring_attention
    from gofr_tpu_torch.ops.ulysses import ulysses_attention
    from gofr_tpu_torch.parallel import MeshPlan, make_mesh
    from gofr_tpu_torch.parallel.longcontext import sp_llama_forward
    from gofr_tpu_torch.parallel.mesh import axis_of

    out = {}
    mesh8 = make_mesh(MeshPlan(sp=8), device="cpu")
    sp8 = axis_of(mesh8, "sp")
    out["rank8"] = sp8.rank
    out["ring"] = _attend_grads(ring_attention, sp8, *data["ring"])
    out["ring_grad"] = _attend_grads(ring_attention, sp8,
                                     *data["ring_grad"])
    out["ulysses"] = _attend_grads(ulysses_attention, sp8,
                                   *data["ulysses"])
    out["ulysses_grad"] = _attend_grads(ulysses_attention, sp8,
                                        *data["ulysses_grad"])
    bad = torch.ones((1, 2, 6, 8))   # 6 heads do not divide by sp=8
    try:
        ulysses_attention(bad, bad, bad, sp8)
        out["heads_refused"] = None
    except ValueError as exc:
        out["heads_refused"] = str(exc)
    mesh4 = make_mesh(MeshPlan(sp=4, dp=2), device="cpu")
    sp4 = axis_of(mesh4, "sp")
    out["rank4"] = sp4.rank
    with torch.no_grad():
        qkv = [_chunk(torch.from_numpy(x), sp4) for x in data["vs_ring"]]
        out["vs_ring"] = (_np(ulysses_attention(*qkv, sp4)),
                          _np(ring_attention(*qkv, sp4)))
    params = _tree(np_params)
    tokens = torch.from_numpy(data["tokens"]).long()
    out["coords"] = _coords(mesh4)
    with torch.no_grad():
        out["sp_forward"] = {attn: _np(sp_llama_forward(params, cfg, tokens,
                                                        mesh4, attn=attn))
                             for attn in ("ring", "ulysses")}
    try:
        sp_llama_forward(params, cfg, torch.ones((1, 30), dtype=torch.long),
                         mesh8)
        out["seq_refused"] = None
    except ValueError as exc:
        out["seq_refused"] = str(exc)
    return out


# -- sharded training (test_torch_sharded_train.py, test_torch_gpipe.py) ------
def _snapshot(tree):
    """A numpy copy of `tree` (the step updates its tensors in place)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return np.array(tree.detach().cpu() if torch.is_tensor(tree) else tree)


def _train_run(mesh, forward, np_params, batch, steps, has_aux=False,
               remat=True):
    """The sharded step (train.make_train_step with mesh=) on this rank's
    blocks of np_params (shard_params under llama_param_specs(moe=has_aux))
    and the global batch (tokens, targets, mask or None): the first step's
    gradient blocks (loss_and_grads), then `steps` steps' metrics and
    parameter blocks."""
    from gofr_tpu_torch.parallel import llama_param_specs, shard_params
    from gofr_tpu_torch.train import make_train_step

    specs = llama_param_specs(moe=has_aux)
    # a copy: the step updates in place, and shard_params keeps a leaf no
    # axis splits as it is (over the numpy arrays' memory)
    params = shard_params(_tree(_snapshot(np_params)), mesh, specs)
    tokens, targets, mask = (None if x is None else torch.from_numpy(x)
                             for x in batch)
    tokens, targets = tokens.long(), targets.long()
    init, step = make_train_step(forward, has_aux_loss=has_aux, remat=remat,
                                 mesh=mesh)
    *_, grads = step.loss_and_grads(params, tokens, targets, mask)
    out = {"coords": _coords(mesh), "grads": _snapshot(grads),
           "metrics": [], "params": []}
    state = init(params)
    for _ in range(steps):
        params, state, metrics = step(params, state, tokens, targets, mask)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["params"].append(_snapshot(params))
    return out


def _mutated(run, mutation):
    """run() with one fault of the sharded step put in: "no_dp" drops the
    dp sum of the gradients, "tp_identity" puts an identity in place of
    the tp copy (so its backward all-reduce is gone)."""
    from gofr_tpu_torch import train
    from gofr_tpu_torch.models import llama

    real_reduce, real_copy = train.reduce_gradients, llama.copy_to
    if mutation == "no_dp":
        train.reduce_gradients = lambda grads, axes: real_reduce(
            grads, [a for a in axes if a.name != "dp"])
    else:
        llama.copy_to = lambda x, axis: x
    try:
        return run()
    finally:
        train.reduce_gradients, llama.copy_to = real_reduce, real_copy


def dense_train_suite(rank, world, np_params, cfg, batch, mask, steps):
    """The dense twin at dp=2 x sp=2 x tp=2 (remat on, as the reference's
    default): the unmasked run, the masked run, and the unmasked run's
    first step under each mutation."""
    from gofr_tpu_torch.parallel import MeshPlan, make_mesh, make_mesh_forward

    mesh = make_mesh(MeshPlan(dp=2, sp=2, tp=2), device="cpu")
    fwd = make_mesh_forward(cfg, mesh)

    def run(mask=None, n=steps):
        return _train_run(mesh, fwd, np_params, (*batch, mask), n)

    out = {"plain": run(), "masked": run(mask)}
    for mutation in ("no_dp", "tp_identity"):
        out[mutation] = _mutated(lambda: run(n=1), mutation)
    return out


def moe_train_suite(rank, world, np_params, cfg, batch, steps):
    """The MoE twin at dp=2 x ep=4 (remat on)."""
    from gofr_tpu_torch.parallel import MeshPlan, make_mesh, make_mesh_forward

    mesh = make_mesh(MeshPlan(dp=2, ep=4), device="cpu")
    return _train_run(mesh, make_mesh_forward(cfg, mesh), np_params,
                      (*batch, None), steps, has_aux=True)


def sp_train_suite(rank, world, np_params, cfg, batch, steps):
    """The sequence-parallel twins (remat off, as the reference's): ring at
    sp=8 and Ulysses at dp=2 x sp=4 (sp divides the 4 query heads)."""
    from gofr_tpu_torch.parallel import MeshPlan, make_mesh, make_sp_forward

    out = {}
    for attn, plan in (("ring", MeshPlan(sp=8)),
                       ("ulysses", MeshPlan(dp=2, sp=4))):
        mesh = make_mesh(plan, device="cpu")
        out[attn] = _train_run(mesh, make_sp_forward(cfg, mesh, attn=attn),
                               np_params, (*batch, None), steps,
                               remat=False)
    return out


def one_rank_train(rank, world, np_params, cfg, batch, steps):
    """A world of one: the sharded step on the all-ones mesh against the
    unsharded step on the same weights and batch (every metric and leaf
    after each step, for a bit-for-bit comparison), and the pipelined
    forward at pp=1 against the plain forward."""
    from gofr_tpu_torch.models.llama import llama_forward_nocache
    from gofr_tpu_torch.parallel import (MeshPlan, make_mesh,
                                         make_mesh_forward,
                                         pipelined_llama_forward)
    from gofr_tpu_torch.train import make_train_step

    mesh = make_mesh(MeshPlan(), device="cpu")
    tokens, targets = (torch.from_numpy(x).long() for x in batch)
    runs = {}
    # the embedding's backward accumulates repeated ids' rows in any order
    # unless asked for deterministic kernels
    torch.use_deterministic_algorithms(True)
    for name, kw in (("sharded", dict(mesh=mesh)), ("plain", {})):
        fwd = (make_mesh_forward(cfg, mesh) if kw else
               (lambda p, t: llama_forward_nocache(p, cfg, t)))
        params = _tree(_snapshot(np_params))
        init, step = make_train_step(fwd, **kw)
        state = init(params)
        runs[name] = []
        for _ in range(steps):
            params, state, metrics = step(params, state, tokens, targets)
            runs[name].append(({k: _np(v) for k, v in metrics.items()},
                               _snapshot(params)))
    torch.use_deterministic_algorithms(False)
    with torch.no_grad():
        params = _tree(np_params)
        runs["piped"] = _np(pipelined_llama_forward(params, cfg, tokens,
                                                    mesh, 2))
        runs["plain_logits"] = _np(llama_forward_nocache(params, cfg,
                                                         tokens))
    return runs


def gpipe_suite(rank, world, np_params, cfg, tokens, n_micro, steps):
    """The GPipe twin at pp=4 x tp=2 (remat off, as the reference's):
    this rank's logits of the pipelined forward, the sharded step's run
    on (tokens[:, :-1], tokens[:, 1:]), and the refusal of a microbatch
    count that does not divide the batch."""
    from gofr_tpu_torch.parallel import (MeshPlan, llama_param_specs,
                                         make_mesh, pipelined_llama_forward,
                                         shard_params)

    mesh = make_mesh(MeshPlan(pp=4, tp=2), device="cpu")
    toks = torch.from_numpy(tokens).long()
    params = shard_params(_tree(np_params), mesh, llama_param_specs())
    with torch.no_grad():
        logits = _np(pipelined_llama_forward(params, cfg, toks, mesh,
                                             n_micro))
    try:
        pipelined_llama_forward(params, cfg, toks, mesh, n_micro - 1)
        refused = None
    except ValueError as exc:
        refused = str(exc)

    def fwd(p, t):
        return pipelined_llama_forward(p, cfg, t, mesh, n_micro)

    run = _train_run(mesh, fwd, np_params, (tokens[:, :-1], tokens[:, 1:],
                                             None), steps, remat=False)
    return {"logits": logits, "refused": refused, **run}


# -- the batcher servers' job -------------------------------------------------------
def mnist_job(rank, world, port, images):
    """One rank of serve_mnist's job, joined through the JAX_* keys on the
    CPU: the device client's mesh over the job's ranks, then /predict on
    this rank's own HTTP port for `images` against the unbatched forward
    of this rank's params, /.well-known/health's tpu, and the App's
    shutdown leaving the job."""
    import http.client
    import json

    import numpy as np
    import torch
    import torch.distributed as dist

    from gofr_tpu_torch import serve_mnist
    from gofr_tpu_torch.models.mlp import mlp_forward

    app = serve_mnist.build_app({
        "JAX_COORDINATOR_ADDR": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank),
        "JAX_COORDINATOR_TIMEOUT_S": "60", "HTTP_PORT": "0",
        "METRICS_PORT": "0", "LOG_LEVEL": "WARN", "REQUEST_TIMEOUT": "60",
        "HOSTPROF": "false"}, device="cpu")
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend(),
           "platform": app.container.tpu.platform}
    mesh = app.container.tpu.mesh({"dp": -1})
    out["mesh"] = {name: mesh.size(i)
                   for i, name in enumerate(mesh.mesh_dim_names)}
    app.start()
    try:
        answers = []
        for image in images:
            conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                              timeout=60)
            conn.request("POST", "/predict",
                         json.dumps({"image": image.tolist()}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answers.append((resp.status, json.loads(resp.read())))
            conn.close()
        with torch.no_grad():
            logits = mlp_forward(app.params,
                                 torch.from_numpy(np.stack(images))).numpy()
        out["answers"] = answers
        out["logits"] = logits
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=60)
        conn.request("GET", "/.well-known/health")
        out["health"] = json.loads(conn.getresponse().read())["data"]
        conn.close()
        dist.barrier()   # rank 0 serves the store: nobody leaves early
    finally:
        app.shutdown()
    out["left"] = not dist.is_initialized()
    return out
