"""A dispatch's program held against the same work run eagerly.

For ``chip_smoke.py`` and the card's tests, not for serving: one decode
block, one admission wave (full or, on the paged engine, tail-only), one
speculative verify or one chunk of a chunked admission, replayed from its
program (a CUDA graph on the card) and the same work run op by op from the
same state, which is copied before the replay and put back before the
eager run (the loop state, the caches or pools with their scales, a chunk
job's carried state, and the generator). On a sampling_controls engine the rows' top_p /
top_k come from ``CONTROLS`` or are all 0, and the block runs the decode
variant the host picks for them: with the per-row filters, or without.
Any engine will do, on bf16 or int8 weights (models.llama.quantize_weights:
an int8 tree's products are cuBLASLt int8 products inside the captures).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops import launch_counts
from .paging import PagedLLMEngine, _pow2_at_least
from .sampling import pack_controls

# the (top_p, top_k) of rows 0, 1, 2, ... in turn where a check sets the
# per-row controls: none, top_k, top_p, both
CONTROLS = ((0.0, 0), (0.0, 40), (0.9, 0), (0.9, 40))


def _controls(K: int, temperature: float, filters: bool) -> np.ndarray:
    """[K, 3] row controls at `temperature`, the rows' top_p / top_k from
    CONTROLS in turn, or all 0."""
    picks = [CONTROLS[i % len(CONTROLS)] if filters else (0.0, 0)
             for i in range(K)]
    return pack_controls([temperature] * K, [p for p, _ in picks],
                         [k for _, k in picks])


def state_tensors(eng) -> List[torch.Tensor]:
    """Every device tensor a dispatch reads or writes in place: the loop
    state, then the caches or pools (and their scales)."""
    kv = ([eng.k_cache, eng.v_cache] if isinstance(eng, PagedLLMEngine)
          else [*eng.k_cache, *eng.v_cache])
    if eng._q8:
        kv += ([eng.k_scale, eng.v_scale] if isinstance(eng, PagedLLMEngine)
               else [*eng.k_scale, *eng.v_scale])
    return [eng._tokens, eng._positions, eng._temps, *kv]


def eager_block(eng, block: int) -> torch.Tensor:
    """`block` decode steps run eagerly, outside the program cache, with
    the decode variant a dispatch would pick now."""
    row_filter = eng._row_filter_now()
    if isinstance(eng, PagedLLMEngine):
        table = torch.from_numpy(eng._build_table()).to(eng.device)
        return eng._decode_fn_paged(table, block, row_filter)
    return eng._decode_fn(block, row_filter)


def _decode_launches() -> int:
    counts = launch_counts.counts()
    return sum(n for k, n in counts.items() if k != "flash_attention")


def graph_vs_eager(eng, block: int, temperature: float = 0.0,
                   filters: bool = False) -> dict:
    """Sync the engine's in-flight dispatches, set every row's temperature
    (and, on a sampling_controls engine, its top_p / top_k: CONTROLS in
    turn with `filters`, else 0, with the engine's record of the rows that
    have a control to match), run one real block through the program
    (capturing it if it is new), then: copy the state, replay the block,
    put the state back and run the block eagerly. Returns the two [B,
    block] token matrices, the largest difference over the state each left
    behind, the decode reads each ran (counted on the card, so 0 on the
    CPU) and whether the block ran the per-row filters."""
    on_card = eng.device.type == "cuda"
    with torch.no_grad(), eng._stream_ctx():
        while eng._inflight:
            eng._sync_oldest()
        if eng.sampling_controls:
            eng._temps.copy_(torch.from_numpy(
                _controls(eng.n_slots, temperature, filters)))
            eng._filter_rows = ({i for i in range(eng.n_slots)
                                 if any(CONTROLS[i % len(CONTROLS)])}
                                if filters else set())
        else:
            eng._temps.fill_(temperature)
        eng._run_decode(block)
        state = state_tensors(eng)
        saved = [t.clone() for t in state]
        rng = eng.generator.get_state()
        before = _decode_launches() if on_card else 0
        graph = eng._run_decode(block).clone()
        mid = _decode_launches() if on_card else 0
        after_graph = [t.clone() for t in state]
        for t, s in zip(state, saved):
            t.copy_(s)
        eng.generator.set_state(rng)
        eager = eager_block(eng, block)
        end = _decode_launches() if on_card else 0
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(after_graph, state))
    return {"graph": graph, "eager": eager, "state_diff": diff,
            "graph_launches": mid - before, "eager_launches": end - mid,
            "row_filter": eng._row_filter_now()}


def wave(eng, K: int, bucket: int, tail: bool = False,
         prefix_pages: int = 2, temperature: float = 0.0, seed: int = 0,
         filters: bool = False):
    """A synthetic admission wave of K rows at `bucket` into slots 0..K-1:
    (its program, the host arrays a dispatch fills it with, the eager
    function). Prompt tokens and lengths come from a numpy generator seeded
    with `seed` (full waves: lengths in (bucket / 2, bucket]); on a
    sampling_controls engine the rows' top_p / top_k are CONTROLS in turn
    with `filters`, else 0; paged rows
    take distinct pages from 1 up; a tail wave (paged) gives each row
    `prefix_pages` cached pages and a tail of up to `bucket` tokens, over a
    table as wide as dispatch makes it. The dense engine's cache is grown
    first where the bucket needs it, as dispatch does. Raises if the pool
    has too few pages for distinct ones."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, eng.cfg.vocab_size, (K, bucket), dtype=np.int64)
    slots = np.arange(K, dtype=np.int64)
    temps = (_controls(K, temperature, filters) if eng.sampling_controls
             else np.full(K, temperature, dtype=np.float32))
    tails = rng.integers(bucket // 2 + 1, bucket + 1, K).astype(np.int32)
    if not isinstance(eng, PagedLLMEngine):
        if tail:
            raise ValueError("tail-only waves run on the paged engine")
        if bucket + 1 > eng._cache_len:
            eng._grow_cache(bucket + 1)
        return (eng._prefill_program(bucket, K),
                (tokens, slots, tails, temps), eng._prefill_fn)
    ps = eng.page_size
    if not tail:
        n_ptable = -(-bucket // ps)
        program = eng._prefill_program(bucket, K)
        arrays = (tokens, _pages(eng, K, n_ptable), slots, tails, temps)
        return program, arrays, eng._prefill_fn
    prefix = np.full(K, prefix_pages * ps, dtype=np.int32)
    lengths = prefix + tails
    n_table = _pow2_at_least(eng.allocator.pages_for(int(lengths.max())))
    program = eng._prefix_program(bucket, K, n_table)
    arrays = (tokens, _pages(eng, K, n_table), prefix, slots, lengths, temps)
    return program, arrays, eng._prefix_fn


def _pages(eng, K: int, width: int) -> np.ndarray:
    if K * width >= eng.allocator.n_pages:
        raise ValueError(f"{K} x {width} distinct pages do not fit a pool of "
                         f"{eng.allocator.n_pages}")
    return np.arange(1, K * width + 1, dtype=np.int32).reshape(K, width)


def _flash() -> int:
    return launch_counts.counts()["flash_attention"]


def prefill_graph_vs_eager(eng, K: int, bucket: int, tail: bool = False,
                           temperature: float = 0.0,
                           filters: bool = False) -> dict:
    """Sync the engine's in-flight dispatches and copy its state; make
    (capturing it if it is new) the program of a synthetic K-row wave at
    `bucket` (`wave`: full, or tail-only on the paged engine; `filters`:
    its rows' per-row controls on a sampling_controls engine) and put the
    state back; replay the wave, copy what it left, put the state back and
    run the same wave eagerly on the same inputs; put the state back once
    more, so the engine is left as it was found. Returns both runs' [K]
    first tokens, the largest difference over the loop state and the
    caches or pools with their scales (`state_diff`) beside the largest
    magnitude in the caches or pools (`state_max`), and the flash launches
    each run made
    (counted on the card, so 0 on the CPU). The paged pools' garbage page
    0 is left out of `state_diff` and reported alone (`garbage_diff`): a
    wave's pad positions all scatter there, so on the card which of the
    duplicate writes lands last is not fixed."""
    on_card = eng.device.type == "cuda"
    with torch.no_grad(), eng._stream_ctx():
        while eng._inflight:
            eng._sync_oldest()
        if (not isinstance(eng, PagedLLMEngine)
                and bucket + 1 > eng._cache_len):
            eng._grow_cache(bucket + 1)
        state = state_tensors(eng)
        saved = [t.clone() for t in state]
        rng = eng.generator.get_state()

        def restore():
            for t, s in zip(state, saved):
                t.copy_(s)
            eng.generator.set_state(rng)

        program, arrays, eager_fn = wave(eng, K, bucket, tail,
                                        temperature=temperature,
                                        filters=filters)
        restore()
        before = _flash() if on_card else 0
        graph = eng._call(program, arrays).clone()
        mid = _flash() if on_card else 0
        after_graph = [t.clone() for t in state]
        restore()
        eager = eager_fn(*program.inputs)
        end = _flash() if on_card else 0
        diff, garbage, scale = _compare(eng, state, after_graph)
        restore()
    return {"graph": graph, "eager": eager, "state_diff": diff,
            "garbage_diff": garbage, "state_max": scale,
            "graph_launches": mid - before, "eager_launches": end - mid}


def _compare(eng, state, after_graph, loop: int = 3) -> tuple:
    """(largest difference of the state a replay left against the eager
    run's, the paged garbage page 0's alone, the largest |K/V|): `state`
    is state_tensors(eng), then any carried buffers, the first `loop` the
    loop state; the pools' page 0 is left out of the first number
    (duplicate pad and junk writes land there in no fixed order on the
    card)."""
    pools = isinstance(eng, PagedLLMEngine)
    diffs = [(a.float() - b.float()).abs() for a, b in zip(after_graph, state)]
    n_kv = len(state_tensors(eng)) - loop
    kv = range(loop, loop + n_kv)
    diff = max(float((d[:, 1:] if pools and i in kv else d).max())
               for i, d in enumerate(diffs))
    garbage = (max(float(diffs[i][:, 0].max()) for i in kv) if pools
               else 0.0)
    scale = max(float(after_graph[i].float().abs().max()) for i in kv)
    return diff, garbage, scale


def _saved(state):
    return [t.clone() for t in state]


def greedy_drafts(eng):
    """Drafts [B, d] that every active greedy row's verify accepts in full,
    and their lengths [B] (d on those rows, else 0): the model's own greedy
    continuation, found one position at a time by d eager verifies from
    copies of the engine's state, which is put back after each (the
    engine's in-flight dispatches synced)."""
    d, B = eng.speculative_tokens, eng.n_slots
    drafts = np.zeros((B, d), dtype=np.int64)
    rows = [i for i, slot in enumerate(eng.slots)
            if slot.active and slot.request.temperature <= 0.0]
    if not rows:
        raise ValueError("greedy_drafts needs an active greedy row")
    lens = np.zeros((B,), dtype=np.int32)
    lens[rows] = d
    with torch.no_grad(), eng._stream_ctx():
        while eng._inflight:
            eng._sync_oldest()
        state = state_tensors(eng)
        saved = _saved(state)
        rng = eng.generator.get_state()
        table = ((torch.from_numpy(eng._build_table()).to(eng.device),)
                 if isinstance(eng, PagedLLMEngine) else ())
        for i in range(d):
            out = eng._verify_fn(torch.from_numpy(drafts).to(eng.device),
                                 torch.from_numpy(lens).to(eng.device),
                                 eng._row_filter_now(), *table)
            drafts[rows, i] = out[rows, i].cpu().numpy()
            for t, s in zip(state, saved):
                t.copy_(s)
            eng.generator.set_state(rng)
    return drafts, lens


def verify_graph_vs_eager(eng, drafts=None, lens=None) -> dict:
    """Sync the engine's in-flight dispatches; with `drafts` [B, d] and
    `lens` [B] (default: greedy_drafts, which every active greedy row
    accepts in full) make the verify program a dispatch would call
    (capturing it if it is new) and put the state back; replay it, copy
    what it left, put the state back and run the same verify eagerly on
    the same inputs; put the state back once more. Returns both [B, d+2]
    outputs (the window's tokens and, last, the emit counts), `state_diff`
    (the paged pools' page 0 left out, where inactive rows' windows land),
    `garbage_diff`, `state_max`, the rows that drafted and the drafts
    accepted by the replay."""
    paged = isinstance(eng, PagedLLMEngine)
    with torch.no_grad(), eng._stream_ctx():
        while eng._inflight:
            eng._sync_oldest()
        if not paged:
            need = eng._decode_need()
            if need > eng._cache_len:
                eng._grow_cache(need)
        if drafts is None:
            drafts, lens = greedy_drafts(eng)
        row_filter = eng._row_filter_now()
        if paged:
            table = eng._build_table()
            program = eng._verify_program(table.shape[1], row_filter)
            arrays = (table, drafts, lens)
        else:
            program = eng._verify_program(row_filter)
            arrays = (drafts, lens)
        state = state_tensors(eng)
        saved = _saved(state)
        rng = eng.generator.get_state()

        def restore():
            for t, s in zip(state, saved):
                t.copy_(s)
            eng.generator.set_state(rng)

        graph = eng._call(program, arrays).clone()
        after_graph = _saved(state)
        restore()
        inputs = program.inputs
        eager = eng._verify_fn(inputs[-2], inputs[-1], row_filter,
                               *inputs[:-2])
        diff, garbage, scale = _compare(eng, state, after_graph)
        restore()
    n_emit = graph[:, -1].cpu()
    rows = int((lens > 0).sum())
    return {"graph": graph, "eager": eager, "state_diff": diff,
            "garbage_diff": garbage, "state_max": scale, "rows": rows,
            "accepted": int((n_emit - 1).clamp(min=0).sum())}


def chunk_graph_vs_eager(eng, K: int, bucket: int, final: bool,
                         temperature: float = 0.0, seed: int = 0) -> dict:
    """A synthetic K-row chunked admission at `bucket` into slots 0..K-1
    (prompt lengths in (bucket / 2, bucket], paged rows on distinct pages
    from 1 up): its chunks before the checked one run through their
    programs, then the checked chunk (the second, a middle one, or with
    `final` the last) is replayed from its program and run eagerly from the
    same state, as prefill_graph_vs_eager does for a wave; the engine's
    state (the loop state, the caches or pools, the job's carried buffers,
    the generator) is put back at the end. Returns both runs' outputs (the
    [K] first tokens of a final chunk, else the carried logits),
    `state_diff` over the state and the carried buffers (the paged pools'
    page 0 left out), `garbage_diff`, `state_max`."""
    chunk = eng.chunk_prefill_tokens
    if not eng._chunked(bucket):
        raise ValueError(f"bucket {bucket} is not admitted in chunks")
    paged = isinstance(eng, PagedLLMEngine)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, eng.cfg.vocab_size, (K, bucket), dtype=np.int64)
    lengths = rng.integers(bucket // 2 + 1, bucket + 1, K).astype(np.int32)
    temps = (_controls(K, temperature, False) if eng.sampling_controls
             else np.full(K, temperature, dtype=np.float32))
    slots = np.arange(K, dtype=np.int64)
    extra = (_pages(eng, K, -(-bucket // eng.page_size)),) if paged else ()
    target = bucket - chunk if final else chunk
    with torch.no_grad(), eng._stream_ctx():
        while eng._inflight:
            eng._sync_oldest()
        if not paged and bucket + 1 > eng._cache_len:
            eng._grow_cache(bucket + 1)
        key = eng._chunk_key(bucket, K)
        bufs = list(eng._chunk_state(key))
        state = state_tensors(eng) + bufs
        saved = _saved(state)
        gen = eng.generator.get_state()

        def restore():
            for t, s in zip(state, saved):
                t.copy_(s)
            eng.generator.set_state(gen)

        def program_at(start):
            last = start + chunk >= bucket
            if paged:
                return eng._chunk_program_paged(chunk, K, bucket, last)
            return eng._chunk_program(chunk, K, start == 0, last)

        def arrays_at(start):
            pos = np.tile(np.arange(start, start + chunk, dtype=np.int64),
                          (K, 1))
            return (tokens[:, start:start + chunk], pos, *extra,
                    np.asarray([start], dtype=np.int64), slots, lengths,
                    temps)

        for start in range(0, target + chunk, chunk):
            program_at(start)          # capture before any state is kept
        restore()
        for start in range(0, target, chunk):
            eng._call(program_at(start), arrays_at(start))
        before = _saved(state)
        program = program_at(target)
        graph = eng._call(program, arrays_at(target)).clone()
        after_graph = _saved(state)
        for t, s in zip(state, before):
            t.copy_(s)
        eng.generator.set_state(gen)      # only a final chunk draws
        last = target + chunk >= bucket
        if paged:
            tmp_k, tmp_v, selected = bufs
            eager = eng._chunk_fn_paged(tmp_k, tmp_v, selected, last,
                                        *program.inputs)
        else:
            eager = eng._chunk_fn(bufs[0], target == 0, last,
                                  *program.inputs)
        eager = eager.clone()
        diff, garbage, scale = _compare(eng, state, after_graph)
        restore()
    return {"graph": graph, "eager": eager, "state_diff": diff,
            "garbage_diff": garbage, "state_max": scale}
