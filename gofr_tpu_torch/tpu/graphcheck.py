"""A decode block's program held against the same block run eagerly.

For ``chip_smoke.py`` and the card's tests, not for serving: one decode
block replayed from its program (a CUDA graph on the card) and the same
block run op by op from the same state, which is copied before the replay
and put back before the eager run (the loop state, the caches or pools
with their scales, and the generator).
"""

from __future__ import annotations

from typing import List

import torch

from ..ops import launch_counts
from .paging import PagedLLMEngine


def state_tensors(eng) -> List[torch.Tensor]:
    """Every device tensor a decode block reads or writes in place: the
    loop state, then the caches or pools (and their scales)."""
    kv = ([eng.k_cache, eng.v_cache] if isinstance(eng, PagedLLMEngine)
          else [*eng.k_cache, *eng.v_cache])
    if eng._q8:
        kv += ([eng.k_scale, eng.v_scale] if isinstance(eng, PagedLLMEngine)
               else [*eng.k_scale, *eng.v_scale])
    return [eng._tokens, eng._positions, eng._temps, *kv]


def eager_block(eng, block: int) -> torch.Tensor:
    """`block` decode steps run eagerly, outside the program cache."""
    if isinstance(eng, PagedLLMEngine):
        return eng._decode_fn_paged(eng._to_device(eng._build_table()), block)
    return eng._decode_fn(block)


def _decode_launches() -> int:
    counts = launch_counts.counts()
    return sum(n for k, n in counts.items() if k != "flash_attention")


def graph_vs_eager(eng, block: int, temperature: float = 0.0) -> dict:
    """Sync the engine's in-flight dispatches, run one real block through
    the program (capturing it if it is new), then: copy the state, replay
    the block, put the state back and run the block eagerly. Returns the
    two [B, block] token matrices, the largest difference over the state
    each left behind, and the decode reads each ran (counted on the card,
    so 0 on the CPU)."""
    on_card = eng.device.type == "cuda"
    with torch.no_grad(), eng._stream_ctx():
        while eng._inflight:
            eng._sync_oldest()
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
            "graph_launches": mid - before, "eager_launches": end - mid}
