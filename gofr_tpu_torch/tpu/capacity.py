"""Card memory capacity plan: fit the serving config to the card's budget.

A copy of ``gofr_tpu/tpu/capacity.py`` (``kv_token_bytes``,
``kv_cache_bytes``, ``params_bytes``, ``kv_scales_bytes``,
``prefill_temp_bytes``, ``plan_capacity``, ``CapacityPlan``): host
arithmetic from the model config, no device allocation, so the plan is
testable with a fake budget. Two differences:

- ``device_budget_bytes`` reads the card's total memory
  (``torch.cuda.get_device_properties``) where the reference reads the JAX
  device's ``bytes_limit``; it returns 0 on the CPU, where the reference's
  CPU backend reports no limit, and 0 means no plan.
- The port's peak has a term the reference has none of: the CUDA graph
  pools its programs are captured into (``tpu/executor.py``). Their size
  is not known before the captures, so ``graph_pool_margin`` states it per
  configuration from what the card has shown (at ``WARMUP=wide``, Llama-3-8B,
  8 slots, buckets up to 512: up to 1.5 GiB with a bf16 cache, 1.54-3.04 GiB
  with an int8 one, whose quantizing writes keep f32 temporaries in the
  pool). ``plan_capacity`` adds ``graph_pool_bytes`` (0 by default, the
  reference's plan) to the peak; the engines pass the margin on the card
  only, where graphs are captured.
- Under a mesh (ROADMAP A14a) the reference plans the whole slice's
  GLOBAL bytes (``params_nbytes`` of the sharded tree and the whole cache)
  against its per-device budget times ``mesh.size``. Each rank of the port
  is a process that sees its own card: it plans that card's bytes (its
  block of the params, by ``params_nbytes`` of the tree it holds, and the
  cache of its KV heads, from its rank-local config) against that card's
  budget, which comes to the same fit. The ranks then take the minimum
  plan (``LLMEngine._agree_on_plan``).
- ``twin_budget_bytes`` sizes the second engine of a pair on one card
  (``DISAGG_MODE=both``) from the memory the first left free, where the
  reference hands both the device's whole limit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}

# the graph pools' margin by KV dtype (None: the model's dtype), see above
GRAPH_POOL_MARGIN = {None: 2 << 30, "int8": 4 << 30}


def _dtype_bytes(name: str) -> int:
    return _DTYPE_BYTES.get(name, 4)


def graph_pool_margin(cfg) -> int:
    """Card bytes kept for the CUDA graph pools of a config's programs."""
    return GRAPH_POOL_MARGIN[getattr(cfg, "kv_dtype", None)]


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """The fit decision for one serving config on one device budget."""

    n_slots: int
    max_seq_len: int
    prefill_buckets: Tuple[int, ...]
    budget_bytes: int
    params_bytes: int
    cache_bytes_max: int        # both caches at the planned max_seq_len
    # the dense cache's transient: one more cache-sized pair (the
    # reference's decode carries; here the growth copy, which it covers)
    growth_transient_bytes: int
    prefill_temp_bytes: int      # worst fused-admission temporaries
    fits: bool
    clamped: bool                # True if the requested config was shrunk
    graph_pool_bytes: int = 0    # the port's graph pools (module docstring)

    @property
    def peak_bytes(self) -> int:
        """Worst simultaneous residency the plan accounts for."""
        return (self.params_bytes + self.cache_bytes_max
                + max(self.growth_transient_bytes, self.prefill_temp_bytes)
                + self.graph_pool_bytes)

    def summary(self) -> str:
        gb = 1 << 30
        return (f"capacity plan: slots={self.n_slots} max_seq={self.max_seq_len} "
                f"params={self.params_bytes / gb:.2f}GiB "
                f"kv={self.cache_bytes_max / gb:.2f}GiB "
                f"transient={max(self.growth_transient_bytes, self.prefill_temp_bytes) / gb:.2f}GiB "
                f"graphs={self.graph_pool_bytes / gb:.2f}GiB "
                f"peak={self.peak_bytes / gb:.2f}GiB "
                f"budget={self.budget_bytes / gb:.2f}GiB "
                f"fits={self.fits} clamped={self.clamped}")


def kv_token_bytes(cfg, dtype: Optional[str] = None) -> int:
    """Bytes one cached token occupies across BOTH (k, v) caches:
    2 * n_layers * n_kv_heads * head_dim * itemsize."""
    return (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
            * _dtype_bytes(dtype or getattr(cfg, "kv_dtype", None)
                           or cfg.dtype))


def kv_cache_bytes(cfg, n_slots: int, seq_len: int,
                   dtype: Optional[str] = None) -> int:
    """Both (k, v) caches: 2 * [L, B, Hkv, dh, S] in the cache dtype."""
    return n_slots * seq_len * kv_token_bytes(cfg, dtype=dtype or cfg.dtype)


def params_bytes(cfg) -> int:
    return cfg.param_count() * _dtype_bytes(cfg.dtype)


def kv_scales_bytes(cfg, n_slots: int, seq_len: int) -> int:
    """The int8 cache's f32 dequant-scale buffers: 2 * [L, B, Hkv, S]."""
    return 2 * cfg.n_layers * n_slots * cfg.n_kv_heads * seq_len * 4


def prefill_temp_bytes(cfg, k_max: int, bucket_max: int) -> int:
    """Worst-case fused-admission temporaries for a [K, bucket] prefill:
    the window's k/v (2 * [L, K, bucket, Hkv, dh]) plus ~4 live [K, bucket,
    max(D, F)] activations."""
    dt = _dtype_bytes(cfg.dtype)
    tmp_kv = 2 * (cfg.n_layers * k_max * bucket_max * cfg.n_kv_heads
                  * cfg.head_dim * dt)
    acts = 4 * k_max * bucket_max * max(cfg.dim, cfg.ffn_dim) * dt
    return tmp_kv + acts


def plan_capacity(cfg, n_slots: int, max_seq_len: int,
                  budget_bytes: int,
                  prefill_buckets: Sequence[int] = (),
                  safety_frac: float = 0.92,
                  paged: bool = False,
                  clamp: bool = True,
                  min_slots: int = 1,
                  min_seq: int = 128,
                  params_nbytes: Optional[int] = None,
                  graph_pool_bytes: int = 0) -> CapacityPlan:
    """Compute the fit; optionally shrink (n_slots, max_seq_len) until it
    fits.

    budget_bytes: the card's budget (device_budget_bytes); a safety
    fraction keeps headroom for the allocator's fragmentation. paged=True
    drops the growth transient (the pool is allocated once). Clamping
    halves whichever of (max_seq_len, n_slots) costs more cache bytes;
    raises ValueError if even the minimum config cannot fit.
    params_nbytes: the tree's actual bytes (models.llama.params_nbytes),
    which the analytic estimate gets 2x wrong for int8 weights.
    graph_pool_bytes: the port's graph pools (module docstring)."""
    p_known = params_nbytes if params_nbytes else params_bytes(cfg)
    if budget_bytes <= 0:
        # no budget (the CPU): trust the caller's config
        buckets = tuple(b for b in prefill_buckets if b <= max_seq_len)
        return CapacityPlan(n_slots, max_seq_len, buckets, 0,
                            p_known, kv_cache_bytes(cfg, n_slots, max_seq_len),
                            0, 0, fits=True, clamped=False)

    p_bytes = p_known
    usable = int(budget_bytes * safety_frac)
    requested = (n_slots, max_seq_len)

    def peak(slots: int, seq: int) -> Tuple[int, int, int]:
        kv_dtype = getattr(cfg, "kv_dtype", None)
        cache = kv_cache_bytes(cfg, slots, seq, dtype=kv_dtype)
        if kv_dtype == "int8":
            cache += kv_scales_bytes(cfg, slots, seq)
        transient = 0 if paged else cache
        bucket_max = max((b for b in prefill_buckets if b <= seq), default=0)
        ptmp = prefill_temp_bytes(cfg, slots, bucket_max) if bucket_max else 0
        return cache, transient, ptmp

    while True:
        cache, transient, ptmp = peak(n_slots, max_seq_len)
        total = p_bytes + cache + max(transient, ptmp) + graph_pool_bytes
        if total <= usable:
            break
        if not clamp:
            buckets = tuple(b for b in prefill_buckets if b <= max_seq_len)
            return CapacityPlan(n_slots, max_seq_len, buckets, budget_bytes,
                                p_bytes, cache, transient, ptmp,
                                fits=False, clamped=False,
                                graph_pool_bytes=graph_pool_bytes)
        if n_slots <= min_slots and max_seq_len <= min_seq:
            raise ValueError(
                f"model cannot serve within budget: params {p_bytes >> 20} MiB "
                f"+ minimum cache {cache >> 20} MiB exceed "
                f"{usable >> 20} MiB usable of {budget_bytes >> 20} MiB")
        # shed whichever axis is currently more expensive, respecting floors
        if (max_seq_len > min_seq
                and (max_seq_len >= 2 * min_seq and max_seq_len * min_slots
                     >= n_slots * min_seq or n_slots <= min_slots)):
            max_seq_len = max(min_seq, max_seq_len // 2)
        else:
            n_slots = max(min_slots, n_slots // 2)

    buckets = tuple(b for b in prefill_buckets if b <= max_seq_len)
    return CapacityPlan(n_slots, max_seq_len, buckets, budget_bytes,
                        p_bytes, cache, transient, ptmp,
                        fits=True, clamped=(n_slots, max_seq_len) != requested,
                        graph_pool_bytes=graph_pool_bytes)


def device_budget_bytes(device=None) -> int:
    """The card's memory in bytes (its total, as the reference's
    ``bytes_limit`` is the whole device's: the plan counts the weights
    already placed on it through params_nbytes), or 0 on the CPU, where
    the reference's CPU backend reports no limit."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        return 0
    return int(torch.cuda.get_device_properties(dev).total_memory)


def twin_budget_bytes(device, params_nbytes: int) -> int:
    """The budget of a second engine built on a card where one already
    serves over the same params tree (DISAGG_MODE=both's prefill pool): the
    card's free memory now, plus the shared weights, which the plan counts
    but the twin does not allocate again. Where the reference gives both
    engines the device's whole limit, each plan here would claim the card
    (``device_budget_bytes`` reads its total), so the second is sized from
    what the first left free. 0 on the CPU (no plan)."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        return 0
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free) + int(params_nbytes)
