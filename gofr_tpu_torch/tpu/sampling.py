"""Token sampling on the device: greedy / temperature / top-k / top-p.

Ports ``temperature_of``, ``pack_controls`` and ``sample_tokens`` of
``gofr_tpu/tpu/sampling.py``, with its two control planes, told apart by the
shape of ``samp``:

- [B] float32: per-row temperature only (the lean serving default, no sort
  in the sampler);
- [B, 3] float32: per-row (temperature, top_p, top_k), the engine's
  ``sampling_controls`` mode. One descending sort serves both filters,
  composed top_k then top_p; a row's 0 disables its filter
  (``row_filters``).

The static engine-wide ``top_k``/``top_p`` caps apply on top of either.
Rows with temperature <= 0 take the argmax.

The reference puts the per-row filters behind a data-dependent
``jax.lax.cond``, so a batch in which no row has a filter skips the [B, V]
sort at run time. A CUDA graph cannot branch on device data, so here the
caller decides: ``row_filter=False`` skips the filters. The engine knows
exactly which rows of its device state have a control set (it sets them at
admission and clears them when a slot frees), so it picks, per decode
block, the program with the filters or the one without (tpu/engine.py).
On rows whose controls are 0 ``row_filters`` returns its input bit for
bit, so either choice gives the reference's tokens wherever it is allowed.

Sampling draws from an explicit ``torch.Generator`` by Gumbel-max: it
cannot give ``jax.random``'s numbers, so tests hold sampled rows to the
set the filters allow, not to JAX's tokens. The filters draw nothing, so a
program draws the same numbers with and without them. Inside a program
captured as a CUDA graph (tpu/executor.py) the draws stay graph-safe: the
engine's generator is registered with each graph before its capture
(``CUDAGraph.register_generator_state``), so every replay draws at the
generator's current Philox offset and advances it, as an eager call does
(``chip_smoke.py``'s ``check graph`` lines).
"""

from __future__ import annotations

import numpy as np
import torch

_NEG = -1e30


def temperature_of(samp):
    """The per-row temperature vector from either control-plane shape."""
    return samp if samp.dim() == 1 else samp[:, 0]


def pack_controls(temperature, top_p, top_k) -> np.ndarray:
    """Host-side [K, 3] float32 row controls (see sample_tokens)."""
    return np.stack([np.asarray(temperature, dtype=np.float32),
                     np.asarray(top_p, dtype=np.float32),
                     np.asarray(top_k, dtype=np.float32)], axis=1)


def row_filters(scaled, samp):
    """The per-row top_k then top_p filters of a [B, 3] control plane over
    the [B, V] temperature-scaled logits: tokens outside a row's filters
    go to -1e30. One descending sort serves both: in sorted space top_k
    keeps columns [0, k), so the nucleus mass is taken over the top_k
    filtered, renormalized distribution. A row's 0 disables that filter,
    and a row with both at 0 comes back bit for bit."""
    V = scaled.shape[-1]
    top_p_row, top_k_row = samp[:, 1:2], samp[:, 2:3]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (top_k_row.long() - 1).clamp(0, V - 1)
    kth = torch.gather(sorted_desc, -1, k_idx)
    s = torch.where((top_k_row > 0) & (scaled < kth), _NEG, scaled)
    col = torch.arange(V, device=scaled.device)[None, :]
    in_topk = (top_k_row <= 0) | (col < top_k_row.long())
    sorted_masked = torch.where(in_topk, sorted_desc, _NEG)
    cumulative = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    # JAX's gather clamps an index past the end; torch's must be told
    cutoff_idx = torch.sum(cumulative < top_p_row, dim=-1,
                           keepdim=True).clamp(max=V - 1)
    cutoff = torch.gather(sorted_masked, -1, cutoff_idx)
    return torch.where((top_p_row > 0) & (s < cutoff), _NEG, s)


def sample_tokens(logits, generator: torch.Generator, samp,
                  top_k: int = 0, top_p: float = 0.0,
                  row_filter: bool = True):
    """logits: [B, V] float32; samp: [B] temperatures or [B, 3] per-row
    (temperature, top_p, top_k) controls (0 = greedy / disabled); top_k /
    top_p: engine-wide caps (0 disables), applied on top of any per-row
    controls; row_filter: run the per-row filters of a [B, 3] plane (False
    only where no row has a control). Returns [B] int64 tokens.

    The draw is Gumbel-max over the filtered, temperature-scaled logits —
    the same distribution as a categorical draw, with no host sync."""
    temperature = temperature_of(samp)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if top_k and top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, _NEG, scaled)
    if top_p and top_p > 0.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        cumulative = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p
        cutoff_idx = torch.sum(cumulative < top_p, dim=-1, keepdim=True)
        cutoff_idx = torch.clamp(cutoff_idx, max=scaled.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        scaled = torch.where(scaled < cutoff, _NEG, scaled)
    if samp.dim() == 2 and row_filter:
        scaled = row_filters(scaled, samp)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20, max=1.0 - 1e-7)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)
