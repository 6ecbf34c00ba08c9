"""Token sampling on the device: greedy / temperature / top-k / top-p.

Ports ``sample_tokens`` of ``gofr_tpu/tpu/sampling.py`` with the [B]
temperature plane and the static engine-wide ``top_k``/``top_p`` caps; the
[B, 3] per-row controls are ROADMAP A9. Rows with temperature <= 0 take the
argmax. Sampling draws from an explicit ``torch.Generator``: it cannot give
``jax.random``'s numbers, so tests hold sampled rows to the set the filters
allow, not to JAX's tokens.

Inside a decode block captured as a CUDA graph (tpu/executor.py) the draws
stay graph-safe: the engine's generator, not the default one, is
registered with each graph before its capture
(``CUDAGraph.register_generator_state``), so every replay draws at the
generator's current Philox offset and advances it, as an eager call does.
Greedy rows never read the draw. Sampled rows keep their distribution, and
their numbers do not change: a replay draws what the eager block draws
from the same generator state (``chip_smoke.py``'s ``check graph`` lines,
at temperature 0.7).
"""

from __future__ import annotations

import torch

_NEG = -1e30


def sample_tokens(logits, generator: torch.Generator, temperature,
                  top_k: int = 0, top_p: float = 0.0):
    """logits: [B, V] float32; temperature: [B] (<= 0 means greedy);
    top_k / top_p: engine-wide caps (0 disables). Returns [B] int64 tokens.

    The draw is Gumbel-max over the filtered, temperature-scaled logits —
    the same distribution as a categorical draw, with no host sync."""
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
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20, max=1.0 - 1e-7)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)
