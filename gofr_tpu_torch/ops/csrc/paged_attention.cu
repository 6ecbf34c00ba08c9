// Paged decode attention for Hopper (sm_90a): one query token per row, GQA,
// read through a block table, from bf16 pools or from int8 pools with
// per-token f32 scales.
//
// Replaces: gofr_tpu/ops/paged_attention.py, paged_attention ->
// _paged_kernel, with quantized=False (gofr_paged_attention) and
// quantized=True (gofr_paged_attention_q8).
//
// Layout (the JAX pool's, so the port's pools compare one to one):
// q, o [B, H, dh] bf16; k_pool, v_pool [P, Hkv, dh, ps] (token index minor),
// bf16 or int8; k_scale, v_scale [P, Hkv, ps] f32; table [B, NP] int32 page
// ids; lengths [B] int32 live tokens per row.
//
// Both: decode_split.cuh with Paged addressing (bf16 or int8 elements), each
// row's NP * ps tokens cut into units of `unit` tokens (whole pages) dealt
// round-robin to nsplit blocks that read in parallel and the last of them
// combines. A block reads table[b, tok / ps] itself (the counterpart of
// scalar prefetch) and walks only live tokens; entries past a row's live
// pages are never read.

#include "decode_split.cuh"

using gofr_split::Paged;

// Each returns a cudaError_t code: 0 when the launch was accepted.
// part [B, Hkv, nsplit, H / Hkv, dh + 2] f32 scratch and counters [>= B * Hkv]
// int32 zeros are read only when nsplit > 1 (decode_split.cuh).
extern "C" int gofr_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                    const void* table, const void* lengths, void* o,
                                    void* part, void* counters, int B, int H, int Hkv,
                                    int dh, int P, int ps, int NP, int unit, int nsplit,
                                    float scale, void* stream) {
  if (ps <= 0 || NP <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const Paged addr{static_cast<const int*>(table), static_cast<const int*>(lengths),
                   Hkv, dh, P, ps, NP};
  return gofr_split::dispatch<gofr_split::KvBf16>(H, q, k_pool, v_pool, nullptr, nullptr,
                                                  addr, o, part, counters, B, unit,
                                                  nsplit, scale, stream);
}

extern "C" int gofr_paged_attention_q8(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scale, const void* v_scale,
                                       const void* table, const void* lengths, void* o,
                                       void* part, void* counters, int B, int H, int Hkv,
                                       int dh, int P, int ps, int NP, int unit, int nsplit,
                                       float scale, void* stream) {
  if (ps <= 0 || NP <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const Paged addr{static_cast<const int*>(table), static_cast<const int*>(lengths),
                   Hkv, dh, P, ps, NP};
  return gofr_split::dispatch<gofr_split::KvInt8>(H, q, k_pool, v_pool, k_scale, v_scale,
                                                  addr, o, part, counters, B, unit,
                                                  nsplit, scale, stream);
}
