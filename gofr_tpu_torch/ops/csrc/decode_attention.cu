// Dense decode attention for Hopper (sm_90a): one query token per row, GQA,
// over a per-slot cache, masked by per-row lengths, from bf16 caches or from
// int8 caches with per-token f32 scales.
//
// Replaces: gofr_tpu/ops/decode_attention.py, decode_attention ->
// _decode_kernel, without scales (gofr_decode_attention) and with them
// (gofr_decode_attention_q8).
//
// Layout (the JAX cache's, so the port's caches compare one to one):
// q, o [B, H, dh] bf16; k_cache, v_cache [B, Hkv, dh, S] (token index minor),
// bf16 or int8; k_scale, v_scale [B, Hkv, S] f32; lengths [B] int32.
//
// Both: decode_split.cuh with Dense addressing (bf16 or int8 elements, the
// int8 dequantization folded into the read), each row's S tokens cut into
// units of `unit` tokens dealt round-robin to nsplit blocks that read in
// parallel and the last of them combines. A row's length is clamped to S,
// as the Pallas grid covers only S / block_s blocks: in lock-step decode a
// row that finished and was not reused keeps advancing past the cache. The
// Pallas kernel needs S % block_s == 0; this one takes any S >= 1.

#include "decode_split.cuh"

using gofr_split::Dense;

// Each returns a cudaError_t code: 0 when the launch was accepted.
// part [B, Hkv, nsplit, H / Hkv, dh + 2] f32 scratch and counters [>= B * Hkv]
// int32 zeros are read only when nsplit > 1 (decode_split.cuh); launches is
// the kernel's uint64 launch counter (ops/launch_counts.py).
extern "C" int gofr_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                     const void* lengths, void* o, void* part,
                                     void* counters, void* launches, int B, int H,
                                     int Hkv, int dh, int S, int unit, int nsplit,
                                     float scale, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const Dense addr{static_cast<const int*>(lengths), Hkv, dh, S};
  return gofr_split::dispatch<gofr_split::KvBf16>(H, q, k_cache, v_cache, nullptr, nullptr,
                                                  addr, o, part, counters, launches, B, unit,
                                                  nsplit, scale, stream);
}

extern "C" int gofr_decode_attention_q8(const void* q, const void* k_cache,
                                        const void* v_cache, const void* k_scale,
                                        const void* v_scale, const void* lengths, void* o,
                                        void* part, void* counters, void* launches,
                                        int B, int H, int Hkv, int dh, int S, int unit,
                                        int nsplit, float scale, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const Dense addr{static_cast<const int*>(lengths), Hkv, dh, S};
  return gofr_split::dispatch<gofr_split::KvInt8>(H, q, k_cache, v_cache, k_scale, v_scale,
                                                  addr, o, part, counters, launches, B, unit,
                                                  nsplit, scale, stream);
}
