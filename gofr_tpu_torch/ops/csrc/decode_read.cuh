// The int8 T=1 decode read for Hopper (sm_90a), shared by the paged and the
// dense KV caches: int8 K/V with per-token f32 scales, one query token per
// row, GQA, f32 accumulation. The bf16 reads run decode_split.cuh, which
// shares this header's Paged / Dense addressing.
//
// Two instantiations (paged_attention.cu gofr_paged_attention_q8,
// decode_attention.cu gofr_decode_attention_q8):
//   Paged  addressing: pools [P, Hkv, dh, ps], table [B, NP] int32 page ids,
//                      scales [P, Hkv, ps];
//   Dense  addressing: caches [B, Hkv, dh, S] (one row per slot), scales
//                      [B, Hkv, S].
// q and o are [B, H, dh] bf16; lengths [B] int32 live tokens per row. The
// layouts are the JAX ones (token index minor), kept so the port's caches
// compare one to one with the reference.
//
// Replaces the Pallas bodies _paged_kernel (gofr_tpu/ops/paged_attention.py)
// and _decode_kernel (gofr_tpu/ops/decode_attention.py) with quantized=True /
// scales: one online softmax under two addressing schemes.
//
// What bounds it on an H100: bytes. Each row must read the K and V of its live
// tokens once with their two scales: len * Hkv * (dh * 2 + 2 * 4) bytes over
// 3.35 TB/s; the operations (~4 * H * len * dh per row) are two orders below
// the int8 bound. What the design does about it: a block reads only its row's
// live tokens (the table lookup is the block's own, the counterpart of scalar
// prefetch), each K/V element is read once for all G query heads that share
// the kv head, and neighbouring threads read neighbouring addresses (thread t
// reads k[.., d, t]; a warp reads 32 contiguous bytes per d). The int8 bytes
// are what cross device memory: dequantization is folded into the arithmetic
// and never materialised. Not done here (decode_split.cuh does it for bf16):
// splitting one row's context over several blocks, 16-byte asynchronous
// loads; B * Hkv blocks must fill the card's 132 SMs by themselves.
//
// Design: one block of 128 threads per (kv head, row). The row's live tokens
// are walked in chunks of 128, thread t taking token t of the chunk. Thread t
// computes the G scores of its token against the G query heads held in shared
// memory and stages its token's v column in shared memory; block-wide max and
// sum reductions carry the online softmax (m, l) across chunks; then thread d
// (< dh) sums p[g][t] * v[d][t] over the chunk's tokens for each of the G
// heads. The scales fold in the Pallas order: s = (q . k8) * scale *
// k_scale[tok]; the max and p = exp(s - m) follow; l sums p BEFORE the v
// scale; only then p *= v_scale[tok] and acc += p . v8. Tokens at or past a
// row's length are never read: a paged row's length is clamped to NP * ps
// (the addressable pages) and a dense row's to S, as the Pallas grids cover
// only those. A row of length 0 returns zeros, as the Pallas kernels do.
// Page ids outside [0, P) are treated as masked tokens rather than read.
// (The template still compiles for bf16 elements; nothing instantiates it.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gofr_decode {

constexpr int NT = 128;              // threads per block == tokens per chunk
constexpr int NW = NT / 32;
constexpr float kMask = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) { x = __float2bfloat16(0.f); }
__device__ __forceinline__ void set_zero(int8_t& x) { x = 0; }

// Pools [P, Hkv, dh, ps] read through table [B, NP]; scales [P, Hkv, ps].
struct Paged {
  const int* table;
  const int* lengths;
  int Hkv, dh, P, ps, NP;

  __device__ int live(int b) const {
    const int n = lengths[b];
    const int cap = NP * ps;
    return n < 0 ? 0 : (n < cap ? n : cap);
  }
  __device__ size_t stride() const { return (size_t)ps; }
  // element offset of k[.., d=0, tok] and scale offset of token `tok` of row
  // b, kv head hk; false when its page id is outside the pool
  __device__ bool locate(int b, int hk, int tok, size_t* off, size_t* soff) const {
    const int page = table[(size_t)b * NP + tok / ps];
    if (page < 0 || page >= P) return false;
    const size_t slot = (size_t)page * Hkv + hk;
    *soff = slot * ps + tok % ps;
    *off = slot * dh * ps + tok % ps;
    return true;
  }
};

// Caches [B, Hkv, dh, S]; scales [B, Hkv, S].
struct Dense {
  const int* lengths;
  int Hkv, dh, S;

  __device__ int live(int b) const {
    const int n = lengths[b];
    return n < 0 ? 0 : (n < S ? n : S);
  }
  __device__ size_t stride() const { return (size_t)S; }
  __device__ bool locate(int b, int hk, int tok, size_t* off, size_t* soff) const {
    const size_t slot = (size_t)b * Hkv + hk;
    *soff = slot * S + tok;
    *off = slot * dh * S + tok;
    return true;
  }
};

template <int DH, int G, typename T, class Addr>
__global__ void __launch_bounds__(NT)
decode_read_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const Addr addr,
                   __nv_bfloat16* __restrict__ o, float scale) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  // padded so thread d's row reads (d * VSTR + j) fall in 32 distinct banks
  constexpr int VSTR = kQuant ? NT + 4 : NT + 2;
  __shared__ float Qs[G][DH];
  __shared__ __align__(16) T Vs[DH][VSTR];
  __shared__ float Ps[G][NT];
  __shared__ float red[G][NW];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int H = addr.Hkv * G;

  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)hk * G) * DH;
  for (int i = t; i < G * DH; i += NT) Qs[i / DH][i % DH] = __bfloat162float(qb[i]);

  const int live = addr.live(b);
  const size_t stride = addr.stride();
  float m[G], l[G], acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) { m[g] = kMask; l[g] = 0.f; acc[g] = 0.f; }
  __syncthreads();

  for (int c0 = 0; c0 < live; c0 += NT) {
    const int tok = c0 + t;
    size_t off = 0, soff = 0;
    const bool valid = tok < live && addr.locate(b, hk, tok, &off, &soff);
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    float ksc = 1.f, vsc = 1.f;
    if (valid) {
      const T* kc = k + off;
      const T* vc = v + off;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kd = to_float(kc[(size_t)d * stride]);
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] += Qs[g][d] * kd;
      }
#pragma unroll 8
      for (int d = 0; d < DH; ++d) Vs[d][t] = vc[(size_t)d * stride];
      if constexpr (kQuant) {
        ksc = k_scale[soff];
        vsc = v_scale[soff];
      }
    } else {
      for (int d = 0; d < DH; ++d) set_zero(Vs[d][t]);
    }

    // block max per head; the k scale multiplies the score after q . k
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float x = s[g] * scale;
      if constexpr (kQuant) x *= ksc;
      sc[g] = valid ? x : kMask;
      const float w = warp_max(sc[g]);
      if (lane == 0) red[g][warp] = w;
    }
    __syncthreads();
    float m_new[G], alpha[G], p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = red[g][0];
#pragma unroll
      for (int w = 1; w < NW; ++w) mx = fmaxf(mx, red[g][w]);
      m_new[g] = fmaxf(m[g], mx);
      p[g] = valid ? expf(sc[g] - m_new[g]) : 0.f;
      alpha[g] = expf(m[g] - m_new[g]);
    }
    __syncthreads();   // every thread has read red before it is reused
    // l sums p before the v scale; the v scale then folds into p
#pragma unroll
    for (int g = 0; g < G; ++g) {
      Ps[g][t] = kQuant ? p[g] * vsc : p[g];
      const float w = warp_sum(p[g]);
      if (lane == 0) red[g][warp] = w;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += red[g][w];
      l[g] = l[g] * alpha[g] + sum;
      m[g] = m_new[g];
    }

    // p . v: thread d reduces over the chunk's tokens
    if (t < DH) {
      const int n = live - c0 < NT ? live - c0 : NT;
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] *= alpha[g];
      for (int j = 0; j < n; ++j) {
        const float vd = to_float(Vs[t][j]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += Ps[g][j] * vd;
      }
    }
    __syncthreads();   // Vs, Ps and red are rewritten by the next chunk
  }

  if (t < DH) {
    __nv_bfloat16* ob = o + ((size_t)b * H + (size_t)hk * G) * DH;
#pragma unroll
    for (int g = 0; g < G; ++g)
      ob[(size_t)g * DH + t] = __float2bfloat16(acc[g] / fmaxf(l[g], 1e-30f));
  }
}

template <int DH, int G, typename T, class Addr>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const Addr& addr, void* o, int B, float scale, cudaStream_t stream) {
  const dim3 grid(addr.Hkv, B);
  decode_read_kernel<DH, G, T, Addr><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), addr, static_cast<__nv_bfloat16*>(o), scale);
  return (int)cudaGetLastError();
}

template <int DH, typename T, class Addr>
int launch_g(int G, const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const Addr& addr, void* o, int B, float scale,
             cudaStream_t st) {
  switch (G) {
    case 1: return launch<DH, 1, T>(q, k, v, ks, vs, addr, o, B, scale, st);
    case 2: return launch<DH, 2, T>(q, k, v, ks, vs, addr, o, B, scale, st);
    case 4: return launch<DH, 4, T>(q, k, v, ks, vs, addr, o, B, scale, st);
    case 8: return launch<DH, 8, T>(q, k, v, ks, vs, addr, o, B, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch the read on `stream`; returns a cudaError_t code, 0 when the launch
// was accepted. ks / vs are null for bf16 elements.
template <typename T, class Addr>
int dispatch(int H, const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const Addr& addr, void* o, int B, float scale,
             void* stream) {
  if (B <= 0 || addr.Hkv <= 0 || H % addr.Hkv != 0) return (int)cudaErrorInvalidValue;
  if (std::is_same<T, int8_t>::value && (ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / addr.Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (addr.dh == 128) return launch_g<128, T>(G, q, k, v, ks, vs, addr, o, B, scale, st);
  if (addr.dh == 64) return launch_g<64, T>(G, q, k, v, ks, vs, addr, o, B, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gofr_decode
