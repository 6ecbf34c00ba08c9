// Paged decode attention for Hopper (sm_90a): one query token per row,
// GQA, read through a block table, bf16 pools, f32 accumulation.
//
// Replaces: gofr_tpu/ops/paged_attention.py, paged_attention ->
// _paged_kernel with quantized=False (the Pallas scalar-prefetch kernel).
//
// Layout (kept from the JAX pool so the port's pools compare one to one):
// q, o [B, H, dh]; k_pool, v_pool [P, Hkv, dh, ps] (token index minor);
// table [B, NP] int32 page ids; lengths [B] int32 live tokens per row.
//
// What bounds it on an H100: bytes. Each row must read the K and V of its
// live tokens once, sum_b len_b * Hkv * dh * 2 * 2 bytes (the ragged tail
// of the last page is not needed), over 3.35 TB/s;
// the operations (~4 * B * H * len * dh) are two orders below the FLOP
// bound. What the design does about it: a block reads only the pages of its
// row's live tokens (the table lookup is the block's own, the counterpart
// of scalar prefetch), each K/V byte is read once for all G query heads that
// share the kv head, and neighbouring threads read neighbouring addresses
// (thread t reads k[page, h, :, t]). Not yet done: splitting one row's
// context over several blocks (flash-decoding), so B * Hkv blocks must fill
// the card's 132 SMs by themselves.
//
// Design: one block of 128 threads per (kv head, row). The row's live
// tokens are walked in chunks of 128, thread t taking token t of the chunk
// (its page is table[b, tok / ps], its offset tok % ps). Thread t computes
// the G scores of its token against the G query heads held in shared
// memory and stages its token's v column in shared memory; block-wide max
// and sum reductions carry the online softmax (m, l) across chunks; then
// thread d (< dh) sums p[g][t] * v[d][t] over the chunk's tokens t for each
// of the G heads. Tokens at or past lengths[b] (the ragged last page, table
// columns past the live pages) are never read. A row of length 0 returns
// zeros, as the Pallas kernel does (its reference returns the mean of v).
// Page ids outside [0, P) are treated as masked tokens rather than read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int DH, int G>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ o,
                    int Hkv, int P, int ps, int NP, float scale) {
  constexpr int VSTR = NT + 2;       // padded so thread d's row reads miss each other's banks
  __shared__ float Qs[G][DH];
  __shared__ __align__(16) __nv_bfloat16 Vs[DH][VSTR];
  __shared__ float Ps[G][NT];
  __shared__ float red[G][NW];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int H = Hkv * G;

  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)hk * G) * DH;
  for (int i = t; i < G * DH; i += NT) Qs[i / DH][i % DH] = __bfloat162float(qb[i]);

  // live tokens, clamped to the table's width (a row's position may run
  // past its table in lock-step decode; only NP pages are addressable)
  int live = lengths[b];
  live = live < 0 ? 0 : live;
  live = live < NP * ps ? live : NP * ps;

  float m[G], l[G], acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) { m[g] = kMask; l[g] = 0.f; acc[g] = 0.f; }
  __syncthreads();

  const size_t page_stride = (size_t)Hkv * DH * ps;
  for (int c0 = 0; c0 < live; c0 += NT) {
    const int tok = c0 + t;
    bool valid = tok < live;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const int page = table[(size_t)b * NP + tok / ps];
      valid = page >= 0 && page < P;
      if (valid) {
        const size_t base = (size_t)page * page_stride + (size_t)hk * DH * ps + tok % ps;
        const __nv_bfloat16* kc = k_pool + base;
        const __nv_bfloat16* vc = v_pool + base;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          const float kd = __bfloat162float(kc[(size_t)d * ps]);
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += Qs[g][d] * kd;
        }
#pragma unroll 8
        for (int d = 0; d < DH; ++d) Vs[d][t] = vc[(size_t)d * ps];
      }
    }
    if (!valid) {
      for (int d = 0; d < DH; ++d) Vs[d][t] = __float2bfloat16(0.f);
    }

    // block max per head
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sc[g] = valid ? s[g] * scale : kMask;
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
#pragma unroll
    for (int g = 0; g < G; ++g) {
      Ps[g][t] = p[g];
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
        const float vd = __bfloat162float(Vs[t][j]);
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

template <int DH, int G>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, void* o, int B, int Hkv, int P, int ps, int NP,
           float scale, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  paged_decode_kernel<DH, G><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), table, lengths,
      static_cast<__nv_bfloat16*>(o), Hkv, P, ps, NP, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_g(int G, const void* q, const void* kp, const void* vp, const int* table,
             const int* lengths, void* o, int B, int Hkv, int P, int ps, int NP,
             float scale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<DH, 1>(q, kp, vp, table, lengths, o, B, Hkv, P, ps, NP, scale, st);
    case 2: return launch<DH, 2>(q, kp, vp, table, lengths, o, B, Hkv, P, ps, NP, scale, st);
    case 4: return launch<DH, 4>(q, kp, vp, table, lengths, o, B, Hkv, P, ps, NP, scale, st);
    case 8: return launch<DH, 8>(q, kp, vp, table, lengths, o, B, Hkv, P, ps, NP, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int gofr_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                    const void* table, const void* lengths, void* o,
                                    int B, int H, int Hkv, int dh, int P, int ps, int NP,
                                    float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || ps <= 0 || NP <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128) return launch_g<128>(G, q, k_pool, v_pool, tb, ln, o, B, Hkv, P, ps, NP, scale, st);
  if (dh == 64) return launch_g<64>(G, q, k_pool, v_pool, tb, ln, o, B, Hkv, P, ps, NP, scale, st);
  return (int)cudaErrorInvalidValue;
}
