// The bf16 T=1 decode read for Hopper (sm_90a), split over the context
// (flash-decoding) and combined inside the same launch: one query token per
// row, GQA, f32 softmax and accumulation, bf16 K/V in the JAX layout.
//
// Replaces: the Pallas bodies _paged_kernel (gofr_tpu/ops/paged_attention.py,
// quantized=False) and _decode_kernel (gofr_tpu/ops/decode_attention.py,
// without scales): one online softmax under two addressing schemes.
// Instantiated for Paged addressing (pools [P, Hkv, dh, ps], table [B, NP])
// by paged_attention.cu and for Dense addressing (caches [B, Hkv, dh, S]) by
// decode_attention.cu; q and o are [B, H, dh] bf16, lengths [B] int32. The
// int8 reads keep decode_read.cuh, whose Paged / Dense structs this header
// shares.
//
// What bounds it on an H100: bytes. A row must read the K and V of its live
// tokens once, len * Hkv * dh * 2 * 2 bytes, over 3.35 TB/s; the operations
// (~4 * H * dh per token) are two orders below the tensor-core bound and one
// below the CUDA cores' f32 rate.
//
// Design:
// - grid (Hkv, B, nsplit). The wrapper cuts each row's capacity (NP * ps
//   paged, S dense) into units of `unit` tokens, a whole number of 64-token
//   tiles (and of pages), and block s of a row takes units s, s + nsplit,
//   s + 2 nsplit, ...; nsplit is chosen on the host from B, Hkv and the
//   capacity so that B * Hkv * nsplit is about two waves of 132 SMs. The
//   units are dealt round-robin, not cut into nsplit contiguous spans,
//   because the host does not know the live lengths: a paged table is as
//   wide as the next power of two above its longest row, so contiguous
//   spans left up to half the blocks of a long row idle and the others
//   twice the work. A block whose first unit starts at or past its row's
//   live length returns at once; block 0 of a row always runs (a row of
//   length 0 writes zeros).
// - K and V tiles of 64 tokens x dh are copied global -> shared with 16-byte
//   cp.async.cg into two stages: tiles 0 and 1 are in flight before q is
//   read, and once every warp is done with tile j its stage takes tile
//   j + 2, so the next tile is always in flight while one is computed (a
//   block of two tiles waits for one copy latency, not two). The loader
//   also records which of the tile's tokens are live and readable, a mask
//   per stage that the score pass reads. A run of 8 tokens is one 16-byte
//   copy of one d row (a paged slab and a dense row are token-contiguous);
//   a run that reaches past the live length copies only its live bytes and
//   the copy zero-fills the rest; a run that is not 16-byte aligned (a dense
//   S that is not a multiple of 8) or that crosses a page (ps not a multiple
//   of 8) is loaded element by element. Table entries past a row's live
//   pages are never read, and a page id outside [0, P) is a masked token,
//   read as zeros. Each 16-byte chunk of a [dh][64] tile sits at chunk
//   index c ^ (d & 7), so the reads below are free of bank conflicts.
// - each warp owns 16 tokens of every tile and keeps its own online softmax
//   (m, l, acc) over them, so the tile's arithmetic needs no block
//   barrier. Scores: lane (p, c) sums q . k for tokens 2p, 2p + 1 over
//   d = 8i + 2c, 8i + 2c + 1 (bf16 pairs), and two shuffles add the four
//   d classes; every K element is read once for all G heads of its kv head.
//   The warp max takes three shuffles; p = exp(s - m) stays f32 and goes
//   through a warp-private row of shared memory. p . v: lane l owns
//   d = l + 32k and reads the warp's 16 tokens of each V row as two 16-byte
//   chunks, so the tile's tokens are spread over the four warps.
// - after its last tile the block merges its four warps with the online
//   softmax's rescaling (exp(m_w - m)). With one live block the row writes
//   o = acc / max(l, 1e-30) in bf16. Otherwise it writes its (acc[G][dh], m,
//   l) to the wrapper's scratch [B, Hkv, nsplit, G, dh + 2], fences, and
//   takes a ticket from the per-(row, kv head) counter; the block holding
//   the last ticket merges the live blocks the same way (one warp per head
//   for the weights, every thread's partial loads in flight together),
//   writes o and sets the counter back to 0. No second kernel: a decode
//   step launches one read per layer, as before. The counters must not be
//   shared by reads in flight at the same time (the wrapper keys them by
//   device and stream).
// - the arithmetic is the old kernel's: s = (q . k) * scale, masked tokens
//   never contribute, p in f32, zeros at length 0, lengths clamped to
//   NP * ps (paged) and S (dense); only the order of the sums differs.
//
// ptxas (sm_90a, -O3, CUDA 12.8; the report lands in
// build/torch_kernels/lib*.log): 86-167 registers over the 16
// instantiations (dh 64 / 128, G 1 / 2 / 4 / 8, paged and dense; 128-139 at
// dh=128, G=4, Llama-3-8B's), 0 spill bytes, under __launch_bounds__(128,
// 3). Shared memory, dynamic: 4 * 64 * dh bf16 tiles + G * dh f32 q +
// 4 * G * 16 f32 p + 2 * 8 mask bytes = 71696 bytes at dh=128, G=8 and
// 68624 at G=4, so three blocks fit on an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "decode_read.cuh"

namespace gofr_split {

using gofr_decode::Dense;
using gofr_decode::kMask;
using gofr_decode::Paged;
typedef __nv_bfloat16 bf16;

constexpr int NT = 128;              // threads per block
constexpr int NWARP = NT / 32;
constexpr int TK = 64;               // tokens per tile
constexpr int WT = TK / NWARP;       // tokens per warp per tile
constexpr int CH = TK / 8;           // 16-byte chunks per tile row
constexpr int MAX_SPLIT = 64;        // blocks per row (the combine's weights)

using gofr_cp::cp_async16;
using gofr_cp::cp_async_commit;
using gofr_cp::cp_async_wait;
using gofr_cp::smem_addr;

// element offset of (row d, 16-byte chunk c) in a swizzled [dh][TK] tile
__device__ __forceinline__ int swz(int d, int c) {
  return d * TK + ((c ^ (d & 7)) << 3);
}

// the two bf16 of a 32-bit word (low half first) as floats
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// element offset of k[.., d=0, tok] of row b, kv head hk when the n >= 1
// tokens [tok, tok + n) lie in one valid page; -1 when they cross a page or
// the page id is outside the pool
__device__ __forceinline__ long long run_offset(const Paged& a, int b, int hk,
                                                int tok, int n) {
  const int page = a.table[(size_t)b * a.NP + tok / a.ps];
  const int in = tok % a.ps;
  if (page < 0 || page >= a.P || in + n > a.ps) return -1;
  return ((long long)page * a.Hkv + hk) * a.dh * a.ps + in;
}

__device__ __forceinline__ long long run_offset(const Dense& a, int b, int hk,
                                                int tok, int) {
  return ((long long)b * a.Hkv + hk) * a.dh * a.S + tok;
}

// tokens [t0, t0 + TK) of row b, kv head hk into the swizzled K and V tiles,
// and mask[c] bit i set when token t0 + 8c + i is live and readable; tokens
// at or past `live` and unreadable tokens become zeros. Thread tid copies
// chunk tid % CH of rows tid / CH, tid / CH + NT / CH, ...
template <int DH, class Addr>
__device__ __forceinline__ void load_tile(bf16* Ks, bf16* Vs, uint8_t* mask,
                                          const bf16* k, const bf16* v,
                                          const Addr& a, int b, int hk, int t0,
                                          int live, int tid) {
  const int c = tid % CH;
  const int tok = t0 + c * 8;
  int n = live - tok;
  n = n < 0 ? 0 : (n > 8 ? 8 : n);
  const long long off = n > 0 ? run_offset(a, b, hk, tok, n) : -1;
  const size_t stride = a.stride();
  if (tid < CH) {
    uint32_t bits = 0;
#pragma unroll 1
    for (int i = 0; i < 8; ++i)
      if (i < n && (off >= 0 || run_offset(a, b, hk, tok + i, 1) >= 0)) bits |= 1u << i;
    mask[c] = (uint8_t)bits;
  }
#pragma unroll 4
  for (int d = tid / CH; d < DH; d += NT / CH) {
    bf16* dk = Ks + swz(d, c);
    bf16* dv = Vs + swz(d, c);
    if (n == 0) {
      cp_async16(smem_addr(dk), k, 0);
      cp_async16(smem_addr(dv), v, 0);
      continue;
    }
    if (off >= 0) {
      const bf16* gk = k + off + d * stride;
      const bf16* gv = v + off + d * stride;
      if (((reinterpret_cast<uintptr_t>(gk) | reinterpret_cast<uintptr_t>(gv)) & 15) == 0) {
        cp_async16(smem_addr(dk), gk, 2 * n);
        cp_async16(smem_addr(dv), gv, 2 * n);
        continue;
      }
    }
    // unaligned, crossing a page or holding an unreadable page: one token at
    // a time, unreadable tokens as zeros
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      const long long o = i < n ? run_offset(a, b, hk, tok + i, 1) : -1;
      dk[i] = o >= 0 ? k[o + d * stride] : __float2bfloat16(0.f);
      dv[i] = o >= 0 ? v[o + d * stride] : __float2bfloat16(0.f);
    }
  }
}

template <int DH, int G>
constexpr int smem_bytes() {
  return (int)sizeof(bf16) * 2 * 2 * DH * TK          // K, V x 2 stages
         + (int)sizeof(float) * (G * DH + NWARP * G * WT)    // q, p
         + 2 * CH;                                     // token masks x 2 stages
}

// at most 170 registers a thread, so three blocks fit on an SM as their
// shared memory does
template <int DH, int G, class Addr>
__global__ void __launch_bounds__(NT, 3)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const Addr a,
                    bf16* __restrict__ o, float* __restrict__ part,
                    int* __restrict__ counters, int unit, int nsplit,
                    float scale) {
  static_assert(DH % 32 == 0, "dh");
  constexpr int KD = DH / 32;        // d values per lane in p . v
  constexpr int PS = DH + 2;         // a partial's (acc[dh], m, l) per head

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);                 // [2][K, V][DH][TK]
  float* Qs = reinterpret_cast<float*>(tiles + 2 * 2 * DH * TK);   // [G][DH]
  float* Pw = Qs + G * DH;                                     // [NWARP][G][WT]
  uint8_t* masks = reinterpret_cast<uint8_t*>(Pw + NWARP * G * WT);  // [2][CH]

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int H = a.Hkv * G;
  const int live = a.live(b);
  if (split > 0 && split * unit >= live) return;   // nothing of this row here
  // units holding live tokens, blocks with any (block 0 always runs), and
  // this block's live units split, split + nsplit, ... and tiles: the tiles
  // of its units that start before `live`, in order
  const int units = (live + unit - 1) / unit;
  const int nlive = units < 1 ? 1 : (units < nsplit ? units : nsplit);
  const int n_units = units > split ? (units - split + nsplit - 1) / nsplit : 0;
  const int tpu = unit / TK;
  int n_tiles = 0;
  if (n_units > 0) {
    const int last = live - (split + (n_units - 1) * nsplit) * unit;
    n_tiles = (n_units - 1) * tpu + ((last + TK - 1) / TK < tpu ? (last + TK - 1) / TK : tpu);
  }
  auto tile_start = [=](int j) { return (split + j / tpu * nsplit) * unit + j % tpu * TK; };

  const bf16* qb = q + ((size_t)b * H + (size_t)hk * G) * DH;
  // lane (p, c): tokens 2p, 2p + 1 of the warp's 16; d class c of four
  const int p = lane & 7, dc = lane >> 3;
  const int tau = w * WT + 2 * p;               // tile-relative token
  float m[G], l[G], acc[G][KD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMask;
    l[g] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) acc[g][kk] = 0.f;
  }

  int next = 0;          // the next tile to copy; tile t goes to stage t & 1
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    // tiles j and j + 1 in flight: stage (j + 1) & 1 was freed by the
    // barrier that ended tile j - 1
#pragma unroll 1
    for (; next < n_tiles && next < j + 2; ++next) {
      bf16* buf = tiles + (next & 1) * 2 * DH * TK;
      load_tile<DH>(buf, buf + DH * TK, masks + (next & 1) * CH, k, v, a, b,
                    hk, tile_start(next), live, tid);
      cp_async_commit();
    }
    if (j == 0)          // q is read while the first tiles are in flight
      for (int i = tid; i < G * DH; i += NT) Qs[i] = __bfloat162float(qb[i]);
    if (next > j + 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();     // tile j (and q) landed for every thread
    const bf16* Kt = tiles + (j & 1) * 2 * DH * TK;
    const bf16* Vt = Kt + DH * TK;
    const uint32_t bits = masks[(j & 1) * CH + (tau >> 3)] >> (tau & 7);

    // s = q . k for the lane's two tokens, summed over its d class
    float s0v[G], s1v[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s0v[g] = s1v[g] = 0.f;
#pragma unroll 4
    for (int i = 0; i < DH / 8; ++i) {
      const int d = 8 * i + 2 * dc;
      const uint32_t k0 = *reinterpret_cast<const uint32_t*>(Kt + swz(d, tau >> 3) + (tau & 7));
      const uint32_t k1 = *reinterpret_cast<const uint32_t*>(Kt + swz(d + 1, tau >> 3) + (tau & 7));
      const float a0 = lo(k0), b0 = hi(k0), a1 = lo(k1), b1 = hi(k1);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float2 qq = *reinterpret_cast<const float2*>(Qs + g * DH + d);
        s0v[g] += qq.x * a0 + qq.y * a1;
        s1v[g] += qq.x * b0 + qq.y * b1;
      }
    }
    const bool v0 = bits & 1u, v1 = bits & 2u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s0v[g] += __shfl_xor_sync(0xffffffffu, s0v[g], 8);
      s0v[g] += __shfl_xor_sync(0xffffffffu, s0v[g], 16);
      s1v[g] += __shfl_xor_sync(0xffffffffu, s1v[g], 8);
      s1v[g] += __shfl_xor_sync(0xffffffffu, s1v[g], 16);
      const float x0 = v0 ? s0v[g] * scale : kMask;
      const float x1 = v1 ? s1v[g] * scale : kMask;
      float mx = fmaxf(x0, x1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      const float p0 = v0 ? expf(x0 - m_new) : 0.f;
      const float p1 = v1 ? expf(x1 - m_new) : 0.f;
      l[g] = l[g] * alpha + p0 + p1;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) acc[g][kk] *= alpha;
      if (dc == 0)
        *reinterpret_cast<float2*>(Pw + (w * G + g) * WT + 2 * p) = make_float2(p0, p1);
    }
    __syncwarp();

    // acc += p . v over the warp's 16 tokens, 8 at a time
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float vf[KD][8];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint4 raw = *reinterpret_cast<const uint4*>(Vt + swz(lane + 32 * kk, 2 * w + h));
        vf[kk][0] = lo(raw.x); vf[kk][1] = hi(raw.x);
        vf[kk][2] = lo(raw.y); vf[kk][3] = hi(raw.y);
        vf[kk][4] = lo(raw.z); vf[kk][5] = hi(raw.z);
        vf[kk][6] = lo(raw.w); vf[kk][7] = hi(raw.w);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 pa = *reinterpret_cast<const float4*>(Pw + (w * G + g) * WT + 8 * h);
        const float4 pb = *reinterpret_cast<const float4*>(Pw + (w * G + g) * WT + 8 * h + 4);
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          acc[g][kk] += pa.x * vf[kk][0] + pa.y * vf[kk][1] + pa.z * vf[kk][2] +
                        pa.w * vf[kk][3] + pb.x * vf[kk][4] + pb.y * vf[kk][5] +
                        pb.z * vf[kk][6] + pb.w * vf[kk][7];
      }
    }
    if (next < n_tiles) __syncthreads();   // every warp is done with this stage
  }

  // merge the four warps: (m, l, acc) of warp w at wst[w][g][0..DH+1]
  __syncthreads();       // the tile buffers are free (no copy in flight)
  float* wst = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lt = l[g];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    float* row = wst + (w * G + g) * PS;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) row[lane + 32 * kk] = acc[g][kk];
    if (lane == 0) {
      row[DH] = m[g];
      row[DH + 1] = lt;
    }
  }
  __syncthreads();

  const size_t bh = (size_t)b * a.Hkv + hk;
  bf16* ob = o + ((size_t)b * H + (size_t)hk * G) * DH;
  float* mine = part + (bh * nsplit + split) * G * PS;
  for (int e = tid; e < G * DH; e += NT) {
    const int g = e / DH, d = e % DH;
    float M = kMask;
#pragma unroll
    for (int ww = 0; ww < NWARP; ++ww) M = fmaxf(M, wst[(ww * G + g) * PS + DH]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int ww = 0; ww < NWARP; ++ww) {
      const float* row = wst + (ww * G + g) * PS;
      const float f = expf(row[DH] - M);
      L += f * row[DH + 1];
      A += f * row[d];
    }
    if (nlive == 1) {
      ob[e] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    } else {
      mine[g * PS + d] = A;
      if (d == 0) {
        mine[g * PS + DH] = M;
        mine[g * PS + DH + 1] = L;
      }
    }
  }
  if (nlive == 1) return;

  // the last live block of (b, hk) to finish merges them all
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + bh, 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  const float* rows = part + bh * nsplit * G * PS;
  float* ws = wst;                   // [MAX_SPLIT][G] m, then weights
  float* ls = wst + MAX_SPLIT * G;   // [MAX_SPLIT][G] l
  float* Ls = ls + MAX_SPLIT * G;    // [G] merged l
  for (int i = tid; i < nlive * G; i += NT) {
    const float* r = rows + (size_t)(i / G) * G * PS + (i % G) * PS;
    ws[i] = __ldcg(r + DH);
    ls[i] = __ldcg(r + DH + 1);
  }
  __syncthreads();
  // warp w merges the (m, l) of heads w, w + NWARP, ... over lanes s
  for (int g = w; g < G; g += NWARP) {
    float M = kMask;
    for (int s = lane; s < nlive; s += 32) M = fmaxf(M, ws[s * G + g]);
    M = gofr_decode::warp_max(M);
    float L = 0.f;
    for (int s = lane; s < nlive; s += 32) {
      const float f = expf(ws[s * G + g] - M);
      ws[s * G + g] = f;
      L += f * ls[s * G + g];
    }
    L = gofr_decode::warp_sum(L);
    if (lane == 0) Ls[g] = L;
  }
  __syncthreads();
  constexpr int OUT = (G * DH + NT - 1) / NT;   // outputs per thread
  float A[OUT];
#pragma unroll
  for (int r = 0; r < OUT; ++r) A[r] = 0.f;
#pragma unroll 4
  for (int s = 0; s < nlive; ++s) {
    const float* rs = rows + (size_t)s * G * PS;
#pragma unroll
    for (int r = 0; r < OUT; ++r) {
      const int e = tid + r * NT;
      if (e < G * DH) A[r] += ws[s * G + e / DH] * __ldcg(rs + (e / DH) * PS + e % DH);
    }
  }
#pragma unroll
  for (int r = 0; r < OUT; ++r) {
    const int e = tid + r * NT;
    if (e < G * DH) ob[e] = __float2bfloat16(A[r] / fmaxf(Ls[e / DH], 1e-30f));
  }
  if (tid == 0) atomicExch(counters + bh, 0);
}

template <int DH, int G, class Addr>
int launch(const void* q, const void* k, const void* v, const Addr& a, void* o,
           void* part, void* counters, int B, int unit, int nsplit, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH, G>();
  static_assert(smem <= 232448, "shared memory");
  static_assert(NWARP * G * (DH + 2) <= 2 * 2 * DH * TK / 2, "merge area");
  static_assert(2 * MAX_SPLIT * G + G <= 2 * 2 * DH * TK / 2, "combine area");
  // above 48 KB a kernel must opt in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(decode_split_kernel<DH, G, Addr>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in[dev] = true;
  }
  const dim3 grid(a.Hkv, B, nsplit);
  decode_split_kernel<DH, G, Addr><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), a, static_cast<bf16*>(o),
      static_cast<float*>(part), static_cast<int*>(counters), unit, nsplit,
      scale);
  return (int)cudaGetLastError();
}

template <int DH, class Addr>
int launch_g(int G, const void* q, const void* k, const void* v, const Addr& a,
             void* o, void* part, void* counters, int B, int unit, int nsplit,
             float scale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<DH, 1>(q, k, v, a, o, part, counters, B, unit, nsplit, scale, st);
    case 2: return launch<DH, 2>(q, k, v, a, o, part, counters, B, unit, nsplit, scale, st);
    case 4: return launch<DH, 4>(q, k, v, a, o, part, counters, B, unit, nsplit, scale, st);
    case 8: return launch<DH, 8>(q, k, v, a, o, part, counters, B, unit, nsplit, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch the split read on `stream`; returns a cudaError_t code, 0 when the
// launch was accepted. part: [B, Hkv, nsplit, G, dh + 2] f32 scratch and
// counters: [>= B * Hkv] int32, all 0, each needed only when nsplit > 1.
template <class Addr>
int dispatch(int H, const void* q, const void* k, const void* v, const Addr& a,
             void* o, void* part, void* counters, int B, int unit, int nsplit,
             float scale, void* stream) {
  if (B <= 0 || a.Hkv <= 0 || H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if (unit <= 0 || unit % TK != 0 || nsplit < 1 || nsplit > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / a.Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.dh == 128) return launch_g<128>(G, q, k, v, a, o, part, counters, B, unit, nsplit, scale, st);
  if (a.dh == 64) return launch_g<64>(G, q, k, v, a, o, part, counters, B, unit, nsplit, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gofr_split
