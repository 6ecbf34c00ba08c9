// The T=1 decode read for Hopper (sm_90a), split over the context
// (flash-decoding) and combined inside the same launch: one query token per
// row, GQA, f32 softmax and accumulation, K/V in the JAX layout as bf16, or
// as int8 with per-token f32 scales.
//
// Replaces: the Pallas bodies _paged_kernel (gofr_tpu/ops/paged_attention.py,
// quantized=False and True) and _decode_kernel (gofr_tpu/ops/
// decode_attention.py, without and with scales): one online softmax under two
// addressing schemes and two element types. Instantiated for Paged
// addressing (pools [P, Hkv, dh, ps], table [B, NP], scale pools
// [P, Hkv, ps]) by paged_attention.cu and for Dense addressing (caches
// [B, Hkv, dh, S], scales [B, Hkv, S]) by decode_attention.cu, each for
// KvBf16 and KvInt8 elements; q and o are [B, H, dh] bf16, lengths [B]
// int32.
//
// What bounds it on an H100: bytes. A row must read the K and V of its live
// tokens once, len * Hkv * dh * 2 * 2 bytes in bf16, len * Hkv * (dh * 2 +
// 2 * 4) in int8 with the scales, over 3.35 TB/s; the operations (~4 * H * dh
// per token) are two orders below the tensor-core bound. int8 halves the
// bytes but not the work per element, so there the arithmetic must stay
// cheap: an int8 -> f32 conversion by I2F issues at a quarter or less of the
// FMA rate, and I2F plus the FMAs would take longer than the bytes.
//
// Design:
// - grid (Hkv, B, nsplit). The wrapper cuts each row's capacity (NP * ps
//   paged, S dense) into units of `unit` tokens, a whole number of tiles
//   (and of pages), and block s of a row takes units s, s + nsplit,
//   s + 2 nsplit, ...; nsplit is chosen on the host from B, Hkv and the
//   capacity so that B * Hkv * nsplit is about two waves of 132 SMs. The
//   units are dealt round-robin, not cut into nsplit contiguous spans,
//   because the host does not know the live lengths: a paged table is as
//   wide as the next power of two above its longest row, so contiguous
//   spans left up to half the blocks of a long row idle and the others
//   twice the work. A block whose first unit starts at or past its row's
//   live length returns at once; block 0 of a row always runs (a row of
//   length 0 writes zeros).
// - a tile is E::TK tokens x dh, one 128-byte line per d row: 64 bf16
//   tokens, 128 int8 tokens (a 64-token int8 tile moved half lines and paid
//   the per-tile softmax, barriers and waits for half the tokens: 0.13 ms
//   against 0.10 at B=8 x 8192 on an H100). K and V tiles are copied global
//   -> shared with 16-byte cp.async.cg into two stages: tiles 0 and 1 are in
//   flight before q is read, and once every warp is done with tile j its
//   stage takes tile j + 2, so the next tile is always in flight while one
//   is computed. An int8 stage also holds the tile's 128 k and 128 v scales,
//   copied in 4-token 16-byte chunks in the same commit group. The loader
//   records which of the tile's tokens are live and readable, a mask per
//   stage that the score pass reads. A 16-byte run (8 bf16 or 16 int8
//   tokens of one d row; a paged slab, a dense row and the scale rows are
//   token-contiguous) is one copy when it lies in one valid page and is
//   16-byte aligned; a run that reaches past the live length copies only
//   its live bytes and the copy zero-fills the rest; a run that is not
//   aligned (a dense S that is not a multiple of 8 bf16 / 16 int8 / 4 scale
//   tokens) or that crosses a page is loaded element by element. Table
//   entries past a row's live pages are never read, and a page id outside
//   [0, P) is a masked token, read as zeros. Chunk c of row d sits at
//   c ^ (d & 7), so the reads below are free of bank conflicts.
// - each warp owns TK / 4 tokens of every tile and keeps its own online
//   softmax (m, l, acc) over them, so the tile's arithmetic needs no block
//   barrier. Scores: lane (p, c) sums q . k for the TPL tokens of one 32-bit
//   word (2 bf16, 4 int8) from TPL p over d = 8i + 2c, 8i + 2c + 1, and two
//   shuffles add the four d classes; every K element is read once for all
//   G heads of its kv head. The warp max takes three shuffles; p = exp(s -
//   m) stays f32 and goes through a warp-private row of shared memory; a
//   masked token's score is s + kMask = kMask and its p is multiplied by 0
//   (float masks, no predicates). p . v: lane l owns d = l + 32k and reads
//   the warp's tokens of each V row as two 16-byte chunks, so the tile's
//   tokens are spread over the four warps.
// - int8 -> f32 without I2F (i8x4): XOR 0x80 makes a byte x + 128 unsigned;
//   a byte permute puts it under the exponent byte 0x4B, which is the float
//   2^23 + x + 128; one subtract of 2^23 + 128 leaves x, exact for every
//   int8. A byte permute and an FADD per element, not the quarter-rate I2F.
//   The int8 read takes exp as ex2.approx.ftz (exp_); bf16 keeps expf.
// - after its last tile the block merges its four warps with the online
//   softmax's rescaling (exp(m_w - m)). With one live block the row writes
//   o = acc / max(l, 1e-30) in bf16. Otherwise it writes its (acc[G][dh], m,
//   l) to the wrapper's scratch [B, Hkv, nsplit, G, dh + 2], fences, and
//   takes a ticket from the per-(row, kv head) counter; the block holding
//   the last ticket merges the live blocks the same way (one warp per head
//   for the weights, every thread's partial loads in flight together),
//   writes o and sets the counter back to 0. No second kernel: a decode
//   step launches one read per layer. The counters must not be shared by
//   reads in flight at the same time (the wrapper keys them by device and
//   stream).
// - thread 0 of block (0, 0, 0) adds one to the wrapper's 64-bit launch
//   counter (ops/launch_counts.py) before anything else, so a launch counts
//   where it runs, a CUDA graph's replays included.
// - the arithmetic is the Pallas kernels': s = (q . k) * scale, and for
//   int8 s = (q . k8) * scale * k_scale[tok], masked tokens never
//   contribute, l sums p = exp(s - m) before the v scale, then p *=
//   v_scale[tok] and acc += p . v8; p in f32 (the Pallas kernels round it
//   to bf16), zeros at length 0, lengths clamped to NP * ps (paged) and S
//   (dense); only the order of the sums differs.
//
// ptxas (sm_90a, -O3, CUDA 12.8; the report lands in
// build/torch_kernels/lib*.log and chip_smoke.py prints it per element
// type), under __launch_bounds__(128, 3), 0 spill bytes in all 32
// instantiations (bf16 and int8, dh 64 / 128, G 1 / 2 / 4 / 8, paged and
// dense): 83-167 registers, 127-128 at dh=128, G=4 (Llama-3-8B's) in both
// types. Shared memory, dynamic: 2 stages of K, V (and scales) + G * dh
// f32 q + G * TK f32 p + 2 * 8 mask words: 68672 bytes in bf16 and 71744
// in int8 at dh=128, G=4, so three blocks fit on an SM. The int8 reads'
// SASS holds no int -> float conversion (cuobjdump, counted by
// chip_smoke.py) besides the reciprocal seeds of integer division.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace gofr_split {

typedef __nv_bfloat16 bf16;

constexpr int NT = 128;              // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_SPLIT = 64;        // blocks per row (the combine's weights)
constexpr float kMask = -0.7f * 3.402823466e38f;

using gofr_cp::cp_async16;
using gofr_cp::cp_async_commit;
using gofr_cp::cp_async_wait;
using gofr_cp::smem_addr;

// K/V element types. TK: tokens per tile, so that a tile's d row is one
// 128-byte line; EPC: elements per 16-byte chunk; TPL: tokens per 32-bit
// word, the tokens a lane scores; NSTAGE: tiles in flight; kScaled:
// per-token f32 scales (and the fast exp, see below).
struct KvBf16 {
  typedef bf16 T;
  static constexpr int TK = 64, EPC = 8, TPL = 2, NSTAGE = 2;
  static constexpr bool kScaled = false;
  __device__ static T zero() { return __float2bfloat16(0.f); }
};
struct KvInt8 {
  typedef int8_t T;
  static constexpr int TK = 128, EPC = 16, TPL = 4, NSTAGE = 2;
  static constexpr bool kScaled = true;
  __device__ static T zero() { return 0; }
};

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
};

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

// element offset of (row d, 16-byte chunk c) in a [dh][TK] tile, a d row
// per 128 bytes, its eight chunks XOR-swizzled by d & 7
template <class E>
__device__ __forceinline__ int swz(int d, int c) {
  static_assert(E::TK * sizeof(typename E::T) == 128, "one line per d row");
  return d * E::TK + ((c ^ (d & 7)) * E::EPC);
}

// the two bf16 of a 32-bit word (low half first) as floats
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the four int8 of a 32-bit word (byte 0 first) as exact floats, without
// I2F: byte x ^ 0x80 under the exponent byte 0x4B is 2^23 + x + 128
__device__ __forceinline__ void i8x4(uint32_t w, float f[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// the TPL tokens of a 32-bit word of a K/V row as floats
template <class E>
__device__ __forceinline__ void unpack(uint32_t w, float f[E::TPL]) {
  if constexpr (E::kScaled) {
    i8x4(w, f);
  } else {
    f[0] = lo(w);
    f[1] = hi(w);
  }
}

// exp(x): expf for bf16 as before; for int8, whose read has the
// conversions to pay for, 2^(x log2 e) by ex2.approx.ftz (two instructions,
// a few ulp from expf, results below 2^-126 flushed to 0)
template <class E>
__device__ __forceinline__ float exp_(float x) {
  if constexpr (E::kScaled) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
    return y;
  } else {
    return expf(x);
  }
}

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

// the same for the scale of token tok: [P, Hkv, ps] paged, [B, Hkv, S] dense
__device__ __forceinline__ long long scale_offset(const Paged& a, int b, int hk,
                                                  int tok, int n) {
  const int page = a.table[(size_t)b * a.NP + tok / a.ps];
  const int in = tok % a.ps;
  if (page < 0 || page >= a.P || in + n > a.ps) return -1;
  return ((long long)page * a.Hkv + hk) * a.ps + in;
}

__device__ __forceinline__ long long scale_offset(const Dense& a, int b, int hk,
                                                  int tok, int) {
  return ((long long)b * a.Hkv + hk) * a.S + tok;
}

// bytes of one stage: the K and V tiles, then (int8) the k and v scales
template <class E, int DH>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * DH * E::TK * (int)sizeof(typename E::T) + (E::kScaled ? 2 * E::TK * 4 : 0);
}

// tokens [t0, t0 + TK) of row b, kv head hk into the swizzled K and V tiles
// of `stage` (and their scales), and mask[c] bit i set when token
// t0 + EPC c + i is live and readable; tokens at or past `live` and
// unreadable tokens become zeros. Thread tid copies chunk tid % CH of rows
// tid / CH, tid / CH + NT / CH, ...; threads 0 .. TK / 2 - 1 copy the scale
// chunks.
template <class E, int DH, class Addr>
__device__ __forceinline__ void load_tile(unsigned char* stage, uint32_t* mask,
                                          const typename E::T* k,
                                          const typename E::T* v,
                                          const float* ks, const float* vs,
                                          const Addr& a, int b, int hk, int t0,
                                          int live, int tid) {
  typedef typename E::T T;
  constexpr int TK = E::TK, EPC = E::EPC, CH = TK / EPC;
  T* Ks = reinterpret_cast<T*>(stage);
  T* Vs = Ks + DH * TK;
  const int c = tid % CH;
  const int tok = t0 + c * EPC;
  int n = live - tok;
  n = n < 0 ? 0 : (n > EPC ? EPC : n);
  const long long off = n > 0 ? run_offset(a, b, hk, tok, n) : -1;
  const size_t stride = a.stride();
  if (tid < CH) {
    uint32_t bits = 0;
#pragma unroll 1
    for (int i = 0; i < EPC; ++i)
      if (i < n && (off >= 0 || run_offset(a, b, hk, tok + i, 1) >= 0)) bits |= 1u << i;
    mask[c] = bits;
  }
#pragma unroll 4
  for (int d = tid / CH; d < DH; d += NT / CH) {
    T* dk = Ks + swz<E>(d, c);
    T* dv = Vs + swz<E>(d, c);
    if (n == 0) {
      cp_async16(smem_addr(dk), k, 0);
      cp_async16(smem_addr(dv), v, 0);
      continue;
    }
    if (off >= 0) {
      const T* gk = k + off + d * stride;
      const T* gv = v + off + d * stride;
      if (((reinterpret_cast<uintptr_t>(gk) | reinterpret_cast<uintptr_t>(gv)) & 15) == 0) {
        cp_async16(smem_addr(dk), gk, (int)sizeof(T) * n);
        cp_async16(smem_addr(dv), gv, (int)sizeof(T) * n);
        continue;
      }
    }
    // unaligned, crossing a page or holding an unreadable page: one token at
    // a time, unreadable tokens as zeros
#pragma unroll 1
    for (int i = 0; i < EPC; ++i) {
      const long long o = i < n ? run_offset(a, b, hk, tok + i, 1) : -1;
      dk[i] = o >= 0 ? k[o + d * stride] : E::zero();
      dv[i] = o >= 0 ? v[o + d * stride] : E::zero();
    }
  }
  if constexpr (E::kScaled) {
    // chunk j of 4 tokens: threads 0 .. SC - 1 the k scales, the next SC
    // the v scales
    constexpr int SC = TK / 4;
    if (tid < 2 * SC) {
      const int j = tid % SC, tj = t0 + 4 * j;
      const float* src = tid < SC ? ks : vs;
      float* dst = reinterpret_cast<float*>(Vs + DH * TK) + (tid < SC ? 0 : TK) + 4 * j;
      int ns = live - tj;
      ns = ns < 0 ? 0 : (ns > 4 ? 4 : ns);
      const long long so = ns > 0 ? scale_offset(a, b, hk, tj, ns) : -1;
      if (ns == 0) {
        cp_async16(smem_addr(dst), src, 0);
      } else if (so >= 0 && (reinterpret_cast<uintptr_t>(src + so) & 15) == 0) {
        cp_async16(smem_addr(dst), src + so, 4 * ns);
      } else {
#pragma unroll 1
        for (int i = 0; i < 4; ++i) {
          const long long o = i < ns ? scale_offset(a, b, hk, tj + i, 1) : -1;
          dst[i] = o >= 0 ? src[o] : 0.f;
        }
      }
    }
  }
}

template <class E, int DH, int G>
constexpr int smem_bytes() {
  return E::NSTAGE * stage_bytes<E, DH>()                          // K, V (scales)
         + (int)sizeof(float) * (G * DH + G * E::TK)               // q, p
         + 4 * E::NSTAGE * (E::TK / E::EPC);                       // token masks
}

// at most 170 registers a thread, so three blocks fit on an SM as their
// shared memory does
template <class E, int DH, int G, class Addr>
__global__ void __launch_bounds__(NT, 3)
decode_split_kernel(const bf16* __restrict__ q, const typename E::T* __restrict__ k,
                    const typename E::T* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const Addr a,
                    bf16* __restrict__ o, float* __restrict__ part,
                    int* __restrict__ counters,
                    unsigned long long* __restrict__ launches, int unit,
                    int nsplit, float scale) {
  typedef typename E::T T;
  static_assert(DH % 32 == 0, "dh");
  constexpr int KD = DH / 32;        // d values per lane in p . v
  constexpr int PS = DH + 2;         // a partial's (acc[dh], m, l) per head
  constexpr int NS = E::NSTAGE;
  constexpr int TK = E::TK, WT = TK / NWARP;   // tokens per tile, per warp
  constexpr int EPC = E::EPC, CH = TK / EPC;
  constexpr int TPL = E::TPL;        // tokens per lane in the score pass
  constexpr int NGP = WT / TPL;      // token groups per warp (8)
  static_assert(NGP == 8 && WT == 2 * EPC, "lane map");
  constexpr int SB = stage_bytes<E, DH>();

  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + NS * SB);        // [G][DH]
  float* Pw = Qs + G * DH;                                     // [NWARP][G][WT]
  uint32_t* masks = reinterpret_cast<uint32_t*>(Pw + NWARP * G * WT);  // [NS][CH]

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  if ((hk | b | split | tid) == 0) atomicAdd(launches, 1ull);
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
  // lane (p, dc): tokens TPL p .. TPL p + TPL - 1 of the warp's WT; d class
  // dc of four
  const int p = lane % NGP, dc = lane / NGP;
  const int tau = w * WT + TPL * p;             // tile-relative token
  float m[G], l[G], acc[G][KD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMask;
    l[g] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) acc[g][kk] = 0.f;
  }

  // tile t goes to stage t % NS, one commit group each (empty past the last
  // tile), so tile j has landed when at most NS - 1 groups are pending
  int next = 0;          // the next tile to copy
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    // tiles j .. j + NS - 1 in flight: stage (j + NS - 1) % NS was freed by
    // the barrier that ended tile j - 1
#pragma unroll 1
    for (; next < j + NS; ++next) {
      if (next < n_tiles)
        load_tile<E, DH>(smem + (next % NS) * SB, masks + (next % NS) * CH, k, v,
                         k_scale, v_scale, a, b, hk, tile_start(next), live, tid);
      cp_async_commit();
    }
    if (j == 0)          // q is read while the first tiles are in flight
      for (int i = tid; i < G * DH; i += NT) Qs[i] = __bfloat162float(qb[i]);
    cp_async_wait<NS - 1>();
    __syncthreads();     // tile j (and q) landed for every thread
    const unsigned char* st = smem + (j % NS) * SB;
    const T* Kt = reinterpret_cast<const T*>(st);
    const T* Vt = Kt + DH * TK;
    // the lane's token mask as floats: a masked token's K and scales are
    // zeros, so its score s + kMask is kMask, and its p is multiplied by 0
    const uint32_t bits = masks[(j % NS) * CH + tau / EPC] >> (tau % EPC);
    float neg[TPL], keep[TPL];
#pragma unroll
    for (int t = 0; t < TPL; ++t) {
      const bool on = (bits >> t) & 1u;
      neg[t] = on ? 0.f : kMask;
      keep[t] = on ? 1.f : 0.f;
    }

    // s = q . k for the lane's TPL tokens, summed over its d class: rows d
    // and d + 1, one 32-bit word of TPL tokens each (d & 7 is 2 dc and
    // 2 dc + 1 for every i, so the swizzle is the same for every pair)
    float sv[G][TPL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int t = 0; t < TPL; ++t) sv[g][t] = 0.f;
    const T* k0p = Kt + swz<E>(2 * dc, tau / EPC) + tau % EPC;
    const T* k1p = Kt + swz<E>(2 * dc + 1, tau / EPC) + tau % EPC;
    const float* qp = Qs + 2 * dc;
#pragma unroll 4
    for (int i = 0; i < DH / 8; ++i) {
      float f0[TPL], f1[TPL];
      unpack<E>(*reinterpret_cast<const uint32_t*>(k0p + 8 * i * TK), f0);
      unpack<E>(*reinterpret_cast<const uint32_t*>(k1p + 8 * i * TK), f1);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float2 qq = *reinterpret_cast<const float2*>(qp + g * DH + 8 * i);
#pragma unroll
        for (int t = 0; t < TPL; ++t) sv[g][t] += qq.x * f0[t] + qq.y * f1[t];
      }
    }
    // the tile's scales: k after q . k, v into p after l
    float ksc[TPL], vsc[TPL];
    if constexpr (E::kScaled) {
      const float* Ss = reinterpret_cast<const float*>(Vt + DH * TK);
      const float4 k4 = *reinterpret_cast<const float4*>(Ss + tau);
      const float4 v4 = *reinterpret_cast<const float4*>(Ss + TK + tau);
      ksc[0] = k4.x; ksc[1] = k4.y; ksc[2] = k4.z; ksc[3] = k4.w;
      vsc[0] = v4.x; vsc[1] = v4.y; vsc[2] = v4.z; vsc[3] = v4.w;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float x[TPL];
#pragma unroll
      for (int t = 0; t < TPL; ++t) {
#pragma unroll
        for (int off = NGP; off < 32; off <<= 1)
          sv[g][t] += __shfl_xor_sync(0xffffffffu, sv[g][t], off);
        float s = sv[g][t] * scale;
        if constexpr (E::kScaled) s *= ksc[t];
        x[t] = s + neg[t];
      }
      float mx = fmaxf(x[0], x[1]);
#pragma unroll
      for (int t = 2; t < TPL; ++t) mx = fmaxf(mx, x[t]);
#pragma unroll
      for (int off = 1; off < NGP; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = exp_<E>(m[g] - m_new);
      m[g] = m_new;
      float pr[TPL];
      float lg = l[g] * alpha;
#pragma unroll
      for (int t = 0; t < TPL; ++t) {
        pr[t] = exp_<E>(x[t] - m_new) * keep[t];
        lg += pr[t];
        if constexpr (E::kScaled) pr[t] *= vsc[t];   // l summed p before it
      }
      l[g] = lg;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) acc[g][kk] *= alpha;
      if (dc == 0) {
        float* dst = Pw + (w * G + g) * WT + TPL * p;
        if constexpr (TPL == 2)
          *reinterpret_cast<float2*>(dst) = make_float2(pr[0], pr[1]);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(pr[0], pr[1], pr[2], pr[3]);
      }
    }
    __syncwarp();

    // acc += p . v over the warp's WT tokens, two 16-byte chunks per V row
    if constexpr (E::kScaled) {
      // 16 int8 tokens a chunk, converted 4 at a time
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        uint4 raw[KD];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          raw[kk] = *reinterpret_cast<const uint4*>(Vt + swz<E>(lane + 32 * kk, 2 * w + h2));
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float vf[KD][4];
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            i8x4(h == 0 ? raw[kk].x : h == 1 ? raw[kk].y : h == 2 ? raw[kk].z : raw[kk].w,
                 vf[kk]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 pa =
                *reinterpret_cast<const float4*>(Pw + (w * G + g) * WT + 16 * h2 + 4 * h);
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)
              acc[g][kk] += pa.x * vf[kk][0] + pa.y * vf[kk][1] + pa.z * vf[kk][2] +
                            pa.w * vf[kk][3];
          }
        }
      }
    } else {
      // 8 bf16 tokens a chunk
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float vf[KD][8];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const uint4 raw = *reinterpret_cast<const uint4*>(Vt + swz<E>(lane + 32 * kk, 2 * w + h));
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
    }
    if (j + NS < n_tiles) __syncthreads();   // every warp is done with this stage
  }

  // merge the four warps: (m, l, acc) of warp w at wst[w][g][0..DH+1]
  __syncthreads();       // the tile buffers are free (no copy in flight)
  float* wst = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lt = l[g];
#pragma unroll
    for (int off = 1; off < NGP; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
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
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < nlive; s += 32) {
      const float f = expf(ws[s * G + g] - M);
      ws[s * G + g] = f;
      L += f * ls[s * G + g];
    }
    L = warp_sum(L);
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

template <class E, int DH, int G, class Addr>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const Addr& a, void* o, void* part, void* counters,
           void* launches, int B, int unit, int nsplit, float scale,
           cudaStream_t stream) {
  typedef typename E::T T;
  constexpr int smem = smem_bytes<E, DH, G>();
  constexpr int tiles = E::NSTAGE * stage_bytes<E, DH>();
  static_assert(smem <= 232448, "shared memory");
  static_assert(4 * NWARP * G * (DH + 2) <= tiles, "merge area");
  static_assert(E::TK % 64 == 0, "units");
  static_assert(4 * (2 * MAX_SPLIT * G + G) <= tiles, "combine area");
  // above 48 KB a kernel must opt in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(decode_split_kernel<E, DH, G, Addr>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in[dev] = true;
  }
  const dim3 grid(a.Hkv, B, nsplit);
  decode_split_kernel<E, DH, G, Addr><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), a, static_cast<bf16*>(o),
      static_cast<float*>(part), static_cast<int*>(counters),
      static_cast<unsigned long long*>(launches), unit, nsplit, scale);
  return (int)cudaGetLastError();
}

template <class E, int DH, class Addr>
int launch_g(int G, const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const Addr& a, void* o, void* part, void* counters,
             void* launches, int B, int unit, int nsplit, float scale,
             cudaStream_t st) {
  switch (G) {
    case 1: return launch<E, DH, 1>(q, k, v, ks, vs, a, o, part, counters, launches, B, unit, nsplit, scale, st);
    case 2: return launch<E, DH, 2>(q, k, v, ks, vs, a, o, part, counters, launches, B, unit, nsplit, scale, st);
    case 4: return launch<E, DH, 4>(q, k, v, ks, vs, a, o, part, counters, launches, B, unit, nsplit, scale, st);
    case 8: return launch<E, DH, 8>(q, k, v, ks, vs, a, o, part, counters, launches, B, unit, nsplit, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch the split read on `stream`; returns a cudaError_t code, 0 when the
// launch was accepted. ks / vs: the f32 scales of int8 elements (null for
// bf16). part: [B, Hkv, nsplit, G, dh + 2] f32 scratch and counters:
// [>= B * Hkv] int32, all 0, each needed only when nsplit > 1. launches: the
// kernel's uint64 launch counter, which the launch adds one to.
template <class E, class Addr>
int dispatch(int H, const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const Addr& a, void* o, void* part, void* counters,
             void* launches, int B, int unit, int nsplit, float scale,
             void* stream) {
  if (B <= 0 || a.Hkv <= 0 || H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if (unit <= 0 || unit % E::TK != 0 || nsplit < 1 || nsplit > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  if (E::kScaled && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  if (launches == nullptr) return (int)cudaErrorInvalidValue;
  const int G = H / a.Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.dh == 128)
    return launch_g<E, 128>(G, q, k, v, ks, vs, a, o, part, counters, launches, B, unit, nsplit, scale, st);
  if (a.dh == 64)
    return launch_g<E, 64>(G, q, k, v, ks, vs, a, o, part, counters, launches, B, unit, nsplit, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gofr_split
