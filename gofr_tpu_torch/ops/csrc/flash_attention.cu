// Flash attention forward for Hopper (sm_90a): causal or non-causal GQA,
// bf16 in and out, f32 accumulation, online softmax, both products on the
// tensor cores.
//
// Replaces: gofr_tpu/ops/flash_attention.py, flash_attention -> _flash_bhtd,
// both Pallas kernels (_kernel_resident and _kernel_streaming). Those two
// differ only in what the TPU's VMEM holds; here K/V always stream through
// shared memory one tile at a time, so one kernel covers every length.
//
// Layout: q, o [B, H, T, dh]; k, v [B, Hkv, S, dh], each given by element
// strides (batch, head, token) with dh contiguous, so the model's
// [B, T, H, dh] tensors come in as transposed views with no copy. Every
// stride is a multiple of 8 elements and every base 16-byte aligned (the
// wrapper checks). Query head h reads kv head h / (H / Hkv). Causal
// requires T == S (the wrapper sends mixed-length causal to the reference,
// as the JAX dispatch does). Mask: kv_pos < S and, under causal,
// kv_pos <= q_pos, with the JAX kernels' finite mask value.
//
// What bounds it on an H100: at long windows the operations. Causal
// attention does 4*B*H*dh*T*(T+1)/2 flops against the 989 TFLOP/s bf16
// tensor-core peak; at the served windows (T <= 256) the bytes (q, k, v
// read once, o written once) over 3.35 TB/s, and in practice the launch and
// one block's serial walk over its few kv tiles.
//
// Design (the FlashAttention-2 shape on mma.sync):
// - one block of 4 warps per (64-row q tile, head, batch); each warp owns
//   16 query rows. Under causal the q tiles run heaviest first, so the long
//   diagonal rows do not form the tail; query heads that share a kv head
//   sit next to each other in the grid and find its K/V tiles in L2.
// - the q tile is copied to shared memory once (cp.async) and each warp
//   keeps its 16 x dh slice in registers as m16n8k16 A fragments (ldmatrix).
// - K/V tiles of 64 keys are double-buffered in shared memory with 16-byte
//   cp.async.cg: tile j+1 is in flight while tile j is multiplied. Rows past
//   S are zero-filled by the copy itself (src-size 0), never read out of
//   bounds. Shared rows are XOR-swizzled (16-byte chunk ^ row % 8) so that
//   the ldmatrix reads of eight rows hit eight different bank groups.
// - S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 out), K fragments by
//   ldmatrix from the [key][dh] rows (the "col" B layout). The online
//   softmax runs in registers: each thread holds two rows' scores, the row
//   max is reduced over the quad of lanes that share a row, and exp2 takes
//   scale * log2(e) folded in. Masks are applied only on the tiles that
//   need one (the diagonal and the ragged last tile); tiles wholly above
//   the diagonal are skipped.
// - O += P V without shared memory: p is rounded to bf16 (as the Pallas
//   kernels round p to v's type) and the C fragments of two adjacent n8
//   score tiles are repacked as one k16 A fragment, against V fragments
//   from ldmatrix.trans ([key][dh] rows read as the [dh][key] B operand).
// - the epilogue divides by max(l, 1e-30), stages the warp's 16 rows as
//   bf16 in its own (now free) rows of the q tile, and writes them out as
//   16-byte stores; rows past T are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per kv tile
constexpr int NWARP = 4;             // each warp owns 16 query rows
constexpr int NT = NWARP * 32;
// the JAX kernels' DEFAULT_MASK_VALUE: finite, so exp(mask - mask) is 1,
// never NaN, on a row whose every key so far is masked
constexpr float kMask = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

using gofr_cp::cp_async16;
using gofr_cp::cp_async_commit;
using gofr_cp::cp_async_wait;
using gofr_cp::smem_addr;

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a . b on one m16n8k16 tile: a 16x16 bf16 (4 regs), b 16x8 bf16
// (2 regs), d 16x8 f32 (4 regs)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) -> one bf16x2 register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// element offset of (row, 16-byte chunk) in a swizzled [rows][DH] tile
template <int DH>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * DH + ((chunk ^ (row & 7)) << 3);
}

// rows [row0, row0 + 64) of a [*, DH] matrix with row stride `stride`
// into a swizzled shared tile; rows at or past `n_rows` become zeros
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int n_rows, int tid) {
  constexpr int CH = DH / 8;              // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * CH / NT; ++it) {
    const int i = it * NT + tid;
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < n_rows;
    const bf16* g = ok ? src + (long long)(row0 + r) * stride + c * 8 : src;
    cp_async16(smem_addr(dst + swz<DH>(r, c)), g, ok ? 16 : 0);
  }
}

template <int DH>
constexpr int smem_bytes() {
  return (int)sizeof(bf16) * (BQ * DH + 2 * 2 * BK * DH);   // Q, 2 x (K, V)
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int H, int Hkv, int T, int S, int causal, float scale_log2,
                 long long sqb, long long sqh, long long sqt,
                 long long skb, long long skh, long long skt,
                 long long svb, long long svh, long long svt,
                 long long sob, long long soh, long long sot,
                 unsigned long long* __restrict__ launches) {
  constexpr int KQ = DH / 16;            // k16 steps of q . k
  constexpr int NS = BK / 8;             // n8 score tiles per warp
  constexpr int NO = DH / 8;             // n8 output tiles per warp
  constexpr int CH = DH / 8;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);        // [BQ][DH]
  bf16* Ks = Qs + BQ * DH;                         // [2][BK][DH]
  bf16* Vs = Ks + 2 * BK * DH;                     // [2][BK][DH]

  const int tile = causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;          // mma row group, column pair
  // one count per launch, kept on the card (ops/launch_counts.py)
  if ((blockIdx.x | h | b | tid) == 0) atomicAdd(launches, 1ull);
  const int q0 = tile * BQ;
  const int wrow = warp * 16;                      // the warp's first row in the tile

  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    // tiles whose first key is at or before this block's last query row
    const int last = (q0 + BQ - 1) / BK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  // two copy groups: the q tile, then kv tile 0
  load_tile<DH>(Qs, qb, sqt, q0, T, tid);
  cp_async_commit();
  load_tile<DH>(Ks, kb, skt, 0, S, tid);
  load_tile<DH>(Vs, vb, svt, 0, S, tid);
  cp_async_commit();

  // ldmatrix row addresses: lane l names row l % 8 of matrix l / 8
  const int a_row = wrow + (lane & 15), a_ch = lane >> 4;            // Q (A)
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_ch = (lane >> 3) & 1;  // K (B)
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_ch = lane >> 4;  // V (B, trans)

  // the warp's 16 q rows as A fragments, in registers for the whole loop
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
    ldsm_x4(smem_addr(Qs + swz<DH>(a_row, 2 * kk + a_ch)), qf[kk]);

  float acc[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  // this thread's two rows, wrow + g and wrow + g + 8: running max (in the
  // log2 domain) and its partial sum over the thread's own columns
  float m0 = kMask, m1 = kMask, l0 = 0.f, l1 = 0.f;
  const int qpos0 = q0 + wrow + g, qpos1 = qpos0 + 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      // the other stage was released by the barrier that ended tile j - 1
      load_tile<DH>(Ks + (st ^ 1) * BK * DH, kb, skt, (j + 1) * BK, S, tid);
      load_tile<DH>(Vs + (st ^ 1) * BK * DH, vb, svt, (j + 1) * BK, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // s = q . k for the warp's 16 rows and the tile's 64 keys
    const bf16* Kt = Ks + st * BK * DH;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        const int row = np * 16 + k_row;
        ldsm_x4(smem_addr(Kt + swz<DH>(row, 2 * kk + k_ch)), bk);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    const int k0 = j * BK;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    }
    // only the ragged last tile and tiles that cross this warp's diagonal
    if (k0 + BK > S || (causal && k0 + BK - 1 > q0 + wrow)) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          if (kpos >= S || (causal && kpos > qpos)) s[n][e] = kMask;
        }
      }
    }

    // online softmax: the row max over the quad that shares each row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = fast_exp2(m0 - mx0), alpha1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      acc[d][0] *= alpha0;
      acc[d][1] *= alpha0;
      acc[d][2] *= alpha1;
      acc[d][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = fast_exp2(s[n][0] - mx0);
      s[n][1] = fast_exp2(s[n][1] - mx0);
      s[n][2] = fast_exp2(s[n][2] - mx1);
      s[n][3] = fast_exp2(s[n][3] - mx1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // acc += p . v: score tiles 2kk and 2kk + 1 (C layout) are the k16
    // A fragment of keys [16kk, 16kk + 16)
    const bf16* Vt = Vs + st * BK * DH;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bv[4];
        const int row = kk * 16 + v_row;
        ldsm_x4_trans(smem_addr(Vt + swz<DH>(row, 2 * dp + v_ch)), bv);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  // the row sums over the quad, then acc / max(l, 1e-30) as bf16 into the
  // warp's own rows of the q tile (only this warp read them)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = wrow + g, r1 = r0 + 8;
#pragma unroll
  for (int d = 0; d < NO; ++d) {
    *reinterpret_cast<uint32_t*>(Qs + swz<DH>(r0, d) + 2 * t4) =
        pack_bf16(acc[d][0] * inv0, acc[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(Qs + swz<DH>(r1, d) + 2 * t4) =
        pack_bf16(acc[d][2] * inv1, acc[d][3] * inv1);
  }
  __syncwarp();
  bf16* ob = o + b * sob + h * soh;
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int i = it * 32 + lane;
    const int r = wrow + i / CH, c = i % CH;
    if (q0 + r < T)
      *reinterpret_cast<uint4*>(ob + (long long)(q0 + r) * sot + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<DH>(r, c));
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int T, int S, int causal, float scale, const long long* st,
           void* launches, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  // above 48 KB a kernel must opt in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in[dev] = true;
  }
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Hkv, T, S, causal,
      scale * kLog2e, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], static_cast<unsigned long long*>(launches));
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements, (batch, head, token) for q, k, v, then o. launches:
// the kernel's uint64 launch counter, which every launch adds one to.
// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int gofr_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
    int T, int S, int dh, int causal, float scale, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sob, long long soh, long long sot,
    void* launches, void* stream) {
  if (launches == nullptr) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const long long st[12] = {sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 128) return launch<128>(q, k, v, o, B, H, Hkv, T, S, causal, scale, st, launches, s);
  if (dh == 64) return launch<64>(q, k, v, o, B, H, Hkv, T, S, causal, scale, st, launches, s);
  return (int)cudaErrorInvalidValue;
}
