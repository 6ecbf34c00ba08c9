// Flash attention forward for Hopper (sm_90a): causal or non-causal GQA,
// bf16 in and out, f32 accumulation, online softmax.
//
// Replaces: gofr_tpu/ops/flash_attention.py, flash_attention -> _flash_bhtd,
// both Pallas kernels (_kernel_resident and _kernel_streaming). Those two
// differ only in what the TPU's VMEM holds; here K/V always stream through
// shared memory one tile at a time, so one kernel covers every length.
//
// Layout: q, o [B, H, T, dh]; k, v [B, Hkv, S, dh], all contiguous. Query
// head h reads kv head h / (H / Hkv). Causal requires T == S (the wrapper
// sends mixed-length causal to the reference, as the JAX dispatch does).
//
// What bounds it on an H100: at serving lengths the FLOPs. Causal attention
// does ~2*B*H*T^2*dh multiply-adds' worth of operations (4*B*H*T*S*dh / 2)
// against the 989 TFLOP/s bf16 tensor-core peak; the bytes (q, k, v read
// once, o written once) over 3.35 TB/s are the bound only for short windows.
// This first version does its products on the CUDA cores in f32, not on the
// tensor cores (mma.sync / wgmma is later work), so it sits far from the
// FLOP bound by design. What it does about the bound: kv tiles above the
// diagonal are skipped (half the work under causal), each K/V tile is read
// from device memory once per 64 query rows and reused by all of them from
// shared memory, and scores never touch device memory.
//
// Design: one block per (q tile of 64 rows, head, batch), 8 warps, each
// warp owns 8 query rows. Per kv tile of 64 keys: lane j computes the
// scores of keys j and j+32 for the warp's 8 rows (K rows padded to dh+2
// bf16 so the column reads hit 32 different banks), the online-softmax
// statistics (m, l) are reduced with warp shuffles and kept in registers,
// p goes through a per-warp shared-memory row, and for p.v each lane owns
// dh/32 output columns of its warp's 8 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per kv tile
constexpr int NWARP = 8;
constexpr int NT = NWARP * 32;
constexpr int R = BQ / NWARP;        // query rows per warp
// the JAX kernels' DEFAULT_MASK_VALUE: finite, so exp(mask - mask) is 1,
// never NaN, on a row whose every key so far is masked
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

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (BQ * DH + BK * (DH + 2) + BK * DH)
         + sizeof(float) * BQ * BK;
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int H, int Hkv, int T, int S, int causal, float scale) {
  constexpr int KSTR = DH + 2;       // padded K row, in bf16 elements
  constexpr int D2 = DH / 2;         // bf16x2 pairs per row
  constexpr int P2 = DH / 64;        // bf16x2 pairs per lane in p.v
  constexpr int VEC = 8;             // bf16 per 16-byte load
  constexpr int ROWV = DH / VEC;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [BQ][DH]
  __nv_bfloat16* Ks = Qs + BQ * DH;                              // [BK][KSTR]
  __nv_bfloat16* Vs = Ks + BK * KSTR;                            // [BK][DH]
  float* Ps = reinterpret_cast<float*>(Vs + BK * DH);            // [BQ][BK]

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = tile * BQ;
  const int r0 = warp * R;

  const __nv_bfloat16* qb = q + (size_t)(b * H + h) * T * DH;
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * S * DH;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * S * DH;

  // the q tile, zero rows past T (their results are never written)
  for (int i = tid; i < BQ * ROWV; i += NT) {
    const int r = i / ROWV, c = (i % ROWV) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < T) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * DH + c);
    *reinterpret_cast<uint4*>(Qs + r * DH + c) = val;
  }

  float m[R], l[R], acc[R][2 * P2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kMask;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * P2; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    // tiles whose first key is at or before this block's last query row
    const int last = (q0 + BQ - 1) / BK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the previous tile's K/V reads are done
    for (int i = tid; i < BK * ROWV; i += NT) {
      const int r = i / ROWV, c = (i % ROWV) * VEC;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * DH + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * DH + c);
      }
      // padded K rows are only 4-byte aligned: store as four bf16x2
      uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + r * KSTR + c);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<uint4*>(Vs + r * DH + c) = vv;
    }
    __syncthreads();

    // scores of keys (lane, lane + 32) for the warp's R rows
    float s[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r][0] = s[r][1] = 0.f;
    const __nv_bfloat162* Ka = reinterpret_cast<const __nv_bfloat162*>(Ks + lane * KSTR);
    const __nv_bfloat162* Kb = reinterpret_cast<const __nv_bfloat162*>(Ks + (lane + 32) * KSTR);
    const __nv_bfloat162* Q2 = reinterpret_cast<const __nv_bfloat162*>(Qs + r0 * DH);
#pragma unroll 4
    for (int d2 = 0; d2 < D2; ++d2) {
      const float2 ka = __bfloat1622float2(Ka[d2]);
      const float2 kc = __bfloat1622float2(Kb[d2]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 qq = __bfloat1622float2(Q2[r * D2 + d2]);
        s[r][0] += qq.x * ka.x + qq.y * ka.y;
        s[r][1] += qq.x * kc.x + qq.y * kc.y;
      }
    }

    // mask, online softmax, p into this warp's rows of Ps
    const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + r0 + r;
      const bool ok0 = kp0 < S && (!causal || kp0 <= qpos);
      const bool ok1 = kp1 < S && (!causal || kp1 <= qpos);
      const float a0 = ok0 ? s[r][0] * scale : kMask;
      const float a1 = ok1 ? s[r][1] * scale : kMask;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(a0, a1)));
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * P2; ++c) acc[r][c] *= alpha;
      Ps[(r0 + r) * BK + lane] = p0;
      Ps[(r0 + r) * BK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += p . v; lane owns column pairs lane + 32*i
    for (int c = 0; c < BK; ++c) {
      const __nv_bfloat162* V2 = reinterpret_cast<const __nv_bfloat162*>(Vs + c * DH);
      float2 vv[P2];
#pragma unroll
      for (int i = 0; i < P2; ++i) vv[i] = __bfloat1622float2(V2[lane + 32 * i]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = Ps[(r0 + r) * BK + c];
#pragma unroll
        for (int i = 0; i < P2; ++i) {
          acc[r][2 * i] += p * vv[i].x;
          acc[r][2 * i + 1] += p * vv[i].y;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= T) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat162* O2 = reinterpret_cast<__nv_bfloat162*>(
        o + ((size_t)(b * H + h) * T + qpos) * DH);
#pragma unroll
    for (int i = 0; i < P2; ++i)
      O2[lane + 32 * i] = __floats2bfloat162_rn(acc[r][2 * i] * inv, acc[r][2 * i + 1] * inv);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int T, int S, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Hkv, T, S, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int gofr_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, int B, int H, int Hkv, int T, int S,
                                        int dh, int causal, float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128) return launch<128>(q, k, v, o, B, H, Hkv, T, S, causal, scale, st);
  if (dh == 64) return launch<64>(q, k, v, o, B, H, Hkv, T, S, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
