// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces consensus_tpu/ops/flash_attention.py::flash_attention (the Pallas
// TPU kernel, _kernel :43-116).  Same function: blockwise streaming-softmax
// attention over (B, S, H, hd) where each batch row holds ONE contiguous
// valid span [start, start + length) given by two per-row int32 scalars;
// causal mask on the global position, optional sliding window
// (qpos - kpos < window), optional logit softcap applied before the mask, a
// caller-given scale, and zero output wherever a query position has no
// valid key.  K and V may carry fewer heads than Q (GQA): q head h reads kv
// head h / (H / KV), so the caller never materializes repeated K/V.
//
// What bounds it on an H100 (SXM data sheet: 989 TFLOP/s dense bf16,
// 3.35 TB/s): the larger of the causal FLOPs over the bf16 rate and the
// bytes over the HBM rate, counting o in full but q and GQA k, v only over
// each row's span (no tile outside it is read).  At the llama3-8b scoring
// shape (B=32, S=768, H=32, KV=8, hd=128) with full rows that is
// 2*B*H*S^2*hd ~ 1.5e11 FLOPs (~0.16 ms) against ~0.5 GB (~0.15 ms); with
// K/V repeated to 32 heads, as the JAX call passes them, ~0.8 GB
// (~0.24 ms).  Ragged rows shrink both; chip_smoke.py computes the bound
// from each run's lengths.  This first version sits far above it, limited
// by how it feeds the tensor cores (WMMA through shared memory, no
// copy/compute overlap).
//
// Design (simple and correct first; wgmma/TMA come later):
//  * one block of 4 warps per (batch*head, 64-query tile); the TPU grid's
//    sequential k axis becomes a loop inside the block, with the running
//    max, sum and fp32 accumulator held in shared memory;
//  * the loop runs only over key tiles that can hold a valid key for this
//    query tile: it starts at the span start (or the window's lower edge)
//    and stops at the span end and the causal edge;
//  * Q K^T and P V run on the tensor cores through WMMA (16x16x16 bf16
//    fragments, fp32 accumulators); each warp owns 16 query rows and keeps
//    its Q fragments in registers; the online softmax runs in fp32 with
//    one warp per row group; P is rounded to bf16 for the P V product.
//  * no padding copy: tiles past S load as zeros and are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

// Shared-memory layout.  Leading dimensions are padded against bank
// conflicts while keeping every WMMA fragment pointer 32-byte aligned.
template <int HD>
struct Layout {
  static constexpr int LDQ = HD + 8;       // bf16 Q/K/V rows
  static constexpr int LDS = BLOCK_K + 4;  // fp32 logits
  static constexpr int LDP = BLOCK_K + 8;  // bf16 probabilities
  static constexpr int LDO = HD + 4;       // fp32 accumulator
  static constexpr size_t Q_BYTES = (size_t)BLOCK_Q * LDQ * 2;
  static constexpr size_t KV_BYTES = (size_t)BLOCK_K * LDQ * 2;
  static constexpr size_t S_BYTES = (size_t)BLOCK_Q * LDS * 4;
  static constexpr size_t P_BYTES = (size_t)BLOCK_Q * LDP * 2;
  static constexpr size_t O_BYTES = (size_t)BLOCK_Q * LDO * 4;
  static constexpr size_t ML_BYTES = (size_t)2 * BLOCK_Q * 4;
  static constexpr size_t BYTES =
      Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES + O_BYTES + ML_BYTES;
};

// Copy rows [row0, row0 + 64) of head `head` of a (B, S, NH, HD) tensor into
// shared memory, 16 bytes per thread per step; rows past S become zeros.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int b, int row0, int S, int nheads,
                                          int head) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = HD / VEC;
  constexpr int LD = Layout<HD>::LDQ;
  for (int i = threadIdx.x; i < BLOCK_K * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) {
      val = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * S + s) * nheads + head) * HD + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const int* __restrict__ lengths, const int* __restrict__ starts,
                 int S, int H, int KV, float scale, float softcap, int window,
                 int causal) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::Q_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::Q_BYTES + L::KV_BYTES);
  float* sS = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES);
  bf16* sP = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sS) + L::S_BYTES);
  float* sO = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sP) + L::P_BYTES);
  float* sM = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sO) + L::O_BYTES);
  float* sL = sM + BLOCK_Q;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * BLOCK_Q;
  const int start = starts[b];
  const int end = start + lengths[b];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Query rows of this tile inside the span, and the keys they can see.
  const int q_lo = max(q0, start);
  const int q_hi = min(q0 + BLOCK_Q, end);
  int k_lo = start;
  int k_hi = end;
  if (causal) k_hi = min(k_hi, q_hi);
  if (window > 0) k_lo = max(k_lo, q_lo - window + 1);

  for (int i = threadIdx.x; i < BLOCK_Q * L::LDO; i += THREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BLOCK_Q; i += THREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }

  if (q_lo < q_hi && k_lo < k_hi) {  // uniform across the block
    load_tile<HD>(sQ, q, b, q0, S, H, h);
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HD / 16];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * L::LDQ + kk * 16, L::LDQ);
    }

    for (int k0 = (k_lo / BLOCK_K) * BLOCK_K; k0 < k_hi; k0 += BLOCK_K) {
      __syncthreads();  // every warp is done with the previous K/V tile
      load_tile<HD>(sK, k, b, k0, S, KV, kvh);
      load_tile<HD>(sV, v, b, k0, S, KV, kvh);
      __syncthreads();

      // Logits of this warp's 16 query rows against the 64 keys.
#pragma unroll
      for (int n = 0; n < BLOCK_K / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, sK + n * 16 * L::LDQ + kk * 16, L::LDQ);
          wmma::mma_sync(acc, qf[kk], kf, acc);
        }
        wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, acc, L::LDS,
                                wmma::mem_row_major);
      }
      __syncwarp();

      // Online softmax, one row at a time, two key columns per lane.
      for (int rr = 0; rr < 16; ++rr) {
        const int r = warp * 16 + rr;
        const int qpos = q0 + r;
        const bool q_ok = qpos >= start && qpos < end;
        float x[2];
        bool ok[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          const int kpos = k0 + c;
          float val = sS[r * L::LDS + c] * scale;
          if (softcap > 0.f) val = softcap * tanhf(val / softcap);
          const bool valid = q_ok && kpos >= start && kpos < end &&
                             (!causal || kpos <= qpos) &&
                             (window <= 0 || qpos - kpos < window);
          x[j] = valid ? val : NEG_INF;
          ok[j] = valid;
        }
        float mx = fmaxf(x[0], x[1]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_prev = sM[r];
        const float m_new = fmaxf(m_prev, mx);
        const float p0 = ok[0] ? expf(x[0] - m_new) : 0.f;
        const float p1 = ok[1] ? expf(x[1] - m_new) : 0.f;
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        const float alpha = expf(m_prev - m_new);
        sP[r * L::LDP + lane] = __float2bfloat16(p0);
        sP[r * L::LDP + lane + 32] = __float2bfloat16(p1);
        for (int d = lane; d < HD; d += 32) sO[r * L::LDO + d] *= alpha;
        __syncwarp();  // every lane has read sM[r] before lane 0 rewrites it
        if (lane == 0) {
          sM[r] = m_new;
          sL[r] = sL[r] * alpha + sum;
        }
      }
      __syncwarp();

      // Accumulator += P V for this warp's rows.
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, sO + warp * 16 * L::LDO + dn * 16, L::LDO,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(pf, sP + warp * 16 * L::LDP + kk * 16, L::LDP);
          wmma::load_matrix_sync(vf, sV + kk * 16 * L::LDQ + dn * 16, L::LDQ);
          wmma::mma_sync(acc, pf, vf, acc);
        }
        wmma::store_matrix_sync(sO + warp * 16 * L::LDO + dn * 16, acc, L::LDO,
                                wmma::mem_row_major);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // Normalize and write the tile; rows with no valid key have l == 0 and a
  // zero accumulator, so they come out as 0.
  for (int i = threadIdx.x; i < BLOCK_Q * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i % HD;
    const int s = q0 + r;
    if (s >= S) continue;
    const float val = sO[r * L::LDO + d] / fmaxf(sL[r], 1e-30f);
    o[(((size_t)b * S + s) * H + h) * HD + d] = __float2bfloat16(val);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* lengths, const int* starts, int B, int S, int H, int KV,
           float scale, float softcap, int window, int causal,
           cudaStream_t stream) {
  const size_t smem = Layout<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((S + BLOCK_Q - 1) / BLOCK_Q));
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lengths, starts, S,
      H, KV, scale, softcap, window, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd) bf16; k, v: (B, S, KV, hd) bf16 with H % KV == 0;
// lengths, starts: (B,) int32 on the device.  softcap <= 0 and window <= 0
// switch those features off.  Returns the launch's cudaError_t.
int consensus_flash_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, const void* lengths,
                                  const void* starts, int B, int S, int H,
                                  int KV, int head_dim, float scale,
                                  float softcap, int window, int causal,
                                  void* stream) {
  const int* len = static_cast<const int*>(lengths);
  const int* st = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return launch<128>(q, k, v, o, len, st, B, S, H, KV, scale, softcap,
                         window, causal, s);
    case 256:
      return launch<256>(q, k, v, o, len, st, B, S, H, KV, scale, softcap,
                         window, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
