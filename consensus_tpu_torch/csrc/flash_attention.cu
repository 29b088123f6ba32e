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
// each row's span (no tile outside it is read).  At the best-of-N path's
// shape (B=32, S=1024, H=32, KV=8, hd=128, ragged spans) that is bytes,
// ~0.14 ms, most of it the output; the causal FLOPs alone take ~0.08 ms at
// the dense rate.  chip_smoke.py computes the bound from each run's
// lengths.
//
// Design (FlashAttention-2 on mma.sync; see sm90_mma.cuh):
//  * one block of 4 warps per (batch*head, query tile); at hd=128 each
//    warp owns 32 query rows (two 16-row MMA tiles, so every K and V
//    fragment loaded from shared memory feeds two MMAs), at hd=256 16 rows.
//    Query tiles launch longest-causal first (blockIdx.y reversed).
//  * Q.K^T and P.V run on mma.sync m16n8k16 with ldmatrix operands (.trans
//    for V).  The logits, the running max and sum and the output
//    accumulator stay in registers for the whole key loop; P goes from the
//    logit accumulators to bf16 A fragments without touching shared
//    memory.  The softmax runs in base 2 with log2(e) folded into the
//    scale; a row's max and sum reduce over its quad of lanes.
//  * K and V tiles of 32 keys come through a two-stage ring filled by
//    cp.async: tile j+1 is in flight while tile j is multiplied.  Shared
//    memory is Q plus two (K, V) stages, 68 KB at hd=128 and 99 KB at
//    hd=256; registers (up to 255 a thread, no spills) allow two blocks of
//    4 warps per SM.  (32-key tiles measured faster than 64-key ones, whose
//    logits no longer fit beside the accumulators without spilling; see
//    PERF.md.)
//  * The loop covers only key tiles that can hold a valid key for the
//    block's rows.  Each warp classifies each tile once: empty (skipped),
//    interior (every key valid for every row: no mask), or edge (span
//    ends, causal diagonal or window edge: per-element mask).
//  * The normalised tile goes back through the warp's own Q rows in shared
//    memory, so the output is written in 16-byte coalesced stores; rows
//    past S are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

using namespace sm90;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// Per head_dim: warps per block, 16-row MMA tiles per warp (MT) and keys
// per K/V tile (BK).
template <int HD>
struct Tiles;
template <>
struct Tiles<128> {
  static constexpr int WARPS = 4, MT = 2, BK = 32;
};
template <>
struct Tiles<256> {
  static constexpr int WARPS = 4, MT = 1, BK = 32;
};

template <int HD>
struct Layout {
  static constexpr int WARPS = Tiles<HD>::WARPS;
  static constexpr int MT = Tiles<HD>::MT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WQ = 16 * MT;        // query rows per warp
  static constexpr int BQ = WQ * WARPS;     // query rows per block
  static constexpr int BK = Tiles<HD>::BK;  // keys per tile
  static constexpr int LD = HD + 8;         // bf16 per shared-memory row
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BK * LD;  // one K or one V tile
  // Q, then stage 0 (K, V), then stage 1 (K, V).
  static constexpr size_t BYTES = (size_t)(Q_ELEMS + 4 * KV_ELEMS) * sizeof(bf16);
};

// The keys [lo, hi) that query position q may see; empty (lo == hi) when q
// lies outside the span.
__device__ __forceinline__ void key_range(int q, int start, int end, int causal,
                                          int window, int& lo, int& hi) {
  lo = start;
  hi = end;
  if (q < start || q >= end) {
    hi = lo;
    return;
  }
  if (causal) hi = min(hi, q + 1);
  if (window > 0) lo = max(lo, q - window + 1);
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::THREADS, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const int* __restrict__ lengths, const int* __restrict__ starts,
                 int S, int H, int KV, float scale, float softcap, int window,
                 int causal) {
  using L = Layout<HD>;
  constexpr int MT = L::MT;
  constexpr int BK = L::BK;
  constexpr int LD = L::LD;
  constexpr int NS = BK / 8;  // 8-key logit tiles per key tile
  constexpr int NO = HD / 8;  // 8-column output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BQ;  // longest causal tiles first
  const int start = starts[b];
  const int end = start + lengths[b];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KV * HD;
  const bf16* q_base = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const bf16* k_base = k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const bf16* v_base = v + (size_t)b * S * kv_stride + (size_t)kvh * HD;

  // Key tiles that can hold a valid key for some row of the block: the
  // ranges grow with the query position, so the first and last rows of
  // the tile inside the span bound them.
  int kt_lo = 0, kt_hi = 0;
  {
    const int qa = max(q0, start);
    const int qb = min(q0 + L::BQ, end) - 1;
    if (qa <= qb) {
      int lo, hi, unused;
      key_range(qa, start, end, causal, window, lo, unused);
      key_range(qb, start, end, causal, window, unused, hi);
      if (lo < hi) {
        kt_lo = lo / BK;
        kt_hi = (hi + BK - 1) / BK;
      }
    }
  }

  // This warp's rows: bounds for the per-tile classification, and the key
  // ranges of the rows (g, g + 8 of each 16-row tile) this lane holds.
  const int wq0 = q0 + warp * L::WQ;
  const int wa = max(wq0, start);
  const int wb = min(wq0 + L::WQ, end) - 1;
  const bool has_rows = wa <= wb;
  const bool full_rows = wa == wq0 && wb == wq0 + L::WQ - 1;
  int lo_min = 0, lo_max = 0, hi_min = 0, hi_max = 0;
  if (has_rows) {
    key_range(wa, start, end, causal, window, lo_min, hi_min);
    key_range(wb, start, end, causal, window, lo_max, hi_max);
  }
  int row_lo[MT][2], row_hi[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      key_range(wq0 + mt * 16 + half * 8 + g, start, end, causal, window, row_lo[mt][half],
                row_hi[mt][half]);
    }
  }

  const bool capped = softcap > 0.f;
  const float scale_log2 = scale * LOG2E;
  const float cap_in = capped ? scale / softcap : 0.f;
  const float cap_out = softcap * LOG2E;

  float acc[MT][NO][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  if (kt_lo < kt_hi) {
    load_rows<HD, L::BQ, L::THREADS>(sQ, q_base, q_stride, q0, S);
    bf16* sK0 = sQ + L::Q_ELEMS;
    load_rows<HD, BK, L::THREADS>(sK0, k_base, kv_stride, kt_lo * BK, S);
    load_rows<HD, BK, L::THREADS>(sK0 + L::KV_ELEMS, v_base, kv_stride, kt_lo * BK, S);
    cp_async_commit();
  }

  const bf16* q_frag = sQ + warp * L::WQ * LD + a_offset<LD>(lane);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    const bf16* sK = sQ + L::Q_ELEMS + stage * 2 * L::KV_ELEMS;
    const bf16* sV = sK + L::KV_ELEMS;
    if (kt + 1 < kt_hi) {  // prefetch tile kt + 1 into the other stage
      bf16* nK = sQ + L::Q_ELEMS + (stage ^ 1) * 2 * L::KV_ELEMS;
      load_rows<HD, BK, L::THREADS>(nK, k_base, kv_stride, (kt + 1) * BK, S);
      load_rows<HD, BK, L::THREADS>(nK + L::KV_ELEMS, v_base, kv_stride, (kt + 1) * BK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile kt have landed (for this thread)
    __syncthreads();     // ... and for every thread

    const int k0 = kt * BK;
    const bool empty = !has_rows || k0 >= hi_max || k0 + BK <= lo_min;
    const bool interior = full_rows && k0 >= lo_max && k0 + BK <= hi_min;
    if (!empty) {
      // S = Q K^T for this warp's rows against the tile's keys; each K
      // fragment feeds all MT row tiles.
      float s[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NS; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
      }
      const bf16* k_frag = sK + kt_offset<LD>(lane);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], q_frag + mt * 16 * LD + kk * 16);
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, k_frag + n * 8 * LD + kk * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][n], a[mt], bk[0], bk[1]);
            mma_bf16(s[mt][n + 1], a[mt], bk[2], bk[3]);
          }
        }
      }

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // Scale (and cap) into base-2 logits; mask only on edge tiles.
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = capped ? cap_out * tanhf(s[mt][n][e] * cap_in) : s[mt][n][e] * scale_log2;
            if (!interior) {
              const int key = k0 + n * 8 + 2 * t + (e & 1);
              if (key < row_lo[mt][e >> 1] || key >= row_hi[mt][e >> 1]) x = -INFINITY;
            }
            s[mt][n][e] = x;
          }
        }

        // Online softmax: new row max over the quad, rescale, exponentiate.
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[mt][n][0], s[mt][n][1]));
          mx1 = fmaxf(mx1, fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        mx0 = fmaxf(m_run[mt][0], quad_max(mx0));
        mx1 = fmaxf(m_run[mt][1], quad_max(mx1));
        const float base0 = mx0 == -INFINITY ? 0.f : mx0;  // a row with no key yet
        const float base1 = mx1 == -INFINITY ? 0.f : mx1;
        const float alpha0 = fast_exp2(m_run[mt][0] - base0);
        const float alpha1 = fast_exp2(m_run[mt][1] - base1);
        m_run[mt][0] = mx0;
        m_run[mt][1] = mx1;
        l_run[mt][0] *= alpha0;
        l_run[mt][1] *= alpha1;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[mt][n][0] *= alpha0;
          acc[mt][n][1] *= alpha0;
          acc[mt][n][2] *= alpha1;
          acc[mt][n][3] *= alpha1;
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          s[mt][n][0] = fast_exp2(s[mt][n][0] - base0);
          s[mt][n][1] = fast_exp2(s[mt][n][1] - base0);
          s[mt][n][2] = fast_exp2(s[mt][n][2] - base1);
          s[mt][n][3] = fast_exp2(s[mt][n][3] - base1);
          l_run[mt][0] += s[mt][n][0] + s[mt][n][1];
          l_run[mt][1] += s[mt][n][2] + s[mt][n][3];
        }
      }

      // acc += P V, P rounded to bf16 straight from the logit registers;
      // each V fragment feeds all MT row tiles.
      const bf16* v_frag = sV + v_offset<LD>(lane);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, v_frag + kk * 16 * LD + n * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][n], a[mt], bv[0], bv[1]);
            mma_bf16(acc[mt][n + 1], a[mt], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // Normalise; a row with no valid key has l == 0 and a zero accumulator.
  // Every copy has landed and every warp has left the loop, and no other
  // warp reads this warp's Q rows: stage the bf16 tile there.
  bf16* tile = sQ + warp * L::WQ * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float l0 = quad_sum(l_run[mt][0]);
    const float l1 = quad_sum(l_run[mt][1]);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    bf16* rows = tile + (mt * 16 + g) * LD;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(rows + col) =
          pack_bf16(acc[mt][n][0] * inv0, acc[mt][n][1] * inv0);
      *reinterpret_cast<uint32_t*>(rows + 8 * LD + col) =
          pack_bf16(acc[mt][n][2] * inv1, acc[mt][n][3] * inv1);
    }
  }
  __syncwarp();
  constexpr int CHUNKS = HD / 8;
#pragma unroll
  for (int it = 0; it < L::WQ * CHUNKS / 32; ++it) {
    const int i = it * 32 + lane;
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int s = wq0 + r;
    if (s < S) {
      *reinterpret_cast<uint4*>(o + (size_t)b * S * q_stride + (size_t)s * q_stride +
                                (size_t)h * HD + c) =
          *reinterpret_cast<const uint4*>(tile + r * LD + c);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* lengths, const int* starts, int B, int S, int H, int KV,
           float scale, float softcap, int window, int causal,
           cudaStream_t stream) {
  using L = Layout<HD>;
  // The shared-memory limit is kept per device context: set it once per
  // device, so that a later launch holds only stream work and can be
  // captured into a CUDA graph.
  static std::atomic<int> attr_set[kMaxDevices];
  const cudaError_t attr_err = ensure_smem_limit(
      (const void*)flash_fwd_kernel<HD>, (int)L::BYTES, attr_set);
  if (attr_err != cudaSuccess) return (int)attr_err;
  dim3 grid((unsigned)(B * H), (unsigned)((S + L::BQ - 1) / L::BQ));
  flash_fwd_kernel<HD><<<grid, L::THREADS, L::BYTES, stream>>>(
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
