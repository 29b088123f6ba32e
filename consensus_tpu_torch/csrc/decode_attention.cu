// Decode attention for Hopper (sm_90a): one new query position per
// (slot x role) row against its role's trunk, shared by every slot, plus the
// row's own tail.  bf16 in, fp32 softmax and accumulation, bf16 out.
//
// Replaces consensus_tpu/ops/decode_attention.py::decode_attention (the
// Pallas TPU kernel, _kernel :51-146, pallas_call :245).  Same function:
// row p*R + r (slot-major) reads trunk (R, W0, KV, hd) of role r, valid on
// [start_r, W0), and tail (Rows, Ts, KV, hd) row p*R + r, valid on columns
// <= write_col; GQA (q head h reads kv head h / (H/KV)); optional softcap
// before the mask; optional window, which keeps trunk column c while
// qpos_r - (c - start_r) < window and tail column j while
// write_col - j < window; a row with no valid key writes zeros.  Any
// number of slots: the query rows of a (role, kv head) group, n_slots x
// (H/KV) of them, are cut into 16-row tiles.
//
// What bounds it on an H100 (SXM data sheet: 3.35 TB/s, 989 TFLOP/s dense
// bf16): bytes.  Each launch must read q, write out, read each role's trunk
// K/V over its valid span ONCE, and each row's tail K/V over columns
// 0..write_col; the work is 4*hd FLOPs per (row, head, key), far below the
// bf16 rate's share.  At the llama3-8b beam shape (P=4, R=6, H=32, KV=8,
// hd=128, W0=1024, Ts=200) that is ~10-30 MB, a few microseconds, so what
// the design fights is latency: short serial chains and many blocks.
//
// Design (see sm90_mma.cuh for the fragment layouts):
//  * No fold, pad or concatenate: the kernel reads the strided per-layer
//    cache views in place.
//  * Pass 1, grid (R*KV, n_trunk_chunks + P * n_tail_chunks, row tiles).
//    Blocks y < n_trunk_chunks own one chunk of keys of the trunk of
//    (role, kv head) and one 16-row tile of ALL the group's P*reps query
//    rows, so a trunk tile is read once per row tile (once in all when
//    P*reps <= 16, as at the beam shape).  The other blocks own one chunk
//    of one slot's tail and that slot's reps rows (padded to 16): a row
//    reads only its own slot's tail.  Masks are contiguous key ranges, so
//    a block walks only [lo, hi) of its chunk.  The chunk is the wrapper's
//    KEY_CHUNK, 256 keys: at most four 64-key tiles a block, and at the beam
//    shape ~300 blocks that hold keys on the 132 SMs (256 measured faster
//    than 64 or 128: fewer partials to write and merge).
//  * Inside a block, K and V tiles of 16 keys per warp come through a
//    two-stage cp.async ring.  Each warp runs Q.K^T and P.V for its 16 keys
//    on mma.sync m16n8k16 (the 16 query rows are M), with the online
//    softmax in registers and P handed to P.V as bf16 A fragments, as in
//    flash_attention.cu.  The warps' partials merge in shared memory and
//    the block writes one fp32 partial (m, l, acc) per row to scratch.
//  * Pass 2, a second kernel, merges a row's partials and writes acc / l
//    in bf16, one warp per row.  (Merging inside pass 1 instead -- the last
//    block of each group, found by an atomic ticket, merges the group's
//    rows -- measured slower at the beam shape and with 16 slots: one block
//    per group merges while the rest of the card idles.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

using namespace sm90;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Layout {
  static constexpr int WARPS = HD == 128 ? 4 : 2;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BK = 16 * WARPS;  // keys per tile: 16 per warp
  static constexpr int LD = HD + 8;      // bf16 per shared-memory row
  static constexpr int LDO = HD + 8;     // fp32 per row of a warp's partial
  static constexpr int Q_ELEMS = 16 * LD;
  static constexpr int KV_ELEMS = BK * LD;
  // Q, then stage 0 (K, V), then stage 1 (K, V); the stages hold the
  // warps' partial accumulators after the key loop.
  static constexpr size_t BYTES = (size_t)(Q_ELEMS + 4 * KV_ELEMS) * sizeof(bf16);
  static_assert((size_t)WARPS * 16 * LDO * sizeof(float) <= 4 * KV_ELEMS * sizeof(bf16),
                "warp partials do not fit in the K/V stages");
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  const bf16 *q, *trunk_k, *trunk_v, *tail_k, *tail_v;
  const int *starts, *qpos;
  float *part_ml, *part_acc;
  bf16* out;
  int P, R, H, KV, W0, Ts, write_col, n_trunk, n_tail, chunk;
  float scale, softcap;
  int window;
};

// Pass 2, one warp per query row i of group g: the splits that saw a key
// weigh in with exp2(m - max m), and the row is acc / l in bf16.
template <int HD>
__global__ void __launch_bounds__(128) decode_combine_kernel(const Args a) {
  const int g = blockIdx.x;
  const int i = blockIdx.y * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int VEC = HD / 32;  // output columns per lane
  const int reps = a.H / a.KV;
  const int rows = a.P * reps;
  if (i >= rows) return;  // warp-uniform
  const int n_splits = a.n_trunk + a.n_tail;
  const float2* ml = reinterpret_cast<const float2*>(a.part_ml) + (size_t)g * n_splits * rows;
  const float* acc = a.part_acc + (size_t)g * n_splits * rows * HD;

  float m_max = -INFINITY;
  for (int s = lane; s < n_splits; s += 32) {
    const float2 e = ml[(size_t)s * rows + i];
    if (e.y > 0.f) m_max = fmaxf(m_max, e.x);
  }
  m_max = warp_max(m_max);

  float o[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) o[v] = 0.f;
  float l_sum = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += 32) {
    float w = 0.f;
    if (s0 + lane < n_splits) {
      const float2 e = ml[(size_t)(s0 + lane) * rows + i];
      if (e.y > 0.f) {
        w = fast_exp2(e.x - m_max);
        l_sum += e.y * w;
      }
    }
    const int n = min(32, n_splits - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      if (wj > 0.f) {  // warp-uniform; empty splits wrote no acc
        const float* src = acc + ((size_t)(s0 + j) * rows + i) * HD + lane * VEC;
#pragma unroll
        for (int v = 0; v < VEC; v += 4) {
          const float4 x = *reinterpret_cast<const float4*>(src + v);
          o[v] += x.x * wj;
          o[v + 1] += x.y * wj;
          o[v + 2] += x.z * wj;
          o[v + 3] += x.w * wj;
        }
      }
    }
  }
  l_sum = warp_sum(l_sum);
  const float inv = l_sum > 0.f ? 1.f / l_sum : 0.f;

  const int r = g / a.KV;
  const int kvh = g % a.KV;
  const int p = i / reps;
  const int m = i % reps;
  bf16* dst = a.out + (((size_t)p * a.R + r) * a.H + kvh * reps + m) * HD + lane * VEC;
#pragma unroll
  for (int v = 0; v < VEC; v += 4) {
    uint2 packed;
    packed.x = pack_bf16(o[v] * inv, o[v + 1] * inv);
    packed.y = pack_bf16(o[v + 2] * inv, o[v + 3] * inv);
    *reinterpret_cast<uint2*>(dst + v) = packed;
  }
}

// Pass 1, one block: the partial (m, l, acc) of its rows over its keys.
template <int HD>
__global__ void __launch_bounds__(Layout<HD>::THREADS)
decode_partial_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Layout<HD>;
  constexpr int BK = L::BK;
  constexpr int LD = L::LD;
  constexpr int NO = HD / 8;
  __shared__ float s_ml[L::WARPS][16][2];
  __shared__ float s_wgt[L::WARPS][16];
  bf16* sQ = reinterpret_cast<bf16*>(smem);

  const int g = blockIdx.x;  // role * KV + kv head
  const int r = g / a.KV;
  const int kvh = g % a.KV;
  const int reps = a.H / a.KV;
  const int group_rows = a.P * reps;
  const int n_splits = a.n_trunk + a.n_tail;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t = lane % 4;

  // The key range [lo, hi) this block owns, and its query rows: group rows
  // row0 .. row0 + nrows - 1 (row i = slot i / reps, q head kvh*reps + i % reps).
  int lo, hi, row0, nrows, split;
  const bf16* kbase;
  const bf16* vbase;
  if ((int)blockIdx.y < a.n_trunk) {
    const int start = a.starts[r];
    lo = max(start, (int)blockIdx.y * a.chunk);
    hi = min(a.W0, ((int)blockIdx.y + 1) * a.chunk);
    if (a.window > 0) lo = max(lo, a.qpos[r] + start - a.window + 1);
    const size_t off = ((size_t)r * a.W0 * a.KV + kvh) * HD;
    kbase = a.trunk_k + off;
    vbase = a.trunk_v + off;
    row0 = blockIdx.z * 16;
    nrows = min(16, group_rows - row0);
    split = blockIdx.y;
  } else {
    const int y = blockIdx.y - a.n_trunk;
    const int p = y / a.n_tail;
    const int j = y % a.n_tail;
    lo = j * a.chunk;
    hi = min((j + 1) * a.chunk, a.write_col + 1);
    if (a.window > 0) lo = max(lo, a.write_col - a.window + 1);
    const size_t tail_row = (size_t)p * a.R + r;
    const size_t off = (tail_row * a.Ts * a.KV + kvh) * HD;
    kbase = a.tail_k + off;
    vbase = a.tail_v + off;
    row0 = p * reps + blockIdx.z * 16;
    nrows = min(16, reps - (int)blockIdx.z * 16);
    split = a.n_trunk + j;
  }
  if (nrows <= 0) return;  // a row tile past this block's rows
  float2* ml_out = reinterpret_cast<float2*>(a.part_ml) + ((size_t)g * n_splits + split) * group_rows;
  float* acc_out = a.part_acc + ((size_t)g * n_splits + split) * group_rows * HD;
  if (lo >= hi) {  // uniform: nothing of this chunk is valid
    if (threadIdx.x < nrows) ml_out[row0 + threadIdx.x] = make_float2(-INFINITY, 0.f);
    return;
  }

  // Q rows (zero past nrows), then the first K/V tile.
  const size_t kstride = (size_t)a.KV * HD;
  {
    constexpr int CHUNKS = HD / 8;
    for (int idx = threadIdx.x; idx < 16 * CHUNKS; idx += L::THREADS) {
      const int i = idx / CHUNKS;
      const int c = (idx % CHUNKS) * 8;
      const int qr = row0 + min(i, nrows - 1);
      const bf16* src = a.q + (((size_t)(qr / reps) * a.R + r) * a.H + kvh * reps + qr % reps) * HD + c;
      cp_async_16(sQ + i * LD + c, src, i < nrows);
    }
  }
  bf16* stages = sQ + L::Q_ELEMS;
  load_rows<HD, BK, L::THREADS>(stages, kbase, kstride, lo, hi);
  load_rows<HD, BK, L::THREADS>(stages + L::KV_ELEMS, vbase, kstride, lo, hi);
  cp_async_commit();

  const bool capped = a.softcap > 0.f;
  const float scale_log2 = a.scale * LOG2E;
  const float cap_in = capped ? a.scale / a.softcap : 0.f;
  const float cap_out = a.softcap * LOG2E;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const bf16* q_frag = sQ + a_offset<LD>(lane);
  const int n_tiles = (hi - lo + BK - 1) / BK;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const bf16* sK = stages + stage * 2 * L::KV_ELEMS;
    const bf16* sV = sK + L::KV_ELEMS;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      bf16* nK = stages + (stage ^ 1) * 2 * L::KV_ELEMS;
      load_rows<HD, BK, L::THREADS>(nK, kbase, kstride, lo + (it + 1) * BK, hi);
      load_rows<HD, BK, L::THREADS>(nK + L::KV_ELEMS, vbase, kstride, lo + (it + 1) * BK, hi);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int wk0 = lo + it * BK + warp * 16;  // this warp's 16 keys
    if (wk0 < hi) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bf16* k_frag = sK + warp * 16 * LD + kt_offset<LD>(lane);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4], kb[4];
        ldmatrix_x4(qa, q_frag + kk * 16);
        ldmatrix_x4(kb, k_frag + kk * 16);
        mma_bf16(s[0], qa, kb[0], kb[1]);
        mma_bf16(s[1], qa, kb[2], kb[3]);
      }

      const bool edge = wk0 + 16 > hi;  // only the last tile can be cut
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = capped ? cap_out * tanhf(s[n][e] * cap_in) : s[n][e] * scale_log2;
          if (edge && wk0 + n * 8 + 2 * t + (e & 1) >= hi) x = -INFINITY;
          s[n][e] = x;
        }
      }

      float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
      float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
      mx0 = fmaxf(m_run[0], quad_max(mx0));
      mx1 = fmaxf(m_run[1], quad_max(mx1));
      const float base0 = mx0 == -INFINITY ? 0.f : mx0;
      const float base1 = mx1 == -INFINITY ? 0.f : mx1;
      const float alpha0 = fast_exp2(m_run[0] - base0);
      const float alpha1 = fast_exp2(m_run[1] - base1);
      m_run[0] = mx0;
      m_run[1] = mx1;
      l_run[0] *= alpha0;
      l_run[1] *= alpha1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] = fast_exp2(s[n][0] - base0);
        s[n][1] = fast_exp2(s[n][1] - base0);
        s[n][2] = fast_exp2(s[n][2] - base1);
        s[n][3] = fast_exp2(s[n][3] - base1);
        l_run[0] += s[n][0] + s[n][1];
        l_run[1] += s[n][2] + s[n][3];
      }

      uint32_t pa[4];
      pa[0] = pack_bf16(s[0][0], s[0][1]);
      pa[1] = pack_bf16(s[0][2], s[0][3]);
      pa[2] = pack_bf16(s[1][0], s[1][1]);
      pa[3] = pack_bf16(s[1][2], s[1][3]);
      const bf16* v_frag = sV + warp * 16 * LD + v_offset<LD>(lane);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_frag + n * 8);
        mma_bf16(acc[n], pa, vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // Merge the warps' partials through shared memory (the K/V stages are
  // free now), then write the block's partial of its rows.
  float* s_acc = reinterpret_cast<float*>(stages) + warp * 16 * L::LDO;
  const float l0 = quad_sum(l_run[0]);
  const float l1 = quad_sum(l_run[1]);
  if (t == 0) {
    s_ml[warp][gq][0] = m_run[0];
    s_ml[warp][gq][1] = l0;
    s_ml[warp][gq + 8][0] = m_run[1];
    s_ml[warp][gq + 8][1] = l1;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(s_acc + gq * L::LDO + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(s_acc + (gq + 8) * L::LDO + col) = make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    const int i = threadIdx.x;
    float m_blk = -INFINITY;
#pragma unroll
    for (int w = 0; w < L::WARPS; ++w) m_blk = fmaxf(m_blk, s_ml[w][i][0]);
    const float base = m_blk == -INFINITY ? 0.f : m_blk;
    float l_blk = 0.f;
#pragma unroll
    for (int w = 0; w < L::WARPS; ++w) {
      const float wgt = fast_exp2(s_ml[w][i][0] - base);
      s_wgt[w][i] = wgt;
      l_blk += s_ml[w][i][1] * wgt;
    }
    if (i < nrows) ml_out[row0 + i] = make_float2(m_blk, l_blk);
  }
  __syncthreads();
  const float* s_all = reinterpret_cast<const float*>(stages);
  for (int idx = threadIdx.x; idx < nrows * HD; idx += L::THREADS) {
    const int i = idx / HD;
    const int d = idx % HD;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < L::WARPS; ++w) sum += s_all[(w * 16 + i) * L::LDO + d] * s_wgt[w][i];
    acc_out[(size_t)(row0 + i) * HD + d] = sum;
  }
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<HD>;
  // The shared-memory limit is kept per device context: set it once per
  // device, so that a later launch holds only stream work and can be
  // captured into a CUDA graph.
  static std::atomic<int> attr_set[kMaxDevices];
  const cudaError_t attr_err = ensure_smem_limit(
      (const void*)decode_partial_kernel<HD>, (int)L::BYTES, attr_set);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int rows = a.P * (a.H / a.KV);
  dim3 grid1((unsigned)(a.R * a.KV), (unsigned)(a.n_trunk + a.P * a.n_tail),
             (unsigned)((rows + 15) / 16));
  decode_partial_kernel<HD><<<grid1, L::THREADS, L::BYTES, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2((unsigned)(a.R * a.KV), (unsigned)((rows + 3) / 4));
  decode_combine_kernel<HD><<<grid2, 128, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: (P*R, H, hd) bf16; trunk_k/v: (R, W0, KV, hd) bf16; tail_k/v:
// (P*R, Ts, KV, hd) bf16, all contiguous; starts, qpos: (R,) int32 on the
// device.  The trunk splits into n_trunk chunks and the tail columns
// 0..write_col into n_tail chunks of `chunk` keys; part_ml:
// (R*KV, n_trunk+n_tail, P*H/KV, 2) fp32 and part_acc:
// (R*KV, n_trunk+n_tail, P*H/KV, hd) fp32 scratch.  softcap <= 0 and
// window <= 0 switch those features off.  Returns a cudaError_t.
int consensus_decode_attention_fwd(const void* q, const void* trunk_k,
                                   const void* trunk_v, const void* tail_k,
                                   const void* tail_v, const void* starts,
                                   const void* qpos, void* part_ml,
                                   void* part_acc, void* out,
                                   int P, int R, int H, int KV, int head_dim,
                                   int W0, int Ts, int write_col, int n_trunk,
                                   int n_tail, int chunk, float scale,
                                   float softcap, int window, void* stream) {
  if (P < 1 || R < 1 || KV < 1 || H % KV != 0 || W0 < 1 || write_col < 0 ||
      write_col >= Ts || chunk < 1 || n_trunk < 1 || n_tail < 1 ||
      (long long)n_trunk * chunk < W0 || (long long)n_tail * chunk < write_col + 1 ||
      (P * (H / KV) + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{static_cast<const bf16*>(q),       static_cast<const bf16*>(trunk_k),
         static_cast<const bf16*>(trunk_v), static_cast<const bf16*>(tail_k),
         static_cast<const bf16*>(tail_v),  static_cast<const int*>(starts),
         static_cast<const int*>(qpos),     static_cast<float*>(part_ml),
         static_cast<float*>(part_acc),     static_cast<bf16*>(out),
         P, R, H, KV, W0, Ts, write_col, n_trunk, n_tail, chunk,
         scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return launch<128>(a, s);
    case 256:
      return launch<256>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
