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
// write_col - j < window; a row with no valid key writes zeros.
//
// What bounds it on an H100 (SXM data sheet: 3.35 TB/s, 989 TFLOP/s dense
// bf16): bytes.  Each launch must read q, write out, read each role's trunk
// K/V over its valid span ONCE, and each row's tail K/V over columns
// 0..write_col; the work is 4*hd FLOPs per (row, head, key), far below the
// bf16 rate's share.  At the llama3-8b beam shape (P=4, R=6, H=32, KV=8,
// hd=128, W0=1024, Ts=200) that is ~10-20 MB, a few microseconds.
//
// Design (simple and correct first):
//  * No fold, pad or concatenate: the kernel reads the strided per-layer
//    cache views in place.  The Pallas wrapper's fold of trunk + tails into
//    one array would copy more bytes than the kernel reads.
//  * Pass 1, grid (R*KV, n_chunks + P).  Blocks y < n_chunks own one key
//    range of the trunk of (role, kv head) and serve ALL P*reps query rows
//    of that group, so a trunk tile is read once for every slot.  Blocks
//    y >= n_chunks own slot p = y - n_chunks: its reps query rows read only
//    that slot's tail columns (the TPU kernel scored every row against every
//    slot's tail and masked block-diagonally: P times the work).  The masks
//    are contiguous key ranges, so a block only walks [lo, hi).  Splitting
//    the trunk into chunks (flash-decoding) fills the SMs: the natural grid
//    of R*KV groups is ~48 blocks on 132 SMs.
//  * Inside a block, 32-key tiles go through shared memory; Q.K runs on the
//    CUDA cores with one key per lane and the warp's query rows in the same
//    pass (fp32 products of the bf16 values), the online softmax runs on
//    warp shuffles, and P.V keeps the fp32 accumulators in registers, one
//    output column per thread for all rows.  Each block writes its
//    unnormalised partial (m, l, acc) to fp32 scratch.
//  * Pass 2, grid (R*KV, P*reps): merge the partials of a row and write
//    acc / max(l, 1e-30) in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_K = 32;    // keys per tile: one per lane in Q.K
constexpr int MAX_ROWS = 32;  // query rows per (role, kv head)
constexpr float NEG_INF = -1e30f;

// Shared-memory layout for head_dim HD and QPT query-row slots.  Key rows
// are padded by 8 bytes so that the lanes' 8-byte reads of 32 different
// keys hit distinct banks.
template <int HD, int QPT>
struct Layout {
  static constexpr int LDK = HD + 4;   // bf16 key / value rows
  static constexpr int LDP = QPT + 4;  // fp32 probabilities, key-major
  static constexpr size_t Q_BYTES = (size_t)QPT * HD * sizeof(float);
  static constexpr size_t KV_BYTES = (size_t)TILE_K * LDK * sizeof(bf16);
  static constexpr size_t P_BYTES = (size_t)TILE_K * LDP * sizeof(float);
  static constexpr size_t A_BYTES = (size_t)QPT * sizeof(float);
  static constexpr size_t BYTES = Q_BYTES + 2 * KV_BYTES + P_BYTES + A_BYTES;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

__device__ __forceinline__ void bf16x4_to_float(uint2 raw, float out[4]) {
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(pair[0]);
  const float2 b = __bfloat1622float2(pair[1]);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

template <int HD, int QPT>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ trunk_k,
                      const bf16* __restrict__ trunk_v,
                      const bf16* __restrict__ tail_k,
                      const bf16* __restrict__ tail_v,
                      const int* __restrict__ starts, const int* __restrict__ qpos,
                      float* __restrict__ part_ml, float* __restrict__ part_acc,
                      int P, int R, int H, int KV, int W0, int Ts, int write_col,
                      int n_chunks, int chunk, float scale, float softcap,
                      int window) {
  using L = Layout<HD, QPT>;
  constexpr int RPW = QPT / WARPS;   // query rows per warp in Q.K
  constexpr int EPT = HD / THREADS;  // output columns per thread in P.V
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::Q_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::Q_BYTES + L::KV_BYTES);
  float* sP = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES);
  float* sA = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES + L::P_BYTES);

  const int g = blockIdx.x;  // role * KV + kv head
  const int r = g / KV;
  const int kvh = g % KV;
  const int reps = H / KV;
  const int group_rows = P * reps;
  const int n_splits = n_chunks + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The key range [lo, hi) this block owns and the query rows that read it:
  // rows row0 .. row0 + nq - 1 of the group (row i = slot i / reps, query
  // head kvh * reps + i % reps).
  int lo, hi, row0, nq, split;
  const bf16* kbase;
  const bf16* vbase;
  if ((int)blockIdx.y < n_chunks) {
    const int start = starts[r];
    lo = max(start, (int)blockIdx.y * chunk);
    hi = min(W0, ((int)blockIdx.y + 1) * chunk);
    if (window > 0) lo = max(lo, qpos[r] + start - window + 1);
    const size_t off = ((size_t)r * W0 * KV + kvh) * HD;
    kbase = trunk_k + off;
    vbase = trunk_v + off;
    row0 = 0;
    nq = group_rows;
    split = blockIdx.y;
  } else {
    const int p = blockIdx.y - n_chunks;
    lo = 0;
    hi = min(write_col + 1, Ts);
    if (window > 0) lo = max(lo, write_col - window + 1);
    const size_t tail_row = (size_t)p * R + r;
    const size_t off = (tail_row * Ts * KV + kvh) * HD;
    kbase = tail_k + off;
    vbase = tail_v + off;
    row0 = p * reps;
    nq = reps;
    split = n_chunks;
  }
  const size_t kstride = (size_t)KV * HD;
  float* ml_out = part_ml + ((size_t)g * n_splits + split) * group_rows * 2;
  float* acc_out = part_acc + ((size_t)g * n_splits + split) * group_rows * HD;

  if (lo >= hi) {  // uniform across the block: nothing of this range is valid
    for (int i = threadIdx.x; i < nq; i += THREADS) {
      ml_out[(row0 + i) * 2] = NEG_INF;
      ml_out[(row0 + i) * 2 + 1] = 0.f;
    }
    return;
  }

  for (int idx = threadIdx.x; idx < QPT * HD; idx += THREADS) {
    const int i = idx / HD;
    const int d = idx % HD;
    float val = 0.f;
    if (i < nq) {
      const int qr = row0 + i;
      const int p = qr / reps;
      const int m = qr % reps;
      val = __bfloat162float(q[(((size_t)p * R + r) * H + kvh * reps + m) * HD + d]);
    }
    sQ[idx] = val;
  }
  // Rows >= nq keep p = 0 and alpha = 1, so their accumulators stay 0.
  for (int idx = threadIdx.x; idx < TILE_K * L::LDP; idx += THREADS) sP[idx] = 0.f;
  for (int i = threadIdx.x; i < QPT; i += THREADS) sA[i] = 1.f;

  float m_run[RPW];
  float l_run[RPW];
#pragma unroll
  for (int t = 0; t < RPW; ++t) {
    m_run[t] = NEG_INF;
    l_run[t] = 0.f;
  }
  float acc[QPT][EPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = lo; k0 < hi; k0 += TILE_K) {
    const int nk = min(TILE_K, hi - k0);
    __syncthreads();  // the previous tile is consumed; orders the init above

    // K and V tile: 16 bytes per thread-step; keys past hi load as zeros.
    constexpr int VEC = 8;
    constexpr int PER_ROW = HD / VEC;
    for (int idx = threadIdx.x; idx < TILE_K * PER_ROW; idx += THREADS) {
      const int j = idx / PER_ROW;
      const int c = (idx % PER_ROW) * VEC;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = make_uint4(0u, 0u, 0u, 0u);
      if (j < nk) {
        kx = *reinterpret_cast<const uint4*>(kbase + (size_t)(k0 + j) * kstride + c);
        vx = *reinterpret_cast<const uint4*>(vbase + (size_t)(k0 + j) * kstride + c);
      }
      uint2* kd = reinterpret_cast<uint2*>(sK + j * L::LDK + c);
      uint2* vd = reinterpret_cast<uint2*>(sV + j * L::LDK + c);
      kd[0] = make_uint2(kx.x, kx.y);
      kd[1] = make_uint2(kx.z, kx.w);
      vd[0] = make_uint2(vx.x, vx.y);
      vd[1] = make_uint2(vx.z, vx.w);
    }
    __syncthreads();

    // Q.K: lane j scores key k0 + j against rows warp, warp + WARPS, ...
    float s[RPW];
#pragma unroll
    for (int t = 0; t < RPW; ++t) s[t] = 0.f;
    const bf16* krow = sK + lane * L::LDK;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float kf[4];
      bf16x4_to_float(*reinterpret_cast<const uint2*>(krow + d), kf);
#pragma unroll
      for (int t = 0; t < RPW; ++t) {
        if (warp + WARPS * t < nq) {  // warp-uniform
          const float4 qv =
              *reinterpret_cast<const float4*>(sQ + (warp + WARPS * t) * HD + d);
          s[t] += qv.x * kf[0] + qv.y * kf[1] + qv.z * kf[2] + qv.w * kf[3];
        }
      }
    }

    // Online softmax over the tile's keys, one row per warp at a time.
    const bool valid = lane < nk;
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int i = warp + WARPS * t;
      if (i < nq) {  // warp-uniform, so the shuffles see every lane
        float x = s[t] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const float m_new = fmaxf(m_run[t], warp_max(valid ? x : NEG_INF));
        const float pj = valid ? expf(x - m_new) : 0.f;
        const float alpha = expf(m_run[t] - m_new);
        l_run[t] = l_run[t] * alpha + warp_sum(pj);
        m_run[t] = m_new;
        sP[lane * L::LDP + i] = pj;
        if (lane == 0) sA[i] = alpha;
      }
    }
    __syncthreads();

    // P.V: thread owns output columns threadIdx.x + e * THREADS of every row.
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const float a = sA[i];
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[i][e] *= a;
    }
    for (int j = 0; j < nk; ++j) {
      float v[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        v[e] = __bfloat162float(sV[j * L::LDK + threadIdx.x + e * THREADS]);
      }
      const float* prow = sP + j * L::LDP;
#pragma unroll
      for (int i4 = 0; i4 < QPT; i4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(prow + i4);
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          acc[i4][e] += p4.x * v[e];
          acc[i4 + 1][e] += p4.y * v[e];
          acc[i4 + 2][e] += p4.z * v[e];
          acc[i4 + 3][e] += p4.w * v[e];
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < RPW; ++t) {
    const int i = warp + WARPS * t;
    if (i < nq && lane == 0) {
      ml_out[(row0 + i) * 2] = m_run[t];
      ml_out[(row0 + i) * 2 + 1] = l_run[t];
    }
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    if (i < nq) {
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        acc_out[(size_t)(row0 + i) * HD + threadIdx.x + e * THREADS] = acc[i][e];
      }
    }
  }
}

// Merge the n_chunks + 1 partials of one query row; partials with l == 0
// (an empty key range) carry no acc and are skipped.
template <int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc, bf16* __restrict__ out,
                      int P, int R, int H, int KV, int n_splits) {
  const int g = blockIdx.x;
  const int i = blockIdx.y;
  const int d = threadIdx.x;
  const int r = g / KV;
  const int kvh = g % KV;
  const int reps = H / KV;
  const int group_rows = P * reps;
  const float* ml = part_ml + (size_t)g * n_splits * group_rows * 2;

  float m_max = NEG_INF;
  for (int s = 0; s < n_splits; ++s) {
    const float* e = ml + ((size_t)s * group_rows + i) * 2;
    if (e[1] > 0.f) m_max = fmaxf(m_max, e[0]);
  }
  float l_sum = 0.f;
  float o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* e = ml + ((size_t)s * group_rows + i) * 2;
    if (e[1] > 0.f) {
      const float w = expf(e[0] - m_max);
      l_sum += e[1] * w;
      o += part_acc[(((size_t)g * n_splits + s) * group_rows + i) * HD + d] * w;
    }
  }
  const int p = i / reps;
  const int m = i % reps;
  out[(((size_t)p * R + r) * H + kvh * reps + m) * HD + d] =
      __float2bfloat16(o / fmaxf(l_sum, 1e-30f));
}

struct Args {
  const bf16 *q, *trunk_k, *trunk_v, *tail_k, *tail_v;
  const int *starts, *qpos;
  float *part_ml, *part_acc;
  bf16* out;
  int P, R, H, KV, W0, Ts, write_col, n_chunks;
  float scale, softcap;
  int window;
};

template <int HD, int QPT>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Layout<HD, QPT>::BYTES;
  // Once per instantiation (a thread-safe static), so that a launch holds
  // only stream work and can be captured into a CUDA graph.
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      decode_partial_kernel<HD, QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  cudaError_t err;
  const int chunk = (a.W0 + a.n_chunks - 1) / a.n_chunks;
  dim3 grid1((unsigned)(a.R * a.KV), (unsigned)(a.n_chunks + a.P));
  decode_partial_kernel<HD, QPT><<<grid1, THREADS, smem, stream>>>(
      a.q, a.trunk_k, a.trunk_v, a.tail_k, a.tail_v, a.starts, a.qpos, a.part_ml,
      a.part_acc, a.P, a.R, a.H, a.KV, a.W0, a.Ts, a.write_col, a.n_chunks, chunk,
      a.scale, a.softcap, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2((unsigned)(a.R * a.KV), (unsigned)(a.P * (a.H / a.KV)));
  decode_combine_kernel<HD><<<grid2, HD, 0, stream>>>(
      a.part_ml, a.part_acc, a.out, a.P, a.R, a.H, a.KV, a.n_chunks + 1);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_rows(const Args& a, cudaStream_t stream) {
  const int rows = a.P * (a.H / a.KV);
  if (rows <= 4) return launch<HD, 4>(a, stream);
  if (rows <= 8) return launch<HD, 8>(a, stream);
  if (rows <= 16) return launch<HD, 16>(a, stream);
  return launch<HD, MAX_ROWS>(a, stream);
}

}  // namespace

extern "C" {

// q, out: (P*R, H, hd) bf16; trunk_k/v: (R, W0, KV, hd) bf16; tail_k/v:
// (P*R, Ts, KV, hd) bf16, all contiguous; starts, qpos: (R,) int32 on the
// device; part_ml: (R*KV, n_chunks+1, P*H/KV, 2) fp32 and part_acc:
// (R*KV, n_chunks+1, P*H/KV, hd) fp32 scratch.  softcap <= 0 and
// window <= 0 switch those features off.  Returns a cudaError_t.
int consensus_decode_attention_fwd(const void* q, const void* trunk_k,
                                   const void* trunk_v, const void* tail_k,
                                   const void* tail_v, const void* starts,
                                   const void* qpos, void* part_ml,
                                   void* part_acc, void* out, int P, int R, int H,
                                   int KV, int head_dim, int W0, int Ts,
                                   int write_col, int n_chunks, float scale,
                                   float softcap, int window, void* stream) {
  if (P < 1 || R < 1 || KV < 1 || H % KV != 0 || P * (H / KV) > MAX_ROWS ||
      W0 < 1 || n_chunks < 1 || write_col < 0 || write_col >= Ts) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{static_cast<const bf16*>(q),       static_cast<const bf16*>(trunk_k),
         static_cast<const bf16*>(trunk_v), static_cast<const bf16*>(tail_k),
         static_cast<const bf16*>(tail_v),  static_cast<const int*>(starts),
         static_cast<const int*>(qpos),     static_cast<float*>(part_ml),
         static_cast<float*>(part_acc),     static_cast<bf16*>(out),
         P, R, H, KV, W0, Ts, write_col, n_chunks, scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return launch_rows<128>(a, s);
    case 256:
      return launch_rows<256>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
