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
// number of slots: a block holds at most 64 query rows (whole slots), and
// more slots take more row blocks.
//
// What bounds it on an H100 (SXM data sheet: 3.35 TB/s, 989 TFLOP/s dense
// bf16): bytes.  Each launch must read q, write out, read each role's trunk
// K/V over its valid span ONCE, and each row's tail K/V over columns
// 0..write_col; the work is 4*hd FLOPs per (row, head, key), far below the
// bf16 rate's share.  Most calls move 0.1-30 MB, 0.1-10 microseconds at
// the memory rate, so what the design fights is latency: one launch, short
// serial chains, many blocks, loads in flight from the first cycle.
//
// Design (see sm90_mma.cuh for the fragment layouts, sm90_wgmma.cuh for the
// mbarrier, TMA and cluster PTX):
//  * One launch.  Grid (splits, R*KV, row blocks); the `splits` blocks of one
//    (role, kv head, row block) group form a thread-block cluster
//    (cudaLaunchKernelEx with the cluster dimension; up to 8 blocks, the
//    portable size).  The wrapper chooses `splits` on the host
//    (ops/decode_attention.py::launch_plan) from the grid's groups, a
//    group's key tiles and how many clusters of each size the card holds
//    at once (cudaOccupancyMaxActiveClusters, asked once per device): a
//    cluster needs its blocks on one GPC, so at one block an SM a card
//    holds fewer clusters of s blocks than SMs / s, and a launch past that
//    runs in two waves (measured: about twice the time).
//  * A group's work is a list of key tiles (BK keys: 64 at hd 128, 32 at hd
//    256, 16 KB of K and 16 of V either way): the trunk's valid span [lo, W0)
//    read ONCE for all the group's query rows, then the slots' tail tiles
//    for each slot's rows, tile j of every slot (row tiles in turn, so
//    consecutive tiles go to different warps) before tile j + 1.  Block b of
//    the cluster walks tiles [b*U/splits, (b+1)*U/splits) of the U its group
//    has, so the split follows the valid span the device reads from
//    `starts`, and a block may own none (it still meets the cluster barrier).
//  * Loads: every thread copies a share of Q's rows with cp.async; one
//    producer thread sets the mbarriers and keeps a ring of 4 stages (3 at
//    hd 256 with 64 rows) filled by TMA, a tile as hd / 64 boxes of 64
//    columns x BK keys under 128-byte swizzle, K and V on separate
//    barriers, so Q.K^T starts as soon as K has landed.  The tensor maps are
//    encoded on the host at each call (4 a call; the wrapper's host time
//    per call fell with the scratch allocations gone, PERF.md).  Two other
//    ways measured slower on an H100: cp.async.bulk row copies (one 256- or
//    512-byte request a key), and cp.async from producer warps (one warp
//    kept about one tile in flight an SM; four came closer, still behind
//    TMA where an SM walks many tiles).
//  * 8 consumer warps.  At hd 256 each pair computes the same logits and
//    owns one 128-column half of the output (no warp holds more than 64 fp32
//    sums).  A warp owns one 16-row tile of the group's rows (R16 tiles in
//    all) and a share of each tile's 16-key steps; where a row tile has
//    more warps than a tile has steps, they take alternate tiles ("unit
//    lanes").  Q.K^T and P.V run on mma.sync m16n8k16 with the online
//    softmax in registers and P handed to P.V as bf16 A fragments; K and V
//    fragments come by ldmatrix from the swizzled tiles.  mma.sync, not
//    wgmma: a group has 1-64 query rows, and wgmma's 64-row M would be
//    mostly padding.  With the copies this fast the products are the bound
//    (the kernel without them takes about half the time, PERF.md).
//  * Merge, inside the cluster: each block merges its warps' partials
//    (m, l, acc) in shared memory and stores each block's share of them --
//    8-column chunks of the group's output rows, block b merging chunks
//    [b*N/splits, (b+1)*N/splits) -- straight into that block's shared
//    memory (distributed shared memory), with every row's (m, l), once every
//    block of the cluster has started (a relaxed cluster arrival after the
//    setup, its wait before the first store).  One cluster barrier makes
//    the stores visible; each block then merges its
//    chunks locally and writes bf16 out.  No fp32 scratch in device memory,
//    no second kernel, no read of another block's shared memory after the
//    barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "sm90_mma.cuh"
#include "sm90_wgmma.cuh"

using namespace sm90;

namespace {

constexpr float LOG2E = 1.4426950408889634f;
// Blocks of a cluster: 8, the largest portable cluster size.
constexpr int kMaxSplits = 8;
// Query rows a block holds: four 16-row tiles.
constexpr int kBlockRows = 64;
// Rows of the warps' partials: key groups x row tiles x 16.
constexpr int kPartRows = 128;
template <int HD, int R16>
struct Layout {
  static constexpr int CWARPS = 8;                   // consumer warps
  static constexpr int CPG = CWARPS / (HD / 128);    // of them per 128-column half
  static constexpr int THREADS = 32 * CWARPS + 32;   // and one producer warp
  static constexpr int BK = HD == 128 ? 64 : 32;  // keys per stage
  // Three stages where four and the merge's buffer would not fit.
  static constexpr int STAGES = HD == 256 && R16 == 4 ? 3 : 4;
  static constexpr int LD = HD + 8;   // bf16 per row of Q in shared memory
  static constexpr int LDP = HD + 8;  // fp32 per row of a partial
  static constexpr int ROWS = 16 * R16;
  static constexpr int NSUB = BK / 16;  // 16-key steps of a tile
  // The CPG warps of a column half: R16 row tiles x KG key groups; a key
  // group is a share KGS of a tile's steps in one of UL unit lanes (lane l
  // takes the tiles it with it % UL == l).
  static constexpr int KG = CPG / R16;
  static constexpr int KGS = KG < NSUB ? KG : NSUB;
  static constexpr int UL = KG / KGS;
  static constexpr int NSW = NSUB / KGS;  // 16-key steps a warp takes per tile
  static constexpr int PART_ROWS = KG * ROWS;
  static constexpr int Q_ELEMS = ROWS * LD;
  // A K or V tile as TMA writes it: HD / 64 chunks of BK rows x 128 bytes,
  // 128-byte swizzle (16-byte piece c of row r at (c ^ (r % 8)) * 16).
  static constexpr int CHUNK_BYTES = BK * 128;
  static constexpr int TILE_BYTES = BK * HD * 2;
  static constexpr size_t RING_BYTES = (size_t)STAGES * 2 * TILE_BYTES;
  // The merge's receive buffer: the cluster's blocks' partials of this
  // block's 8-column chunks of the output, 32 bytes a chunk.
  static constexpr size_t RECV_BYTES = (size_t)(ROWS * HD / 8 + kMaxSplits) * 32;
  // The swizzle repeats every 1024 bytes: the ring starts on 1024, after up
  // to 1023 bytes of slack.
  static constexpr size_t BYTES =
      1024 + RING_BYTES + (size_t)Q_ELEMS * sizeof(bf16) + RECV_BYTES;
  static_assert(R16 == 1 || R16 == 2 || R16 == 4, "a block holds 1, 2 or 4 row tiles");
  static_assert(KGS * NSW == NSUB && KGS * UL == KG, "warps do not split the tiles evenly");
  // After the key loop the ring holds the warps' partials.
  static_assert(PART_ROWS <= kPartRows, "too many partial rows");
  static_assert((size_t)PART_ROWS * LDP * sizeof(float) <= RING_BYTES,
                "the warps' partials do not fit in the ring");
};

struct Args {
  const bf16 *q, *trunk_k, *trunk_v, *tail_k, *tail_v;
  const int *starts, *qpos;
  bf16* out;
  int P, R, H, KV, W0, Ts, write_col, splits, slots_per_block;
  float scale, softcap;
  int window;
};

// What one block's group reads: its role and kv head, its slots and rows,
// the trunk's valid span in tiles and each slot's tail span in tiles.
struct Span {
  int r, kvh, reps, p0, rows, tile_slots;
  int trunk_lo, n_trunk, tail_lo, n_tail;
};

template <int BK>
__device__ __forceinline__ Span span_of(const Args& a) {
  Span s;
  s.r = blockIdx.y / a.KV;
  s.kvh = blockIdx.y % a.KV;
  s.reps = a.H / a.KV;
  s.p0 = blockIdx.z * a.slots_per_block;
  s.rows = min(a.slots_per_block, a.P - s.p0) * s.reps;
  s.tile_slots = max(1, 16 / s.reps);  // slots a 16-row tile holds
  const int start = a.starts[s.r];
  int lo = max(start, 0);
  if (a.window > 0) lo = max(lo, a.qpos[s.r] + start - a.window + 1);
  s.trunk_lo = lo;
  s.n_trunk = lo < a.W0 ? (a.W0 - lo + BK - 1) / BK : 0;
  s.tail_lo = a.window > 0 ? max(0, a.write_col - a.window + 1) : 0;
  s.n_tail = (a.write_col + 1 - s.tail_lo + BK - 1) / BK;
  return s;
}

// tanh(x) = 1 - 2 / (1 + e^2x) on the special-function unit: absolute error
// ~1e-6, which the softcap (50 for gemma2) turns into ~5e-5 of a logit.
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, 1.f + fast_exp2(2.f * LOG2E * x));
}

// One key tile: keys [k0, k1) of the trunk's role `outer` or of the tail's
// row `outer`, for the group's rows [row_lo, row_hi).
struct Unit {
  bool trunk;
  int outer, k0, k1, row_lo, row_hi;
};

// The q-th slot of the block in an order that takes the row tiles in turn
// (slot 0 of row tile 0, of row tile 1, ..., then slot 1 of each), so that
// consecutive tail tiles go to different consumer warps.
__device__ __forceinline__ int slot_in_turn(int q, int slots, int tile_slots) {
  const int tiles = (slots + tile_slots - 1) / tile_slots;
  const int last = slots - (tiles - 1) * tile_slots;  // slots of the last row tile
  if (q < last * tiles) return (q % tiles) * tile_slots + q / tiles;
  q -= last * tiles;
  return (q % (tiles - 1)) * tile_slots + last + q / (tiles - 1);
}

// Tile u of the group: the trunk's tiles first, then the slots' tail tiles,
// tile j of every slot (in turn) before tile j + 1.
template <int BK>
__device__ __forceinline__ Unit unit_of(const Args& a, const Span& s, int u) {
  Unit t;
  if (u < s.n_trunk) {
    t.trunk = true;
    t.outer = s.r;
    t.k0 = s.trunk_lo + u * BK;
    t.k1 = min(t.k0 + BK, a.W0);
    t.row_lo = 0;
    t.row_hi = s.rows;
  } else {
    const int v = u - s.n_trunk;
    const int slots = s.rows / s.reps;
    const int sl = slot_in_turn(v % slots, slots, s.tile_slots);
    const int slot = s.p0 + sl;
    const size_t tail_row = (size_t)slot * a.R + s.r;
    t.trunk = false;
    t.outer = (int)tail_row;
    t.k0 = s.tail_lo + (v / slots) * BK;
    t.k1 = min(t.k0 + BK, a.write_col + 1);
    t.row_lo = sl * s.reps;
    t.row_hi = t.row_lo + s.reps;
  }
  return t;
}

template <int HD, int R16>
__global__ void __launch_bounds__(Layout<HD, R16>::THREADS, 1)
decode_attention_kernel(const __grid_constant__ CUtensorMap tm_trunk_k,
                        const __grid_constant__ CUtensorMap tm_trunk_v,
                        const __grid_constant__ CUtensorMap tm_tail_k,
                        const __grid_constant__ CUtensorMap tm_tail_v, const Args a) {
  using L = Layout<HD, R16>;
  constexpr int BK = L::BK;
  constexpr int LD = L::LD;
  constexpr int LDP = L::LDP;
  constexpr int STAGES = L::STAGES;
  constexpr int KG = L::KG;
  constexpr int KGS = L::KGS;
  constexpr int UL = L::UL;
  constexpr int NSW = L::NSW;
  constexpr int CTHREADS = 32 * L::CWARPS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // full K, full V and empty per stage, then Q's barrier.
  __shared__ __align__(8) uint64_t bars[3 * STAGES + 1];
  __shared__ float2 s_ml[kPartRows];    // (m, l) per key group x row tile row
  __shared__ float2 s_recv_ml[kMaxSplits][kBlockRows];  // every block's (m, l) per row
  __shared__ float s_w[kBlockRows][kMaxSplits];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring_addr = (raw + 1023) & ~1023u;
  unsigned char* ring = smem_raw + (ring_addr - raw);
  bf16* sQ = reinterpret_cast<bf16*>(ring + L::RING_BYTES);
  float* recv = reinterpret_cast<float*>(ring + L::RING_BYTES + L::Q_ELEMS * sizeof(bf16));
  float* part = reinterpret_cast<float*>(ring);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Span sp = span_of<BK>(a);
  const uint32_t bar0 = smem_addr(bars);
  const uint32_t bar_q = bar0 + 8 * (3 * STAGES);
  // Barrier addresses: full K of stage s, full V, empty.
#define FULL_K(s) (bar0 + 8 * (s))
#define FULL_V(s) (bar0 + 8 * (STAGES + (s)))
#define EMPTY(s) (bar0 + 8 * (2 * STAGES + (s)))

  const int n_units = sp.n_trunk + (sp.rows / sp.reps) * sp.n_tail;
  const int rank = (int)cluster_rank();
  // 32-bit arithmetic throughout (a 64-bit division is a long software
  // routine): tiles, chunks and splits are far below 2^31 / 8.
  const int u0 = rank * n_units / a.splits;
  const int u1 = (rank + 1) * n_units / a.splits;

  // Tile it of this block (unit u0 + it) into its stage, by TMA: a K or V
  // tile as HD / 64 boxes of 64 columns x BK keys (keys past the tensor's
  // end load as zeros; those past the span are masked).
  auto issue = [&](int it) {
    const int stage = it % STAGES;
    const Unit t = unit_of<BK>(a, sp, u0 + it);
    const uint32_t k_dst = ring_addr + stage * 2 * L::TILE_BYTES;
    const uint32_t v_dst = k_dst + L::TILE_BYTES;
    const CUtensorMap* map_k = t.trunk ? &tm_trunk_k : &tm_tail_k;
    const CUtensorMap* map_v = t.trunk ? &tm_trunk_v : &tm_tail_v;
    mbar_expect_tx(FULL_K(stage), L::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_4d(k_dst + c * L::CHUNK_BYTES, map_k, FULL_K(stage), c * 64, sp.kvh, t.k0,
                  t.outer);
    }
    mbar_expect_tx(FULL_V(stage), L::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_4d(v_dst + c * L::CHUNK_BYTES, map_v, FULL_V(stage), c * 64, sp.kvh, t.k0,
                  t.outer);
    }
  };

  // Q's rows by every thread's cp.async; then the producer's lane 0 sets
  // the barriers and puts the first tiles in flight before the block
  // barrier.
  constexpr int CH = HD / 8;  // 16-byte pieces of a row
#pragma unroll 1
  for (int idx = threadIdx.x; idx < sp.rows * CH; idx += L::THREADS) {
    const int i = idx / CH;
    const int slot = sp.p0 + i / sp.reps;
    const bf16* src =
        a.q + (((size_t)slot * a.R + sp.r) * a.H + sp.kvh * sp.reps + i % sp.reps) * HD;
    cp_async_16(sQ + i * LD + (idx % CH) * 8, src + (idx % CH) * 8, true);
  }
  const bool producer = warp == L::CWARPS && lane == 0;
  if (producer) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(FULL_K(s), 1);
      mbar_init(FULL_V(s), 1);
      mbar_init(EMPTY(s), L::CWARPS / UL);
    }
    mbar_init(bar_q, L::THREADS);
    mbar_fence_init();
    for (int it = 0; it < STAGES && u0 + it < u1; ++it) issue(it);
  }
  __syncthreads();
  mbar_arrive_cp_async(bar_q);
  // This block has started; before its first store into another block's
  // shared memory it waits until every block of the cluster has too.
  cluster_arrive_relaxed();

  if (warp == L::CWARPS) {
    // The producer: the ring's later tiles, each once its stage is free.
    if (producer) {
      for (int it = STAGES; u0 + it < u1; ++it) {
        mbar_wait(EMPTY(it % STAGES), ((it / STAGES) - 1) & 1);
        issue(it);
      }
    }
    __syncwarp();
    cluster_wait();
  } else {
    // A consumer: column half cg, row tile rt, key group kg (unit lane
    // kg / KGS, steps kg % KGS + j * KGS of a tile).
    const int cg = warp / L::CPG;
    const int rt = (warp % L::CPG) % R16;
    const int kg = (warp % L::CPG) / R16;
    const int lane_of_units = kg / KGS;
    const int ks = kg % KGS;
    const int gq = lane / 4;
    const int t = lane % 4;

    // Q's padding rows are zeros (the real ones are in flight).
    for (int idx = threadIdx.x; idx < (L::ROWS - sp.rows) * (HD / 8); idx += CTHREADS) {
      const int row = sp.rows + idx / (HD / 8);
      *reinterpret_cast<uint4*>(sQ + row * LD + (idx % (HD / 8)) * 8) = make_uint4(0, 0, 0, 0);
    }
    named_barrier_sync(1, CTHREADS);

    const bool capped = a.softcap > 0.f;
    const float scale_log2 = a.scale * LOG2E;
    const float cap_in = capped ? a.scale / a.softcap : 0.f;
    const float cap_out = a.softcap * LOG2E;

    float acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    const bf16* q_frag = sQ + rt * 16 * LD + a_offset<LD>(lane);
    mbar_wait(bar_q, 0);

    for (int u = u0, it = 0; u < u1; ++u, ++it) {
      if (it % UL != lane_of_units) continue;
      const int stage = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      const Unit un = unit_of<BK>(a, sp, u);
      const unsigned char* sK = ring + stage * 2 * L::TILE_BYTES;
      const unsigned char* sV = sK + L::TILE_BYTES;
      const bool active = un.row_lo < rt * 16 + 16 && un.row_hi > rt * 16;
      mbar_wait(FULL_K(stage), parity);
      if (active) {
        // At hd 128 with two row tiles, even and odd depth steps sum into
        // separate fragments (two dependent chains of 4 products instead of
        // one of 8); elsewhere the registers are short (ptxas gives a
        // 288-thread block at most 168 a thread).
        constexpr bool SPLIT = HD == 128 && R16 == 2;
        float s[NSW][2][4];
        float s_odd[NSW][2][4];
#pragma unroll
        for (int j = 0; j < NSW; ++j)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][n][e] = s_odd[j][n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t qa[4];
          ldmatrix_x4(qa, q_frag + kk * 16);
#pragma unroll
          for (int j = 0; j < NSW; ++j) {
            const int st = ks + j * KGS;
            if (un.k0 + st * 16 < un.k1) {
              // Keys st*16 + (lane & 7) + 8 * (lane / 16), columns kk*16 +
              // 8 * ((lane / 8) % 2): kt_offset's addresses, swizzled.
              uint32_t kb[4];
              const int piece = ((kk % 4) * 2 + ((lane >> 3) & 1)) ^ (lane & 7);
              ldmatrix_x4(kb, sK + (kk / 4) * L::CHUNK_BYTES +
                                  (st * 16 + (lane & 7) + ((lane >> 4) << 3)) * 128 + piece * 16);
              float(&acc_s)[2][4] = SPLIT && kk % 2 == 1 ? s_odd[j] : s[j];
              mma_bf16(acc_s[0], qa, kb[0], kb[1]);
              mma_bf16(acc_s[1], qa, kb[2], kb[3]);
            }
          }
        }

        // Logits in log2 units; keys past the tile's span and rows outside
        // its rows are masked.
        float mx0 = m_run[0];
        float mx1 = m_run[1];
#pragma unroll
        for (int j = 0; j < NSW; ++j) {
          const int key0 = un.k0 + (ks + j * KGS) * 16;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float dot = s[j][n][e] + s_odd[j][n][e];
              float x = capped ? cap_out * fast_tanh(dot * cap_in) : dot * scale_log2;
              const int key = key0 + n * 8 + 2 * t + (e & 1);
              const int row = rt * 16 + gq + (e >> 1) * 8;
              if (key >= un.k1 || row < un.row_lo || row >= un.row_hi) x = -INFINITY;
              s[j][n][e] = x;
            }
          }
          mx0 = fmaxf(mx0, fmaxf(fmaxf(s[j][0][0], s[j][0][1]), fmaxf(s[j][1][0], s[j][1][1])));
          mx1 = fmaxf(mx1, fmaxf(fmaxf(s[j][0][2], s[j][0][3]), fmaxf(s[j][1][2], s[j][1][3])));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float base0 = mx0 == -INFINITY ? 0.f : mx0;
        const float base1 = mx1 == -INFINITY ? 0.f : mx1;
        const float alpha0 = fast_exp2(m_run[0] - base0);
        const float alpha1 = fast_exp2(m_run[1] - base1);
        m_run[0] = mx0;
        m_run[1] = mx1;
        l_run[0] *= alpha0;
        l_run[1] *= alpha1;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          acc[n][0] *= alpha0;
          acc[n][1] *= alpha0;
          acc[n][2] *= alpha1;
          acc[n][3] *= alpha1;
        }
#pragma unroll
        for (int j = 0; j < NSW; ++j) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            s[j][n][0] = fast_exp2(s[j][n][0] - base0);
            s[j][n][1] = fast_exp2(s[j][n][1] - base0);
            s[j][n][2] = fast_exp2(s[j][n][2] - base1);
            s[j][n][3] = fast_exp2(s[j][n][3] - base1);
            l_run[0] += s[j][n][0] + s[j][n][1];
            l_run[1] += s[j][n][2] + s[j][n][3];
          }
        }

        mbar_wait(FULL_V(stage), parity);
#pragma unroll
        for (int j = 0; j < NSW; ++j) {
          const int st = ks + j * KGS;
          if (un.k0 + st * 16 < un.k1) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[j][0][0], s[j][0][1]);
            pa[1] = pack_bf16(s[j][0][2], s[j][0][3]);
            pa[2] = pack_bf16(s[j][1][0], s[j][1][1]);
            pa[3] = pack_bf16(s[j][1][2], s[j][1][3]);
            // Keys st*16 + (lane & 7) + 8 * ((lane / 8) % 2), columns
            // cg*128 + n*8 + 8 * (lane / 16): v_offset's addresses, swizzled.
            const unsigned char* v_rows =
                sV + (st * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * 128;
#pragma unroll
            for (int n = 0; n < 16; n += 2) {
              uint32_t vb[4];
              const int piece = ((n % 8) + (lane >> 4)) ^ (lane & 7);
              ldmatrix_x4_trans(vb, v_rows + (cg * 2 + n / 8) * L::CHUNK_BYTES + piece * 16);
              mma_bf16(acc[n], pa, vb[0], vb[1]);
              mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
            }
          }
        }
      } else {
        mbar_wait(FULL_V(stage), parity);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(EMPTY(stage));
    }

    // Every consumer is done with the ring: it now holds the warps'
    // partials, row kg * ROWS + i for key group kg and block row i.
    named_barrier_sync(1, CTHREADS);
    const float l0 = quad_sum(l_run[0]);
    const float l1 = quad_sum(l_run[1]);
    const int prow = kg * L::ROWS + rt * 16 + gq;
    if (cg == 0 && t == 0) {
      s_ml[prow] = make_float2(m_run[0], l0);
      s_ml[prow + 8] = make_float2(m_run[1], l1);
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = cg * 128 + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + prow * LDP + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(part + (prow + 8) * LDP + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
    named_barrier_sync(1, CTHREADS);
    // The block's partial of each row over its key groups, sent in 8-column
    // chunks: chunk c of the N = rows x hd/8 goes to block b, which merges
    // chunks [b*N/splits, (b+1)*N/splits) of the group's output, with a
    // store into b's shared memory; every row's (m, l) goes to every block.
    const int chunks = sp.rows * (HD / 8);
    const int per_block = (chunks + a.splits - 1) / a.splits;
    const uint32_t recv_addr = smem_addr(recv);
    const uint32_t recv_ml_addr = smem_addr(s_recv_ml);
    cluster_wait();
#pragma unroll 1
    for (int c = threadIdx.x; c < chunks; c += CTHREADS) {
      const int i = c / (HD / 8);
      const int col = (c % (HD / 8)) * 8;
      float m = -INFINITY;
#pragma unroll
      for (int g = 0; g < KG; ++g) m = fmaxf(m, s_ml[g * L::ROWS + i].x);
      const float base = m == -INFINITY ? 0.f : m;
      float o[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) o[v] = 0.f;
      float l = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const float2 e = s_ml[g * L::ROWS + i];
        const float w = fast_exp2(e.x - base);
        const float4* x = reinterpret_cast<const float4*>(part + (g * L::ROWS + i) * LDP + col);
        const float4 x0 = x[0];
        const float4 x1 = x[1];
        o[0] += w * x0.x;
        o[1] += w * x0.y;
        o[2] += w * x0.z;
        o[3] += w * x0.w;
        o[4] += w * x1.x;
        o[5] += w * x1.y;
        o[6] += w * x1.z;
        o[7] += w * x1.w;
        l += w * e.y;
      }
      const int b = ((c + 1) * a.splits - 1) / chunks;
      const uint32_t dst =
          cluster_map(recv_addr + (uint32_t)((rank * per_block + c - b * chunks / a.splits) * 32), b);
      st_cluster_f4(dst, make_float4(o[0], o[1], o[2], o[3]));
      st_cluster_f4(dst + 16, make_float4(o[4], o[5], o[6], o[7]));
      if (col == 0) {
        const uint32_t ml = recv_ml_addr + (uint32_t)((rank * kBlockRows + i) * 8);
#pragma unroll 1
        for (int j = 0; j < a.splits; ++j) st_cluster_f2(cluster_map(ml, j), make_float2(m, l));
      }
    }
  }
#undef FULL_K
#undef FULL_V
#undef EMPTY

  // Every block's sends are in; each block merges its slice locally.
  cluster_sync();
  const int n_parts = a.splits;
  const int chunks = sp.rows * (HD / 8);
  const int per_block = (chunks + n_parts - 1) / n_parts;
  if ((int)threadIdx.x < sp.rows) {
    // Row i's weight of each block: exp2(m_j - max m) / l.
    const int i = threadIdx.x;
    float m = -INFINITY;
    for (int j = 0; j < n_parts; ++j) m = fmaxf(m, s_recv_ml[j][i].x);
    const float base = m == -INFINITY ? 0.f : m;
    float l = 0.f;
    for (int j = 0; j < n_parts; ++j) {
      const float w = fast_exp2(s_recv_ml[j][i].x - base);
      s_w[i][j] = w;
      l += w * s_recv_ml[j][i].y;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int j = 0; j < n_parts; ++j) s_w[i][j] *= inv;
  }
  __syncthreads();
  // This block's slice: the blocks' partials weighed and summed, in bf16.
  const int c0 = rank * chunks / n_parts;
  const int c1 = (rank + 1) * chunks / n_parts;
#pragma unroll 1
  for (int c = c0 + threadIdx.x; c < c1; c += L::THREADS) {
    const int i = c / (HD / 8);
    const int col = (c % (HD / 8)) * 8;
    float o[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) o[v] = 0.f;
#pragma unroll 1
    for (int j = 0; j < n_parts; ++j) {  // every block's partial of the chunk
      const float w = s_w[i][j];
      const float4* x = reinterpret_cast<const float4*>(recv + (j * per_block + c - c0) * 8);
      const float4 x0 = x[0];
      const float4 x1 = x[1];
      o[0] += w * x0.x;
      o[1] += w * x0.y;
      o[2] += w * x0.z;
      o[3] += w * x0.w;
      o[4] += w * x1.x;
      o[5] += w * x1.y;
      o[6] += w * x1.z;
      o[7] += w * x1.w;
    }
    const int slot = sp.p0 + i / sp.reps;
    bf16* dst = a.out + (((size_t)slot * a.R + sp.r) * a.H + sp.kvh * sp.reps + i % sp.reps) * HD +
                col;
    uint4 packed;
    packed.x = pack_bf16(o[0], o[1]);
    packed.y = pack_bf16(o[2], o[3]);
    packed.z = pack_bf16(o[4], o[5]);
    packed.w = pack_bf16(o[6], o[7]);
    *reinterpret_cast<uint4*>(dst) = packed;
  }
}

// The kernel's shared-memory limit is kept per device context: set it once
// per device, so that a later launch holds only stream work and can be
// captured into a CUDA graph.
template <int HD, int R16>
cudaError_t prepare() {
  static std::atomic<int> attr_set[kMaxDevices];
  return ensure_smem_limit((const void*)decode_attention_kernel<HD, R16>,
                           (int)Layout<HD, R16>::BYTES, attr_set);
}

template <int HD, int R16>
cudaLaunchConfig_t config(int splits, unsigned groups, unsigned row_blocks,
                          cudaLaunchAttribute* cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, groups, row_blocks);
  cfg.blockDim = dim3(Layout<HD, R16>::THREADS);
  cfg.dynamicSmemBytes = Layout<HD, R16>::BYTES;
  cfg.stream = stream;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = (unsigned)splits;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// cuTensorMapEncodeTiled, a libcuda function, found through the CUDA
// runtime's entry-point query so that the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  });
  return fn;
}

// A map of a contiguous (outer, S, KV, hd) bf16 tensor as 4-D (hd, KV, S,
// outer), one box 64 columns x 1 kv head x `keys` positions, 128-byte
// swizzle.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int kv, int S, int outer, int keys) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)kv, (cuuint64_t)S, (cuuint64_t)outer};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)kv * hd * 2,
                                 (cuuint64_t)S * kv * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)keys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int R16>
int launch(const Args& a, int row_blocks, cudaStream_t stream) {
  using L = Layout<HD, R16>;
  const cudaError_t attr_err = prepare<HD, R16>();
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tm_trunk_k, tm_trunk_v, tm_tail_k, tm_tail_v;
  const int rows = a.P * a.R;
  if (!make_map(&tm_trunk_k, a.trunk_k, HD, a.KV, a.W0, a.R, L::BK) ||
      !make_map(&tm_trunk_v, a.trunk_v, HD, a.KV, a.W0, a.R, L::BK) ||
      !make_map(&tm_tail_k, a.tail_k, HD, a.KV, a.Ts, rows, L::BK) ||
      !make_map(&tm_tail_v, a.tail_v, HD, a.KV, a.Ts, rows, L::BK)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = config<HD, R16>(a.splits, (unsigned)(a.R * a.KV),
                                                 (unsigned)row_blocks, &cluster, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<HD, R16>, tm_trunk_k,
                                             tm_trunk_v, tm_tail_k, tm_tail_v, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `splits` blocks the current device holds at once.
template <int HD, int R16>
int max_clusters(int splits) {
  const cudaError_t attr_err = prepare<HD, R16>();
  if (attr_err != cudaSuccess) return -(int)attr_err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = config<HD, R16>(splits, 1, 1, &cluster, nullptr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, decode_attention_kernel<HD, R16>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// 16-row tiles of a block of `rows` query rows (1, 2 or 4).
inline int row_tiles(int rows) { return rows <= 16 ? 1 : rows <= 32 ? 2 : 4; }

}  // namespace

extern "C" {

// q, out: (P*R, H, hd) bf16; trunk_k/v: (R, W0, KV, hd) bf16; tail_k/v:
// (P*R, Ts, KV, hd) bf16, all contiguous; starts, qpos: (R,) int32 on the
// device.  `splits` blocks (one cluster, at most 8) share each (role, kv
// head) group's keys; a block holds `slots_per_block` slots' query rows (at
// most 64 rows).  softcap <= 0 and window <= 0 switch those features off.
// Returns a cudaError_t.
int consensus_decode_attention_fwd(const void* q, const void* trunk_k,
                                   const void* trunk_v, const void* tail_k,
                                   const void* tail_v, const void* starts,
                                   const void* qpos, void* out,
                                   int P, int R, int H, int KV, int head_dim,
                                   int W0, int Ts, int write_col, int splits,
                                   int slots_per_block, float scale,
                                   float softcap, int window, void* stream) {
  if (P < 1 || R < 1 || KV < 1 || H % KV != 0 || W0 < 1 || write_col < 0 ||
      write_col >= Ts || splits < 1 || splits > kMaxSplits || slots_per_block < 1 ||
      (long long)slots_per_block * (H / KV) > kBlockRows || (long long)R * KV > 65535 ||
      (P + slots_per_block - 1) / slots_per_block > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = (slots_per_block < P ? slots_per_block : P) * (H / KV);
  const int r16 = row_tiles(rows);
  const int row_blocks = (P + slots_per_block - 1) / slots_per_block;
  Args a{static_cast<const bf16*>(q),       static_cast<const bf16*>(trunk_k),
         static_cast<const bf16*>(trunk_v), static_cast<const bf16*>(tail_k),
         static_cast<const bf16*>(tail_v),  static_cast<const int*>(starts),
         static_cast<const int*>(qpos),     static_cast<bf16*>(out),
         P, R, H, KV, W0, Ts, write_col, splits, slots_per_block,
         scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim * 8 + r16) {
    case 128 * 8 + 1:
      return launch<128, 1>(a, row_blocks, s);
    case 128 * 8 + 2:
      return launch<128, 2>(a, row_blocks, s);
    case 128 * 8 + 4:
      return launch<128, 4>(a, row_blocks, s);
    case 256 * 8 + 1:
      return launch<256, 1>(a, row_blocks, s);
    case 256 * 8 + 2:
      return launch<256, 2>(a, row_blocks, s);
    case 256 * 8 + 4:
      return launch<256, 4>(a, row_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The clusters of `splits` blocks the current device holds at once, for
// blocks of `rows` query rows at `head_dim` (cudaOccupancyMaxActiveClusters);
// a negative cudaError_t on failure.
int consensus_decode_attention_max_clusters(int head_dim, int rows, int splits) {
  if (rows < 1 || rows > kBlockRows || splits < 1 || splits > kMaxSplits) {
    return -(int)cudaErrorInvalidValue;
  }
  switch (head_dim * 8 + row_tiles(rows)) {
    case 128 * 8 + 1:
      return max_clusters<128, 1>(splits);
    case 128 * 8 + 2:
      return max_clusters<128, 2>(splits);
    case 128 * 8 + 4:
      return max_clusters<128, 4>(splits);
    case 256 * 8 + 1:
      return max_clusters<256, 1>(splits);
    case 256 * 8 + 2:
      return max_clusters<256, 2>(splits);
    case 256 * 8 + 4:
      return max_clusters<256, 4>(splits);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
