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
// the dense rate.  So the kernel has to keep the tensor cores near their
// rate on the spans while the zero part of the output streams out at the
// memory's rate.  chip_smoke.py computes the bound from each run's lengths.
//
// Design (FlashAttention-3's structure on sm_90a; the PTX is in
// sm90_wgmma.cuh):
//  * Work tiles of BM = 64 x CWG query rows of one (batch row, head),
//    numbered longest causal first.  A block has one producer warpgroup and
//    CWG consumer warpgroups of 64 rows each.  CWG is 2 (128 rows) unless
//    128-row tiles would leave SMs idle (a tp rank's one head at B=8,
//    S=384: 24 tiles), then 1.  With four tiles an SM or more, one block
//    per SM walks the tiles (persistent: the next tile's Q and K/V load
//    while this one computes, and its output store overlaps the next);
//    with fewer, one block per tile, which the hardware's block scheduler
//    balances better over uneven causal tiles.
//  * Copies through TMA.  One producer thread loads each tile's Q and its
//    key tiles' K and V into a ring of two stages, as far ahead as the
//    mbarriers let it: full barriers count the bytes that land, empty
//    barriers count the consumer warps done with a stage (K once its
//    logits are computed, V once its P.V product is, Q after the tile's
//    last Q.K^T).  The tensor maps are 4-D over (hd, heads, S, B), made on
//    the host for each call, 64 columns (128 bytes, the swizzle's width) a
//    box: a tile past S loads zeros and its output rows are not stored,
//    and no tile reaches into the next batch row.  The producer gives its
//    registers up (setmaxnreg) to the consumers.
//  * Tensor cores through wgmma.  S = Q K^T with both operands in shared
//    memory (K-major, 128-byte swizzle); O += P V with P from registers
//    (the logits of the S accumulator, turned into probabilities in place
//    and rounded to bf16 A fragments, never stored) and V read MN-major
//    from shared memory.  BN = 128 keys a tile at hd=128 (64 logits a
//    thread beside the 64-float O accumulator) and 64 at hd=256 (O takes
//    128 floats a thread).  Within a warpgroup a key tile's P.V product
//    is issued with the next tile's Q.K^T and runs during that tile's
//    softmax; between the two warpgroups, named barriers make them take
//    turns to issue (ping-pong), so that one's softmax runs while the
//    other's products hold the tensor cores.  The softmax runs in base 2,
//    the scale folded into one FMA per logit; the softcap's tanh is one
//    ex2 and one rcp.  A row's max and sum reduce over its quad of lanes.
//  * Masking economy: a tile walks only the key tiles that can hold a
//    valid key for its rows; each consumer classifies each key tile once
//    for its 64 rows as empty (it adds nothing), interior (every key valid
//    for every row: no mask) or edge (span ends, causal diagonal, window
//    edge or a left-padded start inside the tile: per-element mask).  A
//    query tile wholly outside its row's span loads nothing: its
//    consumers write zeros with 16-byte stores.
//  * Output: each consumer normalises its rows, writes them as bf16 into
//    an output slot in shared memory in the 128-byte swizzled layout, and
//    one thread stores them with TMA.  At hd=256 the two consumers take
//    turns with one slot.
//  * Shared memory: Q, the output slots and two (K, V) stages: 192 KB at
//    hd=128 and 224 KB at hd=256 (128-row tiles); one block per SM.  Every
//    wgmma is issued on a path that all of its warpgroup takes, and the
//    registers that a wgmma reads are written only while none is in
//    flight: otherwise ptxas serialises the wgmmas.

#include <cuda.h>
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

// 1/x on the special-function unit (rcp.approx with flush to zero): 1/inf
// is 0.
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int CWG>
struct Cfg {
  static constexpr int THREADS = 128 * (CWG + 1);
  static constexpr int BM = 64 * CWG;              // query rows per tile
  static constexpr int BN = HD == 128 ? 128 : 64;  // keys per K/V tile
  static constexpr int CHUNKS = HD / 64;           // 64-column TMA boxes per row
  static constexpr int STAGES = 2;
  static constexpr int Q_CHUNK = BM * 128;  // bytes of one 64-column chunk
  static constexpr int KV_CHUNK = BN * 128;
  static constexpr int Q_BYTES = Q_CHUNK * CHUNKS;
  static constexpr int KV_BYTES = KV_CHUNK * CHUNKS;  // one K or one V tile
  // The output goes out through shared memory of its own and TMA stores,
  // so that the Q tile is free for the next tile's as soon as the last
  // Q.K^T has read it.  A slot holds one warpgroup's 64 rows; at hd 256
  // two would not fit beside Q and the ring, and the two consumers take
  // turns with one.
  static constexpr int O_SLOT = 64 * HD * 2;
  static constexpr int O_SLOTS = HD == 128 ? CWG : 1;
  // From a 1024-byte aligned base: Q, the output slots, per stage K and
  // V, then the barriers (full K, full V, empty K, empty V per stage; full
  // and empty Q; the shared output slot's).
  static constexpr int O_OFFSET = Q_BYTES;
  static constexpr int KV_OFFSET = Q_BYTES + O_SLOTS * O_SLOT;
  static constexpr int BAR_OFFSET = KV_OFFSET + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFFSET + 8 * (4 * STAGES + 3);
};

// Registers with two consumers (384 threads): 168 a thread at entry; the
// producer gives all but 24 up and the consumers take 240.  With one (256
// threads) every thread may hold up to 255, and nothing moves.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

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

// One work tile: query rows [q0, q0 + BM) of head h of batch row b, whose
// span is [start, end), and the key tiles [kt_lo, kt_hi) that can hold a
// valid key for one of its rows (none when no row has one).  Tiles are
// numbered longest causal first: the last query tile of every (b, h), then
// the one before it, and so on; block c of G takes tiles c, c + G, ...
struct Tile {
  int b, h, q0, start, end, kt_lo, kt_hi;
};

struct Problem {
  const int* lengths;
  const int* starts;
  int S, H, BH, n_qt, causal, window;
};

template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(int t, const Problem& pr) {
  Tile x;
  const int bh = t % pr.BH;
  x.b = bh / pr.H;
  x.h = bh % pr.H;
  x.q0 = (pr.n_qt - 1 - t / pr.BH) * BM;
  x.start = pr.starts[x.b];
  x.end = x.start + pr.lengths[x.b];
  x.kt_lo = x.kt_hi = 0;
  // The key ranges grow with the query position, so the first and last
  // rows of the tile inside the span bound them.
  const int qa = max(x.q0, x.start);
  const int qb = min(x.q0 + BM, x.end) - 1;
  if (qa <= qb) {
    int lo, hi, unused;
    key_range(qa, x.start, x.end, pr.causal, pr.window, lo, unused);
    key_range(qb, x.start, x.end, pr.causal, pr.window, unused, hi);
    if (lo < hi) {
      x.kt_lo = lo / BN;
      x.kt_hi = (hi + BN - 1) / BN;
    }
  }
  return x;
}

// S (64 x BN) = Q rows (64 x HD) . K tile^T, one wgmma per 16 columns of hd.
template <int HD, int BN>
__device__ __forceinline__ void qk_product(float (&s)[BN / 2], uint32_t q_rows, int q_chunk,
                                           uint32_t k_tile) {
  // Opaque to the compiler: the descriptors are made here, from two
  // registers, not hoisted out of the key loop into many.
  asm volatile("" : "+r"(q_rows), "+r"(k_tile));
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;  // 16 columns of a 128-byte row
    const uint64_t da = wgmma_desc(q_rows + (kk / 4) * q_chunk + step, 16, 1024);
    const uint64_t db = wgmma_desc(k_tile + (kk / 4) * (BN * 128) + step, 16, 1024);
    if constexpr (BN == 128) {
      if (kk == 0) {
        wgmma_ss_m64n128k16_zero(s, da, db);
      } else {
        wgmma_ss_m64n128k16(s, da, db);
      }
    } else {
      if (kk == 0) {
        wgmma_ss_m64n64k16_zero(s, da, db);
      } else {
        wgmma_ss_m64n64k16(s, da, db);
      }
    }
  }
}

// O (64 x HD) += P (64 x BN, bf16 registers) . V tile, one wgmma per 16 keys
// and 128 columns of hd.  V's rows (keys) are 128 bytes of 64 columns.
template <int HD, int BN>
__device__ __forceinline__ void pv_product(float (&o)[HD / 128][64],
                                           const uint32_t (&p)[BN / 16][4], uint32_t v_tile) {
  asm volatile("" : "+r"(v_tile));  // as in qk_product
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < HD / 128; ++x) {
      const uint64_t dv = wgmma_desc(v_tile + x * 2 * (BN * 128) + kk * 16 * 128, BN * 128, 1024);
      wgmma_rs_m64n128k16(o[x], p[kk], dv);
    }
  }
}

template <int HD, int CWG>
__global__ void __launch_bounds__(Cfg<HD, CWG>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 bf16* __restrict__ o_out, const int* __restrict__ lengths,
                 const int* __restrict__ starts, int B, int S, int H, int KV, float scale,
                 float softcap, int window, int causal) {
  using C = Cfg<HD, CWG>;
  constexpr int BM = C::BM;
  constexpr int BN = C::BN;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t bars = base + C::BAR_OFFSET;
  auto k_tile = [&](int s) { return base + C::KV_OFFSET + s * 2 * C::KV_BYTES; };
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8 * (3 * STAGES + s); };
  const uint32_t full_q = bars + 8 * 4 * STAGES;
  const uint32_t empty_q = full_q + 8;
  const uint32_t o_free = full_q + 16;  // the shared output slot is stored

  const Problem pr{lengths, starts, S, H, B * H, (S + BM - 1) / BM, causal, window};
  const int n_tiles = pr.BH * pr.n_qt;
  const int G = gridDim.x;
  auto tile_index = [&](int r) { return r * G + (int)blockIdx.x; };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * CWG);  // every consumer warp
      mbar_init(empty_v(s), 4 * CWG);
    }
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * CWG);
    mbar_init(o_free, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup's role, read through a shuffle so that the compiler sees
  // it uniform across each warp.
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // Producer warpgroup: one thread issues every copy, tile after tile,
    // as far ahead as the barriers let it.  K and V have separate
    // barriers: a K tile is free once its logits are computed, a V tile
    // only once its P.V product is.
    if constexpr (CWG == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int kv_count = 0;  // K/V tiles loaded so far: the ring's position
      uint32_t q_count = 0;
      for (int r = 0; r * G < n_tiles; ++r) {
        const int t = tile_index(r);
        if (t >= n_tiles) continue;
        const Tile x = tile_at<BM, BN>(t, pr);
        const int kvh = x.h / (H / KV);
        for (int kt = x.kt_lo; kt < x.kt_hi; ++kt, ++kv_count) {
          const int s = kv_count % STAGES;
          const uint32_t free_parity = ((kv_count / STAGES) & 1) ^ 1;  // passes at first use
          const uint32_t sK = k_tile(s);
          mbar_wait(empty_k(s), free_parity);
          mbar_expect_tx(full_k(s), C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load_4d(sK + c * C::KV_CHUNK, &tm_k, full_k(s), c * 64, kvh, kt * BN, x.b);
          }
          if (kt == x.kt_lo) {
            mbar_wait(empty_q, (q_count & 1) ^ 1);
            mbar_expect_tx(full_q, C::Q_BYTES);
#pragma unroll
            for (int c = 0; c < C::CHUNKS; ++c) {
              tma_load_4d(sQ + c * C::Q_CHUNK, &tm_q, full_q, c * 64, x.h, x.q0, x.b);
            }
            ++q_count;
          }
          mbar_wait(empty_v(s), free_parity);
          mbar_expect_tx(full_v(s), C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load_4d(sK + C::KV_BYTES + c * C::KV_CHUNK, &tm_v, full_v(s), c * 64, kvh,
                        kt * BN, x.b);
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows of each tile each.
    if constexpr (CWG == 2) setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int HALVES = HD / 128;  // 128-column O accumulators
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const uint32_t q_rows = sQ + cw * 64 * 128;

    // Every consumer warp arrives on a stage's empty barrier.
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Ping-pong (two consumers): the warpgroups take turns to issue their
    // products, so that one's softmax runs while the other's wgmmas hold
    // the tensor cores.  Warpgroup cw waits for its turn on barrier 3 + cw
    // and hands the turn over on the other's; warpgroup 0 goes first.
    auto my_turn = [&]() {
      if constexpr (CWG == 2) named_barrier_sync(3 + cw, 256);
    };
    auto your_turn = [&]() {
      if constexpr (CWG == 2) named_barrier_arrive(4 - cw, 256);
    };

    // The tile at t as every thread sees it: its key-tile range read
    // through shuffles, so that the compiler sees the loop bounds (and the
    // ring stages and wgmma descriptors made from them) uniform and keeps
    // the descriptors in uniform registers, as wgmma takes them.
    auto tile = [&](int t) {
      Tile x = tile_at<BM, BN>(t, pr);
      x.kt_lo = __shfl_sync(0xffffffffu, x.kt_lo, 0);
      x.kt_hi = __shfl_sync(0xffffffffu, x.kt_hi, 0);
      return x;
    };
    // The first round at or after r whose tile has a valid key (r G >=
    // n_tiles when there is none); the tiles passed on the way get zeros
    // in this warpgroup's rows, 16-byte stores coalesced along the rows,
    // and load nothing.
    auto next_busy = [&](int r) {
      for (; r * G < n_tiles; ++r) {
        const int t = tile_index(r);
        if (t >= n_tiles) continue;
        const Tile x = tile(t);
        if (x.kt_lo < x.kt_hi) break;
        constexpr int CH = HD / 8;
        const int r0 = x.q0 + 64 * cw;
        const int rows = min(64, S - r0);
        for (int idx = tid; idx < rows * CH; idx += 128) {
          const size_t row = (size_t)x.b * S + r0 + idx / CH;
          *reinterpret_cast<uint4*>(o_out + (row * H + x.h) * HD + (idx % CH) * 8) =
              make_uint4(0, 0, 0, 0);
        }
      }
      return r;
    };

    int kv_count = 0;  // K/V tiles consumed so far: the ring's position
    int o_turn = 0;  // tiles done so far
    int round = next_busy(0);
    if (CWG == 2 && cw == 1 && round * G < n_tiles) named_barrier_arrive(3, 256);
    while (round * G < n_tiles) {
      const Tile x = tile(tile_index(round));
      const int n = x.kt_hi - x.kt_lo;
      const int wq0 = x.q0 + 64 * cw;

      const int start = x.start;
      const int end = x.end;

      float o[HALVES][64];
#pragma unroll
      for (int h2 = 0; h2 < HALVES; ++h2) {
#pragma unroll
        for (int e = 0; e < 64; ++e) o[h2][e] = 0.f;
      }
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};

      // Logits of key tile kt, in the S accumulator `sc`, to unnormalised
      // probabilities in place: cap, mask, update the running max and sum;
      // `alpha` gets the factors that rescale O to the new max.
      auto softmax = [&](float (&sc)[BN / 2], int kt, float (&alpha)[2]) {
        // This warpgroup's rows bound the classification; the key ranges
        // of the two rows (16 warp + g, + 8) this thread holds mask an edge
        // tile.  (Made anew for each key tile: no registers held.)
        const int wa = max(wq0, start);
        const int wb = min(wq0 + 64, end) - 1;
        const bool has_rows = wa <= wb;
        const bool full_rows = wa == wq0 && wb == wq0 + 63;
        int lo_min = 0, lo_max = 0, hi_min = 0, hi_max = 0;
        if (has_rows) {
          key_range(wa, start, end, causal, window, lo_min, hi_min);
          key_range(wb, start, end, causal, window, lo_max, hi_max);
        }
        const int k0 = kt * BN;
        const bool empty = !has_rows || k0 >= hi_max || k0 + BN <= lo_min;
        const bool interior = full_rows && k0 >= lo_max && k0 + BN <= hi_min;
        // Logits to base 2: capped ones come out of the cap already scaled.
        // The factors are made anew for each key tile, from the kernel's
        // parameters behind an empty asm: hoisted out of the key loop they
        // would hold registers that the loop's other values need.
        float scale_p = scale, softcap_p = softcap;
        asm volatile("" : "+f"(scale_p), "+f"(softcap_p));
        const bool capped = softcap_p > 0.f;
        const float logit_scale = capped ? 1.f : scale_p * LOG2E;
        if (capped) {
          // softcap tanh(scale s / softcap) in base 2, with tanh(y) =
          // 1 - 2 / (e^(2y) + 1) on the special-function unit: one ex2 and
          // one rcp, absolute error under 1e-6, against tanhf's branches.
          const float to_exp2 = 2.f * LOG2E * scale_p * fast_rcp(softcap_p);
          const float cap_out = softcap_p * LOG2E;
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) {
            sc[e] = cap_out * fmaf(-2.f, fast_rcp(fast_exp2(sc[e] * to_exp2) + 1.f), 1.f);
          }
        }
        if (empty) {
          // No key of the tile is valid for any of these rows: it adds nothing.
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) sc[e] = -INFINITY;
        } else if (!interior) {
          int row_lo[2], row_hi[2];
          int q_row = wq0 + 16 * warp + g;
          asm volatile("" : "+r"(q_row));  // as the factors above: not hoisted
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            key_range(q_row + 8 * half, start, end, causal, window, row_lo[half], row_hi[half]);
          }
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) {
            const int key = k0 + (e / 4) * 8 + 2 * t4 + (e & 1);
            const int r = (e >> 1) & 1;
            if (key < row_lo[r] || key >= row_hi[r]) sc[e] = -INFINITY;
          }
        }
        // Online softmax: new row max over the quad, rescale, exponentiate;
        // the scale into base 2 folds into one FMA per logit (m_run is in
        // base-2 units).
        float mx[2] = {-INFINITY, -INFINITY}, base2[2];
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(m_run[r], quad_max(mx[r]) * logit_scale);
          base2[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no key yet
          alpha[r] = fast_exp2(m_run[r] - base2[r]);
          m_run[r] = mx[r];
          l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          sc[e] = fast_exp2(fmaf(sc[e], logit_scale, -base2[(e >> 1) & 1]));
          l_run[(e >> 1) & 1] += sc[e];
        }
      };
      // P rounds to bf16 straight from the probabilities' registers: two
      // neighbouring 8-key groups of the accumulator are one 16-deep A
      // fragment.
      auto to_fragments = [&](const float (&sc)[BN / 2], uint32_t (&p)[BN / 16][4]) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
          }
        }
      };
      auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
        for (int h2 = 0; h2 < HALVES; ++h2) {
#pragma unroll
          for (int e = 0; e < 64; ++e) o[h2][e] *= alpha[(e >> 1) & 1];
        }
      };
      auto fence_o = [&]() {
#pragma unroll
        for (int h2 = 0; h2 < HALVES; ++h2) fence_operand(o[h2]);
      };

      // Key tile i's P.V product is issued in iteration i + 1, after tile
      // i + 1's Q.K^T: it runs on the tensor cores while that tile's
      // logits go through the softmax.  As in FlashAttention-3, P is made
      // from the probabilities only once every wgmma that reads its
      // registers is done, and O is rescaled between the two products: a
      // register that a wgmma reads and other code writes while a wgmma is
      // in flight would make ptxas serialise them.  Every wgmma is issued
      // on a path that all of the warpgroup takes (no tile is skipped
      // around one).  The Q tile is released after the tile's last Q.K^T.
      float sc[BN / 2];
      uint32_t p[BN / 16][4];
      float alpha[2];
      mbar_wait(full_q, o_turn & 1);
      {
        const int s = kv_count % STAGES;
        mbar_wait(full_k(s), (kv_count / STAGES) & 1);
        my_turn();
        wgmma_fence();
        qk_product<HD, BN>(sc, q_rows, C::Q_CHUNK, k_tile(s));
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_operand(sc);
        release(empty_k(s));
        if (n == 1) release(empty_q);
        softmax(sc, x.kt_lo, alpha);  // O is still 0: nothing to rescale
        to_fragments(sc, p);
      }
      for (int i = 1; i < n; ++i) {
        const int c = kv_count + i;
        const int s = c % STAGES;
        const int prev = (c - 1) % STAGES;
        mbar_wait(full_k(s), (c / STAGES) & 1);
        my_turn();
        wgmma_fence();
        qk_product<HD, BN>(sc, q_rows, C::Q_CHUNK, k_tile(s));
        wgmma_commit();
        // O, holding the tiles before the previous one, rescales to the
        // max that the previous tile's softmax found.
        rescale(alpha);
        mbar_wait(full_v(prev), ((c - 1) / STAGES) & 1);
        fence_o();
        wgmma_fence();
        pv_product<HD, BN>(o, p, k_tile(prev) + C::KV_BYTES);
        wgmma_commit();
        your_turn();
        wgmma_wait<1>();
        fence_operand(sc);
        release(empty_k(s));
        if (i == n - 1) release(empty_q);
        softmax(sc, x.kt_lo + i, alpha);
        wgmma_wait<0>();
        fence_o();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) fence_operand(p[kk]);
        release(empty_v(prev));
        to_fragments(sc, p);
      }
      {
        const int c = kv_count + n - 1;
        const int s = c % STAGES;
        rescale(alpha);
        mbar_wait(full_v(s), (c / STAGES) & 1);
        fence_o();
        my_turn();
        wgmma_fence();
        pv_product<HD, BN>(o, p, k_tile(s) + C::KV_BYTES);
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_o();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) fence_operand(p[kk]);
        release(empty_v(s));
      }
      kv_count += n;

      // Normalise; a row with no valid key has l == 0 and a zero
      // accumulator.  The tile's coordinates come again from t: fewer
      // registers held through the key loop.
      const float l0 = quad_sum(l_run[0]);
      const float l1 = quad_sum(l_run[1]);
      const float inv[2] = {l0 > 0.f ? 1.f / l0 : 0.f, l1 > 0.f ? 1.f / l1 : 0.f};
      const int t = tile_index(round);
      const int bh = t % pr.BH;
      const int row0 = (pr.n_qt - 1 - t / pr.BH) * BM + 64 * cw;
      // The bf16 rows go to this warpgroup's output slot, swizzled as the
      // output map expects (16-byte group j of row r at j ^ (r % 8)), once
      // the slot's previous store has read it: this warpgroup's own, or
      // with one shared slot the other warpgroup's (they alternate, 0
      // first, and count their turns in `o_turn`).
      constexpr bool SHARED_SLOT = C::O_SLOTS < CWG;
      const uint32_t o_rows = base + C::O_OFFSET + (SHARED_SLOT ? 0 : cw) * C::O_SLOT;
      if constexpr (SHARED_SLOT) {
        const int turn = 2 * o_turn + cw;
        if (turn > 0) mbar_wait(o_free, (turn - 1) & 1);
      } else {
        if (tid == 0) tma_store_wait_read();
        named_barrier_sync(1 + cw, 128);
      }
      unsigned char* rows = smem + (o_rows - base);
#pragma unroll
      for (int h2 = 0; h2 < HALVES; ++h2) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int chunk = 2 * h2 + j / 8;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * warp + 8 * half + g;
            const int offset = chunk * 64 * 128 + r * 128 + (((j % 8) ^ g) * 16) + 4 * t4;
            *reinterpret_cast<uint32_t*>(rows + offset) = pack_bf16(
                o[h2][4 * j + 2 * half] * inv[half], o[h2][4 * j + 2 * half + 1] * inv[half]);
          }
        }
      }
      fence_async_shared();
      named_barrier_sync(1 + cw, 128);
      if (tid == 0) {
        if (row0 < S) {
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_store_4d(&tm_o, o_rows + c * 64 * 128, c * 64, bh % H, row0, bh / H);
          }
        }
        tma_store_commit();
        if constexpr (SHARED_SLOT) {
          tma_store_wait_read();
          mbar_arrive(o_free);
        }
      }
      ++o_turn;
      round = next_busy(round + 1);
    }
    // Warpgroup 1's last hand-over, which warpgroup 0 takes no turn for.
    if (CWG == 2 && cw == 0 && o_turn > 0) named_barrier_sync(3, 256);
    if (tid == 0) tma_store_wait_read();
  }
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

// A map of a contiguous (B, S, heads, hd) bf16 tensor as 4-D (hd, heads, S,
// B), one box 64 columns x 1 head x `rows` positions, 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SM count, read once per device.
cudaError_t sm_count(int* count) {
  static std::atomic<int> counts[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = counts[device].load(std::memory_order_acquire);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    counts[device].store(n, std::memory_order_release);
  }
  *count = n;
  return cudaSuccess;
}

template <int HD, int CWG>
int launch(const void* q, const void* k, const void* v, void* o, const int* lengths,
           const int* starts, int B, int S, int H, int KV, float scale, float softcap,
           int window, int causal, int sms, cudaStream_t stream) {
  using C = Cfg<HD, CWG>;
  // The shared-memory limit is kept per device context: set it once per
  // device, so that a later launch holds only stream work and can be
  // captured into a CUDA graph.
  static std::atomic<int> attr_set[kMaxDevices];
  const cudaError_t attr_err =
      ensure_smem_limit((const void*)flash_fwd_kernel<HD, CWG>, C::SMEM, attr_set);
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, q, HD, H, S, B, C::BM) || !make_map(&tm_k, k, HD, KV, S, B, C::BN) ||
      !make_map(&tm_v, v, HD, KV, S, B, C::BN) || !make_map(&tm_o, o, HD, H, S, B, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  // Persistent, one block per SM walking the tiles, when there are at
  // least four tiles a block; with fewer, one block per tile, so that the
  // hardware's block scheduler balances the uneven causal tiles.
  const long long tiles = (long long)B * H * ((S + C::BM - 1) / C::BM);
  const unsigned grid = (unsigned)(tiles < 4LL * sms ? tiles : sms);
  flash_fwd_kernel<HD, CWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<bf16*>(o), lengths, starts, B, S, H, KV, scale,
      softcap, window, causal);
  return (int)cudaGetLastError();
}

// Two consumer warpgroups (128-row tiles) unless 128-row tiles would leave
// SMs idle; then one (64-row tiles), twice the tiles.
template <int HD>
int dispatch(const void* q, const void* k, const void* v, void* o, const int* lengths,
             const int* starts, int B, int S, int H, int KV, float scale, float softcap,
             int window, int causal, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)B * H * ((S + 127) / 128);
  if (tiles < sms) {
    return launch<HD, 1>(q, k, v, o, lengths, starts, B, S, H, KV, scale, softcap, window,
                         causal, sms, stream);
  }
  return launch<HD, 2>(q, k, v, o, lengths, starts, B, S, H, KV, scale, softcap, window, causal,
                       sms, stream);
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd) bf16; k, v: (B, S, KV, hd) bf16 with H % KV == 0, all
// contiguous and 16-byte aligned (TMA's rule); lengths, starts: (B,) int32
// on the device.  softcap <= 0 and window <= 0 switch those features off.
// Returns the launch's cudaError_t.
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
      return dispatch<128>(q, k, v, o, len, st, B, S, H, KV, scale, softcap, window, causal, s);
    case 256:
      return dispatch<256>(q, k, v, o, len, st, B, S, H, KV, scale, softcap, window, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
