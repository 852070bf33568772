// Bitpacked Boolean matrix multiplication over the AND/OR semiring, by hand
// for Hopper (sm_90a).
//
// Replaces two TPU kernels of repro/kernels/bitmm.py, as one kernel with a
// template flag:
//   * bitmm_pallas (bitmm.py:107, body _bitmm_kernel), entry repro_bitmm:
//
//       out[b, i, j] = OR over {k : bit k of lhs[b, i]} of rhs[b, k, j]
//
//   * bitmm_or_pallas (bitmm.py:73, body _bitmm_or_kernel), entry
//     repro_bitmm_or: the fused closure step  out = acc | (lhs x rhs).  The
//     OR registers are seeded from acc instead of from zero, so the union
//     costs one read of acc.  out never aliases acc (the wrapper allocates
//     it); an all-zero lhs row still writes its acc row.
//
// lhs (B, m, wk) words packing the contraction axis, rhs (B, k = 32·wk, w)
// words packing the output axis, out (B, m, w).  Bit t of word v is column
// 32v + t.  m != k is allowed.  Words are 32-bit; the wrapper passes int32
// tensors, read here as unsigned (bit 31 is a bit like any other).
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 132 SMs x 64 INT32 lanes x
// 1.98 GHz = 16.7e12 integer ops/s).  Bytes: lhs and out once each (acc
// too for bitmm_or), and of the rhs only the rows k that some set lhs bit
// names.  Operations: one OR of a w-word rhs row per set lhs bit.  On the
// closure states (about 1e-4 of the bits set) every shape of the main path
// is bound by bytes: (6, 15872, 496) x (6, 15872, 496) at 0.14 ms, the
// masked R = 128 block at 0.0016 ms, bitmm_or's repair block (6, 2048, 496)
// at 0.025 ms.  On random words (half the bits set) the same R = n product
// is bound by operations at 22.4 ms.
//
// Design.  One block of 256 threads (8 warps) per 64-row tile, covering all
// w output words, so the lhs is read once, with 16-byte loads where
// wk % 4 == 0 (a grid of one block per 64 rows x 64 words has each of a row
// tile's word-tile blocks re-read its whole lhs).  The block first reads its
// tile's lhs, 8 loads in flight per thread, summing set bits per row (popc)
// and ORing each word column into a union in shared memory.  Then it
// branches once, block-uniform, on the tile's set-bit count:
//
//   * <= sparse_max_bits: the sparse path, a Gustavson row gather.  Each
//     warp takes whole output rows from a shared counter (a heavy row holds
//     up only its own warp) and keeps the row's words in registers: NV units
//     of V words per lane (V = 4, 16-byte loads, when w % 4 == 0 and the
//     pointers are 16-byte aligned; else V = 1), a chunk of 32·NV·V words.
//     Three layouts per kernel: (NV, V) = (1, 4) for w <= 128, (4, 4)
//     above, and (8, 1) for every unaligned row.
//     A wider row loops over chunks and rescans its lhs row per chunk.  A
//     row without set bits is written with zeros (bitmm) or its acc row
//     (bitmm_or) and nothing else, so an empty tile (0 bits: most tiles of
//     a closure state) costs its lhs read and its out write.  A row with
//     bits finds them with __ballot_sync / __ffs on its lhs words
//     (warp-uniform, no divergence) and ORs in rhs row k for each set bit
//     k, the loads of two rows in flight at a time, then writes the row
//     once.  Only the rhs rows that set bits name are read, at bit level
//     (not all 32 rows of every non-zero lhs word), mostly from L2, and no
//     barrier is taken.
//   * more bits: the dense path.  The rhs rows are staged in shared memory,
//     shared by the tile's 64 rows, through a ring of STAGES slots filled
//     with cp.async, so the copies of the next two words overlap the ORs of
//     this one, with one barrier per staged word.  Only lhs words whose
//     union over the tile's rows is non-zero are staged, and of each only
//     the rhs rows of the union's set bits; a warp iterates only the bits
//     that one of its 8 rows has.  A thread holds 8 rows x 4 words (one mask
//     per row and bit serves 4 ORs) in output chunks of 128 words: 8 x 8
//     needed more than the 128 registers that two blocks per SM allow, and
//     spilled.
//
// Plain grid (tiles, B, split), two blocks per SM.  A grid of fewer blocks
// than SMs (the masked closure's 128-row block: 12 tiles) splits each
// tile's rows over up to 8 blocks, each scanning the whole tile to take the
// same path; the dense path runs in the first of them.  A persistent grid
// (two blocks per SM striding over the tiles) timed slower at R = n and on
// random words, the same at the 128- and 2048-row blocks, and spilled.
//
// The threshold kSparseMaxBits is where the two paths' times cross in the
// density sweep of chip_smoke.py (phase density_sweep: random lhs words at
// bitmm_or's repair shape against the state), between densities 0.2 and
// 0.3 of a tile's bits; the numbers are in PERF.md.  It is a bit count per
// tile placed at one width (wk = w = 496) on random lhs words, whose rows
// share few columns: it holds only near that width, and tiles whose rows
// share columns would favour the dense path earlier.  No closure state of
// the main path comes near it; a cell with dense states has to place it
// again.  repro_bitmm_path takes
// the threshold as an argument (0 forces the dense path on every non-empty
// tile, INT_MAX the sparse one) for that sweep and the card tests.  Tensor
// cores are not used: the main path is bound by bytes, and a b1 mma with
// .and.popc needs the rhs packed along k (a bit transpose per step).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;         // rows per tile (one block)
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = TM / WARPS;  // dense path: 8 rows per thread
constexpr int DWT = 4;         // dense path: words per thread per row
constexpr int DW = 32 * DWT;   // dense path: output words per column chunk
constexpr int STAGES = 3;      // dense path: cp.async ring depth
constexpr int LW = 16;         // sparse path: lhs words per lane per scan pass
constexpr unsigned FULL = 0xffffffffu;

// Tiles with at most this many set lhs bits take the sparse path.
constexpr int kSparseMaxBits = 300000;

// Dynamic shared memory: row_bits[TM], counters[4], union[wk4],
// klist[wk4], then the ring (16-byte aligned).
constexpr int RING_SLOT_WORDS = TM + 32 * DW;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kSplitPerSm = 1;  // blocks per SM below which tiles are split
constexpr int kMaxSplit = 8;  // blocks per tile at most: one row per warp

__host__ inline size_t smem_bytes(int wk) {
  return 4u * (size_t)(TM + 4 + 2 * round4(wk) + STAGES * RING_SLOT_WORDS);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

// 4-byte copy; src_bytes 0 zero-fills the destination word
__device__ inline void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V consecutive words at p (V = 4: one 16-byte load; p 16-byte aligned)
template <int V>
__device__ inline void load_words(uint32_t (&x)[V], const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ inline void store_words(uint32_t* p, const uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// out[0, n) = acc[0, n) (kAcc) or 0, by all threads of the block from
// `first` with stride `stride` in units of V words (n % V == 0).
template <bool kAcc, int V>
__device__ inline void fill(uint32_t* out, const uint32_t* acc, size_t n,
                            size_t first, size_t stride) {
#pragma unroll 1
  for (size_t i = first * V; i < n; i += stride * V) {
    uint32_t x[V];
    if constexpr (kAcc) {
      load_words<V>(x, acc + i);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = 0u;
    }
    store_words<V>(out + i, x);
  }
}

// Phase 1 over the tile's lhs (rows x wk words, contiguous at lhs_t), U
// words per load: per-row set-bit counts and the per-word union.
template <int U>
__device__ inline void scan_tile(const uint32_t* __restrict__ lhs_t, int rows,
                                 int wk, int* row_bits, uint32_t* uni) {
  constexpr int BATCH = 8;  // loads in flight per thread
  const int total = rows * (wk / U);
  for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * THREADS) {
    uint32_t x[BATCH][U];
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      const int e = e0 + t * THREADS;
      if (e < total) {
        load_words<U>(x[t], lhs_t + (size_t)e * U);
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) x[t][u] = 0u;
      }
    }
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      int bits = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) bits += __popc(x[t][u]);
      if (bits == 0) continue;
      const int word0 = (e0 + t * THREADS) * U;  // flat word index in tile
      const int r = word0 / wk;
      const int kw = word0 - r * wk;
      atomicAdd(&row_bits[r], bits);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (x[t][u]) atomicOr(&uni[kw + u], x[t][u]);
    }
  }
}

// a[q] |= rhs row at p, lane's units (q·32 + lane)·V of the chunk
template <int NV, int V>
__device__ inline void gather_or(uint32_t (&a)[NV][V], const uint32_t* p,
                                 int lane, int valid) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int j = (q * 32 + lane) * V;
    if (j < valid) {
      uint32_t x[V];
      load_words<V>(x, p + j);
#pragma unroll
      for (int v = 0; v < V; ++v) a[q][v] |= x[v];
    }
  }
}

// the same for two rows, both rows' loads issued before the ORs (three or
// four rows at once timed slower on the main path's data)
template <int NV, int V>
__device__ inline void gather_or2(uint32_t (&a)[NV][V], const uint32_t* p0,
                                  const uint32_t* p1, int lane, int valid) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int j = (q * 32 + lane) * V;
    if (j < valid) {
      uint32_t x[V], y[V];
      load_words<V>(x, p0 + j);
      load_words<V>(y, p1 + j);
#pragma unroll
      for (int v = 0; v < V; ++v) a[q][v] |= x[v] | y[v];
    }
  }
}

// Sparse path: each warp takes whole rows of the tile from a shared
// counter, rows first, first + stride, ... (the block's share of the tile).
// A row without set bits is only filled.
template <bool kAcc, int NV, int V>
__device__ void sparse_rows(const uint32_t* __restrict__ lhs_b,
                            const uint32_t* __restrict__ rhs_b,
                            const uint32_t* __restrict__ acc_b,
                            uint32_t* __restrict__ out_b, int row0, int rows,
                            int first, int stride, int wk, int w,
                            const int* row_bits, int* next_row) {
  constexpr int CW = 32 * NV * V;  // words per column chunk
  const int lane = threadIdx.x & 31;
  for (;;) {
    int r = 0;
    if (lane == 0) r = first + stride * atomicAdd(next_row, 1);
    r = __shfl_sync(FULL, r, 0);
    if (r >= rows) break;
    const size_t row = (size_t)(row0 + r);
    uint32_t* out_row = out_b + row * w;
    const uint32_t* acc_row = kAcc ? acc_b + row * w : nullptr;
    if (row_bits[r] == 0) {
      fill<kAcc, V>(out_row, acc_row, (size_t)w, lane, 32);
      continue;
    }
    const uint32_t* lhs_row = lhs_b + row * wk;
#pragma unroll 1
    for (int c0 = 0; c0 < w; c0 += CW) {
      const int valid = w - c0;
      uint32_t a[NV][V];
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int j = (q * 32 + lane) * V;
        if (kAcc && j < valid) {
          load_words<V>(a[q], acc_row + c0 + j);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) a[q][v] = 0u;
        }
      }
      const uint32_t* pending = nullptr;  // one rhs row waits for a partner
#pragma unroll 1
      for (int kw0 = 0; kw0 < wk; kw0 += 32 * LW) {
        uint32_t lw[LW];
#pragma unroll
        for (int t = 0; t < LW; ++t) {
          const int kw = kw0 + t * 32 + lane;
          lw[t] = kw < wk ? __ldg(lhs_row + kw) : 0u;
        }
#pragma unroll
        for (int t = 0; t < LW; ++t) {
          uint32_t ball = __ballot_sync(FULL, lw[t] != 0u);
          while (ball) {
            const int src = __ffs(ball) - 1;
            ball &= ball - 1u;
            uint32_t word = __shfl_sync(FULL, lw[t], src);
            const size_t kbase = 32u * (size_t)(kw0 + t * 32 + src);
            while (word) {
              const int bit = __ffs(word) - 1;
              word &= word - 1u;
              const uint32_t* p = rhs_b + (kbase + bit) * w + c0;
              if (pending == nullptr) {
                pending = p;
              } else {
                gather_or2<NV, V>(a, pending, p, lane, valid);
                pending = nullptr;
              }
            }
          }
        }
      }
      if (pending != nullptr) gather_or<NV, V>(a, pending, lane, valid);
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int j = (q * 32 + lane) * V;
        if (j < valid) store_words<V>(out_row + c0 + j, a[q]);
      }
    }
  }
}

// The thread's dense-path column of chunk word index d (0 <= d < DWT):
// 16-byte layout: 128·(d / 4) + tx·4 + d % 4; 4-byte layout: tx + 32·d.
// Either way a warp reads consecutive shared words.
template <int V>
__device__ inline int dense_col(int tx, int d) {
  if constexpr (V == 4) {
    return 128 * (d / 4) + tx * 4 + d % 4;
  } else {
    return tx + 32 * d;
  }
}

// Dense path: the ring of staged rhs rows, shared by the tile's 64 rows.
template <bool kAcc, int V>
__device__ void dense_tile(const uint32_t* __restrict__ lhs_b,
                           const uint32_t* __restrict__ rhs_b,
                           const uint32_t* __restrict__ acc_b,
                           uint32_t* __restrict__ out_b, int row0, int rows,
                           int wk, int w, const uint32_t* uni,
                           int* klist, int* nk_s, uint32_t* ring) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;  // the warp's rows: ty·8 .. ty·8 + 7
  // compact the non-zero union words into klist (warp 0, in order)
  if (ty == 0) {
    int cnt = 0;
    for (int base = 0; base < wk; base += 32) {
      const int kw = base + tx;
      const bool nz = kw < wk && uni[kw] != 0u;
      const unsigned ball = __ballot_sync(FULL, nz);
      if (nz) klist[cnt + __popc(ball & ((1u << tx) - 1u))] = kw;
      cnt += __popc(ball);
    }
    if (tx == 0) *nk_s = cnt;
  }
  __syncthreads();
  const int nk = *nk_s;

  // stage list entry i into ring slot s: the tile's lhs column and the
  // chunk's columns of the rhs rows of the union's set bits
  auto stage_word = [&](int i, int s, int c0) {
    uint32_t* slot = ring + (size_t)s * RING_SLOT_WORDS;
    const int kw = klist[i];
    const uint32_t u = uni[kw];
    if (tid < TM) {
      const bool ok = tid < rows;
      const uint32_t* src = lhs_b + (size_t)(row0 + (ok ? tid : 0)) * wk + kw;
      cp_async4(slot + tid, src, ok ? 4 : 0);
    }
    // each thread copies the piece of V words at column `col` of every
    // STEP-th staged row; rows of bits the union lacks are skipped
    constexpr int PIECES = DW / V;  // pieces per staged row
    constexpr int STEP = THREADS / PIECES;
    const int col = (tid % PIECES) * V;
    if (c0 + col >= w) return;
    uint32_t* dst = slot + TM + (tid / PIECES) * DW + col;
    const uint32_t* src = rhs_b + ((size_t)kw * 32u + tid / PIECES) * w + c0 + col;
#pragma unroll 1
    for (int bit = tid / PIECES; bit < 32;
         bit += STEP, dst += STEP * DW, src += (size_t)STEP * w) {
      if (!((u >> bit) & 1u)) continue;
      if constexpr (V == 4) {
        cp_async16(dst, src);
      } else {
        cp_async4(dst, src, 4);
      }
    }
  };

#pragma unroll 1
  for (int c0 = 0; c0 < w; c0 += DW) {
    uint32_t a[ROWS_PER_WARP][DWT];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int rr = ty * ROWS_PER_WARP + r;
#pragma unroll
      for (int d = 0; d < DWT; ++d) {
        const int col = c0 + dense_col<V>(tx, d);
        a[r][d] = (kAcc && rr < rows && col < w)
                      ? __ldg(acc_b + (size_t)(row0 + rr) * w + col)
                      : 0u;
      }
    }
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) stage_word(s, s, c0);
      cp_async_commit();
    }
#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // slot i is in; slot i - 1 is free for refill
      if (i + STAGES - 1 < nk)
        stage_word(i + STAGES - 1, (i + STAGES - 1) % STAGES, c0);
      cp_async_commit();

      const uint32_t* slot = ring + (size_t)(i % STAGES) * RING_SLOT_WORDS;
      uint32_t l[ROWS_PER_WARP];
      uint32_t any = 0u;
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        l[r] = slot[ty * ROWS_PER_WARP + r];
        any |= l[r];
      }
      // the bits that some row of this warp has: warp-uniform
      uint32_t bits = any & uni[klist[i]];
      const uint32_t* rs = slot + TM;
      while (bits) {
        const int bit = __ffs(bits) - 1;
        bits &= bits - 1u;
        uint32_t x[DWT];
        if constexpr (V == 4) {
#pragma unroll
          for (int h = 0; h < DWT / 4; ++h) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                rs + bit * DW + 128 * h + tx * 4);
            x[4 * h] = v.x; x[4 * h + 1] = v.y;
            x[4 * h + 2] = v.z; x[4 * h + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int d = 0; d < DWT; ++d) x[d] = rs[bit * DW + tx + 32 * d];
        }
        const int sh = 31 - bit;
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          const uint32_t mask = (uint32_t)((int32_t)(l[r] << sh) >> 31);
#pragma unroll
          for (int d = 0; d < DWT; ++d) a[r][d] |= x[d] & mask;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next chunk refills the ring from slot 0

#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int rr = ty * ROWS_PER_WARP + r;
      if (rr >= rows) continue;
      uint32_t* out_row = out_b + (size_t)(row0 + rr) * w + c0;
      if constexpr (V == 4) {
#pragma unroll
        for (int h = 0; h < DWT / 4; ++h)
          if (c0 + 128 * h + tx * 4 < w)
            *reinterpret_cast<uint4*>(out_row + 128 * h + tx * 4) = make_uint4(
                a[r][4 * h], a[r][4 * h + 1], a[r][4 * h + 2], a[r][4 * h + 3]);
      } else {
#pragma unroll
        for (int d = 0; d < DWT; ++d)
          if (c0 + tx + 32 * d < w) out_row[tx + 32 * d] = a[r][d];
      }
    }
  }
}

// kAcc: seed from acc (bitmm_or), else from zero.  NV units of V words per
// lane and sparse chunk; V = 4 needs w % 4 == 0 and 16-byte aligned rhs,
// acc and out.  Grid (tiles, B, blocks per tile).
template <bool kAcc, int NV, int V>
__global__ void __launch_bounds__(THREADS, 2)
bitmm_kernel(const uint32_t* __restrict__ lhs,
             const uint32_t* __restrict__ rhs,
             const uint32_t* __restrict__ acc,
             uint32_t* __restrict__ out,
             int m, int wk, int w, int sparse_max_bits) {
  extern __shared__ __align__(16) uint32_t smem[];
  int* row_bits = reinterpret_cast<int*>(smem);
  int* counters = row_bits + TM;  // [0] bits, [1] next row, [2] list size
  uint32_t* uni = smem + TM + 4;
  int* klist = reinterpret_cast<int*>(uni + round4(wk));
  uint32_t* ring = reinterpret_cast<uint32_t*>(klist + round4(wk));

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, m - row0);
  const size_t b = blockIdx.y;
  const uint32_t* lhs_b = lhs + b * (size_t)m * wk;
  const uint32_t* rhs_b = rhs + b * (size_t)wk * 32u * w;
  const uint32_t* acc_b = kAcc ? acc + b * (size_t)m * w : nullptr;
  uint32_t* out_b = out + b * (size_t)m * w;

  for (int i = tid; i < TM + 4; i += THREADS) smem[i] = 0u;
  for (int i = tid; i < wk; i += THREADS) uni[i] = 0u;
  __syncthreads();

  const uint32_t* lhs_t = lhs_b + (size_t)row0 * wk;
  if ((wk & 3) == 0 && (reinterpret_cast<uintptr_t>(lhs) & 15u) == 0)
    scan_tile<4>(lhs_t, rows, wk, row_bits, uni);
  else
    scan_tile<1>(lhs_t, rows, wk, row_bits, uni);
  __syncthreads();
  if (tid < 32) {
    int s = row_bits[tid] + row_bits[tid + 32];
    s = __reduce_add_sync(FULL, s);
    if (tid == 0) counters[0] = s;
  }
  __syncthreads();
  const int bits = counters[0];

  if (bits > sparse_max_bits) {
    if (blockIdx.z == 0)
      dense_tile<kAcc, V>(lhs_b, rhs_b, acc_b, out_b, row0, rows, wk, w, uni,
                          klist, &counters[2], ring);
  } else {
    // the sparse path; in an empty tile (bits == 0) every row is filled
    sparse_rows<kAcc, NV, V>(lhs_b, rhs_b, acc_b, out_b, row0, rows,
                             blockIdx.z, gridDim.z, wk, w, row_bits,
                             &counters[1]);
  }
}

template <bool kAcc, int NV, int V>
int launch_instance(const uint32_t* lhs, const uint32_t* rhs,
                    const uint32_t* acc, uint32_t* out, int B, int m, int wk,
                    int w, int sparse_max_bits, cudaStream_t stream) {
  auto kernel = bitmm_kernel<kAcc, NV, V>;
  // per device, once: allow the ring's dynamic shared memory, and note the
  // number of SMs (benign race: a second thread sets the same values)
  static int sms_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // a grid too small to fill the card splits each tile's rows over up to
  // kMaxSplit blocks (each scans the whole tile: the path choice needs it)
  const long long blocks = (long long)((m + TM - 1) / TM) * B;
  const long long target = (long long)kSplitPerSm * sms_of[dev];
  const long long want = (target + blocks - 1) / blocks;
  const int split = want <= 1 ? 1 : want >= kMaxSplit ? kMaxSplit : (int)want;
  const dim3 grid((m + TM - 1) / TM, B, split);
  kernel<<<grid, THREADS, smem_bytes(wk), stream>>>(lhs, rhs, acc, out, m, wk,
                                                     w, sparse_max_bits);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAcc>
int launch(const void* lhs_, const void* rhs_, const void* acc_, void* out_,
           int B, int m, int wk, int w, int sparse_max_bits, void* stream_) {
  const auto* lhs = static_cast<const uint32_t*>(lhs_);
  const auto* rhs = static_cast<const uint32_t*>(rhs_);
  const auto* acc = static_cast<const uint32_t*>(acc_);
  auto* out = static_cast<uint32_t*>(out_);
  auto stream = static_cast<cudaStream_t>(stream_);
  if (smem_bytes(wk) > (size_t)kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const bool vec = w % 4 == 0 && aligned(rhs) && aligned(out) &&
                   (!kAcc || aligned(acc));
  // 16-byte rows: NV = 1 for tile_bitmm's w = 4, NV = 4 for the closure
  // states' w = 496 (a multiple of 4, since states are padded to 128
  // columns); anything else (w % 4 != 0, a misaligned pointer) takes the
  // one 4-byte instance, in chunks of 256 words
  if (vec && w <= 128)
    return launch_instance<kAcc, 1, 4>(lhs, rhs, acc, out, B, m, wk, w,
                                       sparse_max_bits, stream);
  if (vec)
    return launch_instance<kAcc, 4, 4>(lhs, rhs, acc, out, B, m, wk, w,
                                       sparse_max_bits, stream);
  return launch_instance<kAcc, 8, 1>(lhs, rhs, acc, out, B, m, wk, w,
                                     sparse_max_bits, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on ``stream`` and
// returns a CUDA error code as an int: 0 when the launch was accepted.
extern "C" int repro_bitmm(const void* lhs, const void* rhs, void* out,
                           int B, int m, int wk, int w, void* stream) {
  return launch<false>(lhs, rhs, nullptr, out, B, m, wk, w, kSparseMaxBits,
                       stream);
}

extern "C" int repro_bitmm_or(const void* lhs, const void* rhs,
                              const void* acc, void* out,
                              int B, int m, int wk, int w, void* stream) {
  return launch<true>(lhs, rhs, acc, out, B, m, wk, w, kSparseMaxBits, stream);
}

// Either kernel with the path threshold given: acc null is bitmm, else
// bitmm_or.  sparse_max_bits 0 sends every non-empty tile to the dense
// path, INT_MAX every tile to the sparse one.  For timing and tests.
extern "C" int repro_bitmm_path(const void* lhs, const void* rhs,
                                const void* acc, void* out, int B, int m,
                                int wk, int w, int sparse_max_bits,
                                void* stream) {
  if (acc == nullptr)
    return launch<false>(lhs, rhs, nullptr, out, B, m, wk, w, sparse_max_bits,
                         stream);
  return launch<true>(lhs, rhs, acc, out, B, m, wk, w, sparse_max_bits, stream);
}

// The compiled-in threshold of repro_bitmm and repro_bitmm_or.
extern "C" int repro_bitmm_sparse_max_bits() { return kSparseMaxBits; }
