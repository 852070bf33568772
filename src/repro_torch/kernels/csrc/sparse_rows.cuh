// One design for the port's two gathered sparse-row products, instanced on
// a semiring: count_mm.cu (saturating x and + on uint32 counts in int32
// storage) and minplus.cu (an f32 add rounded to nearest, then min).  Each
// computes
//
//   out[p, i, j] = acc[p, i, j] (Ring::zero() without acc)
//                  (+) over k with Ring::take(lhs[p, i, k]) of
//                  lhs[p, i, k] (x) base[s, r, j]
//   with s = slab[p] (p without a slab index), r = row[k] (k without one)
//
// lhs (P, R, K), base (S, base_rows, C), acc and out (P, R, C) of the ring's
// 32-bit type; slab (P,) and row (K,) int64; all contiguous; out never
// aliases acc (the wrapper allocates it).  (+) must be associative and
// commutative on the ring's values, so the terms may come in any order and
// in any number of segments.
//
// What bounds it.  The closures' lhs is nearly all zero (count) or inf
// (min-plus): at all pairs of the count closure 10,576 non-zero entries in
// 251 M.  So the product moves bytes, not operations: the lhs read once,
// acc read once, out written once, and the few rhs rows that a taken entry
// names.  A design that rescans each lhs row once per output column tile,
// and reads the int64 row index of every entry, moves 16x the lhs and 32x
// it again in indices at C = 15,872; this one reads each lhs word once per
// column split (one split wherever the rows fill the card) and each row
// index only for an entry it takes.
//
// Design.  One warp per lhs row; a block of kWarps warps takes kWarps
// consecutive rows of one p, and each warp owns its row's whole output.
//  1. Scan: the warp reads its lhs row once, kU 16-byte loads in flight per
//     lane (a 4-byte fringe of at most 3 entries at each end where the row
//     is not 16-byte aligned), finds the taken entries with __ballot_sync,
//     and appends each one's (value, rhs row) to its list in shared memory:
//     the lane that holds an entry reads its row[k] and writes it.
//  2. Sweep: the warp walks the output in tiles of kTile columns, kCols
//     running sums per lane in registers (4 columns of each of kNV 16-byte
//     groups when C % 4 == 0 and base, acc and out are 16-byte aligned;
//     else kCols single columns 32 apart): it starts a tile from acc (or
//     zero), folds in each list entry's rhs row slice read in coalesced
//     loads, and stores the tile once.
//  3. A list holds kCap entries, as many as one scan step can find, so a
//     row with more is done in segments: when the next step's entries do
//     not fit, the warp sweeps what it has, then resumes the scan at that
//     step, and each later sweep starts its tiles from the sums it stored
//     (the same lane wrote those columns).  Any density is exact and in
//     bounds; a row beyond the first segment costs one more read and write
//     of its output per segment.
//  4. Occupancy: kMinBlocks blocks of kWarps warps per SM (registers capped
//     to match by __launch_bounds__; lists kCap x 8 bytes per warp), so
//     enough 16-byte loads are in flight to cover the scan's and the
//     sweep's latency; and when the P x R rows are too few to fill the
//     card twice over, each row's columns are split in spans of whole
//     tiles among several warps, each of which scans the row for itself.
//     The loop is warp-uniform and the warps share nothing: no block
//     barrier, only __syncwarp around the list.
// Offsets are 64-bit: a state holds (7, 15,872, 15,872) = 1.76e9 elements.
#pragma once

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace sparse_rows {

constexpr int kWarps = 8;                // lhs rows per block, one per warp
constexpr int kThreads = 32 * kWarps;
// blocks resident per SM (__launch_bounds__): 3 leave 85 registers a thread
// (4 leave 64, where the 16-byte instances spilled or ran slower); the
// single-column layout keeps a predicate per column through the list and
// takes 2 (128 registers) so as not to spill; it runs only on operands off
// the closures' path (C % 4 != 0 or a misaligned pointer)
constexpr int kMinBlocks = 3;
constexpr int kScalarMinBlocks = 2;
constexpr int kNV = 4;                   // 16-byte column groups per lane
constexpr int kCols = 4 * kNV;           // running sums per lane
constexpr int kTile = 32 * kCols;        // output columns per sweep step
constexpr int kU = 4;                    // 16-byte lhs loads per lane per step
constexpr int kStep = 32 * 4 * kU;       // lhs entries per scan step
constexpr int kCap = kStep;              // list entries per warp
constexpr unsigned kFull = 0xffffffffu;
// percent of the SM's 228 KB of shared memory that ``blocks`` blocks need
// (their lists and the 1 KB the system reserves per block)
constexpr int carveout(int blocks) {
  return (blocks * (kWarps * kCap * 8 + 1024) * 100 + 228 * 1024 - 1) /
         (228 * 1024);
}
using i64 = long long;  // the wrapper's int64 indices

// Column of sum e of this lane within a tile: the 16-byte layout puts sums
// 4q..4q+3 on columns 4 (lane + 32 q) + 0..3; the scalar layout puts sum e
// on column lane + 32 e.
template <bool kVec>
__device__ __forceinline__ int column(int lane, int e) {
  return kVec ? 4 * (lane + 32 * (e / 4)) + e % 4 : lane + 32 * e;
}

template <class V4>
__device__ __forceinline__ auto part(const V4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// The column a lane loads for its 16-byte group at ``col`` of a tile of
// ``lim`` columns: col itself, or past lim the tile's last group.  So a load
// takes no branch, the lane's loads issue together, and a group past lim
// reads values that are never stored.  (The scalar layout guards its loads
// instead: a clamp per column would give each of its loads an address
// register of its own, and the instances would spill.)
__device__ __forceinline__ int load_col(int col, int lim) {
  return min(col, lim - 4);
}

// a = the tile at src; kRo reads through the read-only path (acc), else
// plainly (out, which this warp wrote)
template <class Ring, bool kVec, bool kRo>
__device__ __forceinline__ void load_tile(typename Ring::T (&a)[kCols],
                                          const typename Ring::T* src,
                                          int lim) {
  using V4 = typename Ring::V4;
  const int lane = threadIdx.x & 31;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      const int col = load_col(column<true>(lane, 4 * q), lim);
      const V4* at = reinterpret_cast<const V4*>(src + col);
      const V4 x = kRo ? __ldg(at) : *at;
      a[4 * q] = x.x;
      a[4 * q + 1] = x.y;
      a[4 * q + 2] = x.z;
      a[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = column<false>(lane, e);
      if (col < lim) {
        a[e] = kRo ? __ldg(src + col) : src[col];
      }
    }
  }
}

// a = a (+) v (x) the rhs row slice at src
template <class Ring, bool kVec>
__device__ __forceinline__ void fold(typename Ring::T (&a)[kCols],
                                     const typename Ring::T* src,
                                     typename Ring::T v, int lim) {
  using V4 = typename Ring::V4;
  const int lane = threadIdx.x & 31;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      const int col = load_col(column<true>(lane, 4 * q), lim);
      const V4 x = __ldg(reinterpret_cast<const V4*>(src + col));
      a[4 * q] = Ring::step(a[4 * q], v, x.x);
      a[4 * q + 1] = Ring::step(a[4 * q + 1], v, x.y);
      a[4 * q + 2] = Ring::step(a[4 * q + 2], v, x.z);
      a[4 * q + 3] = Ring::step(a[4 * q + 3], v, x.w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = column<false>(lane, e);
      if (col < lim) {
        a[e] = Ring::step(a[e], v, __ldg(src + col));
      }
    }
  }
}

// dst = a over the lane's columns below lim
template <class Ring, bool kVec>
__device__ __forceinline__ void store_tile(typename Ring::T* dst,
                                           const typename Ring::T (&a)[kCols],
                                           int lim) {
  using V4 = typename Ring::V4;
  const int lane = threadIdx.x & 31;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      const int col = column<true>(lane, 4 * q);
      if (col < lim) {
        *reinterpret_cast<V4*>(dst + col) =
            Ring::make4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = column<false>(lane, e);
      if (col < lim) {
        dst[col] = a[e];
      }
    }
  }
}

// Append the lane's entry v at lhs column k to the list if the ring takes
// it; n counts the list and stays warp-uniform.
template <class Ring>
__device__ __forceinline__ void append(int2* list, int& n,
                                       typename Ring::T v, int k,
                                       const i64* __restrict__ row) {
  const bool t = Ring::take(v);
  const unsigned m = __ballot_sync(kFull, t);
  if (t) {
    const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
    const int r = row != nullptr ? static_cast<int>(__ldg(row + k)) : k;
    list[n + __popc(m & below)] = make_int2(Ring::bits(v), r);
  }
  n += __popc(m);
}

// The product of one lhs row over one span of output columns (see the
// header); every lane of the warp calls it.  Block x = (row group, column
// split), the splits of a row group adjacent; rows past R return at once
// (warp-uniform).
template <class Ring, bool kVec, bool kAcc>
__device__ __forceinline__ void product_row(
    const typename Ring::T* __restrict__ lhs,
    const typename Ring::T* __restrict__ base, const i64* __restrict__ slab,
    const i64* __restrict__ row, const typename Ring::T* __restrict__ acc,
    typename Ring::T* __restrict__ out, int R, int K, int C, int base_rows,
    int splits, int span) {
  using T = typename Ring::T;
  using V4 = typename Ring::V4;
  __shared__ int2 lists[kWarps][kCap];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int i = (blockIdx.x / splits) * kWarps + w;
  const int p = blockIdx.y;
  if (i >= R) {
    return;
  }
  const int c_begin = (blockIdx.x % splits) * span;
  const int c_end = min(C, c_begin + span);
  int2* list = lists[w];
  const i64 prow = static_cast<i64>(p) * R + i;
  const T* lrow = lhs + prow * K;
  T* orow = out + prow * C;
  const T* accrow = kAcc ? acc + prow * C : nullptr;
  const i64 s = slab != nullptr ? __ldg(slab + p) : p;
  const T* bslab = base + s * base_rows * static_cast<i64>(C);

  // the 16-byte body of the row, and its fringe of at most 3 entries at
  // each end
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(lrow) & 15);
  const int head = min(K, ((16 - skew) & 15) / 4);
  const int nvec = (K - head) / 4;
  const int tail = head + 4 * nvec;
  const V4* lvec = reinterpret_cast<const V4*>(lrow + head);

  int n = 0;
  {
    const int k = lane < head ? lane : tail + lane - head;
    const bool in = lane < head + (K - tail);
    append<Ring>(list, n, in ? __ldg(lrow + k) : Ring::zero(), k, row);
  }
  bool first = true;
  int q0 = 0;  // the next scan step's first 16-byte group
  for (;;) {
    bool full = false;
    for (; q0 < nvec; q0 += 32 * kU) {
      V4 x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {  // past nvec: the last group, unused
        const int q = q0 + 32 * u + lane;
        const V4 y = __ldg(lvec + min(q, nvec - 1));
        x[u] = q < nvec ? y : Ring::zero4();
      }
      int found = 0;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          found += __popc(__ballot_sync(kFull, Ring::take(part(x[u], c))));
        }
      }
      if (found == 0) {
        continue;
      }
      if (n + found > kCap) {
        full = true;  // sweep the list, then scan this step again
        break;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          append<Ring>(list, n, part(x[u], c),
                       head + 4 * (q0 + 32 * u + lane) + c, row);
        }
      }
    }
    __syncwarp();
    if (first || n > 0) {
      for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
        const int lim = c_end - c0;
        T a[kCols];
        if (!first) {
          load_tile<Ring, kVec, false>(a, orow + c0, lim);
        } else if (kAcc) {
          load_tile<Ring, kVec, true>(a, accrow + c0, lim);
        } else {
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            a[e] = Ring::zero();
          }
        }
#pragma unroll 1  // one entry at a time: unrolled, the instances spill
        for (int e = 0; e < n; ++e) {
          const int2 x = list[e];
          fold<Ring, kVec>(a, bslab + static_cast<i64>(x.y) * C + c0,
                           Ring::value(x.x), lim);
        }
        store_tile<Ring, kVec>(orow + c0, a, lim);
      }
    }
    if (!full) {
      return;
    }
    first = false;
    n = 0;
    __syncwarp();
  }
}

template <class T>
using RowsKernel = void (*)(const T*, const T*, const i64*, const i64*,
                            const T*, T*, int, int, int, int, int, int);

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launch kernels[vec][acc given] (the four instances of one ring) on
// ``stream``; returns a CUDA error code (0: launched).  Needs
// 1 <= P <= 65,535, R, C >= 1, K >= 0 and at most 2^31 - 1 blocks.
template <class T>
int launch(const RowsKernel<T> (&kernels)[2][2], const void* lhs,
           const void* base, const void* slab, const void* row,
           const void* acc, void* out, int P, int R, int K, int C,
           int base_rows, void* stream) {
  if (P < 1 || P > 65535 || R < 1 || C < 1 || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = C % 4 == 0 && aligned16(base) && aligned16(out) &&
                   (acc == nullptr || aligned16(acc));
  const RowsKernel<T> kernel = kernels[vec][acc != nullptr];
  // room in each SM's unified cache for kMinBlocks blocks' lists; the rest
  // stays L1 for rhs rows
  static const bool carved = [&] {
    for (const auto& pair : kernels) {
      for (const RowsKernel<T> k : pair) {
        cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             carveout(kMinBlocks));
      }
    }
    return true;
  }();
  (void)carved;
  // Column splits: when P x R warps cannot fill the card twice over, each
  // row's columns are split in spans of whole tiles among that many warps
  // (each scans the row for itself; the row is small then, and read from
  // L2 after the first).
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  const i64 rows = static_cast<i64>(P) * R;
  const i64 want = 2LL * sms * kMinBlocks * kWarps;
  const i64 tiles = (C + kTile - 1) / kTile;
  const i64 ask = rows >= want ? 1 : std::min(tiles, (want + rows - 1) / rows);
  const int span = static_cast<int>((tiles + ask - 1) / ask * kTile);
  const int splits = static_cast<int>((C + static_cast<i64>(span) - 1) / span);
  const i64 blocks = static_cast<i64>((R + kWarps - 1) / kWarps) * splits;
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks), P);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(base),
      static_cast<const i64*>(slab), static_cast<const i64*>(row),
      static_cast<const T*>(acc), static_cast<T*>(out), R, K, C, base_rows,
      splits, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sparse_rows
