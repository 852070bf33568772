// The saturating count product of the count closures, by hand for Hopper
// (sm_90a): a sparse gather over the non-zero lhs entries, with the rhs
// rows gathered inside the kernel through a slab and a row index.
//
// Replaces no TPU kernel: the reference computes the product in plain jnp
// (repro/core/semantics.py:695, _count_mm), and the port's plain version
// is repro_torch/kernels/ref.py::count_mm_ref.  It computes, on uint32
// counts held in int32 storage (SAT = 2^32 - 1, the all-ones word),
//
//   out[p, i, j] = min(SAT, acc[p, i, j] (0 without acc)
//                           + sum over k of min(SAT, lhs[p, i, k] * base[s, r, j]))
//   with s = slab[p] (p without a slab index), r = row[k] (k without one)
//
// lhs (P, R, K), base (S, base_rows, C), acc and out (P, R, C) int32;
// slab (P,) and row (K,) int64; all contiguous; out never aliases acc (the
// wrapper allocates it).  The closures name the rhs rows of their count
// state C in place (slab = the productions' C operands, row = the active
// rows), so no gathered copy of C's rows exists, and the acc form folds
// the Jacobi step's base row and each production of one LHS into the
// same output: a chain of launches, one per production.
//
// Exactness.  Each product is one 32 x 32 -> 64-bit multiply, clamped to
// SAT; the running sum is a 32-bit add clamped to SAT on carry.  Every
// term is >= 0, so the clamped running sum is min(SAT, the exact sum)
// whatever the order of the terms, and the result equals the plain
// version's bit for bit.  A zero lhs entry is skipped: its terms are 0.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 16.7e12 int32 operations/s on
// the SMs' integer lanes), counting what the inputs need.  Bytes: the lhs
// read once, of the rhs only the rows (s, r) that some non-zero lhs entry
// names, acc read once and out written once.  Operations: a multiply and
// an add per non-zero lhs entry per output column.  The closures' lhs is
// mostly zero (a count state is as sparse as its support), so the output
// store dominates: at R = 15,872, C = 15,872 (all pairs of pizza x 16,
// one production) it is 1.0 GB, about 0.3 ms.
//
// Design: the one of minplus.cu.  One warp per lhs row; a block of 8
// warps takes 8 consecutive rows of one p and one tile of 1,024 output
// columns, so each lane keeps 32 running sums in registers (4 columns of
// each of 8 16-byte groups when C % 4 == 0 and the pointers are 16-byte
// aligned; else 32 single columns 32 apart).  The warp reads its lhs row
// 128 entries at a time, finds the non-zero ones with __ballot_sync and
// walks them with __ffs, broadcasting each (value, row index) with
// __shfl_sync: the loop is warp-uniform, so no lane diverges and no
// shared memory or barrier is needed.  For each non-zero entry the warp
// reads the named rhs row's 1,024 columns in coalesced 16-byte loads and
// adds the clamped products; then it writes its output row's tile once.
// Column tiles vary fastest in the grid, so the blocks that share an lhs
// row run together and re-read it from L2.  Offsets are 64-bit: a count
// state holds (7, 15,872, 15,872) = 1.76e9 elements.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // lhs rows per block, one per warp
constexpr int kNV = 8;     // 16-byte column groups per lane
constexpr int kCols = 4 * kNV;  // running sums per lane
constexpr int kTile = 32 * kCols;  // output columns per block
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSat = 0xffffffffu;
using i64 = long long;  // the wrapper's int64 indices
using u32 = unsigned;

// min(SAT, a * b): the 64-bit product saturates iff its high word is set
__device__ __forceinline__ u32 sat_mul(u32 a, u32 b) {
  const unsigned long long p = static_cast<unsigned long long>(a) * b;
  return (p >> 32) != 0 ? kSat : static_cast<u32>(p);
}

// min(SAT, a + b): the 32-bit sum wrapped iff it is below an operand
__device__ __forceinline__ u32 sat_add(u32 a, u32 b) {
  const u32 s = a + b;
  return s < a ? kSat : s;
}

// Column of sum e of this lane within the block's tile: the 16-byte
// layout puts sums 4q..4q+3 on columns 4 (lane + 32 q) + 0..3; the scalar
// layout puts sum e on column lane + 32 e.
template <bool kVec>
__device__ __forceinline__ int column(int lane, int e) {
  return kVec ? 4 * (lane + 32 * (e / 4)) + e % 4 : lane + 32 * e;
}

template <bool kVec>
__device__ __forceinline__ void load_row(u32 (&a)[kCols], const u32* src,
                                         int lim) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      const int col = column<true>(threadIdx.x & 31, 4 * q);
      if (col < lim) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(src + col));
        a[4 * q] = x.x;
        a[4 * q + 1] = x.y;
        a[4 * q + 2] = x.z;
        a[4 * q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = column<false>(threadIdx.x & 31, e);
      if (col < lim) {
        a[e] = __ldg(src + col);
      }
    }
  }
}

// a = sat(a + sat(v * rhs row)) over the lane's columns below lim
template <bool kVec>
__device__ __forceinline__ void accumulate(u32 (&a)[kCols], const u32* src,
                                           u32 v, int lim) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      const int col = column<true>(threadIdx.x & 31, 4 * q);
      if (col < lim) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(src + col));
        a[4 * q] = sat_add(a[4 * q], sat_mul(v, x.x));
        a[4 * q + 1] = sat_add(a[4 * q + 1], sat_mul(v, x.y));
        a[4 * q + 2] = sat_add(a[4 * q + 2], sat_mul(v, x.z));
        a[4 * q + 3] = sat_add(a[4 * q + 3], sat_mul(v, x.w));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = column<false>(threadIdx.x & 31, e);
      if (col < lim) {
        a[e] = sat_add(a[e], sat_mul(v, __ldg(src + col)));
      }
    }
  }
}

template <bool kVec, bool kAcc>
__global__ void __launch_bounds__(32 * kWarps, 1)
count_mm_kernel(const u32* __restrict__ lhs, const u32* __restrict__ base,
                const i64* __restrict__ slab, const i64* __restrict__ row,
                const u32* __restrict__ acc, u32* __restrict__ out, int R,
                int K, int C, int base_rows, int col_tiles) {
  const int lane = threadIdx.x & 31;
  const int ct = blockIdx.x % col_tiles;
  const int i = (blockIdx.x / col_tiles) * kWarps + (threadIdx.x >> 5);
  const int p = blockIdx.y;
  if (i >= R) {
    return;  // warp-uniform; the kernel takes no barrier
  }
  const int c0 = ct * kTile;
  const int lim = C - c0;
  const i64 orow = (static_cast<i64>(p) * R + i) * C + c0;
  u32 a[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    a[e] = 0;
  }
  if (kAcc) {
    load_row<kVec>(a, acc + orow, lim);
  }
  const u32* lrow = lhs + (static_cast<i64>(p) * R + i) * K;
  const i64 s = slab != nullptr ? __ldg(slab + p) : p;
  const u32* bslab = base + s * base_rows * static_cast<i64>(C) + c0;
  for (int k0 = 0; k0 < K; k0 += 128) {
    u32 v[4];
    i64 r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 32 * u + lane;
      v[u] = k < K ? __ldg(lrow + k) : 0u;
      r[u] = (row != nullptr && k < K) ? __ldg(row + k) : k;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      unsigned m = __ballot_sync(kFull, v[u] != 0u);
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        const u32 lv = __shfl_sync(kFull, v[u], b);
        const i64 rk = __shfl_sync(kFull, r[u], b);
        accumulate<kVec>(a, bslab + rk * C, lv, lim);
      }
    }
  }
  u32* dst = out + orow;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      const int col = column<true>(lane, 4 * q);
      if (col < lim) {
        *reinterpret_cast<uint4*>(dst + col) =
            make_uint4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
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

template <bool kVec, bool kAcc>
cudaError_t launch(const u32* lhs, const u32* base, const i64* slab,
                   const i64* row, const u32* acc, u32* out, int P, int R,
                   int K, int C, int base_rows, cudaStream_t stream) {
  const int col_tiles = (C + kTile - 1) / kTile;
  const int row_tiles = (R + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>(col_tiles) * row_tiles, P);
  count_mm_kernel<kVec, kAcc><<<grid, 32 * kWarps, 0, stream>>>(
      lhs, base, slab, row, acc, out, R, K, C, base_rows, col_tiles);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// out = sat(acc + lhs (sat x, sat +) base[slab][:, row]) on ``stream``
// (see the header); slab, row and acc may be null.  Returns a CUDA error
// code (0: launched).  Shapes: lhs (P, R, K), base (S, base_rows, C), out
// (P, R, C); the wrapper has checked them and the index ranges.  Needs
// P <= 65,535, R, C >= 1 and (R / 8) * (C / 1,024) blocks within 2^31 - 1.
extern "C" int repro_count_mm(const void* lhs, const void* base,
                              const void* slab, const void* row,
                              const void* acc, void* out, int P, int R, int K,
                              int C, int base_rows, void* stream) {
  if (P < 1 || P > 65535 || R < 1 || C < 1 || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const i64 blocks = static_cast<i64>((C + kTile - 1) / kTile) *
                     ((R + kWarps - 1) / kWarps);
  if (blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* l = static_cast<const u32*>(lhs);
  const auto* b = static_cast<const u32*>(base);
  const auto* s = static_cast<const i64*>(slab);
  const auto* r = static_cast<const i64*>(row);
  const auto* a = static_cast<const u32*>(acc);
  auto* o = static_cast<u32*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && aligned16(base) && aligned16(out) &&
                   (acc == nullptr || aligned16(acc));
  cudaError_t err;
  if (vec) {
    err = acc != nullptr
              ? launch<true, true>(l, b, s, r, a, o, P, R, K, C, base_rows, st)
              : launch<true, false>(l, b, s, r, a, o, P, R, K, C, base_rows, st);
  } else {
    err = acc != nullptr
              ? launch<false, true>(l, b, s, r, a, o, P, R, K, C, base_rows, st)
              : launch<false, false>(l, b, s, r, a, o, P, R, K, C, base_rows, st);
  }
  return static_cast<int>(err);
}
