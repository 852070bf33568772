// The min-plus product of the single-path closures, by hand for Hopper
// (sm_90a): a sparse gather over the finite lhs entries, with the rhs rows
// gathered inside the kernel through a slab and a row index.
//
// Replaces no TPU kernel: the reference computes the product in plain jnp
// (repro/core/semantics.py:50, _minplus), and the port's plain version is
// repro_torch/kernels/ref.py::minplus_ref.  It computes
//
//   out[p, i, j] = min(acc[p, i, j] (inf without acc),
//                      min over k of lhs[p, i, k] + base[s, r, j])
//   with s = slab[p] (p without a slab index), r = row[k] (k without one)
//
// lhs (P, R, K) f32, base (S, base_rows, C) f32, slab (P,) and row (K,)
// int64, acc and out (P, R, C) f32, all contiguous; out never aliases acc
// (the wrapper allocates it).  The closures name the
// rhs rows of their length state L in place (slab = the productions' C
// operands, row = the active or context rows), so no gathered copy of L's
// rows exists.
//
// Exactness.  Every candidate is one f32 add, rounded to nearest
// (__fadd_rn: no contraction, and there is no multiply), and min is exact
// in any order, so the result equals the plain version's bit for bit.  An
// lhs entry that is not finite is skipped: +inf gives only +inf
// candidates.  Lengths are >= 0 (a NaN or a negative infinity is outside
// the domain; the plain version would differ on one).
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 67e12 float32 operations/s
// outside the tensor cores), counting what the inputs need.  Bytes: the
// lhs read once, of the rhs only the rows (s, r) that some finite lhs entry
// names, acc read once and out written once.  Operations: an add and a min
// per finite lhs entry per output column.  The closures' lhs is mostly
// inf: at R = 991, C = 15,872 (the dense single-path closure of one pizza
// copy) the output alone, (6, 991, 15,872) f32 = 377 MB, takes 0.113 ms,
// and the product is bound by bytes; a fully finite lhs of the same shape
// is bound by operations at 2.8 ms.
//
// Design.  One warp per lhs row; a block of 8 warps takes 8 consecutive
// rows of one p and one tile of TC = 1,024 output columns, so each lane
// keeps 32 running minima in registers (4 columns of each of 8 16-byte
// groups when C % 4 == 0 and the pointers are 16-byte aligned; else 32
// single columns 32 apart).  The warp reads its lhs row 128 entries at a
// time (4 coalesced loads in flight per lane, with their row indices),
// finds the finite entries with __ballot_sync and walks them with __ffs,
// broadcasting each (value, row index) with __shfl_sync: the loop is
// warp-uniform, so no lane diverges, and no shared memory or barrier is
// needed.  For each finite entry the warp reads the named rhs row's 1,024
// columns in coalesced 16-byte loads and relaxes its minima; then it
// writes its output row's tile once.  A row without a finite entry costs
// its lhs scan and its store (inf, or its acc row).  Column tiles vary
// fastest in the grid, so the blocks that share an lhs row run together
// and re-read it from L2.  Offsets are 64-bit: L itself holds
// (7, 15,872, 15,872) = 1.76e9 elements.  A fully finite lhs takes the
// same path: each entry costs a 4 KB rhs row read per warp, mostly from L1
// and L2 (a register-tiled dense path would reuse rhs rows across the
// block's rows; not written).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // lhs rows per block, one per warp
constexpr int kNV = 8;     // 16-byte column groups per lane
constexpr int kCols = 4 * kNV;  // running minima per lane
constexpr int kTile = 32 * kCols;  // output columns per block
constexpr unsigned kFull = 0xffffffffu;
using i64 = long long;  // the wrapper's int64 indices

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Column of minimum e of this lane within the block's tile: the 16-byte
// layout puts minima 4q..4q+3 on columns 4 (lane + 32 q) + 0..3; the
// scalar layout puts minimum e on column lane + 32 e.
template <bool kVec>
__device__ __forceinline__ int column(int lane, int e) {
  return kVec ? 4 * (lane + 32 * (e / 4)) + e % 4 : lane + 32 * e;
}

template <bool kVec>
__device__ __forceinline__ void load_row(float (&a)[kCols], const float* src,
                                         int lim) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      const int col = column<true>(threadIdx.x & 31, 4 * q);
      if (col < lim) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src + col));
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

// a = min(a, v + rhs row) over the lane's columns below lim
template <bool kVec>
__device__ __forceinline__ void relax(float (&a)[kCols], const float* src,
                                      float v, int lim) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      const int col = column<true>(threadIdx.x & 31, 4 * q);
      if (col < lim) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src + col));
        a[4 * q] = fminf(a[4 * q], __fadd_rn(v, x.x));
        a[4 * q + 1] = fminf(a[4 * q + 1], __fadd_rn(v, x.y));
        a[4 * q + 2] = fminf(a[4 * q + 2], __fadd_rn(v, x.z));
        a[4 * q + 3] = fminf(a[4 * q + 3], __fadd_rn(v, x.w));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = column<false>(threadIdx.x & 31, e);
      if (col < lim) {
        a[e] = fminf(a[e], __fadd_rn(v, __ldg(src + col)));
      }
    }
  }
}

template <bool kVec, bool kAcc>
__global__ void __launch_bounds__(32 * kWarps, 1)
minplus_kernel(const float* __restrict__ lhs, const float* __restrict__ base,
               const i64* __restrict__ slab, const i64* __restrict__ row,
               const float* __restrict__ acc, float* __restrict__ out,
               int R, int K, int C, int base_rows, int col_tiles) {
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
  float a[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    a[e] = inf();
  }
  if (kAcc) {
    load_row<kVec>(a, acc + orow, lim);
  }
  const float* lrow = lhs + (static_cast<i64>(p) * R + i) * K;
  const i64 s = slab != nullptr ? __ldg(slab + p) : p;
  const float* bslab = base + s * base_rows * static_cast<i64>(C) + c0;
  for (int k0 = 0; k0 < K; k0 += 128) {
    float v[4];
    i64 r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 32 * u + lane;
      v[u] = k < K ? __ldg(lrow + k) : inf();
      r[u] = (row != nullptr && k < K) ? __ldg(row + k) : k;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      unsigned m = __ballot_sync(kFull, v[u] < inf());
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        const float lv = __shfl_sync(kFull, v[u], b);
        const i64 rk = __shfl_sync(kFull, r[u], b);
        relax<kVec>(a, bslab + rk * C, lv, lim);
      }
    }
  }
  float* dst = out + orow;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      const int col = column<true>(lane, 4 * q);
      if (col < lim) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
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
cudaError_t launch(const float* lhs, const float* base, const i64* slab,
                   const i64* row, const float* acc, float* out, int P,
                   int R, int K, int C, int base_rows, cudaStream_t stream) {
  const int col_tiles = (C + kTile - 1) / kTile;
  const int row_tiles = (R + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>(col_tiles) * row_tiles, P);
  minplus_kernel<kVec, kAcc><<<grid, 32 * kWarps, 0, stream>>>(
      lhs, base, slab, row, acc, out, R, K, C, base_rows, col_tiles);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// out = min(acc, lhs (min,+) base[slab][:, row]) on ``stream`` (see the
// header); slab, row and acc may be null.  Returns a CUDA error code (0:
// launched).  Shapes: lhs (P, R, K), base (S, base_rows, C), out (P, R, C);
// the wrapper has checked them and the index ranges.  Needs P <= 65,535,
// R, C >= 1 and (R / 8) * (C / 1,024) blocks within 2^31 - 1.
extern "C" int repro_minplus(const void* lhs, const void* base,
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
  const auto* l = static_cast<const float*>(lhs);
  const auto* b = static_cast<const float*>(base);
  const auto* s = static_cast<const i64*>(slab);
  const auto* r = static_cast<const i64*>(row);
  const auto* a = static_cast<const float*>(acc);
  auto* o = static_cast<float*>(out);
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
