// The saturating count product of the count closures, by hand for Hopper
// (sm_90a): the sparse-row design of sparse_rows.cuh on the counting
// semiring, with the rhs rows gathered inside the kernel through a slab and
// a row index.
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
// slab (P,) and row (K,) int64; all contiguous.  The closures name the rhs
// rows of their count state C in place (slab = the productions' C
// operands, row = the active rows), so no gathered copy of C's rows
// exists, and the acc form folds the Jacobi step's base row and each
// production of one LHS into the same output: a chain of launches, one per
// production.
//
// Exactness.  Each product is one 32 x 32-bit multiply whose high word
// (__umulhi) says whether it passes SAT, clamped to SAT; the running sum is
// a 32-bit add clamped to SAT on carry.  Every term is >= 0, so the clamped
// running sum is min(SAT, the exact sum) whatever the order of the terms or
// the segments of a long row, and the result equals the plain version's
// bit for bit.  A zero lhs entry is skipped: its terms are 0.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 16.7e12 int32 operations/s on
// the SMs' integer lanes), counting what the inputs need.  Bytes: the lhs
// read once, of the rhs only the rows (s, r) that some non-zero lhs entry
// names, acc read once and out written once.  Operations: a multiply and
// an add per non-zero lhs entry per output column.  The closures' lhs is
// mostly zero (a count state is as sparse as its support), so bytes bound
// it: at R = K = 15,856, C = 15,872 (all pairs of pizza x 16, one
// production) lhs, acc and out take 1.0 GB each, 1.10 ms together.  The
// design (sparse_rows.cuh) reads each lhs word once per launch there and a
// row index only for a non-zero entry, and keeps 24 warps per SM streaming
// acc and out.
#include "sparse_rows.cuh"

namespace {

using sparse_rows::i64;
using u32 = unsigned;

struct CountRing {
  using T = u32;
  using V4 = uint4;
  static constexpr u32 kSat = 0xffffffffu;
  static __device__ T zero() { return 0u; }
  static __device__ V4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ V4 make4(T a, T b, T c, T d) {
    return make_uint4(a, b, c, d);
  }
  static __device__ bool take(T v) { return v != 0u; }
  static __device__ int bits(T v) { return static_cast<int>(v); }
  static __device__ T value(int b) { return static_cast<T>(b); }
  // min(SAT, a + min(SAT, v * x)): the product passes SAT iff its high word
  // is set, the sum iff it wrapped below an operand
  static __device__ T step(T a, T v, T x) {
    const T m = __umulhi(v, x) != 0u ? kSat : v * x;
    const T s = a + m;
    return s < a ? kSat : s;
  }
};

template <bool kVec, bool kAcc>
__global__ void __launch_bounds__(sparse_rows::kThreads,
                                  kVec ? sparse_rows::kMinBlocks
                                       : sparse_rows::kScalarMinBlocks)
count_mm_kernel(const u32* __restrict__ lhs, const u32* __restrict__ base,
                const i64* __restrict__ slab, const i64* __restrict__ row,
                const u32* __restrict__ acc, u32* __restrict__ out, int R,
                int K, int C, int base_rows, int splits,
                int span) {
  sparse_rows::product_row<CountRing, kVec, kAcc>(
      lhs, base, slab, row, acc, out, R, K, C, base_rows, splits, span);
}

// [16-byte columns][acc given]
const sparse_rows::RowsKernel<u32> kKernels[2][2] = {
    {count_mm_kernel<false, false>, count_mm_kernel<false, true>},
    {count_mm_kernel<true, false>, count_mm_kernel<true, true>}};

}  // namespace

// out = sat(acc + lhs (sat x, sat +) base[slab][:, row]) on ``stream``
// (see the header); slab, row and acc may be null.  Returns a CUDA error
// code (0: launched).  Shapes: lhs (P, R, K), base (S, base_rows, C), out
// (P, R, C); the wrapper has checked them and the index ranges.  Needs
// 1 <= P <= 65,535, R, C >= 1 and K >= 0.
extern "C" int repro_count_mm(const void* lhs, const void* base,
                              const void* slab, const void* row,
                              const void* acc, void* out, int P, int R, int K,
                              int C, int base_rows, void* stream) {
  return sparse_rows::launch<u32>(kKernels, lhs, base, slab, row, acc, out,
                                P, R, K, C, base_rows, stream);
}
