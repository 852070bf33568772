// Bitpacked Boolean matrix multiplication over the AND/OR semiring, by hand
// for Hopper (sm_90a).
//
// Replaces two TPU kernels of repro/kernels/bitmm.py, as one kernel with a
// template flag:
//   * bitmm_pallas (body _bitmm_kernel), entry point repro_bitmm:
//
//       out[b, i, j] = OR over {k : bit k of lhs[b, i]} of rhs[b, k, j]
//
//   * bitmm_or_pallas (body _bitmm_or_kernel), entry point repro_bitmm_or —
//     the fused closure step  out = acc | (lhs x rhs):  each thread seeds
//     its OR accumulators from its acc words instead of from zero, so the
//     union costs one read of acc and no second pass over memory.  acc has
//     out's shape (B, m, w); bit 31 of an acc word survives like any other.
//     out must not alias acc or the operands (the wrapper always allocates
//     it): a thread reads its acc words before the k loop and writes the
//     same words of out after it, but the pointers are __restrict__.
//
// lhs (B, m, wk) words packing the contraction axis, rhs (B, k = 32·wk, w)
// words packing the output axis, out (B, m, w).  Bit t of word v is column
// 32v + t.  m != k is allowed (the masked closures contract R active rows
// against the full state).  Words are 32-bit; the wrapper passes int32
// tensors, read here as unsigned — the same bits.
//
// Bounds on an H100 SXM: about 2·B·m·k·w 32-bit integer operations (an AND
// and an OR per output word per contraction bit) on the SMs' INT32 lanes
// (132 SMs x 64 lanes x 1.98 GHz = 16.7e12 ops/s), and as bytes the three
// word arrays (four with acc) — but the rhs is re-read once per row tile:
// B·k·w·4·ceil(m/TM) bytes, which L2 (50 MB) absorbs only in part at full
// size.  The AND/OR count drops with the data: a k-step whose lhs word is
// zero on every row of the block contributes nothing and is skipped, which
// is exact with or without acc (acc only seeds the accumulators).
//
// Design.  The Pallas grid (B, m/ti, w/tw, k/tk) walks k sequentially with
// the output block resident in VMEM.  Here blocks are independent: the grid
// is (word tiles, row tiles, B) and each block runs the whole k loop
// itself, with its OR accumulators in registers.  A block of 32x8 threads
// owns TM = 64 rows x TW = 64 words; thread (tx, ty) owns rows ty*8..ty*8+7
// at words tx and tx+32, so its 16 accumulators share each mask it builds.
// Per chunk of KC lhs words the block stages the chunk's lhs words of its
// rows in shared memory; per contraction word it stages the 32 rhs rows of
// its word tile (coalesced over words), then every thread does
// acc |= rhs & -(bit) over the word's 32 bits.  The ragged edges in m and w
// are masked (at the main path w = 496, not a multiple of 32, 64 or 128).
// wgmma, TMA and tensor-core unpacking are left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // rows per block
constexpr int TW = 64;   // output words per block
constexpr int KC = 8;    // lhs words staged per chunk
constexpr int ROWS_PER_THREAD = TM / 8;

// kAcc: seed the accumulators from acc_in (bitmm_or); else from zero.
template <bool kAcc>
__global__ void __launch_bounds__(256)
bitmm_kernel(const uint32_t* __restrict__ lhs,
             const uint32_t* __restrict__ rhs,
             const uint32_t* __restrict__ acc_in,
             uint32_t* __restrict__ out,
             int m, int wk, int w) {
  __shared__ uint32_t lhs_s[TM][KC];
  __shared__ uint32_t rhs_s[32][TW];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int row0 = blockIdx.y * TM;
  const int word0 = blockIdx.x * TW;
  const size_t b = blockIdx.z;
  const uint32_t* lhs_b = lhs + b * (size_t)m * (size_t)wk;
  const uint32_t* rhs_b = rhs + b * (size_t)wk * 32u * (size_t)w;

  uint32_t acc[ROWS_PER_THREAD][2];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r][0] = acc[r][1] = 0u;
  if constexpr (kAcc) {
    // the same (row, word) cells this thread stores at the end
    const uint32_t* acc_b = acc_in + b * (size_t)m * (size_t)w;
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      const int row = row0 + ty * ROWS_PER_THREAD + r;
      if (row >= m) continue;
      if (word0 + tx < w) acc[r][0] = acc_b[(size_t)row * w + word0 + tx];
      if (word0 + tx + 32 < w) acc[r][1] = acc_b[(size_t)row * w + word0 + tx + 32];
    }
  }

  for (int kc = 0; kc < wk; kc += KC) {
    bool any = false;
    for (int e = tid; e < TM * KC; e += 256) {
      const int r = e / KC, c = e % KC;
      const int row = row0 + r, kw = kc + c;
      const uint32_t v =
          (row < m && kw < wk) ? lhs_b[(size_t)row * wk + kw] : 0u;
      lhs_s[r][c] = v;
      any |= v != 0u;
    }
    // the whole chunk is zero on every row of the block: nothing to OR
    if (!__syncthreads_or(any)) continue;

    for (int c = 0; c < KC && kc + c < wk; ++c) {
      uint32_t l[ROWS_PER_THREAD];
      bool mine = false;
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        l[r] = lhs_s[ty * ROWS_PER_THREAD + r][c];
        mine |= l[r] != 0u;
      }
      // also the barrier that frees rhs_s from the previous word
      if (!__syncthreads_or(mine)) continue;

      const uint32_t* src = rhs_b + (size_t)(kc + c) * 32u * (size_t)w;
      for (int i = ty; i < 32; i += 8) {
        const uint32_t* row = src + (size_t)i * w;
        rhs_s[i][tx] = (word0 + tx < w) ? row[word0 + tx] : 0u;
        rhs_s[i][tx + 32] = (word0 + tx + 32 < w) ? row[word0 + tx + 32] : 0u;
      }
      __syncthreads();

#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        const uint32_t r0 = rhs_s[bit][tx];
        const uint32_t r1 = rhs_s[bit][tx + 32];
#pragma unroll
        for (int r = 0; r < ROWS_PER_THREAD; ++r) {
          const uint32_t mask = 0u - ((l[r] >> bit) & 1u);
          acc[r][0] |= r0 & mask;
          acc[r][1] |= r1 & mask;
        }
      }
    }
    __syncthreads();  // lhs_s is rewritten by the next chunk
  }

  uint32_t* out_b = out + b * (size_t)m * (size_t)w;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int row = row0 + ty * ROWS_PER_THREAD + r;
    if (row >= m) continue;
    if (word0 + tx < w) out_b[(size_t)row * w + word0 + tx] = acc[r][0];
    if (word0 + tx + 32 < w) out_b[(size_t)row * w + word0 + tx + 32] = acc[r][1];
  }
}

template <bool kAcc>
int launch(const void* lhs, const void* rhs, const void* acc, void* out,
           int B, int m, int wk, int w, void* stream) {
  const dim3 grid((w + TW - 1) / TW, (m + TM - 1) / TM, B);
  const dim3 block(32, 8);
  bitmm_kernel<kAcc><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lhs), static_cast<const uint32_t*>(rhs),
      static_cast<const uint32_t*>(acc), static_cast<uint32_t*>(out),
      m, wk, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on ``stream`` and
// returns cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int repro_bitmm(const void* lhs, const void* rhs, void* out,
                           int B, int m, int wk, int w, void* stream) {
  return launch<false>(lhs, rhs, nullptr, out, B, m, wk, w, stream);
}

extern "C" int repro_bitmm_or(const void* lhs, const void* rhs,
                              const void* acc, void* out,
                              int B, int m, int wk, int w, void* stream) {
  return launch<true>(lhs, rhs, acc, out, B, m, wk, w, stream);
}
