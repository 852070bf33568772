// The block-sparse backend's tile contraction, by hand for Hopper (sm_90a):
// gather two packed bit-tiles per pair, multiply them over the AND/OR
// semiring and OR the product into the pair's output block, one launch for
// a whole bucket of pairs.
//
// Replaces the tile_bitmm entry of the TPU kernel bitmm_pallas
// (repro/kernels/ops.py:54, a bitmm_pallas launch over a batch of gathered
// tile pairs) together with the gather and the segment-OR around it in the
// reference's repro/core/blocksparse.py::_contract_chunk (:301-308):
//
//   for each pair p with seg[p] < n_out:
//     out[seg[p], i, :] |= OR over {k : bit k of store[l_idx[p], i]} of
//                          store[r_idx[p], k, :]
//
// Tiles are (B, W = B/32) words: row i, bit t of word v is column 32v + t
// (the layout of repro_torch.core.matrices.pack_bits).  store (n_store, B,
// W) is the slot store both operands are gathered from (tile_bitmm puts its
// two operand batches into one store).  out (n_out, B, W) holds the old
// tiles of the output blocks on entry (zeros for a block without a slot);
// the kernel only ORs into it, with atomicOr, so pairs that share an output
// block may run in any order and the result is exact: OR is associative and
// commutative.  A pad pair names segment n_out and does nothing.  A pair
// whose segment lies outside [0, n_out] or whose slot lies outside the
// store is skipped and sets *fault to 1, which the caller reads at its next
// host sync and raises on.  Words are 32-bit; the wrapper passes int32
// tensors, read here as unsigned.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 132 SMs x 64 INT32 lanes x
// 1.98 GHz = 16.7e12 integer ops/s).  Bytes: each distinct tile the bucket
// names read once (of a tile named only as an rhs, only the rows some set
// lhs bit needs) and one read and one write of each output block.
// Operations: one OR of a W-word rhs row per set lhs bit.
//
// Design (simple first; several pairs per block, cp.async staging and
// skipping empty lhs words are later work).  One block of B·W threads per
// pair: 512 at B = 128, 128 at B = 64, 32 at B = 32.  Each thread copies
// one word of each operand tile into shared memory (the block's loads are
// contiguous, 2 KB per tile at B = 128; a tile named by several pairs is
// read again by each, mostly from L2), then computes one output word
// (i, w): it walks the set bits of lhs row i with __ffs and ORs word w of
// the named rhs row, from shared memory.  A nonzero result is ORed into
// out with atomicOr; a zero one writes nothing.  The loop's trip count is
// the row's set-bit count, so empty rows (most of a sparse tile) cost
// nothing beyond the copy-in.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <int B>
__global__ void __launch_bounds__(B * (B / 32))
tile_contract_kernel(const uint32_t* __restrict__ store,
                     const int* __restrict__ l_idx,
                     const int* __restrict__ r_idx,
                     const int* __restrict__ seg,
                     uint32_t* __restrict__ out,
                     int* __restrict__ fault,
                     int n_store, int n_out) {
  constexpr int W = B / 32;
  constexpr int WORDS = B * W;
  __shared__ uint32_t lhs[WORDS];
  __shared__ uint32_t rhs[WORDS];
  const int p = blockIdx.x;
  const int s = seg[p];
  const int l = l_idx[p];
  const int r = r_idx[p];
  const int t = threadIdx.x;
  // block-uniform: a pad pair (s == n_out) or a pair out of range exits
  // before the barrier, with every thread of its block
  if (s == n_out) {
    return;
  }
  if (s < 0 || s > n_out || l < 0 || l >= n_store || r < 0 || r >= n_store) {
    if (t == 0) {
      atomicExch(fault, 1);
    }
    return;
  }
  lhs[t] = store[static_cast<size_t>(l) * WORDS + t];
  rhs[t] = store[static_cast<size_t>(r) * WORDS + t];
  __syncthreads();
  const int i = t / W;
  const int w = t % W;
  uint32_t acc = 0;
#pragma unroll
  for (int v = 0; v < W; ++v) {
    uint32_t bits = lhs[i * W + v];
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      acc |= rhs[(32 * v + b) * W + w];
    }
  }
  if (acc) {
    atomicOr(out + static_cast<size_t>(s) * WORDS + t, acc);
  }
}

template <int B>
cudaError_t launch(const void* store, const void* l_idx, const void* r_idx,
                   const void* seg, void* out, void* fault, int p,
                   int n_store, int n_out, cudaStream_t stream) {
  tile_contract_kernel<B><<<p, B * (B / 32), 0, stream>>>(
      static_cast<const uint32_t*>(store), static_cast<const int*>(l_idx),
      static_cast<const int*>(r_idx), static_cast<const int*>(seg),
      static_cast<uint32_t*>(out), static_cast<int*>(fault), n_store, n_out);
  return cudaGetLastError();
}

}  // namespace

// out[seg[p]] |= store[l_idx[p]] x store[r_idx[p]] for p < n_pairs, on
// ``stream``; *fault = 1 if a pair is out of range (see above).  B is the
// tile edge (32, 64 or 128).  Returns a CUDA error code (0: launched); an
// empty bucket (n_pairs < 1) is an error, never a launch.
extern "C" int repro_tile_contract(const void* store, const void* l_idx,
                                   const void* r_idx, const void* seg,
                                   void* out, void* fault, int n_pairs,
                                   int n_store, int n_out, int B,
                                   void* stream) {
  if (n_pairs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 32:
      return static_cast<int>(launch<32>(store, l_idx, r_idx, seg, out, fault,
                                         n_pairs, n_store, n_out, st));
    case 64:
      return static_cast<int>(launch<64>(store, l_idx, r_idx, seg, out, fault,
                                         n_pairs, n_store, n_out, st));
    case 128:
      return static_cast<int>(launch<128>(store, l_idx, r_idx, seg, out, fault,
                                          n_pairs, n_store, n_out, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
