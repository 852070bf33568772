// The block-sparse backend's tile contraction, by hand for Hopper (sm_90a):
// one chunk of the block-sparse fixpoint in one launch.  Gather two packed
// bit-tiles per pair, multiply them over the AND/OR semiring, OR the
// product and the old tile into the pair's output block, and set each
// output block's flags.
//
// Replaces the tile_bitmm entry of the TPU kernel bitmm_pallas
// (repro/kernels/ops.py:54, a bitmm_pallas launch over a batch of gathered
// tile pairs) together with the gather, the segment-OR and the flags
// around it in the reference's repro/core/blocksparse.py::_contract_chunk
// (:301-308):
//
//   new[s] = old[s] | OR over pairs p with seg[p] == s of
//            store[l_idx[p]] x store[r_idx[p]]
//   changed[s] = new[s] != old[s],  nonzero[s] = new[s] != 0
//
// with old[s] the tile of slot out_slot[s] where out_exists[s], else zero.
// Tiles are (B, W = B/32) words: row i, bit t of word v is column 32v + t
// (the layout of repro_torch.core.matrices.pack_bits).  store (n_store, B,
// W) is the slot store both operands are gathered from.  out (n_out, B, W)
// is zero on entry; every product and old tile is ORed into it with
// atomicOr, so the blocks of the launch may run in any order and the result
// is exact: OR is associative and commutative.  changed[s] is set where a
// product has a bit the old tile lacks (the old words are read from the
// store, so the order of the blocks does not matter).  A pad pair names
// segment n_out and does nothing.  A pair whose segment lies outside
// [0, n_out] or whose slot lies outside the store, and an output whose old
// slot lies outside it, is skipped and sets *fault to 1, which the caller
// reads at its next host sync and raises on.  The launch also zeroes the
// work buffer that the next chunk will use (the caller alternates two; the
// previous chunk's results there were copied back before this launch).
// Words are 32-bit; the wrapper passes int32 tensors, read here as
// unsigned.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 132 SMs x 64 INT32 lanes x
// 1.98 GHz = 16.7e12 integer ops/s).  Bytes: each distinct tile the chunk
// names read once (of a tile named only as an rhs, only the rows some set
// lhs bit needs) and one read and one write of each output block.
// Operations: one OR of a W-word rhs row per set lhs bit.  A chunk of 512
// pairs of the million-node closure is bound by bytes at 0.3-0.7 us.
//
// Design.  A chunk is far below the card's size, so the time is the launch
// and the chain of dependent loads a block waits on; the design shares
// what pairs share and keeps the chain short.  The fixpoint enumerates
// pairs production -> row block -> k block -> column block, so consecutive
// pairs share their lhs slot in runs.  A block of 256 threads takes one
// run (cut at every 256th pair): block b starts at pair b, and exits at
// once unless pair b begins a run.  Its threads read the run's indices a
// pair each and find the run's end with a ballot (one round of loads).
// The block stages the lhs tile once with cp.async and lists its rows
// with a set bit once, with ballots; it streams the run's rhs tiles
// through a ring of two halves by cp.async, the copies of the next half
// in flight while the threads compute on this one.  The work of a half is
// its (pair, listed row) items, a thread each: the pairs of a run are
// computed side by side, and an empty lhs row costs nothing.  An item
// loads the old row of its output block (for the changed flag), walks the
// set bits of its lhs row with __ffs, ORs the named rhs rows from shared
// memory, and atomicOr-s each nonzero word into the output block (a zero
// word writes nothing).  Extra blocks OR in the old tiles, 4 words a
// thread, and every block zeroes a stride of the next chunk's buffer.
// On the card, a block's time to its compute is set by its chain of
// dependent loads (the run's indices, then its tiles) and barriers, not
// by the work: variants that issued the index loads together, walked four
// set bits a step, gathered the flags in shared memory, used 64-bit
// atomics or scheduled the old-tile blocks first were no faster, and are
// not kept.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads of a block; longest run a block takes
constexpr int kHalfBytes = 8192;  // one half of the rhs ring
constexpr unsigned kFull = 0xffffffffu;
using i64 = long long;

// W consecutive words of one tile row: one 4·W-byte load
template <int W>
struct Row {
  uint32_t w[W];
};

template <int W>
__device__ __forceinline__ Row<W> load_row(const uint32_t* src) {
  Row<W> r;
  if constexpr (W == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    r.w[0] = x.x;
    r.w[1] = x.y;
    r.w[2] = x.z;
    r.w[3] = x.w;
  } else if constexpr (W == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    r.w[0] = x.x;
    r.w[1] = x.y;
  } else {
    r.w[0] = *src;
  }
  return r;
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int B>
__global__ void __launch_bounds__(kThreads)
tile_contract_kernel(const uint32_t* __restrict__ store,
                     const int* __restrict__ l_idx,
                     const int* __restrict__ r_idx,
                     const int* __restrict__ seg,
                     const int* __restrict__ out_slot,
                     const int* __restrict__ out_exists, uint32_t* out,
                     int* flags, int* fault, int* zero, int zero_head,
                     int n_zero, int cap, int n_pairs, int n_store,
                     int n_out) {
  constexpr int W = B / 32;
  constexpr int WORDS = B * W;                   // words of a tile
  constexpr int kPieces = WORDS / 4;             // 16-byte pieces of a tile
  constexpr int kRing = kHalfBytes / (4 * WORDS);  // rhs tiles of a half
  constexpr int kWarps = kThreads / 32;
  __shared__ __align__(16) uint32_t s_lhs[WORDS];
  __shared__ __align__(16) uint32_t s_rhs[2][kRing * WORDS];
  __shared__ int s_r[kThreads];    // rhs slot of the run's pair j (-1: skip)
  __shared__ int s_seg[kThreads];  // its output block (-1: skip)
  __shared__ int s_old[kThreads];  // its output block's old slot (-1: none)
  __shared__ int s_rows[B];        // the lhs rows with a set bit
  __shared__ int s_end[kWarps];
  __shared__ int s_count[B / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // the next chunk's buffer: its flags [0, 2 cap) and dirty tiles
  const i64 total = 2 * static_cast<i64>(cap) + static_cast<i64>(n_zero) * WORDS;
  for (i64 q = static_cast<i64>(blockIdx.x) * kThreads + t; q < total;
       q += static_cast<i64>(gridDim.x) * kThreads) {
    zero[q < 2 * cap ? q : q - 2 * cap + zero_head] = 0;
  }

  if (static_cast<int>(blockIdx.x) >= n_pairs) {
    // words g .. g + 3 of output block s's old tile, and its nonzero flag
    const i64 g = (static_cast<i64>(blockIdx.x - n_pairs) * kThreads + t) * 4;
    const int s = static_cast<int>(g / WORDS);
    if (s >= n_out) {
      return;
    }
    const int slot = out_slot[s];  // loaded beside out_exists[s]
    if (!out_exists[s]) {
      return;
    }
    if (slot < 0 || slot >= n_store) {
      if (g % WORDS == 0) {
        atomicExch(fault, 1);
      }
      return;
    }
    const uint4 x = *reinterpret_cast<const uint4*>(
        store + static_cast<i64>(slot) * WORDS + g % WORDS);
    uint32_t* o = out + g;
    if (x.x) atomicOr(o, x.x);
    if (x.y) atomicOr(o + 1, x.y);
    if (x.z) atomicOr(o + 2, x.z);
    if (x.w) atomicOr(o + 3, x.w);
    if (x.x | x.y | x.z | x.w) {
      flags[cap + s] = 1;
    }
    return;
  }

  // block b takes the run that begins at pair b, if one does
  const int p0 = blockIdx.x;
  const int l = l_idx[p0];
  if (p0 % kThreads != 0 && l_idx[p0 - 1] == l) {
    return;
  }
  const int lim = min(n_pairs, (p0 / kThreads + 1) * kThreads);
  const int q = p0 + t;
  bool in = false;
  int r = 0;
  int s = n_out;
  if (q < lim) {
    in = t == 0 || l_idx[q] == l;
    r = r_idx[q];
    s = seg[q];
  }
  // the run is pairs p0 .. p0 + n - 1: n is the first thread not in it
  const unsigned gone = __ballot_sync(kFull, !in);
  if (lane == 0) {
    s_end[warp] = gone ? warp * 32 + __ffs(gone) - 1 : kThreads;
  }
  const bool l_ok = l >= 0 && l < n_store;
  if (l_ok) {
    for (int c = t; c < kPieces; c += kThreads) {
      cp_async16(&s_lhs[4 * c], store + static_cast<i64>(l) * WORDS + 4 * c);
    }
  }
  __syncthreads();
  int n = kThreads;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    n = min(n, s_end[w]);
  }
  // pair t of the run: checked, and its output's old slot loaded
  int slot = -1;
  int exists = 0;
  if (t < n) {
    const bool pad = s == n_out;
    const bool ok = !pad && s >= 0 && s < n_out && l_ok && r >= 0 && r < n_store;
    if (!pad && !ok) {
      atomicExch(fault, 1);
    }
    s_r[t] = ok ? r : -1;
    s_seg[t] = ok ? s : -1;
    if (ok) {
      slot = out_slot[s];
      exists = out_exists[s];
    }
  }
  __syncthreads();
  const int rounds = (n + kRing - 1) / kRing;
  // the rhs tiles of round k into half k & 1, as one cp.async group
  auto issue = [&](int k) {
    const int j0 = k * kRing;
    const int m = min(kRing, n - j0);
    for (int c = t; c < m * kPieces; c += kThreads) {
      const int jj = c / kPieces;
      const int rr = s_r[j0 + jj];
      if (rr >= 0) {
        cp_async16(&s_rhs[k & 1][jj * WORDS + 4 * (c % kPieces)],
                   store + static_cast<i64>(rr) * WORDS + 4 * (c % kPieces));
      }
    }
    cp_async_commit();
  };
  issue(0);  // one group with the lhs tile
  if (t < n) {
    s_old[t] = exists && slot >= 0 && slot < n_store ? slot : -1;
  }
  int nr = 0;
  for (int k = 0; k < rounds; ++k) {
    if (k + 1 < rounds) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (k == 0) {
      // list the lhs rows with a set bit, once for the run
      bool nz = false;
      unsigned set = 0;
      if (t < B) {  // whole warps: B is a multiple of 32
        const Row<W> a = load_row<W>(&s_lhs[t * W]);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          nz |= a.w[w] != 0;
        }
        nz &= l_ok;
        set = __ballot_sync(kFull, nz);
        if (lane == 0) {
          s_count[warp] = __popc(set);
        }
      }
      __syncthreads();
      int before = 0;
#pragma unroll
      for (int w = 0; w < B / 32; ++w) {
        before += w < warp ? s_count[w] : 0;
        nr += s_count[w];
      }
      if (nz) {
        s_rows[before + __popc(set & ((1u << lane) - 1))] = t;
      }
      __syncthreads();
    }
    // the half's (pair, listed row) items, a thread each
    const int j0 = k * kRing;
    const int m = min(kRing, n - j0);
    const uint32_t* half = s_rhs[k & 1];
    for (int it = t; it < m * nr; it += kThreads) {
      const int jj = it / nr;
      const int o = s_seg[j0 + jj];
      if (o < 0) {
        continue;
      }
      const int i = s_rows[it - jj * nr];
      const int os = s_old[j0 + jj];
      Row<W> old{};
      if (os >= 0) {
        old = load_row<W>(store + static_cast<i64>(os) * WORDS + i * W);
      }
      const Row<W> a = load_row<W>(&s_lhs[i * W]);
      const uint32_t* rhs = half + jj * WORDS;
      Row<W> acc{};
#pragma unroll
      for (int v = 0; v < W; ++v) {
        uint32_t bits = a.w[v];
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const Row<W> x = load_row<W>(rhs + (32 * v + b) * W);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            acc.w[w] |= x.w[w];
          }
        }
      }
      bool nonzero = false;
      bool changed = false;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (acc.w[w]) {
          atomicOr(out + static_cast<i64>(o) * WORDS + i * W + w, acc.w[w]);
          nonzero = true;
          changed |= (acc.w[w] & ~old.w[w]) != 0;
        }
      }
      if (nonzero) {
        flags[cap + o] = 1;
      }
      if (changed) {
        flags[o] = 1;
      }
    }
    __syncthreads();  // the half is free for round k + 2
  }
}

template <int B>
cudaError_t launch(const void* store, const void* l_idx, const void* r_idx,
                   const void* seg, const void* out_slot,
                   const void* out_exists, void* out, void* flags,
                   void* fault, void* zero, int zero_head, int n_zero,
                   int cap, int n_pairs, int n_store, int n_out,
                   cudaStream_t stream) {
  constexpr int kOldWords = kThreads * 4;  // old-tile words of a block
  const i64 old_words = static_cast<i64>(n_out) * B * (B / 32);
  const int blocks = n_pairs + static_cast<int>((old_words + kOldWords - 1) / kOldWords);
  tile_contract_kernel<B><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(store), static_cast<const int*>(l_idx),
      static_cast<const int*>(r_idx), static_cast<const int*>(seg),
      static_cast<const int*>(out_slot), static_cast<const int*>(out_exists),
      static_cast<uint32_t*>(out), static_cast<int*>(flags),
      static_cast<int*>(fault), static_cast<int*>(zero), zero_head, n_zero,
      cap, n_pairs, n_store, n_out);
  return cudaGetLastError();
}

}  // namespace

// One chunk on ``stream``: out (n_out, B, W), zero on entry, becomes the new
// tiles (see above); flags[s] / flags[cap + s] (zero on entry) are set to
// the changed / nonzero flags of output s; *fault = 1 if a pair or an old
// slot is out of range; zero's flags [0, 2 cap) and its tiles
// [zero_head, zero_head + n_zero·B·W) are zeroed.  B is the tile edge (32,
// 64 or 128).  Returns a CUDA error code (0: launched); an empty chunk
// (n_pairs < 1) is an error, never a launch.
extern "C" int repro_tile_contract(const void* store, const void* l_idx,
                                   const void* r_idx, const void* seg,
                                   const void* out_slot,
                                   const void* out_exists, void* out,
                                   void* flags, void* fault, void* zero,
                                   int zero_head, int n_zero, int cap,
                                   int n_pairs, int n_store, int n_out, int B,
                                   void* stream) {
  if (n_pairs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 32:
      return static_cast<int>(launch<32>(
          store, l_idx, r_idx, seg, out_slot, out_exists, out, flags, fault,
          zero, zero_head, n_zero, cap, n_pairs, n_store, n_out, st));
    case 64:
      return static_cast<int>(launch<64>(
          store, l_idx, r_idx, seg, out_slot, out_exists, out, flags, fault,
          zero, zero_head, n_zero, cap, n_pairs, n_store, n_out, st));
    case 128:
      return static_cast<int>(launch<128>(
          store, l_idx, r_idx, seg, out_slot, out_exists, out, flags, fault,
          zero, zero_head, n_zero, cap, n_pairs, n_store, n_out, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
