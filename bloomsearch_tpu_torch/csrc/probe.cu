// Block-bloom probe (K1) for Hopper, with its three fused epilogues.
//
// Replaces bloomsearch_tpu/bloom/pallas_kernels.py::probe_bank_pallas_tk
// (the Pallas probe) together with the XLA epilogues around it:
// probe_and_pack, probe_reduce_and_pack and probe_clauses_pack.
//
// What it computes. The superbank is int32[R, C]: row r = keyspace *
// num_words + word, column c = one data block's filter. For each term t < T
// and column c, term t matches iff bit shift[t*K + j] of
// bank[row_idx[t*K + j], c] is set for every j < K. The epilogue then
// packs (bit i of output word w is column 32w + i):
//   MODE_PACK     out[t, w]  = the T match rows;
//   MODE_REDUCE   out[0, w]  = AND over the terms in and_bits (others true);
//   MODE_CLAUSES  out[m, w]  = member m survives its CNF: clause i fails iff
//                 none of its terms (clause_bits[i]) match, member m
//                 survives iff none of its clauses (member_bits[m]) fail.
//
// Design. One thread per bank column, one warp per 32 columns, so every
// probe is a coalesced read of a contiguous row segment. Each block stages
// the T*K row indices and shifts in shared memory (the TPU kernel had them
// scalar-prefetched). A thread keeps its T term results as bits of one
// register; the epilogue is a __ballot_sync per output row and lane 0
// writes the word. The [T, C] match matrix never reaches device memory,
// unlike the TPU form, whose epilogues read it back from HBM.
//
// What bounds it. The work is T*K*C*4 bytes of bank reads plus the packed
// output, at 3.35 TB/s on an H100 SXM. At the engine's refscale shapes
// (C = 256 columns, T*K <= 160 probes) that is ~0.05 us, far below the
// launch latency, so the kernel is launch-bound there; only banks with tens
// of thousands of columns (C = 32768) read enough to approach the memory
// bound. This simple form does no early exit and no cross-launch batching:
// that is left for a later change measured against these numbers.
#include <cuda_runtime.h>
#include <stdint.h>

#define MODE_PACK 0
#define MODE_REDUCE 1
#define MODE_CLAUSES 2
#define MAX_TERMS 32
#define MAX_CLAUSES 32
#define MAX_MEMBERS 32
#define THREADS 128

struct Epilogue {
  uint32_t and_bits;
  int n_clauses;
  int n_members;
  uint32_t clause_bits[MAX_CLAUSES];
  uint32_t member_bits[MAX_MEMBERS];
};

__global__ void __launch_bounds__(THREADS) probe_kernel(
    const int32_t* __restrict__ bank, int64_t R, int64_t C,
    const int32_t* __restrict__ row_idx, const int32_t* __restrict__ shift,
    int T, int K, int mode, Epilogue ep, int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* s_row = smem;
  int32_t* s_shift = smem + T * K;
  const int P = T * K;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    s_row[p] = row_idx[p];
    s_shift[p] = shift[p] & 31;
  }
  __syncthreads();

  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // C is a multiple of 32, so a warp is either wholly inside or wholly past
  // the bank: the full-mask ballots below never see an exited lane.
  if (c >= C) return;

  uint32_t match = 0;
  for (int t = 0; t < T; ++t) {
    uint32_t bit = 1;
#pragma unroll 4
    for (int j = 0; j < K; ++j) {
      const int p = t * K + j;
      const int64_t r = s_row[p];
      // A row past the bank reads nothing and never matches.
      const uint32_t w = (r >= 0 && r < R) ? (uint32_t)__ldg(bank + r * C + c) : 0u;
      bit &= (w >> s_shift[p]) & 1u;
    }
    match |= bit << t;
  }

  const int64_t words = C / 32;
  const int64_t word = c / 32;
  const bool lane0 = (threadIdx.x & 31) == 0;
  if (mode == MODE_PACK) {
    for (int t = 0; t < T; ++t) {
      const uint32_t b = __ballot_sync(0xffffffffu, (match >> t) & 1u);
      if (lane0) out[t * words + word] = (int32_t)b;
    }
  } else if (mode == MODE_REDUCE) {
    const uint32_t b = __ballot_sync(0xffffffffu, (match & ep.and_bits) == ep.and_bits);
    if (lane0) out[word] = (int32_t)b;
  } else {
    uint32_t fails = 0;
    for (int i = 0; i < ep.n_clauses; ++i)
      fails |= (uint32_t)((match & ep.clause_bits[i]) == 0) << i;
    for (int m = 0; m < ep.n_members; ++m) {
      const uint32_t b = __ballot_sync(0xffffffffu, (fails & ep.member_bits[m]) == 0);
      if (lane0) out[m * words + word] = (int32_t)b;
    }
  }
}

// Plain C entry point, bound with ctypes. clause_bits and member_bits are
// HOST arrays (they travel by value in the kernel's parameters). Launches on
// `stream` and returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int bs_probe_launch(const int32_t* bank, int64_t R, int64_t C,
                               const int32_t* row_idx, const int32_t* shift,
                               int T, int K, int mode, uint32_t and_bits,
                               const uint32_t* clause_bits, int n_clauses,
                               const uint32_t* member_bits, int n_members,
                               int32_t* out, void* stream) {
  if (T < 1 || T > MAX_TERMS || K < 1 || C % 32 != 0 || n_clauses < 0 ||
      n_clauses > MAX_CLAUSES || n_members < 0 || n_members > MAX_MEMBERS)
    return (int)cudaErrorInvalidValue;
  Epilogue ep = {};
  ep.and_bits = and_bits;
  ep.n_clauses = n_clauses;
  ep.n_members = n_members;
  for (int i = 0; i < n_clauses; ++i) ep.clause_bits[i] = clause_bits[i];
  for (int m = 0; m < n_members; ++m) ep.member_bits[m] = member_bits[m];
  const size_t smem = (size_t)2 * T * K * sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((C + THREADS - 1) / THREADS);
  if (blocks > 0)
    probe_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        bank, R, C, row_idx, shift, T, K, mode, ep, out);
  return (int)cudaGetLastError();
}
