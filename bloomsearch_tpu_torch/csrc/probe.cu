// Block-bloom probe (K1) for Hopper, with its three fused epilogues, and its
// access-pattern floor (K1f, probe_floor_kernel below).
//
// Replaces bloomsearch_tpu/bloom/pallas_kernels.py::probe_bank_pallas_tk
// (the Pallas probe) together with the XLA epilogues around it:
// probe_and_pack, probe_reduce_and_pack and probe_clauses_pack.
//
// What it computes. The superbank is int32[R, C]: row r = keyspace *
// num_words + word, column c = one data block's filter. For each term t < T
// and column c, term t matches iff bit shift[t*K + j] & 31 of
// bank[row_idx[t*K + j], c] is set for every j < K; a row outside [0, R)
// reads 0. The epilogue then packs (bit i of output word w is column
// 32w + i):
//   MODE_PACK     out[t, w]  = the T term words;
//   MODE_REDUCE   out[0, w]  = AND over the terms in and_bits (others true);
//   MODE_CLAUSES  out[m, w]  = member m survives its CNF: clause word i is
//                 the OR of its terms' words (clause_bits[i]), member word
//                 m the AND of its clauses' words (member_bits[m]); so a
//                 clause fails iff none of its terms match and a member
//                 survives iff none of its clauses fail.
//
// What bounds it. The work is T*K*C*4 bytes of bank reads (one coalesced
// 128-byte row segment a probe and 32 columns) plus the packed output, at
// 3.35 TB/s on an H100 SXM, against about 3 integer operations a probed
// word (shift, mask, AND) at 67 TOP/s: bytes bound every shape. At the
// engine's refscale shapes (C = 256, T*K <= 160) that is ~0.05 us, far
// below one memory round trip, so what a launch costs there is how many
// dependent round trips it makes; at the bench shape (C = 32,768, T = 4,
// K = 10, 5.2 MB of probed rows) it is how many bytes are in flight.
//
// Design.
// - One warp for each (term t, 32-column word w): lane l reads column
//   32w + l, so every probe is one coalesced 128-byte row segment, and one
//   __ballot_sync gives the term's packed word. The launch has T * C/32
//   warps (T = 16, C = 256: 128 warps; the bench shape: 4,096).
// - All of a term's K loads go out before the first is used: they are
//   sent into a register array in unrolled groups of LOAD_GROUP (16),
//   with no predicate (a probe outside the bank, or a slot past the K-th,
//   loads from a pad row instead), so a term costs one memory round trip
//   per 16 probes (the first form walked all T*K probes in each thread, 4
//   loads at a time: 40 dependent round trips at T = 16).
// - The probe arrays travel by value: row indices, shifts (one byte each)
//   and the epilogue masks are one __grid_constant__ parameter struct, read
//   from the constant bank (every lane of a warp reads the same entry, a
//   broadcast). No host-to-device copy and no staging round trip precede
//   the loads. The struct comes in two capacities (CAP below): 256
//   probes, which hold every launch of the engine and the bench (at most
//   16 terms of k = 10), and 6,400, the API's full range. A launch that
//   carries 32 KB of parameters takes longer on the card
//   (tools/exp_probe_variants.py times both). The larger needs CUDA >= 12.1
//   (kernel parameters above 4 KB).
// - A block holds the T warps of W consecutive words (W = ceil(BLOCK_WARPS
//   / T), at most 32 warps), so at small T a block still has BLOCK_WARPS
//   warps where C allows (tools/exp_probe_variants.py times 1 to 32). The term words of the block meet in shared
//   memory, one word per warp, and the reduce and clauses epilogues are
//   word algebra over them: no per-column bits remain after the ballot.
#include <cuda_runtime.h>
#include <stdint.h>

#define MODE_PACK 0
#define MODE_REDUCE 1
#define MODE_CLAUSES 2
#define MAX_TERMS 32
#define MAX_CLAUSES 32
#define MAX_MEMBERS 32
#define MAX_WARPS 32
#define LOAD_GROUP 16
#define BLOCK_WARPS 4  // least warps a block holds where C allows
#define CAP_SMALL 256
#define CAP_MAX 6400  // T*K (kernels/probe.py MAX_PROBES); 32,392 bytes of parameters
#define FULL_MASK 0xffffffffu

// Everything but the C entry points has internal linkage: a process may
// load two builds of this file (another version, to compare).
namespace {

template <int CAP>
struct Params {
  const int32_t* bank;
  int32_t* out;
  int64_t C;
  uint32_t rows_in;  // min(R, 2^31): row r is inside iff (uint32_t)r < rows_in
  int T, K, mode, words_per_block;
  uint32_t and_bits;  // bits of terms outside [0, T) cleared by the host
  int n_clauses, n_members;
  uint32_t clause_bits[MAX_CLAUSES];
  uint32_t member_bits[MAX_MEMBERS];
  // T*K probes, then LOAD_GROUP spare entries: a group past a term's last
  // probe reads them (or the next term's) and ignores what it reads.
  int32_t row[CAP + LOAD_GROUP];
  uint8_t shift[CAP + LOAD_GROUP];  // already & 31
};

// What a probe outside [0, R) reads (zeros), and what a slot past a term's
// K probes reads: ones for K1 (true under its AND), zeros for K1f (nothing
// under its OR). Indexed by lane, so the load stays one coalesced segment.
__device__ const int32_t kZeros[32] = {};
__device__ const int32_t kOnes[32] = {
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1};

// The K probed words of term t at column c, LOAD_GROUP loads in flight before
// any is used; use(word, shift) folds in a probe's word. The loads carry
// no predicate and no branch (predicate registers would run out and force
// the compiler to use each word before sending the next loads): each group
// first reads its 16 row indices and shifts (broadcasts from the constant
// bank, so none waits behind the loads), then selects each load's address,
// the bank's row segment or a 32-word pad row, loads all 16 and only then
// folds them in. row_mask is ~0 for K1 and ~7 for K1f (row 0 of the
// probe's aligned 8-row group); the row check is on the row itself either
// way.
template <int CAP, typename Use>
__device__ __forceinline__ void term_words(const Params<CAP>& p, int t, int64_t c,
                                           int32_t row_mask, const int32_t* past_k, Use use) {
  const int K = p.K;
  const int base = t * K;
  const int32_t C = (int32_t)p.C;  // < 2^31, checked by the host
  const uint32_t rows_in = p.rows_in;
  const int lane = (int)(c & 31);
  // Byte addresses, selected without a branch. The element offset of any
  // int32 row times C < 2^31 fits an int64; the unused address of a row
  // outside the bank wraps as an unsigned value.
  const uint64_t col = (uint64_t)(p.bank + c);
  const uint64_t zeros = (uint64_t)(kZeros + lane), pad = (uint64_t)(past_k + lane);
  for (int j0 = 0; j0 < K; j0 += LOAD_GROUP) {
    int32_t r[LOAD_GROUP];
    uint32_t sh[LOAD_GROUP];
#pragma unroll
    for (int u = 0; u < LOAD_GROUP; ++u) {
      r[u] = p.row[base + j0 + u];
      sh[u] = p.shift[base + j0 + u];
    }
    uint32_t v[LOAD_GROUP];
#pragma unroll
    for (int u = 0; u < LOAD_GROUP; ++u) {
      uint64_t at = col + ((uint64_t)((int64_t)(r[u] & row_mask) * C) << 2);
      at = (uint32_t)r[u] < rows_in ? at : zeros;
      at = j0 + u < K ? at : pad;
      v[u] = (uint32_t)__ldg((const int32_t*)at);
    }
#pragma unroll
    for (int u = 0; u < LOAD_GROUP; ++u) use(v[u], sh[u]);
  }
}

template <int CAP>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    probe_kernel(const __grid_constant__ Params<CAP> p) {
  __shared__ uint32_t s_word[MAX_WARPS];  // warp's term word: [local word][term]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = warp % p.T;
  const int64_t words = p.C >> 5;
  const int64_t w0 = (int64_t)blockIdx.x * p.words_per_block;
  const int64_t w = w0 + warp / p.T;

  // C is a multiple of 32, so a warp is wholly inside or wholly past the
  // bank, and the full-mask ballot never sees an idle lane.
  uint32_t word = 0;
  if (w < words) {
    uint32_t bit = 1;
    term_words(p, t, w * 32 + lane, ~0, kOnes,
               [&](uint32_t v, uint32_t sh) { bit &= (v >> sh) & 1u; });
    word = __ballot_sync(FULL_MASK, bit);
  }
  if (p.mode == MODE_PACK) {
    if (lane == 0 && w < words) p.out[t * words + w] = (int32_t)word;
    return;
  }
  if (lane == 0) s_word[warp] = word;
  __syncthreads();

  const uint32_t terms = p.T == 32 ? FULL_MASK : (1u << p.T) - 1u;
  const int W = p.words_per_block;
  if (p.mode == MODE_REDUCE) {
    if ((int)threadIdx.x >= W || w0 + threadIdx.x >= words) return;
    const uint32_t* tw = s_word + threadIdx.x * p.T;
    uint32_t acc = FULL_MASK;
    for (uint32_t m = p.and_bits; m; m &= m - 1) acc &= tw[__ffs(m) - 1];
    p.out[w0 + threadIdx.x] = (int32_t)acc;
    return;
  }
  // MODE_CLAUSES: thread (local word x, member m).
  const int x = threadIdx.x / MAX_MEMBERS, m = threadIdx.x % MAX_MEMBERS;
  if (x >= W || m >= p.n_members || w0 + x >= words) return;
  const uint32_t* tw = s_word + x * p.T;
  const uint32_t clauses = p.n_clauses == 32 ? FULL_MASK : (1u << p.n_clauses) - 1u;
  uint32_t acc = FULL_MASK;
  for (uint32_t cm = p.member_bits[m] & clauses; cm; cm &= cm - 1) {
    uint32_t clause = 0;
    for (uint32_t tm = p.clause_bits[__ffs(cm) - 1] & terms; tm; tm &= tm - 1)
      clause |= tw[__ffs(tm) - 1];
    acc &= clause;
  }
  p.out[m * words + w0 + x] = (int32_t)acc;
}

// K1f, the access-pattern floor of probe_kernel. Replaces the Pallas floor
// kernel of scripts/exp_kernel_floor.py (make_dma_kernel, pallas_call :165),
// which had K1's grid and block specs and a body of one OR. This kernel has
// K1's launch shape: the same warps (one a term and 32 columns), blocks and
// by-value probes (the shifts travel and are never read, as the TPU floor
// kernel prefetched them and never read them), the same grouped loads with
// the same row check. Its body keeps only an OR of the loaded words:
//   out[t, c] = OR over j < K of bank[row_idx[t*K + j] & ~7, c]
// (row 0 of each probe's aligned 8-row group, what the TPU kernel ORed; on
// Hopper the mask does not change the bytes read, one coalesced row segment a
// probe), written as int32[T, C]. What bounds it: the same T*K*C*4 bank
// bytes as K1 plus its unpacked output, 32 times K1's packed one, so it is
// compared with K1 each as a share of its own bound.
template <int CAP>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    probe_floor_kernel(const __grid_constant__ Params<CAP> p) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = warp % p.T;
  const int64_t w = (int64_t)blockIdx.x * p.words_per_block + warp / p.T;
  if (w >= (p.C >> 5)) return;
  const int64_t c = w * 32 + lane;
  uint32_t acc = 0;
  term_words(p, t, c, ~7, kZeros, [&](uint32_t v, uint32_t) { acc |= v; });
  p.out[t * p.C + c] = (int32_t)acc;
}

template <int CAP>
int launch(bool floor, const int32_t* bank, int64_t R, int64_t C, const int32_t* row_idx,
           const int32_t* shift, int T, int K, int mode, uint32_t and_bits,
           const uint32_t* clause_bits, int n_clauses, const uint32_t* member_bits,
           int n_members, int32_t* out, cudaStream_t stream) {
  static_assert(sizeof(Params<CAP>) <= 32764, "kernel parameters over 32,764 bytes");
  Params<CAP> p;
  p.bank = bank;
  p.out = out;
  p.C = C;
  p.rows_in = R > 0x7fffffff ? 0x80000000u : (uint32_t)R;
  p.T = T;
  p.K = K;
  p.mode = mode;
  const int64_t words = C / 32;
  int W = (BLOCK_WARPS + T - 1) / T;
  if (W > MAX_WARPS / T) W = MAX_WARPS / T;
  if (W > words) W = (int)words;
  if (W < 1) W = 1;
  p.words_per_block = W;
  p.and_bits = and_bits & (T == 32 ? FULL_MASK : (1u << T) - 1u);
  p.n_clauses = n_clauses;
  p.n_members = n_members;
  for (int i = 0; i < MAX_CLAUSES; ++i) p.clause_bits[i] = i < n_clauses ? clause_bits[i] : 0u;
  for (int m = 0; m < MAX_MEMBERS; ++m) p.member_bits[m] = m < n_members ? member_bits[m] : 0u;
  for (int i = 0; i < T * K + LOAD_GROUP; ++i) {
    p.row[i] = i < T * K ? row_idx[i] : 0;
    p.shift[i] = i < T * K ? (uint8_t)(shift[i] & 31) : 0;
  }
  const int64_t blocks = (words + W - 1) / W;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    if (floor)
      probe_floor_kernel<CAP><<<(unsigned)blocks, 32 * T * W, 0, stream>>>(p);
    else
      probe_kernel<CAP><<<(unsigned)blocks, 32 * T * W, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

int dispatch(bool floor, const int32_t* bank, int64_t R, int64_t C, const int32_t* row_idx,
             const int32_t* shift, int T, int K, int mode, uint32_t and_bits,
             const uint32_t* clause_bits, int n_clauses, const uint32_t* member_bits,
             int n_members, int32_t* out, void* stream) {
  if (T < 1 || T > MAX_TERMS || K < 1 || (int64_t)T * K > CAP_MAX || C < 0 || C % 32 != 0 ||
      C > 0x7fffffff || R < 0 || n_clauses < 0 || n_clauses > MAX_CLAUSES || n_members < 0 ||
      n_members > MAX_MEMBERS || mode < MODE_PACK || mode > MODE_CLAUSES)
    return (int)cudaErrorInvalidValue;
  const int P = T * K;
  cudaStream_t s = (cudaStream_t)stream;
  if (P <= CAP_SMALL)
    return launch<CAP_SMALL>(floor, bank, R, C, row_idx, shift, T, K, mode, and_bits,
                             clause_bits, n_clauses, member_bits, n_members, out, s);
  return launch<CAP_MAX>(floor, bank, R, C, row_idx, shift, T, K, mode, and_bits, clause_bits,
                         n_clauses, member_bits, n_members, out, s);
}

}  // namespace

// Plain C entry points, bound with ctypes. row_idx and shift (int32[T*K]),
// clause_bits and member_bits are HOST arrays: they travel by value in the
// kernel's parameters. Each launches on `stream` and returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int bs_probe_launch(const int32_t* bank, int64_t R, int64_t C,
                               const int32_t* row_idx, const int32_t* shift, int T, int K,
                               int mode, uint32_t and_bits, const uint32_t* clause_bits,
                               int n_clauses, const uint32_t* member_bits, int n_members,
                               int32_t* out, void* stream) {
  return dispatch(false, bank, R, C, row_idx, shift, T, K, mode, and_bits, clause_bits,
                  n_clauses, member_bits, n_members, out, stream);
}

// K1f's entry point: out is int32[T, C]. The same checks and launch shape.
extern "C" int bs_probe_floor_launch(const int32_t* bank, int64_t R, int64_t C,
                                     const int32_t* row_idx, const int32_t* shift, int T,
                                     int K, int32_t* out, void* stream) {
  return dispatch(true, bank, R, C, row_idx, shift, T, K, MODE_PACK, 0u, nullptr, 0, nullptr,
                  0, out, stream);
}
