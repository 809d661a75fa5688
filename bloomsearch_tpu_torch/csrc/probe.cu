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
// - One launch covers every shard a card holds (bloomsearch_tpu/parallel/
//   mesh.py's sharded_probe_* ran the probe on each block-axis shard under
//   shard_map; the port's K3 wrappers, parallel/mesh.py). The launch takes
//   a table of up to MAX_SHARDS shard pointers, all [R, C]; word w of the
//   launch is word w % (C/32) of shard w / (C/32), and every store goes to
//   row * out_stride + first_word + w, so the card's words land where they
//   belong in the joined bitmap of the whole mesh, which may be page-locked
//   host memory the kernel writes through its device address. The
//   single-device launch (one shard, stride C/32) runs an instantiation
//   without the shard lookup, so its code is the unsharded kernel's.
// - Every launch of one query's probe, on one card or on each card of a
//   mesh, is issued and waited for by one C call (bs_probe_plan below):
//   the parameter struct, 32 KB at the larger capacity, is filled once and
//   each launch patches only its banks and output address; the device is
//   switched only where the card changes and each card is waited for on
//   one event. What a call then costs the host is one foreign call, not
//   one a launch.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <time.h>

#define MODE_PACK 0
#define MODE_REDUCE 1
#define MODE_CLAUSES 2
#define MAX_TERMS 32
#define MAX_CLAUSES 32
#define MAX_MEMBERS 32
#define MAX_WARPS 32
#define MAX_SHARDS 8  // shards one launch covers (kernels/probe.py MAX_SHARDS)
#define MAX_DEVICES 64  // card indices a plan record may name
#define LOAD_GROUP 16
#define BLOCK_WARPS 4  // least warps a block holds where C allows
#define CAP_SMALL 256
#define CAP_MAX 6400  // T*K (kernels/probe.py MAX_PROBES); 32,480 bytes of parameters
#define FULL_MASK 0xffffffffu

// Everything but the C entry points has internal linkage: a process may
// load two builds of this file (another version, to compare).
namespace {

template <int CAP>
struct Params {
  const int32_t* bank;  // the first (or only) shard, int32[R, C]
  int32_t* out;
  int64_t C;  // columns of one shard
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
  // The general layout only (probe_kernel<CAP, true>), after the fields the
  // single-device launch reads, which keep their places:
  const int32_t* shards[MAX_SHARDS];  // this launch's shards, shards[0] == bank
  int64_t words;             // output words of the launch: n_shards * C/32
  int64_t out_stride;        // words from one output row to the next
  uint32_t words_per_shard;  // C/32
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
__device__ __forceinline__ void term_words(const Params<CAP>& p, const int32_t* bank, int t,
                                           int64_t c, int32_t row_mask, const int32_t* past_k,
                                           Use use) {
  const int K = p.K;
  const int base = t * K;
  const int32_t C = (int32_t)p.C;  // < 2^31, checked by the host
  const uint32_t rows_in = p.rows_in;
  const int lane = (int)(c & 31);
  // Byte addresses, selected without a branch. The element offset of any
  // int32 row times C < 2^31 fits an int64; the unused address of a row
  // outside the bank wraps as an unsigned value.
  const uint64_t col = (uint64_t)(bank + c);
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

// SHARDED: the launch's general layout (several shards, or an output wider
// than one bank); else one bank into its own [rows, C/32] output, the
// single-device launch, which then takes no division and no table lookup.
template <int CAP, bool SHARDED>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    probe_kernel(const __grid_constant__ Params<CAP> p) {
  __shared__ uint32_t s_word[MAX_WARPS];  // warp's term word: [local word][term]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = warp % p.T;
  const int64_t words = SHARDED ? p.words : p.C >> 5;
  const int64_t stride = SHARDED ? p.out_stride : words;
  const int64_t w0 = (int64_t)blockIdx.x * p.words_per_block;
  const int64_t w = w0 + warp / p.T;
  int32_t* const out = p.out;  // word w of row r: out[r * stride + w]

  // C is a multiple of 32, so a warp is wholly inside or wholly past the
  // bank, and the full-mask ballot never sees an idle lane. Word w is
  // shard w / words_per_shard's word w % words_per_shard.
  uint32_t word = 0;
  if (w < words) {
    const int32_t* bank = p.bank;
    uint32_t local = (uint32_t)w;
    if (SHARDED) {
      const uint32_t shard = local / p.words_per_shard;
      local -= shard * p.words_per_shard;
      bank = p.shards[shard];
    }
    uint32_t bit = 1;
    term_words(p, bank, t, (int64_t)local * 32 + lane, ~0, kOnes,
               [&](uint32_t v, uint32_t sh) { bit &= (v >> sh) & 1u; });
    word = __ballot_sync(FULL_MASK, bit);
  }
  if (p.mode == MODE_PACK) {
    if (lane == 0 && w < words) out[t * stride + w] = (int32_t)word;
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
    out[w0 + threadIdx.x] = (int32_t)acc;
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
  out[m * stride + w0 + x] = (int32_t)acc;
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
  term_words(p, p.bank, t, c, ~7, kZeros, [&](uint32_t v, uint32_t) { acc |= v; });
  p.out[t * p.C + c] = (int32_t)acc;
}

// The probes and the epilogue of one call, as the C entry points take
// them: the part of Params that every launch of the call shares.
struct Probes {
  const int32_t* row_idx;  // host int32[T*K]
  const int32_t* shift;    // host int32[T*K]
  int T, K, mode;
  uint32_t and_bits;
  const uint32_t* clause_bits;
  int n_clauses;
  const uint32_t* member_bits;
  int n_members;
};

// One launch's banks and where its words go.
struct Target {
  const int32_t* const* banks;  // n_shards shard pointers, each int32[R, C]
  int n_shards;
  int64_t R, C;
  int32_t* out;  // device address of the launch's first word of output row 0
  int64_t out_stride;
};

bool probes_ok(const Probes& q) {
  return q.T >= 1 && q.T <= MAX_TERMS && q.K >= 1 && (int64_t)q.T * q.K <= CAP_MAX &&
         q.n_clauses >= 0 && q.n_clauses <= MAX_CLAUSES && q.n_members >= 0 &&
         q.n_members <= MAX_MEMBERS && q.mode >= MODE_PACK && q.mode <= MODE_CLAUSES;
}

bool target_ok(int n_shards, int64_t R, int64_t C, int64_t first_word, int64_t out_stride) {
  return n_shards >= 1 && n_shards <= MAX_SHARDS && C >= 0 && C % 32 == 0 && C <= 0x7fffffff &&
         R >= 0 && first_word >= 0 && out_stride >= first_word + (int64_t)n_shards * (C / 32);
}

// The shared part of p, filled once a call: the probes (rows and shifts
// past the last, the LOAD_GROUP spare entries, read as row 0 and ignored),
// the masks and the mode.
template <int CAP>
void fill_probes(Params<CAP>& p, const Probes& q) {
  const int T = q.T, n = q.T * q.K;
  p.T = T;
  p.K = q.K;
  p.mode = q.mode;
  p.and_bits = q.and_bits & (T == 32 ? FULL_MASK : (1u << T) - 1u);
  p.n_clauses = q.n_clauses;
  p.n_members = q.n_members;
  for (int i = 0; i < MAX_CLAUSES; ++i) p.clause_bits[i] = i < q.n_clauses ? q.clause_bits[i] : 0u;
  for (int m = 0; m < MAX_MEMBERS; ++m) p.member_bits[m] = m < q.n_members ? q.member_bits[m] : 0u;
  for (int i = 0; i < n; ++i) {
    p.row[i] = q.row_idx[i];
    p.shift[i] = (uint8_t)(q.shift[i] & 31);
  }
  for (int i = n; i < n + LOAD_GROUP; ++i) {
    p.row[i] = 0;
    p.shift[i] = 0;
  }
}

// One launch of p (its probes filled) over t, the launch's own fields
// patched in place.
template <int CAP>
int launch(bool floor, Params<CAP>& p, const Target& t, cudaStream_t stream) {
  static_assert(sizeof(Params<CAP>) <= 32764, "kernel parameters over 32,764 bytes");
  p.bank = t.banks[0];
  for (int i = 0; i < MAX_SHARDS; ++i) p.shards[i] = i < t.n_shards ? t.banks[i] : t.banks[0];
  p.out = t.out;
  p.C = t.C;
  p.words_per_shard = (uint32_t)(t.C / 32);
  p.words = (int64_t)t.n_shards * (t.C / 32);
  p.out_stride = t.out_stride;
  p.rows_in = t.R > 0x7fffffff ? 0x80000000u : (uint32_t)t.R;
  const int T = p.T;
  const int64_t words = p.words;
  int W = (BLOCK_WARPS + T - 1) / T;
  if (W > MAX_WARPS / T) W = MAX_WARPS / T;
  if (W > words) W = (int)words;
  if (W < 1) W = 1;
  p.words_per_block = W;
  const int64_t blocks = (words + W - 1) / W;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    if (floor)
      probe_floor_kernel<CAP><<<(unsigned)blocks, 32 * T * W, 0, stream>>>(p);
    else if (t.n_shards > 1 || t.out_stride != t.C / 32)
      probe_kernel<CAP, true><<<(unsigned)blocks, 32 * T * W, 0, stream>>>(p);
    else
      probe_kernel<CAP, false><<<(unsigned)blocks, 32 * T * W, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// One launch of the single-launch entry points, its arguments checked.
template <int CAP>
int launch_one(bool floor, const Probes& q, const Target& t, void* stream) {
  Params<CAP> p;
  fill_probes(p, q);
  return launch(floor, p, t, (cudaStream_t)stream);
}

int dispatch(bool floor, const Probes& q, Target t, int64_t first_word, void* stream) {
  if (!probes_ok(q) || !target_ok(t.n_shards, t.R, t.C, first_word, t.out_stride))
    return (int)cudaErrorInvalidValue;
  t.out += first_word;
  if (q.T * q.K <= CAP_SMALL) return launch_one<CAP_SMALL>(floor, q, t, stream);
  return launch_one<CAP_MAX>(floor, q, t, stream);
}

// The address through which the current card writes the page-locked host
// memory at *p, in place of *p: memory that is not page-locked
// (cudaErrorInvalidHostPointer) or that the card cannot address
// (cudaErrorInvalidDevicePointer) is refused. The caller makes the card's
// context current first: a thread that has launched nothing yet may have
// none, and then no device address is found.
cudaError_t host_device_address(int32_t** p) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, *p);
  if (err != cudaSuccess) return err;
  if (attr.type != cudaMemoryTypeHost) return cudaErrorInvalidHostPointer;
  if (attr.devicePointer == nullptr) return cudaErrorInvalidDevicePointer;
  *p = static_cast<int32_t*>(attr.devicePointer);
  return cudaSuccess;
}

// One event a card for each thread that calls bs_probe_plan, made at the
// thread's first call on the card (timing off) and kept until the thread
// ends: two threads calling at once never wait on each other's event.
struct ThreadEvents {
  cudaEvent_t done[MAX_DEVICES] = {};
  ~ThreadEvents() {
    for (cudaEvent_t e : done)
      if (e != nullptr) cudaEventDestroy(e);
  }
};
thread_local ThreadEvents thread_events;

int64_t monotonic_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

}  // namespace

// One launch of bs_probe_plan: n_shards banks of card `device`, each
// int32[R, C], probed as one bank of their columns in order on `stream`, a
// stream of that card, its words stored from word first_word of each
// output row. 104 bytes without padding on a 64-bit host;
// kernels/probe.py::PlanLaunch mirrors it and compares its size with
// bs_probe_plan_record_size() when it binds.
struct PlanLaunch {
  int32_t device;                      // offset 0
  int32_t n_shards;                    // 4: 1..MAX_SHARDS
  void* stream;                        // 8: a cudaStream_t
  const int32_t* shards[MAX_SHARDS];   // 16
  int64_t R;                           // 80
  int64_t C;                           // 88
  int64_t first_word;                  // 96
};
static_assert(offsetof(PlanLaunch, n_shards) == 4 && offsetof(PlanLaunch, stream) == 8 &&
                  offsetof(PlanLaunch, shards) == 16 && offsetof(PlanLaunch, R) == 80 &&
                  offsetof(PlanLaunch, C) == 88 && offsetof(PlanLaunch, first_word) == 96 &&
                  sizeof(PlanLaunch) == 104,
              "PlanLaunch's layout is the one kernels/probe.py mirrors");

namespace {

// bs_probe_plan's issue and wait, with Params of capacity CAP (module doc:
// the larger is a 32 KB struct, so it is filled once here, not a launch).
template <int CAP>
int run_plan(const Probes& q, const PlanLaunch* plan, int n_launches, int32_t* out,
             int64_t out_stride, bool out_on_host, int64_t* stamps) {
  int last[MAX_DEVICES];  // each card's last launch, -1 for none
  void* streams[MAX_DEVICES];
  for (int d = 0; d < MAX_DEVICES; ++d) last[d] = -1;
  for (int i = 0; i < n_launches; ++i) {
    const PlanLaunch& r = plan[i];
    if (r.device < 0 || r.device >= MAX_DEVICES ||
        !target_ok(r.n_shards, r.R, r.C, r.first_word, out_stride) ||
        (last[r.device] >= 0 && streams[r.device] != r.stream) ||
        (!out_on_host && r.device != plan[0].device))
      return (int)cudaErrorInvalidValue;
    for (int s = 0; s < r.n_shards; ++s)
      if (r.shards[s] == nullptr) return (int)cudaErrorInvalidValue;
    last[r.device] = i;
    streams[r.device] = r.stream;
  }
  int caller = 0;
  int rc = (int)cudaGetDevice(&caller);
  if (rc != 0) return rc;

  Params<CAP> p;
  fill_probes(p, q);
  ThreadEvents& events = thread_events;
  int32_t* card_out[MAX_DEVICES] = {};  // the output's address on each card
  bool recorded[MAX_DEVICES] = {};
  int launched[MAX_DEVICES];  // the cards that may have launched, in order
  int n_cards = 0;
  int current = -1;
  for (int i = 0; i < n_launches && rc == 0; ++i) {
    const PlanLaunch& r = plan[i];
    const int d = r.device;
    if (d != current) {
      rc = (int)cudaSetDevice(d);
      if (rc != 0) break;
      current = d;
    }
    if (card_out[d] == nullptr) {
      int32_t* addr = out;
      if (out_on_host) rc = (int)host_device_address(&addr);
      if (rc == 0 && events.done[d] == nullptr)
        rc = (int)cudaEventCreateWithFlags(&events.done[d], cudaEventDisableTiming);
      if (rc != 0) break;
      card_out[d] = addr;
      launched[n_cards++] = d;  // from here on waited for below, whatever follows
    }
    const Target t = {r.shards, r.n_shards, r.R, r.C, card_out[d] + r.first_word, out_stride};
    rc = launch(false, p, t, static_cast<cudaStream_t>(r.stream));
    if (rc != 0) break;
    if (i == last[d]) {
      rc = (int)cudaEventRecord(events.done[d], static_cast<cudaStream_t>(r.stream));
      recorded[d] = rc == 0;
    }
  }
  if (stamps != nullptr) stamps[1] = monotonic_ns();
  for (int k = 0; k < n_cards; ++k) {
    const int d = launched[k];
    cudaError_t err;
    if (recorded[d]) {
      err = cudaEventSynchronize(events.done[d]);
    } else {  // failed before its event: wait for the card's whole stream
      err = cudaSetDevice(d);
      if (err == cudaSuccess) {
        current = d;
        err = cudaStreamSynchronize(static_cast<cudaStream_t>(streams[d]));
      }
    }
    if (rc == 0) rc = (int)err;
  }
  if (current != -1 && current != caller) {
    const cudaError_t err = cudaSetDevice(caller);
    if (rc == 0) rc = (int)err;
  }
  // The error is returned here; it must not stay the thread's last error,
  // which the next launch's check (this file's or torch's) would report.
  if (rc != 0) cudaGetLastError();
  return rc;
}

}  // namespace

// Plain C entry points, bound with ctypes. row_idx and shift (int32[T*K]),
// clause_bits and member_bits are HOST arrays: they travel by value in the
// kernel's parameters. The single-launch entries launch on `stream` and
// return cudaGetLastError(): 0 when the launch was accepted.
//
// bs_probe_launch covers n_shards <= MAX_SHARDS banks of one card, each
// int32[R, C], as one bank of n_shards * C columns in shard order: output
// word w of row r (bit i: that bank's column 32w + i) is stored at
// out[r * out_stride + first_word + w]. One bank with out_stride = C/32 and
// first_word = 0 is the single-device launch (kernels/probe.py's single-bank
// wrappers). The shard table, the stride and a host output serve
// tools/exp_mesh_join.py's per-launch form (the join before bs_probe_plan,
// timed against it) and the device time of the plan's one-card launch, whose
// own call waits inside itself. With out_on_host, `out` is
// page-locked host memory, which the kernel writes through its device
// address on card `device` (the banks' card): memory that is not
// page-locked (cudaErrorInvalidHostPointer) or that the card cannot
// address (cudaErrorInvalidDevicePointer) is refused before anything is
// launched. It waits for nothing, so a CUDA graph can capture it.
extern "C" int bs_probe_launch(const int32_t* const* banks, int n_shards, int64_t R, int64_t C,
                               const int32_t* row_idx, const int32_t* shift, int T, int K,
                               int mode, uint32_t and_bits, const uint32_t* clause_bits,
                               int n_clauses, const uint32_t* member_bits, int n_members,
                               int32_t* out, int64_t out_stride, int64_t first_word,
                               int out_on_host, int device, void* stream) {
  if (out_on_host) {
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = host_device_address(&out);
    if (err != cudaSuccess) return (int)err;
  }
  const Probes q = {row_idx, shift, T, K, mode, and_bits, clause_bits, n_clauses, member_bits,
                    n_members};
  return dispatch(false, q, Target{banks, n_shards, R, C, out, out_stride}, first_word, stream);
}

// K1f's entry point: one bank, out is int32[T, C] on the card. The same
// checks and launch shape.
extern "C" int bs_probe_floor_launch(const int32_t* bank, int64_t R, int64_t C,
                                     const int32_t* row_idx, const int32_t* shift, int T,
                                     int K, int32_t* out, void* stream) {
  const Probes q = {row_idx, shift, T, K, MODE_PACK, 0u, nullptr, 0, nullptr, 0};
  return dispatch(true, q, Target{&bank, 1, R, C, out, C / 32}, 0, stream);
}

extern "C" int bs_probe_plan_record_size() { return (int)sizeof(PlanLaunch); }

// Every launch of one probe call, issued and waited for in one call: the
// K3 wrappers' launches on every card of a mesh, or the single-device
// combiner's one launch. The probes, masks and mode are given once (as
// bs_probe_launch takes them) and go into one parameter struct, filled
// once; each launch patches only its banks, width and output address.
// plan holds n_launches records; out has out_stride words a row and is
// page-locked host memory (out_on_host), written by every card through its
// own device address, or a device buffer of the one card every record
// names.
//
// Order: every record is checked before the first launch (a card's records
// must share one stream); then the launches in plan order, the device
// switched only when the card changes (and always before the first launch:
// a fresh thread has no current context), the output's device address
// looked up at each card's first launch (so memory that is not page-locked
// is refused before anything is launched), one event recorded on a card's
// stream after its last launch; then every card's event waited for, and
// the caller's current device restored (torch assumes it is unchanged).
// Waiting inside, the call cannot be captured into a CUDA graph.
//
// A failure part-way still waits for every card that launched before it
// returns: those kernels write `out`, which the caller frees or reuses once
// this returns. Returns 0, or the first CUDA error (cudaErrorInvalidValue
// for an argument or record the kernel does not take). stamps, when not
// null, gets the CLOCK_MONOTONIC ns at entry and once every launch and
// event is issued (the measurement tool splits a call's host time with
// them).
extern "C" int bs_probe_plan(const int32_t* row_idx, const int32_t* shift, int T, int K,
                             int mode, uint32_t and_bits, const uint32_t* clause_bits,
                             int n_clauses, const uint32_t* member_bits, int n_members,
                             const PlanLaunch* plan, int n_launches, int32_t* out,
                             int64_t out_stride, int out_on_host, int64_t* stamps) {
  if (stamps != nullptr) stamps[0] = monotonic_ns();
  const Probes q = {row_idx, shift, T, K, mode, and_bits, clause_bits, n_clauses, member_bits,
                    n_members};
  if (plan == nullptr || n_launches < 1 || out == nullptr || !probes_ok(q))
    return (int)cudaErrorInvalidValue;
  if (T * K <= CAP_SMALL)
    return run_plan<CAP_SMALL>(q, plan, n_launches, out, out_stride, out_on_host != 0, stamps);
  return run_plan<CAP_MAX>(q, plan, n_launches, out, out_stride, out_on_host != 0, stamps);
}
