// Stream byte scan (K2) for Hopper, with its segment mode (K2s).
//
// Replaces bloomsearch_tpu/bloom/pallas_kernels.py::byte_scan_pallas_swar
// in stream mode (stream_stride = 480, slots = 1) and the XLA code around it
// in bloomsearch_tpu/rowcache.py::_device_scan_fn: scan_all (the whole
// stream) and scan_segments (dynamic_slice segments, concatenated).
//
// What it computes. The row stream is int32[rows, 128]: each row is one
// 512-byte chunk of a lowercased byte stream, packed little-endian 4 bytes
// per word, whose first 480 bytes are payload and whose last 32 repeat the
// next chunk's head. Logical chunk g hits needle n iff needle n (lens[n] <=
// 32 bytes) occurs at some start s < 480 of the chunk; s + 32 <= 512, so a
// window never leaves its chunk. A needle of length 0 (a padding row)
// matches every chunk, as in the TPU kernel. Bit i of output word w of row
// n is logical chunk 32w + i. Dense mode scans chunk g = row g. Segment
// mode takes up to 4 ranges (first row, chunk count), each count a
// multiple of 32, and maps logical chunk g to its range's rows in order,
// so the ranges are never copied out of the stream.
//
// What bounds it. The work reads each chunk once (512 bytes) and writes
// n_real bits per chunk: at 3.35 TB/s an H100 SXM moves the 1.84 GB
// refscale stream in 0.55 ms. The compares are one per (needle, start),
// 480 per chunk and needle, which at 67 TOP/s stays below the byte time up
// to about 8 needles; so bytes bound it, and the design has to keep the
// memory pipe busy while it compares, at an issue cost per (start, needle)
// of about one instruction.
//
// Design.
// - Loads in flight while comparing: two persistent blocks per SM, each
//   walking tiles of 32 chunks (16 KB, one output word per needle; in
//   segment mode a tile never straddles two ranges) through a ring of
//   STAGES tiles in shared memory. One loader warp fills the ring with
//   TMA's 1-D bulk copy (cp.async.bulk, completing on a "full" mbarrier)
//   and refills a stage once the compute warps have arrived on its "empty"
//   mbarrier, so the next tiles arrive while the current one is compared.
// - Word-wide compares, chunk bytes read once for all needles: a compute
//   warp takes one chunk at a time; each lane holds its 16 bytes in
//   registers plus the next lane's first word (__shfl_down_sync) and forms
//   the 4-byte window at each of its 16 positions with __funnelshift_r.
//   Each needle has a 4-byte anchor, kept in registers (the needle count is
//   a template parameter): a needle of up to 4 bytes is its own anchor,
//   under a mask below 4 bytes, and a window that equals it at a start
//   < 480 is a hit (lanes 30 and 31 hold bytes 480-511 and own no such
//   start); a longer needle is anchored on one of its 4-byte windows, one
//   compare per (window, needle), and a window that equals it gives a
//   start that is checked against the whole needle, word by word, from
//   the chunk in shared memory (start + 28 <= 507, so word 127 is the last
//   read). The anchor is the needle's window with the most distinct bytes,
//   the last of equals (anchor_at): not its first 4 bytes, because in
//   lowercased JSON a needle such as "level":"error" begins with a field
//   name found in every row, and not a fixed window, because on a run of
//   one byte a needle of that byte with one other byte would make every
//   start a candidate wherever the anchor misses the odd byte.
// - Results without atomics: __reduce_or_sync joins the lanes' needle bits
//   per chunk; lane n keeps needle n's bits of the warp's chunks in a
//   register, the loader warp ORs the compute warps' words for the tile and
//   stores one word per needle.
// - A card's shards in one launch (bloomsearch_tpu/parallel/mesh.py's
//   sharded_scan_all_rows ran the dense scan on each shard under
//   shard_map; the port's K3 wrapper, parallel/mesh.py): each range has
//   its own base pointer, so a card's dense sharded scan is one segment
//   launch with a range a shard, and the output's row stride and first
//   word put the card's words where they belong in the joined bitmap of
//   the whole mesh, which may be page-locked host memory the kernel writes
//   through its device address.
// - Every card's launches of one sharded scan from one host call
//   (bs_scan_plan): a sharded call is a few launches of about 0.03 ms of
//   device time each, so what bounds it as a caller sees it is host issue
//   (argument checks, the device switch, the address lookup, the needle
//   packing) paid once per launch and one card after another. The plan
//   entry takes every launch as a record, checks them all, packs the
//   needles once, switches device only when the card changes, looks the
//   output's device address up once a card, records one event a card after
//   its last launch and then waits for all of them, so the cards run while
//   the host is still issuing and the caller makes one foreign call.
// Bytes are compared as unsigned 32-bit words, so chunk bytes >= 0x80 (the
// sign bit of an int32 word) compare like any other.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <time.h>

#define CHUNK_BYTES 512
#define STRIDE 480
#define MAX_WINDOW 32
#define MAX_NEEDLES 8
#define MAX_SEGS 4
#define TILE_CHUNKS 32
#define TILE_BYTES (TILE_CHUNKS * CHUNK_BYTES)
#define STAGES 4
#define COMPUTE_WARPS 16
#define THREADS ((COMPUTE_WARPS + 1) * 32)
#define RING_BYTES (STAGES * TILE_BYTES)
#define MAX_DEVICES 64
#define FULL_MASK 0xffffffffu

// Everything but the C entry points has internal linkage: a process may load
// two builds of this file (another version, to compare), and a template's
// function-local static would otherwise be one object shared by both.
namespace {

struct Needles {
  uint32_t words[MAX_NEEDLES][MAX_WINDOW / 4];  // bytes, little-endian
  uint32_t anchor[MAX_NEEDLES];       // the needle's bytes at anchor_at..+3
  uint32_t anchor_mask[MAX_NEEDLES];  // those of them in the needle
  int32_t anchor_at[MAX_NEEDLES];
  int32_t lens[MAX_NEEDLES];
  uint32_t short_needles;  // bit n: lens[n] <= 4, the anchor is the needle
};

struct Ranges {
  const int32_t* base[MAX_SEGS];   // the stream (or shard) each range reads
  int64_t starts[MAX_SEGS];        // first row of each range in its base
  int64_t offsets[MAX_SEGS + 1];   // first logical chunk of each range
  int32_t n;                       // 0: dense mode
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The first word of tile t (32 logical chunks, all in one range): row t*32
// of the stream in dense mode, else the tile's row in its range's base.
__device__ __forceinline__ const int32_t* tile_src(const Ranges& rg, const int32_t* rows,
                                                   int64_t t) {
  const int64_t g = t * TILE_CHUNKS;
  if (rg.n == 0) return rows + g * (CHUNK_BYTES / 4);
  int r = 0;
  while (r + 1 < rg.n && g >= rg.offsets[r + 1]) ++r;
  return rg.base[r] + (rg.starts[r] + (g - rg.offsets[r])) * (CHUNK_BYTES / 4);
}

// The chunk's bytes b..b+3 against `want`, of which the first `left` bytes
// count.
__device__ __forceinline__ bool word_matches(const uint32_t* cw, int b, uint32_t want, int left) {
  const uint32_t x = __funnelshift_r(cw[b >> 2], cw[(b >> 2) + 1], 8 * (b & 3));
  const uint32_t m = left >= 4 ? FULL_MASK : (1u << (8 * left)) - 1u;
  return ((x ^ want) & m) == 0;
}

// The needle (len > 4 bytes, words nw) against the chunk cw at start
// s < 480. The first word first: a candidate whose anchor is common text
// (a JSON value's quote and colon) mostly fails there in one step; the rest
// issue their loads at once. s + 28 <= 507, so word 127 is the last read.
__device__ __forceinline__ bool match(const uint32_t* cw, int s, const uint32_t* nw, int len) {
  if (!word_matches(cw, s, nw[0], len)) return false;
  bool ok = true;
#pragma unroll
  for (int j = 4; j < MAX_WINDOW; j += 4)
    if (j < len) ok &= word_matches(cw, s + j, nw[j >> 2], len - j);
  return ok;
}

// The needles of `todo` (longer than 4 bytes, their anchor seen at one of
// this lane's windows win[i], bytes 16 * lane + i..+3) checked whole at
// each start the anchor gives -> bit n: needle n occurs at a start < 480.
__device__ __forceinline__ uint32_t verify_lane(const uint32_t* cw, const uint32_t (&win)[16],
                                                int lane, uint32_t todo, const Needles& nd) {
  uint32_t hits = 0;
  while (todo) {
    const int n = __ffs(todo) - 1;
    todo &= todo - 1;
    const uint32_t a = nd.anchor[n], m = nd.anchor_mask[n];
    const int at = nd.anchor_at[n];
    uint32_t cands = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) cands |= (uint32_t)(((win[i] ^ a) & m) == 0) << i;
    // Windows whose start 16 * lane + i - at lies in [0, 480).
    const int lo = max(at - 16 * lane, 0), hi = min(at + STRIDE - 16 * lane, 16);
    cands &= hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
    while (cands) {
      const int i = __ffs(cands) - 1;
      cands &= cands - 1;
      if (match(cw, 16 * lane + i - at, nd.words[n], nd.lens[n])) {
        hits |= 1u << n;
        break;
      }
    }
  }
  return hits;
}

// Loader lanes n < n_real: OR the compute warps' words of needle n for
// tile t and store it.
__device__ __forceinline__ void store_tile(uint32_t (*part)[COMPUTE_WARPS], int n_real,
                                           int lane, uint32_t* out, int64_t out_stride,
                                           int64_t t) {
  if (lane < n_real) {
    uint32_t w = 0;
#pragma unroll
    for (int c = 0; c < COMPUTE_WARPS; ++c) w |= part[lane][c];
    out[lane * out_stride + t] = w;
  }
}

template <int NR>
__global__ void __launch_bounds__(THREADS, 2) byte_scan_kernel(
    const int32_t* __restrict__ rows, int64_t n_tiles, const __grid_constant__ Needles nd,
    const __grid_constant__ Ranges rg, uint32_t* __restrict__ out, int64_t out_stride) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ uint32_t part[STAGES][MAX_NEEDLES][COMPUTE_WARPS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], COMPUTE_WARPS * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int64_t step = gridDim.x;

  if (warp == COMPUTE_WARPS) {
    // Loader: fill the ring; once the compute warps release a stage, store
    // its tile's words and refill it.
    int64_t k = 0;
    for (int64_t t = blockIdx.x; t < n_tiles; t += step, ++k) {
      const int s = (int)(k % STAGES);
      if (k >= STAGES) {
        mbar_wait(&empty[s], (uint32_t)((k / STAGES - 1) & 1));
        store_tile(part[s], NR, lane, out, out_stride, t - STAGES * step);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], TILE_BYTES);
        bulk_load(ring + s * TILE_BYTES, tile_src(rg, rows, t), TILE_BYTES, &full[s]);
      }
    }
    for (int64_t j = k > STAGES ? k - STAGES : 0; j < k; ++j) {
      const int s = (int)(j % STAGES);
      mbar_wait(&empty[s], (uint32_t)((j / STAGES) & 1));
      store_tile(part[s], NR, lane, out, out_stride, blockIdx.x + j * step);
    }
    return;
  }

  // The needles' anchors in registers; lanes 30, 31 (bytes 480..511) hold
  // no start of a short needle.
  uint32_t anchor[NR], mask[NR];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    anchor[n] = nd.anchor[n];
    mask[n] = nd.anchor_mask[n];
  }
  const uint32_t short_hits = lane < STRIDE / 16 ? nd.short_needles : 0u;
  int64_t k = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += step, ++k) {
    const int s = (int)(k % STAGES);
    mbar_wait(&full[s], (uint32_t)((k / STAGES) & 1));
    const uint8_t* tile = ring + s * TILE_BYTES;
    uint32_t bits = 0;  // lane n: needle n's hits among this warp's chunks
    for (int c = warp; c < TILE_CHUNKS; c += COMPUTE_WARPS) {
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(tile + c * CHUNK_BYTES);
      const uint4 v = reinterpret_cast<const uint4*>(cw)[lane];
      const uint32_t w[5] = {v.x, v.y, v.z, v.w, __shfl_down_sync(FULL_MASK, v.x, 1)};
      uint32_t win[16];  // win[i]: bytes 16 * lane + i .. + 3
#pragma unroll
      for (int i = 0; i < 16; ++i)
        win[i] = (i & 3) ? __funnelshift_r(w[i >> 2], w[(i >> 2) + 1], 8 * (i & 3)) : w[i >> 2];
      uint32_t seen = 0;  // bit n: needle n's anchor at one of the lane's windows
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        bool cand = false;
        if (mask[n] == FULL_MASK) {
#pragma unroll
          for (int i = 0; i < 16; ++i) cand |= win[i] == anchor[n];
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) cand |= ((win[i] ^ anchor[n]) & mask[n]) == 0;
        }
        seen |= (uint32_t)cand << n;
      }
      uint32_t hits = seen & short_hits;
      const uint32_t todo = seen & ~nd.short_needles;
      if (todo) hits |= verify_lane(cw, win, lane, todo, nd);
      bits |= ((__reduce_or_sync(FULL_MASK, hits) >> lane) & 1u) << c;
    }
    if (lane < NR) part[s][lane][warp] = bits;
    mbar_arrive(&empty[s]);
  }
}

// One launch of the kernel for NR needles with as many blocks as fit the
// card at once (persistent), their count found once per device; a benign
// race sets the same value twice. Returns cudaGetLastError() (or the error
// of a setup call).
int grid_cap[MAX_DEVICES][MAX_NEEDLES + 1];

template <int NR>
int launch(const int32_t* rows, int64_t chunks, const Needles& nd, const Ranges& rg,
           int32_t* out, int64_t out_stride, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (grid_cap[dev][NR] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(byte_scan_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               RING_BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, byte_scan_kernel<NR>, THREADS,
                                                          RING_BYTES);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_cap[dev][NR] = per_sm * sms;
  }
  const int64_t n_tiles = chunks / TILE_CHUNKS;
  const int64_t blocks = n_tiles < grid_cap[dev][NR] ? n_tiles : grid_cap[dev][NR];
  byte_scan_kernel<NR><<<(unsigned)blocks, THREADS, RING_BYTES, (cudaStream_t)stream>>>(
      rows, n_tiles, nd, rg, reinterpret_cast<uint32_t*>(out), out_stride);
  return (int)cudaGetLastError();
}

// Where a needle of len > 4 bytes is anchored: the 4-byte window with the
// most distinct bytes, the last of equals.
int anchor_at(const uint8_t* b, int len) {
  if (len <= 4) return 0;
  int best = len - 4, best_distinct = 0;
  for (int at = len - 4; at >= 0; --at) {
    int distinct = 1;
    for (int i = 1; i < 4; ++i) {
      bool seen = false;
      for (int j = 0; j < i; ++j) seen |= b[at + i] == b[at + j];
      distinct += !seen;
    }
    if (distinct > best_distinct) {
      best = at;
      best_distinct = distinct;
    }
  }
  return best;
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

// The needles (uint8[n_real, 32] bytes, int32[n_real] lengths) in the
// kernel's form; cudaErrorInvalidValue for a count or a length it does not
// take.
int pack_needles(const uint8_t* needle_bytes, const int32_t* lens, int n_real, Needles* nd) {
  if (n_real < 1 || n_real > MAX_NEEDLES) return (int)cudaErrorInvalidValue;
  *nd = Needles{};
  for (int n = 0; n < n_real; ++n) {
    const int len = lens[n];
    if (len < 0 || len > MAX_WINDOW) return (int)cudaErrorInvalidValue;
    const uint8_t* b = needle_bytes + n * MAX_WINDOW;
    nd->lens[n] = len;
    for (int j = 0; j < len; ++j) nd->words[n][j / 4] |= (uint32_t)b[j] << (8 * (j % 4));
    // A needle of up to 4 bytes is its own anchor (a window that matches
    // it is a hit); a longer one is checked whole where its anchor is seen.
    nd->anchor_at[n] = anchor_at(b, len);
    nd->anchor_mask[n] = len >= 4 ? FULL_MASK : (1u << (8 * len)) - 1u;
    for (int j = 0; j < 4 && nd->anchor_at[n] + j < len; ++j)
      nd->anchor[n] |= (uint32_t)b[nd->anchor_at[n] + j] << (8 * j);
    if (len <= 4) nd->short_needles |= 1u << n;
  }
  return 0;
}

int launch_needles(int n_real, const int32_t* rows, int64_t chunks, const Needles& nd,
                   const Ranges& rg, int32_t* out, int64_t out_stride, void* stream) {
  switch (n_real) {
    case 1: return launch<1>(rows, chunks, nd, rg, out, out_stride, stream);
    case 2: return launch<2>(rows, chunks, nd, rg, out, out_stride, stream);
    case 3: return launch<3>(rows, chunks, nd, rg, out, out_stride, stream);
    case 4: return launch<4>(rows, chunks, nd, rg, out, out_stride, stream);
    case 5: return launch<5>(rows, chunks, nd, rg, out, out_stride, stream);
    case 6: return launch<6>(rows, chunks, nd, rg, out, out_stride, stream);
    case 7: return launch<7>(rows, chunks, nd, rg, out, out_stride, stream);
    default: return launch<8>(rows, chunks, nd, rg, out, out_stride, stream);
  }
}

// One event a card for each thread that calls bs_scan_plan, made at the
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

// Plain C entry point, bound with ctypes. needle_bytes (uint8[n_real, 32]),
// lens (int32[n_real]), range_bases, range_starts and range_chunks
// (n_ranges each) are HOST arrays that travel by value in the kernel's
// parameters. chunks is the logical chunk count (rows in dense mode, the
// sum of range_chunks in segment mode) and a multiple of 32, as is each
// range's count. Range r reads rows [range_starts[r], + range_chunks[r])
// of range_bases[r] (of `rows` when range_bases is null), each base
// holding rows_total rows; so the ranges may lie in different shards of
// one card, and one launch scans all of them. Output word w of needle n is
// stored at out[n * out_stride + first_word + w]. With out_on_host, `out`
// is page-locked host memory, which the kernel writes through its device
// address on card `device` (the stream's card); memory the card cannot
// write that way is refused before anything is launched. Launches on
// `stream` and returns cudaGetLastError() (or the error of a setup call):
// 0 when the launch was accepted.
extern "C" int bs_scan_launch(const int32_t* rows, int64_t rows_total, int64_t chunks,
                              const uint8_t* needle_bytes, const int32_t* lens, int n_real,
                              const int32_t* const* range_bases, const int64_t* range_starts,
                              const int64_t* range_chunks, int n_ranges, int32_t* out,
                              int64_t out_stride, int64_t first_word, int out_on_host,
                              int device, void* stream) {
  if (chunks <= 0 || chunks % TILE_CHUNKS != 0 || n_ranges < 0 || n_ranges > MAX_SEGS ||
      first_word < 0 || out_stride < first_word + chunks / TILE_CHUNKS)
    return (int)cudaErrorInvalidValue;
  Needles nd;
  const int bad = pack_needles(needle_bytes, lens, n_real, &nd);
  if (bad != 0) return bad;
  Ranges rg = {};
  rg.n = n_ranges;
  if (n_ranges > 0) {
    int64_t off = 0;
    for (int r = 0; r < n_ranges; ++r) {
      if (range_chunks[r] <= 0 || range_chunks[r] % TILE_CHUNKS != 0 || range_starts[r] < 0 ||
          range_starts[r] + range_chunks[r] > rows_total)
        return (int)cudaErrorInvalidValue;
      rg.base[r] = range_bases != nullptr ? range_bases[r] : rows;
      rg.starts[r] = range_starts[r];
      rg.offsets[r] = off;
      off += range_chunks[r];
    }
    rg.offsets[n_ranges] = off;
    if (off != chunks) return (int)cudaErrorInvalidValue;
  } else if (chunks > rows_total) {
    return (int)cudaErrorInvalidValue;
  }
  if (out_on_host) {
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = host_device_address(&out);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_needles(n_real, rows, chunks, nd, rg, out + first_word, out_stride, stream);
}

// One launch of bs_scan_plan on card `device`, launched on `stream`, a
// stream of that card, its words stored from word first_word of each output
// row. In segment mode (n_ranges 1..MAX_SEGS) range r reads rows [start[r],
// + chunks[r]) of base[r], each base holding rows_total rows and each count a
// positive multiple of 32. With n_ranges 0 it is a dense-mode launch over
// all rows_total rows of base[0] (a positive multiple of 32; start and
// chunks unread): the same words as one range over the whole base, which
// segment mode scans 0.3% slower at 8 needles on an H100 (chip_smoke.py's
// dense_mode_turns). 128 bytes without padding on a 64-bit
// host; kernels/scan.py::PlanLaunch mirrors it and compares its size with
// bs_scan_plan_record_size() when it binds.
struct PlanLaunch {
  int32_t device;                  // offset 0
  int32_t n_ranges;                // 4: 0 (dense mode over base[0]) or 1..MAX_SEGS
  void* stream;                    // 8: a cudaStream_t
  const int32_t* base[MAX_SEGS];   // 16
  int64_t start[MAX_SEGS];         // 48
  int64_t chunks[MAX_SEGS];        // 80
  int64_t rows_total;              // 112
  int64_t first_word;              // 120
};
static_assert(offsetof(PlanLaunch, stream) == 8 && offsetof(PlanLaunch, base) == 16 &&
                  offsetof(PlanLaunch, start) == 48 && offsetof(PlanLaunch, chunks) == 80 &&
                  offsetof(PlanLaunch, rows_total) == 112 &&
                  offsetof(PlanLaunch, first_word) == 120 && sizeof(PlanLaunch) == 128,
              "PlanLaunch's layout is the one kernels/scan.py mirrors");

extern "C" int bs_scan_plan_record_size() { return (int)sizeof(PlanLaunch); }

// Every launch of one sharded scan, issued and waited for in one call.
// needle_bytes (uint8[n_real, 32]) and lens (int32[n_real]) are host
// arrays, packed once for all launches; plan holds n_launches records; out
// is page-locked host memory of n_real rows of out_stride words, written
// by every card through its own device address.
//
// Order: every record is checked before the first launch (a card's records
// must share one stream); then the launches in plan order, the device
// switched only when the card changes (and always before the first launch:
// a fresh thread has no current context), the output's device address
// looked up at each card's first launch (so memory that is not page-locked
// is refused before anything is launched), one event recorded on a card's
// stream after its last launch; then every card's event waited for, and
// the caller's current device restored (torch assumes it is unchanged).
//
// A failure part-way still waits for every card that launched before it
// returns: those kernels write `out`, which the caller frees or reuses once
// this returns. Returns 0, or the first CUDA error (cudaErrorInvalidValue
// for a record the kernel does not take). stamps, when not null, gets the
// CLOCK_MONOTONIC ns at entry and once every launch and event is issued
// (the measurement tool splits a call's host time with them).
extern "C" int bs_scan_plan(const uint8_t* needle_bytes, const int32_t* lens, int n_real,
                            const PlanLaunch* plan, int n_launches, int32_t* out,
                            int64_t out_stride, int64_t* stamps) {
  if (stamps != nullptr) stamps[0] = monotonic_ns();
  if (plan == nullptr || n_launches < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
  Needles nd;
  int rc = pack_needles(needle_bytes, lens, n_real, &nd);
  if (rc != 0) return rc;
  int last[MAX_DEVICES];  // each card's last launch, -1 for none
  void* streams[MAX_DEVICES];
  for (int d = 0; d < MAX_DEVICES; ++d) last[d] = -1;
  for (int i = 0; i < n_launches; ++i) {
    const PlanLaunch& p = plan[i];
    if (p.device < 0 || p.device >= MAX_DEVICES || p.n_ranges < 0 || p.n_ranges > MAX_SEGS ||
        p.first_word < 0 || (last[p.device] >= 0 && streams[p.device] != p.stream))
      return (int)cudaErrorInvalidValue;
    int64_t chunks = 0;
    if (p.n_ranges == 0) {
      if (p.base[0] == nullptr || p.rows_total <= 0 || p.rows_total % TILE_CHUNKS != 0)
        return (int)cudaErrorInvalidValue;
      chunks = p.rows_total;
    }
    for (int r = 0; r < p.n_ranges; ++r) {
      if (p.base[r] == nullptr || p.chunks[r] <= 0 || p.chunks[r] % TILE_CHUNKS != 0 ||
          p.start[r] < 0 || p.start[r] + p.chunks[r] > p.rows_total)
        return (int)cudaErrorInvalidValue;
      chunks += p.chunks[r];
    }
    if (out_stride < p.first_word + chunks / TILE_CHUNKS) return (int)cudaErrorInvalidValue;
    last[p.device] = i;
    streams[p.device] = p.stream;
  }
  int caller = 0;
  rc = (int)cudaGetDevice(&caller);
  if (rc != 0) return rc;

  ThreadEvents& events = thread_events;
  int32_t* card_out[MAX_DEVICES] = {};  // the output's address on each card
  bool recorded[MAX_DEVICES] = {};
  int launched[MAX_DEVICES];  // the cards that may have launched, in order
  int n_cards = 0;
  int current = -1;
  for (int i = 0; i < n_launches && rc == 0; ++i) {
    const PlanLaunch& p = plan[i];
    const int d = p.device;
    if (d != current) {
      rc = (int)cudaSetDevice(d);
      if (rc != 0) break;
      current = d;
    }
    if (card_out[d] == nullptr) {
      int32_t* addr = out;
      rc = (int)host_device_address(&addr);
      if (rc == 0 && events.done[d] == nullptr)
        rc = (int)cudaEventCreateWithFlags(&events.done[d], cudaEventDisableTiming);
      if (rc != 0) break;
      card_out[d] = addr;
      launched[n_cards++] = d;  // from here on waited for below, whatever follows
    }
    Ranges rg = {};  // n = 0: dense mode
    rg.n = p.n_ranges;
    int64_t off = p.n_ranges == 0 ? p.rows_total : 0;
    for (int r = 0; r < p.n_ranges; ++r) {
      rg.base[r] = p.base[r];
      rg.starts[r] = p.start[r];
      rg.offsets[r] = off;
      off += p.chunks[r];
    }
    if (p.n_ranges > 0) rg.offsets[p.n_ranges] = off;
    rc = launch_needles(n_real, p.base[0], off, nd, rg, card_out[d] + p.first_word, out_stride,
                        p.stream);
    if (rc != 0) break;
    if (i == last[d]) {
      rc = (int)cudaEventRecord(events.done[d], static_cast<cudaStream_t>(p.stream));
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
  if (current != caller) {
    const cudaError_t err = cudaSetDevice(caller);
    if (rc == 0) rc = (int)err;
  }
  // The error is returned here; it must not stay the thread's last error,
  // which the next launch's check (this file's or torch's) would report.
  if (rc != 0) cudaGetLastError();
  return rc;
}
