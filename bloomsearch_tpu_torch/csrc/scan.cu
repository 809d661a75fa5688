// Stream byte scan (K2) for Hopper, with its segment mode (K2s).
//
// Replaces bloomsearch_tpu/bloom/pallas_kernels.py::byte_scan_pallas_swar
// in stream mode (stream_stride = 480, slots = 1) and the XLA code around it
// in bloomsearch_tpu/rowcache.py::_device_scan_fn: scan_all (the whole
// stream) and scan_segments (up to 4 dynamic_slice segments, concatenated).
//
// What it computes. The row stream is int32[rows, 128]: each row is one
// 512-byte chunk of a lowercased byte stream, packed little-endian 4 bytes
// per word, whose first 480 bytes are payload and whose last 32 repeat the
// next chunk's head. Logical chunk g hits needle n iff needle n (lens[n] <=
// 32 bytes) occurs at some start s < 480 of the chunk; s + 32 <= 512, so a
// window never leaves its chunk. A needle of length 0 (a padding row)
// matches every chunk, as in the TPU kernel. Bit i of output word w of row
// n is logical chunk 32w + i. Dense mode scans chunk g = row g; segment
// mode maps logical chunk g to row seg_starts[g / seg_chunks] + g %
// seg_chunks, so the segments are never copied out of the stream.
//
// Design. One warp per chunk, 32 warps per block. A warp stages its chunk
// in shared memory with one 16-byte load per lane (the 512 bytes of a row
// are one coalesced transaction group); each lane then tests the starts
// s = lane, lane + 32, ... < 480 byte by byte, stopping at the first
// mismatch, and __any_sync joins the lanes. The block's 32 chunk bits per
// needle meet in one shared word, and one thread per needle writes it: the
// per-start hit matrix never reaches device memory. The TPU kernel's
// 4-alignment x W-word pattern/mask SWAR existed because Mosaic rolls
// only 32-bit lanes; bytes in shared memory need none of it. Bytes are
// compared as unsigned char, so chunk bytes >= 0x80 (the sign bit of an
// int32 word) compare like any other.
//
// What bounds it. The work reads each chunk once (512 bytes) and writes
// n_real bits per chunk: at 3.35 TB/s an H100 SXM moves a 1.84 GB stream in
// 0.55 ms. The compares are at least one per (needle, start), 480 per chunk
// per needle, which at 67 TOP/s stays below the byte time for up to about
// 8 needles. This simple form is bound by instruction issue instead (a
// lane's byte loop from shared memory, several instructions per compare),
// so it is expected to run several times above the byte bound on a dense
// scan; a wider-word compare and several chunks per warp are left for a
// later change measured against these numbers.
#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK_BYTES 512
#define CHUNK_WORDS 128
#define STRIDE 480
#define MAX_WINDOW 32
#define MAX_NEEDLES 8
#define MAX_SEGS 4
#define WARPS 32

struct Needles {
  uint8_t bytes[MAX_NEEDLES][MAX_WINDOW];
  int32_t lens[MAX_NEEDLES];
  int32_t n_real;
};

struct Segments {
  int64_t starts[MAX_SEGS];
  int64_t seg_chunks;  // 0: dense mode
};

__global__ void __launch_bounds__(WARPS * 32) byte_scan_kernel(
    const int32_t* __restrict__ rows, int64_t words_per_needle,
    const __grid_constant__ Needles nd, const __grid_constant__ Segments seg,
    int32_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t s_chunk[WARPS][CHUNK_BYTES];
  __shared__ uint8_t s_needle[MAX_NEEDLES][MAX_WINDOW];
  __shared__ int32_t s_len[MAX_NEEDLES];
  __shared__ uint32_t s_hit[MAX_NEEDLES];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < MAX_NEEDLES * MAX_WINDOW)
    s_needle[threadIdx.x / MAX_WINDOW][threadIdx.x % MAX_WINDOW] =
        nd.bytes[threadIdx.x / MAX_WINDOW][threadIdx.x % MAX_WINDOW];
  if (threadIdx.x < MAX_NEEDLES) {
    s_len[threadIdx.x] = nd.lens[threadIdx.x];
    s_hit[threadIdx.x] = 0u;
  }

  // The logical chunk count is a multiple of 32, so every warp of a block
  // has a chunk and the full-mask __any_sync below sees all 32 lanes.
  const int64_t g = (int64_t)blockIdx.x * WARPS + warp;
  int64_t row = g;
  if (seg.seg_chunks > 0)
    row = seg.starts[g / seg.seg_chunks] + g % seg.seg_chunks;
  const uint4* src = reinterpret_cast<const uint4*>(rows + row * CHUNK_WORDS);
  reinterpret_cast<uint4*>(s_chunk[warp])[lane] = __ldg(src + lane);
  __syncthreads();

  const uint8_t* c = s_chunk[warp];
  for (int n = 0; n < nd.n_real; ++n) {
    const int len = s_len[n];
    const uint8_t* needle = s_needle[n];
    bool found = len == 0;
    for (int s = lane; s < STRIDE && !found; s += 32) {
      int j = 0;
      while (j < len && c[s + j] == needle[j]) ++j;
      found = j == len;
    }
    if (__any_sync(0xffffffffu, found) && lane == 0)
      atomicOr(&s_hit[n], 1u << warp);
  }
  __syncthreads();
  if (threadIdx.x < nd.n_real)
    out[threadIdx.x * words_per_needle + blockIdx.x] = (int32_t)s_hit[threadIdx.x];
}

// Plain C entry point, bound with ctypes. needle_bytes (uint8[n_real, 32]),
// lens (int32[n_real]) and seg_starts (int64[n_segs]) are HOST arrays that
// travel by value in the kernel's parameters. chunks is the logical chunk
// count (rows in dense mode, n_segs * seg_chunks in segment mode) and a
// multiple of 32; rows_total bounds the segments. Launches on `stream` and
// returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int bs_scan_launch(const int32_t* rows, int64_t rows_total,
                              int64_t chunks, const uint8_t* needle_bytes,
                              const int32_t* lens, int n_real,
                              const int64_t* seg_starts, int n_segs,
                              int64_t seg_chunks, int32_t* out, void* stream) {
  if (chunks <= 0 || chunks % 32 != 0 || n_real < 1 || n_real > MAX_NEEDLES ||
      n_segs < 0 || n_segs > MAX_SEGS)
    return (int)cudaErrorInvalidValue;
  Needles nd = {};
  nd.n_real = n_real;
  for (int n = 0; n < n_real; ++n) {
    if (lens[n] < 0 || lens[n] > MAX_WINDOW) return (int)cudaErrorInvalidValue;
    nd.lens[n] = lens[n];
    for (int j = 0; j < MAX_WINDOW; ++j) nd.bytes[n][j] = needle_bytes[n * MAX_WINDOW + j];
  }
  Segments seg = {};
  if (n_segs > 0) {
    if (seg_chunks <= 0 || chunks != n_segs * seg_chunks) return (int)cudaErrorInvalidValue;
    seg.seg_chunks = seg_chunks;
    for (int s = 0; s < n_segs; ++s) {
      if (seg_starts[s] < 0 || seg_starts[s] + seg_chunks > rows_total)
        return (int)cudaErrorInvalidValue;
      seg.starts[s] = seg_starts[s];
    }
  } else if (chunks > rows_total) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = chunks / WARPS;
  byte_scan_kernel<<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      rows, chunks / 32, nd, seg, out);
  return (int)cudaGetLastError();
}
