// Native host-side runtime kernels for bloomsearch-tpu.
//
// The reference engine's performance-critical inner loops live in Go
// libraries (murmur3 hashing, bitset ops, CRC32C — SURVEY.md §2 "Native
// components"). Here they are C++ with batch interfaces so Python never
// loops per key: batched murmur3 x64_128 string hashing, scatter-OR bloom
// construction, AND-reduce probing, and CRC32C (Castagnoli, slicing-by-8).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>

#if defined(__GNUC__)
#define BS_EXPORT extern "C" __attribute__((visibility("default")))
#else
#define BS_EXPORT extern "C"
#endif

// ---------------------------------------------------------------------------
// murmur3 x64_128 (public domain algorithm), seed 0, little-endian blocks.
// Semantics must match bloomsearch_tpu/bloom/hashing.py::murmur3_x64_128,
// which the tests cross-check.
// ---------------------------------------------------------------------------

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h;
}

static void murmur3_x64_128(const uint8_t* data, uint64_t len, uint64_t seed,
                            uint64_t* out) {
  const uint64_t nblocks = len / 16;
  uint64_t h1 = seed;
  uint64_t h2 = seed;
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;

  for (uint64_t i = 0; i < nblocks; i++) {
    uint64_t k1, k2;
    std::memcpy(&k1, data + i * 16, 8);
    std::memcpy(&k2, data + i * 16 + 8, 8);

    k1 *= c1;
    k1 = rotl64(k1, 31);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl64(h1, 27);
    h1 += h2;
    h1 = h1 * 5 + 0x52dce729;

    k2 *= c2;
    k2 = rotl64(k2, 33);
    k2 *= c1;
    h2 ^= k2;
    h2 = rotl64(h2, 31);
    h2 += h1;
    h2 = h2 * 5 + 0x38495ab5;
  }

  const uint8_t* tail = data + nblocks * 16;
  const uint64_t tail_len = len & 15;
  uint64_t k1 = 0;
  uint64_t k2 = 0;
  switch (tail_len) {
    case 15: k2 ^= ((uint64_t)tail[14]) << 48; [[fallthrough]];
    case 14: k2 ^= ((uint64_t)tail[13]) << 40; [[fallthrough]];
    case 13: k2 ^= ((uint64_t)tail[12]) << 32; [[fallthrough]];
    case 12: k2 ^= ((uint64_t)tail[11]) << 24; [[fallthrough]];
    case 11: k2 ^= ((uint64_t)tail[10]) << 16; [[fallthrough]];
    case 10: k2 ^= ((uint64_t)tail[9]) << 8; [[fallthrough]];
    case 9:
      k2 ^= ((uint64_t)tail[8]) << 0;
      k2 *= c2;
      k2 = rotl64(k2, 33);
      k2 *= c1;
      h2 ^= k2;
      [[fallthrough]];
    case 8: k1 ^= ((uint64_t)tail[7]) << 56; [[fallthrough]];
    case 7: k1 ^= ((uint64_t)tail[6]) << 48; [[fallthrough]];
    case 6: k1 ^= ((uint64_t)tail[5]) << 40; [[fallthrough]];
    case 5: k1 ^= ((uint64_t)tail[4]) << 32; [[fallthrough]];
    case 4: k1 ^= ((uint64_t)tail[3]) << 24; [[fallthrough]];
    case 3: k1 ^= ((uint64_t)tail[2]) << 16; [[fallthrough]];
    case 2: k1 ^= ((uint64_t)tail[1]) << 8; [[fallthrough]];
    case 1:
      k1 ^= ((uint64_t)tail[0]) << 0;
      k1 *= c1;
      k1 = rotl64(k1, 31);
      k1 *= c2;
      h1 ^= k1;
  }

  h1 ^= len;
  h2 ^= len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  h2 += h1;
  out[0] = h1;
  out[1] = h2;
}

// Batch hash: key i spans data[offsets[i], offsets[i+1]). offsets has n+1
// entries. out is [n, 2] uint64 (h1, h2) rows.
BS_EXPORT void bs_hash_batch(const uint8_t* data, const int64_t* offsets,
                             int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    const int64_t start = offsets[i];
    const int64_t len = offsets[i + 1] - start;
    murmur3_x64_128(data + start, (uint64_t)len, 0, out + 2 * i);
  }
}

// ---------------------------------------------------------------------------
// Bloom construction / probing over uint32 word arrays.
// Positions are absolute bit indices in [0, m_bits); layout word = pos >> 5,
// bit = pos & 31, matching hashing.py::split_positions.
// ---------------------------------------------------------------------------

// OR the given bit positions into words (scatter-OR build).
BS_EXPORT void bs_scatter_or(uint32_t* words, const uint64_t* positions,
                             int64_t n_positions) {
  for (int64_t i = 0; i < n_positions; i++) {
    const uint64_t pos = positions[i];
    words[pos >> 5] |= (uint32_t)1 << (pos & 31);
  }
}

// KM positions + scatter-OR fused: hashes is [n,2] uint64.
BS_EXPORT void bs_build_from_hashes(uint32_t* words, uint64_t m_bits, int64_t k,
                                    const uint64_t* hashes, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const uint64_t h1 = hashes[2 * i];
    const uint64_t h2 = hashes[2 * i + 1];
    uint64_t pos = h1;
    for (int64_t j = 0; j < k; j++) {
      const uint64_t p = pos % m_bits;
      words[p >> 5] |= (uint32_t)1 << (p & 31);
      pos += h2;
    }
  }
}

// Blocked-256 layout: one 256-bit aligned block per key, k bits inside it.
// Derivation must match hashing.py::positions_for_hashes_blocked exactly:
// block = (h1 >> 32) % (m/256); step = (h2 | 1) & 255;
// bit_j = (h1 + (j+1)*step) & 255.
BS_EXPORT void bs_build_from_hashes_blocked(uint32_t* words, uint64_t m_bits,
                                            int64_t k, const uint64_t* hashes,
                                            int64_t n) {
  const uint64_t num_blocks = m_bits / 256;
  for (int64_t i = 0; i < n; i++) {
    const uint64_t h1 = hashes[2 * i];
    const uint64_t h2 = hashes[2 * i + 1];
    const uint64_t block = (h1 >> 32) % num_blocks;
    const uint64_t step = (h2 | 1) & 255;
    uint32_t* base = words + block * 8;
    for (int64_t j = 0; j < k; j++) {
      const uint64_t bit = (h1 + (uint64_t)(j + 1) * step) & 255;
      base[bit >> 5] |= (uint32_t)1 << (bit & 31);
    }
  }
}

BS_EXPORT void bs_probe_from_hashes_blocked(const uint32_t* words,
                                            uint64_t m_bits, int64_t k,
                                            const uint64_t* hashes, int64_t n,
                                            uint8_t* out) {
  const uint64_t num_blocks = m_bits / 256;
  for (int64_t i = 0; i < n; i++) {
    const uint64_t h1 = hashes[2 * i];
    const uint64_t h2 = hashes[2 * i + 1];
    const uint64_t block = (h1 >> 32) % num_blocks;
    const uint64_t step = (h2 | 1) & 255;
    const uint32_t* base = words + block * 8;
    uint8_t hit = 1;
    for (int64_t j = 0; j < k; j++) {
      const uint64_t bit = (h1 + (uint64_t)(j + 1) * step) & 255;
      if (!((base[bit >> 5] >> (bit & 31)) & 1)) {
        hit = 0;
        break;
      }
    }
    out[i] = hit;
  }
}

// AND-reduce probe: out[i] = 1 iff all k bits for key i are set.
BS_EXPORT void bs_probe_from_hashes(const uint32_t* words, uint64_t m_bits,
                                    int64_t k, const uint64_t* hashes,
                                    int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    const uint64_t h1 = hashes[2 * i];
    const uint64_t h2 = hashes[2 * i + 1];
    uint64_t pos = h1;
    uint8_t hit = 1;
    for (int64_t j = 0; j < k; j++) {
      const uint64_t p = pos % m_bits;
      if (!((words[p >> 5] >> (p & 31)) & 1)) {
        hit = 0;
        break;
      }
      pos += h2;
    }
    out[i] = hit;
  }
}

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli polynomial 0x1EDC6F41, reflected 0x82F63B78),
// slicing-by-8. Matches Go's hash/crc32 Castagnoli table semantics
// (reference file_format.go:33-34).
// ---------------------------------------------------------------------------

static uint32_t kCrcTables[8][256];

static void crc32c_init_tables() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++) {
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    }
    kCrcTables[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = kCrcTables[0][i];
    for (int t = 1; t < 8; t++) {
      crc = (crc >> 8) ^ kCrcTables[0][crc & 0xff];
      kCrcTables[t][i] = crc;
    }
  }
}

static void crc32c_init() {
  // Magic static: thread-safe one-time table build (the previous plain
  // bool flag let a second GIL-free pool thread read the flag before the
  // table stores were visible and CRC intact blocks wrong).
  static const bool done = (crc32c_init_tables(), true);
  (void)done;
}

#if defined(__x86_64__)
// Hardware CRC32C (SSE4.2 crc32 instruction): ~20 GB/s vs ~2 GB/s for the
// slicing-by-8 table path. Same polynomial, bit-identical results.
__attribute__((target("sse4.2"))) static uint32_t crc32c_hw(
    const uint8_t* data, int64_t n, uint32_t crc) {
  int64_t i = 0;
  uint64_t c = crc;
  while (n - i >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data + i, 8);
    c = __builtin_ia32_crc32di(c, chunk);
    i += 8;
  }
  uint32_t c32 = (uint32_t)c;
  for (; i < n; i++) {
    c32 = __builtin_ia32_crc32qi(c32, data[i]);
  }
  return c32;
}

static bool crc32c_hw_available() {
  static const bool ok = __builtin_cpu_supports("sse4.2");
  return ok;
}
#else
static bool crc32c_hw_available() { return false; }
static uint32_t crc32c_hw(const uint8_t*, int64_t, uint32_t) { return 0; }
#endif

BS_EXPORT uint32_t bs_crc32c(const uint8_t* data, int64_t n, uint32_t crc_in) {
  if (crc32c_hw_available()) {
    return ~crc32c_hw(data, n, ~crc_in);
  }
  crc32c_init();
  uint32_t crc = ~crc_in;
  int64_t i = 0;
  // Process 8 bytes at a time.
  while (n - i >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data + i, 8);
    crc ^= (uint32_t)chunk;
    const uint32_t hi = (uint32_t)(chunk >> 32);
    crc = kCrcTables[7][crc & 0xff] ^ kCrcTables[6][(crc >> 8) & 0xff] ^
          kCrcTables[5][(crc >> 16) & 0xff] ^ kCrcTables[4][crc >> 24] ^
          kCrcTables[3][hi & 0xff] ^ kCrcTables[2][(hi >> 8) & 0xff] ^
          kCrcTables[1][(hi >> 16) & 0xff] ^ kCrcTables[0][hi >> 24];
    i += 8;
  }
  for (; i < n; i++) {
    crc = (crc >> 8) ^ kCrcTables[0][(crc ^ data[i]) & 0xff];
  }
  return ~crc;
}

// Per-row CRC32C over a matrix of fixed-stride rows (bank groups store one
// CRC per flat bank row so sparse seek-reads stay verifiable). GIL released
// by the caller via ctypes.
BS_EXPORT void bs_crc32c_rows(const uint8_t* data, int64_t num_rows,
                              int64_t row_bytes, uint32_t* out) {
  for (int64_t r = 0; r < num_rows; r++) {
    out[r] = bs_crc32c(data + r * row_bytes, row_bytes, 0);
  }
}

// ---------------------------------------------------------------------------
// Length-prefixed row stream helpers.
// Row data sections are streams of (uint32 LE length | row bytes) records
// (reference bloom_tree_engine.go:586-613). Scanning them in Python is a
// per-row loop; this splits a whole decompressed block in one call.
// ---------------------------------------------------------------------------

// Parse offsets of each row payload in a length-prefixed stream.
// out_offsets/out_lengths must have capacity max_rows. Returns the number of
// rows parsed, or -1 on malformed input (record overrunning the buffer).
BS_EXPORT int64_t bs_split_rows(const uint8_t* data, int64_t n,
                                int64_t max_rows, int64_t* out_offsets,
                                int64_t* out_lengths) {
  int64_t pos = 0;
  int64_t count = 0;
  while (pos + 4 <= n && count < max_rows) {
    uint32_t len;
    std::memcpy(&len, data + pos, 4);
    pos += 4;
    if (pos + (int64_t)len > n) return -1;
    out_offsets[count] = pos;
    out_lengths[count] = (int64_t)len;
    pos += (int64_t)len;
    count++;
  }
  if (pos != n) return -1;  // trailing garbage or capacity exhausted
  return count;
}

// ---------------------------------------------------------------------------
// Snappy block codec (format-compatible with the public snappy block format:
// uvarint uncompressed length, then literal/copy tagged elements).
// Implemented from the published format description. The engine frames
// streams as chunks of [uint32 LE compressed_len | snappy block], each block
// covering <= 64 KiB of input (bloomsearch_tpu/snappy.py).
// ---------------------------------------------------------------------------

static const int64_t kSnappyMaxBlockInput = 65536;

BS_EXPORT int64_t bs_snappy_max_compressed(int64_t n) {
  // Worst case: all literals with headers, plus uvarint length.
  return 32 + n + n / 6;
}

static inline uint32_t snappy_hash(uint32_t bytes) {
  return (bytes * 0x1e35a7bdu) >> 18;  // 14-bit table
}

static inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static uint8_t* emit_literal(uint8_t* op, const uint8_t* lit, int64_t len) {
  const int64_t n = len - 1;
  if (n < 60) {
    *op++ = (uint8_t)(n << 2);
  } else if (n < 256) {
    *op++ = 60 << 2;
    *op++ = (uint8_t)n;
  } else {
    *op++ = 61 << 2;
    *op++ = (uint8_t)(n & 0xff);
    *op++ = (uint8_t)(n >> 8);
  }
  std::memcpy(op, lit, len);
  return op + len;
}

static uint8_t* emit_copy(uint8_t* op, int64_t offset, int64_t len) {
  // Emit copies of length 4..64; caller splits longer matches.
  while (len >= 68) {
    *op++ = (uint8_t)((63 << 2) | 2);  // copy-2, len 64
    *op++ = (uint8_t)(offset & 0xff);
    *op++ = (uint8_t)(offset >> 8);
    len -= 64;
  }
  if (len > 64) {
    // Leave >= 4 for the final copy.
    *op++ = (uint8_t)((59 << 2) | 2);  // len 60
    *op++ = (uint8_t)(offset & 0xff);
    *op++ = (uint8_t)(offset >> 8);
    len -= 60;
  }
  if (len >= 12 || offset >= 2048) {
    *op++ = (uint8_t)(((len - 1) << 2) | 2);
    *op++ = (uint8_t)(offset & 0xff);
    *op++ = (uint8_t)(offset >> 8);
  } else {
    *op++ = (uint8_t)(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
    *op++ = (uint8_t)(offset & 0xff);
  }
  return op;
}

// Compress one block (n <= 64 KiB) -> compressed size.
BS_EXPORT int64_t bs_snappy_compress_block(const uint8_t* in, int64_t n,
                                           uint8_t* out) {
  if (n > kSnappyMaxBlockInput) return -1;
  uint8_t* op = out;
  // uvarint uncompressed length
  uint64_t v = (uint64_t)n;
  while (v >= 0x80) {
    *op++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *op++ = (uint8_t)v;

  if (n < 16) {
    if (n > 0) op = emit_literal(op, in, n);
    return op - out;
  }

  static thread_local uint16_t table[1 << 14];
  std::memset(table, 0, sizeof(table));

  const uint8_t* ip = in;
  const uint8_t* ip_end = in + n;
  const uint8_t* ip_limit = ip_end - 15;  // room for load32 + margin
  const uint8_t* next_emit = in;

  ip++;
  while (ip < ip_limit) {
    uint32_t h = snappy_hash(load32(ip));
    const uint8_t* candidate = in + table[h];
    table[h] = (uint16_t)(ip - in);
    if (candidate < ip && load32(candidate) == load32(ip)) {
      // Emit pending literal.
      if (ip > next_emit) op = emit_literal(op, next_emit, ip - next_emit);
      // Extend the match.
      const uint8_t* base = ip;
      ip += 4;
      const uint8_t* match = candidate + 4;
      while (ip < ip_end && match < ip_end && *ip == *match) {
        ip++;
        match++;
      }
      op = emit_copy(op, base - candidate, ip - base);
      next_emit = ip;
      if (ip >= ip_limit) break;
      // Re-prime the table at the new position.
      table[snappy_hash(load32(ip))] = (uint16_t)(ip - in);
      ip++;
    } else {
      ip++;
    }
  }
  if (next_emit < ip_end) op = emit_literal(op, next_emit, ip_end - next_emit);
  return op - out;
}

// Compress a whole buffer into the chunked stream framing
// ([uint32 LE compressed_len | snappy block] per chunk_size bytes of
// input, last chunk may be short) in one GIL-free call. The per-64KB
// Python loop (copy chunk -> alloc out -> ctypes call -> copy result)
// dominated merge's re-compression; this emits the SAME bytes as that
// loop (identical block compressor, identical framing). out must hold
// ceil(n/chunk_size) * (4 + bs_snappy_max_compressed(chunk_size)).
// Returns bytes written, or -1 on bad args.
BS_EXPORT int64_t bs_snappy_compress_stream(const uint8_t* in, int64_t n,
                                            int64_t chunk_size,
                                            uint8_t* out) {
  if (chunk_size <= 0 || chunk_size > kSnappyMaxBlockInput || n < 0)
    return -1;
  uint8_t* op = out;
  for (int64_t pos = 0; pos < n; pos += chunk_size) {
    const int64_t len = (n - pos < chunk_size) ? (n - pos) : chunk_size;
    const int64_t written = bs_snappy_compress_block(in + pos, len, op + 4);
    if (written < 0) return -1;
    const uint32_t w32 = (uint32_t)written;
    std::memcpy(op, &w32, 4);  // little-endian hosts only (same as decode)
    op += 4 + written;
  }
  return op - out;
}

// Parse the uvarint uncompressed length of a block; -1 if malformed.
BS_EXPORT int64_t bs_snappy_uncompressed_length(const uint8_t* in, int64_t n) {
  uint64_t result = 0;
  int shift = 0;
  int64_t i = 0;
  while (i < n && shift < 64) {
    const uint8_t b = in[i++];
    result |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) return (int64_t)result;
    shift += 7;
  }
  return -1;
}

// Decompress one block -> bytes written, or -1 on malformed input.
BS_EXPORT int64_t bs_snappy_decompress_block(const uint8_t* in, int64_t n,
                                             uint8_t* out, int64_t out_cap) {
  // Skip the uvarint header.
  int64_t i = 0;
  while (i < n && (in[i] & 0x80)) i++;
  if (i >= n) return -1;
  i++;

  uint8_t* op = out;
  uint8_t* op_end = out + out_cap;

  // FAST LOOP (klauspost-style): while both cursors are >= 64 bytes from
  // their ends, ops move as fixed-size 16/32/64-byte copies with the slop
  // overwritten by later ops, and per-op bounds checks reduce to the two
  // loop guards. The tail (and rare shapes) falls through to the exact,
  // fully-checked loop below. JSON rows compress to short literals + short
  // copies, so this loop carries nearly all bytes.
  {
    const int64_t n_fast = n - 64;
    uint8_t* const out_fast64 = (out_cap >= 65) ? op_end - 64 : out;
    while (i < n_fast && op < out_fast64) {
      const uint8_t tag = in[i++];
      const uint32_t kind = tag & 3;
      if (kind == 0) {
        int64_t len = (tag >> 2) + 1;
        if (len <= 16) {
          std::memcpy(op, in + i, 16);
        } else if (len <= 60) {
          std::memcpy(op, in + i, 16);
          std::memcpy(op + 16, in + i + 16, 16);
          if (len > 32) {
            std::memcpy(op + 32, in + i + 32, 16);
            std::memcpy(op + 48, in + i + 48, 16);
          }
        } else {
          // Long literal: decode the extra length bytes, exact-check, bulk
          // memcpy (memory-speed for incompressible spans).
          const int extra = (int)(len - 60);
          if (i + extra > n) return -1;
          len = 0;
          for (int b = extra - 1; b >= 0; b--) len = (len << 8) | in[i + b];
          len += 1;
          i += extra;
          if (i + len > n || op + len > op_end) return -1;
          std::memcpy(op, in + i, (size_t)len);
        }
        i += len;
        op += len;
        continue;
      }
      int64_t len, offset;
      if (kind == 1) {
        len = ((tag >> 2) & 7) + 4;
        offset = ((int64_t)(tag >> 5) << 8) | in[i++];
      } else if (kind == 2) {
        len = (tag >> 2) + 1;
        offset = (int64_t)in[i] | ((int64_t)in[i + 1] << 8);
        i += 2;
      } else {
        len = (tag >> 2) + 1;
        offset = (int64_t)in[i] | ((int64_t)in[i + 1] << 8) |
                 ((int64_t)in[i + 2] << 16) | ((int64_t)in[i + 3] << 24);
        i += 4;
      }
      if (offset <= 0 || op - out < offset) return -1;
      const uint8_t* src = op - offset;
      if (offset >= 16) {
        // Non-overlapping for len <= 64 (len caps at 64 for copy tags):
        // unconditional 16-byte strides, slop overwritten later.
        std::memcpy(op, src, 16);
        if (len > 16) std::memcpy(op + 16, src + 16, 16);
        if (len > 32) {
          std::memcpy(op + 32, src + 32, 16);
          std::memcpy(op + 48, src + 48, 16);
        }
      } else if (offset >= len) {
        // Short copy (len <= offset < 16): the 16-byte slop write overlaps
        // the source by 16-offset bytes, so go through a register-resident
        // temporary — memcpy on overlapping ranges is UB even when today's
        // lowering (one vector load+store) happens to be safe.
        uint8_t tmp[16];
        std::memcpy(tmp, src, 16);
        std::memcpy(op, tmp, 16);
      } else {
        // Overlapping: period replication, doubling the realized prefix.
        int64_t done = offset;
        std::memcpy(op, src, (size_t)offset);
        while (done < len) {
          const int64_t chunk = (done < len - done) ? done : len - done;
          std::memcpy(op + done, op, (size_t)chunk);
          done += chunk;
        }
      }
      op += len;
    }
  }

  // Exact tail loop (also the whole path for tiny buffers). Fast-path
  // limits: whenever the cursor is at least 32/16 bytes from the end,
  // short literals and copies move as FIXED-size chunks with the slop
  // overwritten by later ops. Strict (<) comparisons: when the buffer is
  // smaller than the slop the sentinel equals the base pointer and the
  // fast paths are unreachable (op < out is always false) — a <= would let
  // the FIRST op write slop into a tiny output buffer (heap overflow;
  // caught by the malformed-input fuzz).
  const uint8_t* const in_fast = (n >= 33) ? in + n - 32 : in;
  uint8_t* const out_fast = (out_cap >= 33) ? op_end - 32 : out;
  while (i < n) {
    const uint8_t tag = in[i++];
    const uint32_t kind = tag & 3;
    if (kind == 0) {  // literal
      int64_t len = (tag >> 2) + 1;
      if (len <= 32 && in + i < in_fast && op < out_fast) {
        std::memcpy(op, in + i, 16);
        if (len > 16) std::memcpy(op + 16, in + i + 16, 16);
        i += len;
        op += len;
        continue;
      }
      if (len > 60) {
        const int extra = (int)(len - 60);
        if (i + extra > n) return -1;
        len = 0;
        for (int b = extra - 1; b >= 0; b--) len = (len << 8) | in[i + b];
        len += 1;
        i += extra;
      }
      if (i + len > n || op + len > op_end) return -1;
      std::memcpy(op, in + i, len);
      i += len;
      op += len;
    } else {
      int64_t len, offset;
      if (kind == 1) {
        len = ((tag >> 2) & 7) + 4;
        if (i >= n) return -1;
        offset = ((int64_t)(tag >> 5) << 8) | in[i++];
      } else if (kind == 2) {
        len = (tag >> 2) + 1;
        if (i + 2 > n) return -1;
        offset = (int64_t)in[i] | ((int64_t)in[i + 1] << 8);
        i += 2;
      } else {
        len = (tag >> 2) + 1;
        if (i + 4 > n) return -1;
        offset = (int64_t)in[i] | ((int64_t)in[i + 1] << 8) |
                 ((int64_t)in[i + 2] << 16) | ((int64_t)in[i + 3] << 24);
        i += 4;
      }
      if (offset <= 0 || op - out < offset) return -1;
      const uint8_t* src = op - offset;
      if (len <= 16 && offset >= 16 && op < out_fast) {
        std::memcpy(op, src, 16);  // fixed-size, non-overlapping
        op += len;
        continue;
      }
      if (op + len > op_end) return -1;
      if (offset >= len) {
        // Non-overlapping: bulk copy (the common case for text).
        std::memcpy(op, src, (size_t)len);
      } else {
        // Overlapping: replicate the period (RLE semantics). Double the
        // realized prefix each pass instead of byte-at-a-time.
        int64_t done = offset;
        std::memcpy(op, src, (size_t)offset);
        while (done < len) {
          const int64_t chunk = (done < len - done) ? done : len - done;
          std::memcpy(op + done, op, (size_t)chunk);
          done += chunk;
        }
      }
      op += len;
    }
  }
  return op - out;
}

// ---------------------------------------------------------------------------
// Candidate row scan: multi-needle case-insensitive substring search over a
// decompressed block, mapping hits to rows. A sound *pre-filter* for row
// verification — a row can only match token/field conditions if the needle
// bytes appear in it — so JSON parsing runs only on candidates; exact
// verification upstream keeps zero false positives.
// ---------------------------------------------------------------------------

#include <cstdlib>
#include <cstring>
#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace scan_simd {

inline uint8_t lower1(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? (uint8_t)(c + 32) : c;
}

// Case-insensitive needle-at-position verify over RAW bytes (needle is
// already lowercase).
inline bool verify_at(const uint8_t* data, const uint8_t* needle, int64_t nlen) {
  for (int64_t j = 0; j < nlen; j++) {
    if (lower1(data[j]) != needle[j]) return false;
  }
  return true;
}

// Mark every row a hit [pos, pos+nlen) overlaps; rows are sorted by offset
// and hit positions arrive in increasing order, so `row` only advances.
inline void mark_rows(int64_t hit_start, int64_t nlen, const int64_t* row_offsets,
                      const int64_t* row_lengths, int64_t n_rows, int64_t& row,
                      uint8_t* row_out) {
  const int64_t hit_end = hit_start + nlen - 1;
  while (row < n_rows && row_offsets[row] + row_lengths[row] <= hit_start) row++;
  for (int64_t r = row; r < n_rows && row_offsets[r] <= hit_end; r++) row_out[r] = 1;
}

#if defined(__x86_64__)
// ASCII-only in-register lowering. Signed compares: bytes >= 0x80 are
// negative and never lower. A standalone target-attributed function (NOT a
// lambda: lambdas don't inherit the enclosing function's target attribute,
// which breaks the generic no--march fallback build).
__attribute__((target("avx2"))) static inline __m256i lower_vec_avx2(__m256i b) {
  const __m256i vAm1 = _mm256_set1_epi8('A' - 1);
  const __m256i vZp1 = _mm256_set1_epi8('Z' + 1);
  const __m256i v32 = _mm256_set1_epi8(32);
  const __m256i is_upper =
      _mm256_and_si256(_mm256_cmpgt_epi8(b, vAm1), _mm256_cmpgt_epi8(vZp1, b));
  return _mm256_add_epi8(b, _mm256_and_si256(is_upper, v32));
}

// Fused lowercase + anchor-pair substring scan: 32 raw bytes load, ASCII
// lowering in-register, first/last needle byte compared at their relative
// offsets, candidate positions verified exactly. No lowercased copy of the
// buffer is ever materialized and the common no-match case runs at tens of
// GB/s instead of memmem's ~1 GB/s.
__attribute__((target("avx2"))) static void scan_needle_avx2(
    const uint8_t* data, int64_t n, const uint8_t* needle, int64_t nlen,
    const int64_t* row_offsets, const int64_t* row_lengths, int64_t n_rows,
    uint8_t* row_out) {
  const __m256i c0 = _mm256_set1_epi8((char)needle[0]);
  const __m256i cL = _mm256_set1_epi8((char)needle[nlen - 1]);
  int64_t row = 0;
  int64_t i = 0;
  const int64_t last_start = n - nlen;  // last valid match start
  for (; i + 32 + nlen - 1 <= n; i += 32) {
    const __m256i b0 = lower_vec_avx2(
        _mm256_loadu_si256((const __m256i*)(data + i)));
    const __m256i bL = lower_vec_avx2(
        _mm256_loadu_si256((const __m256i*)(data + i + nlen - 1)));
    uint32_t m = (uint32_t)_mm256_movemask_epi8(
        _mm256_and_si256(_mm256_cmpeq_epi8(b0, c0), _mm256_cmpeq_epi8(bL, cL)));
    while (m) {
      const int bit = __builtin_ctz(m);
      m &= m - 1;
      const int64_t pos = i + bit;
      if (verify_at(data + pos, needle, nlen)) {
        mark_rows(pos, nlen, row_offsets, row_lengths, n_rows, row, row_out);
      }
    }
  }
  for (; i <= last_start; i++) {
    if (lower1(data[i]) == needle[0] && verify_at(data + i, needle, nlen)) {
      mark_rows(i, nlen, row_offsets, row_lengths, n_rows, row, row_out);
    }
  }
}

static bool avx2_available() {
  static const bool ok = __builtin_cpu_supports("avx2");
  return ok;
}
#else
static bool avx2_available() { return false; }
static void scan_needle_avx2(const uint8_t*, int64_t, const uint8_t*, int64_t,
                             const int64_t*, const int64_t*, int64_t, uint8_t*) {}
#endif

}  // namespace scan_simd

// out is uint8[n_needles * n_rows] (row-major per needle), set to 1 where the
// needle occurs within (or overlapping) the row's byte range. Needles and
// data are compared case-insensitively for ASCII letters. Returns 0 on
// success, -1 on allocation failure.
BS_EXPORT int64_t bs_scan_candidates(
    const uint8_t* data, int64_t n,
    const uint8_t* needles, const int64_t* needle_offsets, int64_t n_needles,
    const int64_t* row_offsets, const int64_t* row_lengths, int64_t n_rows,
    uint8_t* out) {
  if (n == 0 || n_rows == 0) return 0;
  // Fallback path (no AVX2): lowercase the buffer once, then memmem.
  uint8_t* lower = nullptr;
  if (!scan_simd::avx2_available()) {
    lower = (uint8_t*)std::malloc((size_t)n);
    if (!lower) return -1;
    for (int64_t i = 0; i < n; i++) {
      lower[i] = scan_simd::lower1(data[i]);
    }
  }

  // Rows whose stored bytes cannot PROVE a needle's absence are forced to
  // candidates for every needle (zero-false-negative invariant; exact row
  // verification upstream rejects the false positives):
  // - any byte >= 0x80: raw UTF-8 whose Unicode lowercase may be pure ASCII
  //   (e.g. U+212A KELVIN SIGN lowercases to 'k'), so an ASCII needle can
  //   match a row containing no ASCII needle bytes;
  // - a \uXXXX escape: may encode printable ASCII (serialized ingest can
  //   carry "<" for '<') or a non-ASCII char with an ASCII lowercase;
  // - a \/ escape: legal JSON spelling of '/' that hides the literal byte.
  // Other escapes (\" \\ \b \f \n \r \t) only encode characters that make a
  // needle unusable upstream or split tokens, so they can't hide a match.
  for (int64_t r = 0; r < n_rows; r++) {
    const int64_t row_start = row_offsets[r];
    const int64_t row_end = row_start + row_lengths[r];
    // Word-wise prefilter: most rows contain neither a high byte nor any
    // backslash, and skip the per-byte escape walk entirely.
    bool suspicious = false;
    int64_t i = row_start;
    const uint64_t kHigh = 0x8080808080808080ull;
    const uint64_t kOnes = 0x0101010101010101ull;
    const uint64_t kBackslash = 0x5c5c5c5c5c5c5c5cull;
    for (; i + 8 <= row_end; i += 8) {
      uint64_t w;
      std::memcpy(&w, data + i, 8);
      const uint64_t x = w ^ kBackslash;  // zero byte where '\\'
      if ((w & kHigh) | ((x - kOnes) & ~x & kHigh)) {
        suspicious = true;
        break;
      }
    }
    if (!suspicious) {
      for (; i < row_end; i++) {
        const uint8_t c = data[i];
        if (c >= 0x80 || c == '\\') {
          suspicious = true;
          break;
        }
      }
    }
    if (!suspicious) continue;
    bool unprovable = false;
    for (i = row_start; i < row_end;) {
      const uint8_t c = data[i];
      if (c >= 0x80) {
        unprovable = true;
        break;
      }
      if (c == '\\' && i + 1 < row_end) {
        const uint8_t nxt = data[i + 1];
        if (nxt == 'u' || nxt == 'U' || nxt == '/') {
          unprovable = true;
          break;
        }
        i += 2;  // step over the escaped char (handles literal "\\u")
      } else {
        i += 1;
      }
    }
    if (unprovable) {
      for (int64_t q = 0; q < n_needles; q++) out[q * n_rows + r] = 1;
    }
  }

  for (int64_t q = 0; q < n_needles; q++) {
    const uint8_t* needle = needles + needle_offsets[q];
    const int64_t nlen = needle_offsets[q + 1] - needle_offsets[q];
    uint8_t* row_out = out + q * n_rows;
    if (nlen == 0 || nlen > n) {
      // Degenerate needle: conservatively every row is a candidate.
      std::memset(row_out, 1, (size_t)n_rows);
      continue;
    }
    if (lower == nullptr) {
      // Fused SIMD path: lowercase in-register over the raw bytes.
      scan_simd::scan_needle_avx2(
          data, n, needle, nlen, row_offsets, row_lengths, n_rows, row_out);
      continue;
    }
    int64_t row = 0;
    const uint8_t* cursor = lower;
    const uint8_t* end = lower + n;
    while (cursor < end) {
      const uint8_t* hit =
          (const uint8_t*)memmem(cursor, end - cursor, needle, (size_t)nlen);
      if (!hit) break;
      // Mark every row the hit overlaps (row-spanning hits mark both sides:
      // conservative, exact verification rejects the false side).
      scan_simd::mark_rows(
          hit - lower, nlen, row_offsets, row_lengths, n_rows, row, row_out);
      cursor = hit + 1;
    }
  }
  std::free(lower);
  return 0;
}

// ---------------------------------------------------------------------------
// Ingest tokenizer: parse a batch of compact JSON rows (ASCII bytes — the
// engine serializes with json.dumps ensure_ascii), walk fields exactly like
// the Python tokenizer (dot paths, array indices dropped), tokenize values
// (ASCII-lower + whitespace split), and emit deduplicated murmur3 hash pairs
// for the three keyspaces directly — no key strings cross the FFI boundary.
//
// Exactness contract with bloomsearch_tpu/tokenizer.py (the semantic spec):
// - number tokens are the JSON number text with a trailing ".0" stripped
//   (json.dumps writes repr(); go_like_str == repr() minus trailing .0)
// - Infinity/-Infinity/NaN literals map to "+inf"/"-inf"/"nan"
// - bools are "true"/"false"; null contributes nothing
// - whitespace = ASCII 0x09-0x0d, 0x1c-0x1f, 0x20 (Python str.split's ASCII
//   subset); lowering is ASCII-only
// - any \uXXXX escape >= 0x80 or >= 0x80-codepoint content means unicode
//   lowering/whitespace rules could apply: the row is flagged for the
//   Python fallback path instead (zero-divergence guarantee).
// ---------------------------------------------------------------------------

namespace ingest {

// repr(d) rendered as the go_like_str token (trailing ".0" stripped),
// lowercase. CPython float repr = the SHORTEST round-tripping decimal,
// fixed notation for decimal exponent in [-4, 16), else d.ddde±EE with a
// two-digit-minimum exponent. Reproducing it exactly lets the ingest and
// verify parsers emit the spec token for ANY legal JSON float spelling.
// Returns token length, or -1 (caller falls back to the Python lane).
static int bs_float_repr_token(double d, char* out, int cap) {
  if (!std::isfinite(d)) return -1;
  char buf[64];
  int p;
  for (p = 1; p <= 17; p++) {
    std::snprintf(buf, sizeof(buf), "%.*e", p - 1, d);
    char* e2 = nullptr;
    if (std::strtod(buf, &e2) == d && e2 && *e2 == '\0') break;
  }
  if (p > 17) return -1;
  // buf: [-]D[.DDD...]e±XX with exactly p significant digits.
  char digits[32];
  int nd = 0;
  const char* q = buf;
  bool neg = false;
  if (*q == '-') { neg = true; q++; }
  for (; *q && *q != 'e'; q++)
    if (*q != '.') digits[nd++] = *q;
  if (*q != 'e') return -1;
  const long E = std::strtol(q + 1, nullptr, 10);
  int w = 0;
  auto put = [&](char c) {
    if (w < cap) out[w] = c;
    w++;
  };
  if (neg) put('-');
  if (E >= -4 && E < 16) {
    if (E >= nd - 1) {  // integral value: repr "...0.0", token strips ".0"
      for (int i = 0; i < nd; i++) put(digits[i]);
      for (long i = 0; i < E - (nd - 1); i++) put('0');
    } else if (E >= 0) {
      for (long i = 0; i <= E; i++) put(digits[i]);
      put('.');
      for (int i = (int)E + 1; i < nd; i++) put(digits[i]);
    } else {
      put('0');
      put('.');
      for (long i = 0; i < -E - 1; i++) put('0');
      for (int i = 0; i < nd; i++) put(digits[i]);
    }
  } else {
    put(digits[0]);
    if (nd > 1) {
      put('.');
      for (int i = 1; i < nd; i++) put(digits[i]);
    }
    put('e');
    put(E >= 0 ? '+' : '-');
    long a = E >= 0 ? E : -E;
    char eb[8];
    int en = 0;
    do {
      eb[en++] = (char)('0' + (a % 10));
      a /= 10;
    } while (a);
    if (en == 1) put('0');  // repr pads the exponent to two digits
    while (en) put(eb[--en]);
  }
  if (w >= cap) return -1;
  return w;
}

struct HashSink {
  uint64_t* out;      // [cap, 2]
  int64_t cap;
  int64_t count;
  // Open-addressing dedup set of full (h1, h2) pairs; empty = (0, 0),
  // which only murmur3("") produces and empty keys never occur. The set
  // GROWS by rehash at 50% load, so memory scales with the batch's actual
  // distinct-key count instead of the caller's output capacity (a
  // caps-sized upfront calloc dominated ingest at scale: ~50 MB zeroed
  // per 4k-row batch).
  uint64_t* set_keys;  // [set_size, 2]
  int64_t set_size;    // power of two
  bool overflow;       // out array full (caller retries with bigger caps)
  bool oom;

  static uint64_t slot_of(uint64_t h1, uint64_t h2, int64_t size) {
    return (h1 ^ (h2 * 0x9e3779b97f4a7c15ULL)) & (uint64_t)(size - 1);
  }

  bool grow() {
    const int64_t new_size = set_size * 2;
    uint64_t* fresh = (uint64_t*)std::calloc((size_t)(2 * new_size), 8);
    if (!fresh) {
      oom = true;
      return false;
    }
    for (int64_t i = 0; i < set_size; i++) {
      const uint64_t h1 = set_keys[2 * i];
      const uint64_t h2 = set_keys[2 * i + 1];
      if (h1 == 0 && h2 == 0) continue;
      uint64_t slot = slot_of(h1, h2, new_size);
      while (fresh[2 * slot] != 0 || fresh[2 * slot + 1] != 0) {
        slot = (slot + 1) & (uint64_t)(new_size - 1);
      }
      fresh[2 * slot] = h1;
      fresh[2 * slot + 1] = h2;
    }
    std::free(set_keys);
    set_keys = fresh;
    set_size = new_size;
    return true;
  }

  bool add(uint64_t h1, uint64_t h2) {
    uint64_t slot = slot_of(h1, h2, set_size);
    while (true) {
      uint64_t* entry = set_keys + 2 * slot;
      if (entry[0] == 0 && entry[1] == 0) {
        if (count >= cap) {
          overflow = true;
          return false;
        }
        if (count * 2 >= set_size) {
          if (!grow()) return false;
          return add(h1, h2);  // re-probe in the grown set
        }
        entry[0] = h1;
        entry[1] = h2;
        out[2 * count] = h1;
        out[2 * count + 1] = h2;
        count++;
        return true;
      }
      if (entry[0] == h1 && entry[1] == h2) return true;  // duplicate
      slot = (slot + 1) & (uint64_t)(set_size - 1);
    }
  }
};

static inline bool is_ws(uint8_t c) {
  return (c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x20);
}

static inline uint8_t ascii_lower(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? (uint8_t)(c + 32) : c;
}

// Maximum JSON nesting the native walkers handle before deferring the row
// to the Python path (protects the C stack; Python's own recursion limit
// covers deeper rows).
static const int32_t kMaxDepth = 192;

// Shared recursive-descent walker over one compact-JSON row, parameterized
// by a Sink receiving path push/pop and primitive-value events. Sinks:
// IngestSink (hash emission for bloom construction, bs_ingest_tokenize) and
// VerifySink (exact row verification, bs_verify_rows). Both share identical
// fallback conditions (non-ASCII content, \uXXXX >= 0x80, non-canonical
// numbers, parse trouble) so native behavior is always bit-exact with the
// Python spec or deferred to it.
template <class SinkT>
struct Parser {
  const uint8_t* p;
  const uint8_t* end;
  bool fallback;  // row needs the Python path
  bool error;
  // Sink-requested early stop. No current sink sets it (VerifySink must
  // see every duplicate key; IngestSink indexes the whole row), but the
  // parse loops honor it. The full-consumption checks below deliberately
  // IGNORE it: an early-stopped row has unexamined trailing bytes, so it
  // routes to the Python fallback rather than silently verifying the
  // consumed prefix (json.loads, the spec, rejects trailing bytes).
  bool done;

  // scratch buffers (reused across rows)
  uint8_t* path;       // current dot path
  int64_t path_len;
  uint8_t* value_buf;  // decoded value bytes
  uint8_t* key_buf;    // decoded object key
  int64_t buf_cap;
  int32_t seg_depth;   // pushed path segments (for subtree scoping)
  int32_t depth;       // total nesting depth (recursion guard)

  SinkT* sink;
  uint8_t delimiter;

  void skip_value() {
    // Top-level bare primitive (rows are objects; tolerate anything).
    while (!at_end() && *p != ',' && *p != '}' && *p != ']') p++;
  }

  bool at_end() { return p >= end; }

  // Decode a JSON string into dst (ASCII-lowered if lower=true).
  // Returns length, or -1 -> fallback/error.
  int64_t parse_string(uint8_t* dst, bool lower) {
    if (at_end() || *p != '"') { error = true; return -1; }
    p++;
    int64_t n = 0;
    while (!at_end() && *p != '"') {
      uint8_t c = *p++;
      if (c == '\\') {
        if (at_end()) { error = true; return -1; }
        uint8_t e = *p++;
        switch (e) {
          case '"': c = '"'; break;
          case '\\': c = '\\'; break;
          case '/': c = '/'; break;
          case 'b': c = 0x08; break;
          case 'f': c = 0x0c; break;
          case 'n': c = 0x0a; break;
          case 'r': c = 0x0d; break;
          case 't': c = 0x09; break;
          case 'u': {
            if (end - p < 4) { error = true; return -1; }
            uint32_t cp = 0;
            for (int i = 0; i < 4; i++) {
              const uint8_t h = *p++;
              cp <<= 4;
              if (h >= '0' && h <= '9') cp |= h - '0';
              else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
              else { error = true; return -1; }
            }
            if (cp >= 0x80) { fallback = true; return -1; }
            c = (uint8_t)cp;
            break;
          }
          default: error = true; return -1;
        }
      } else if (c >= 0x80) {
        // Shouldn't occur with ensure_ascii, but be safe.
        fallback = true;
        return -1;
      } else if (c < 0x20) {
        // Raw control byte inside a string: json.loads (strict mode, the
        // spec) REJECTS it — accepting here silently indexed rows the
        // Python lane raises on.
        error = true;
        return -1;
      }
      if (n >= buf_cap) { error = true; return -1; }
      dst[n++] = lower ? ascii_lower(c) : c;
    }
    if (at_end()) { error = true; return -1; }
    p++;  // closing quote
    return n;
  }

  void skip_ws() {
    while (!at_end() && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  }

  void emit_value(int64_t vlen) { sink->on_value(*this, vlen); }

  // Parse a number/keyword primitive; token text goes into value_buf.
  void parse_primitive() {
    const uint8_t c = *p;
    if (c == 't') {  // true
      if (end - p >= 4 && std::memcmp(p, "true", 4) == 0) {
        std::memcpy(value_buf, "true", 4);
        p += 4;
        emit_value(4);
      } else error = true;
    } else if (c == 'f') {
      if (end - p >= 5 && std::memcmp(p, "false", 5) == 0) {
        std::memcpy(value_buf, "false", 5);
        p += 5;
        emit_value(5);
      } else error = true;
    } else if (c == 'n') {
      if (end - p >= 4 && std::memcmp(p, "null", 4) == 0) {
        p += 4;  // null contributes nothing (tokenizer.py: None skipped)
      } else error = true;
    } else if (c == 'N') {  // NaN (json.dumps non-strict)
      if (end - p >= 3 && std::memcmp(p, "NaN", 3) == 0) {
        std::memcpy(value_buf, "nan", 3);
        p += 3;
        emit_value(3);
      } else error = true;
    } else if (c == 'I') {  // Infinity
      if (end - p >= 8 && std::memcmp(p, "Infinity", 8) == 0) {
        std::memcpy(value_buf, "+inf", 4);
        p += 8;
        emit_value(4);
      } else error = true;
    } else {
      // number (or -Infinity)
      if (c == '-' && end - p >= 9 && std::memcmp(p + 1, "Infinity", 8) == 0) {
        std::memcpy(value_buf, "-inf", 4);
        p += 9;
        emit_value(4);
        return;
      }
      int64_t n = 0;
      bool has_dot = false, has_exp = false;
      while (!at_end() &&
             ((*p >= '0' && *p <= '9') || *p == '-' || *p == '+' || *p == '.' ||
              *p == 'e' || *p == 'E')) {
        const uint8_t c2 = ascii_lower(*p++);
        if (c2 == '.') has_dot = true;
        if (c2 == 'e') has_exp = true;
        if (n >= buf_cap) { error = true; return; }
        value_buf[n++] = c2;
      }
      if (n == 0) { error = true; return; }
      // STRICT JSON number grammar first — the char-class loop above eats
      // any [0-9+-.eE] soup, but json.loads (the spec) REJECTS "1-2",
      // "+5", "1.2.3", "5e": such rows must error exactly like the Python
      // lane, not silently index a garbage token.
      {
        const uint8_t* s = value_buf;
        int64_t i = 0;
        if (i < n && s[i] == '-') i++;
        if (i >= n) { error = true; return; }
        if (s[i] == '0') { i++; }
        else if (s[i] >= '1' && s[i] <= '9') { while (i < n && s[i] >= '0' && s[i] <= '9') i++; }
        else { error = true; return; }
        if (i < n && s[i] == '.') {
          i++;
          if (i >= n || s[i] < '0' || s[i] > '9') { error = true; return; }
          while (i < n && s[i] >= '0' && s[i] <= '9') i++;
        }
        if (i < n && s[i] == 'e') {
          i++;
          if (i < n && (s[i] == '+' || s[i] == '-')) i++;
          if (i >= n || s[i] < '0' || s[i] > '9') { error = true; return; }
          while (i < n && s[i] >= '0' && s[i] <= '9') i++;
        }
        if (i != n) { error = true; return; }
      }
      // The Python spec token is repr(json.loads(text)) (go_like_str).
      // Integers parse to arbitrary-precision int -> str(int) == text
      // (grammar already forbids leading zeros), except "-0" whose spec
      // token is "0". Floats (dot or exponent) are COMPUTED: the exact
      // repr token is reproduced from the parsed double, so ANY legal
      // spelling ("1.50", "1e5", "1.25000000000000001") indexes the spec
      // token natively instead of falling back.
      {
        const uint8_t* s = value_buf;
        int64_t start = (s[0] == '-') ? 1 : 0;
        if (!has_dot && !has_exp) {
          if (n - start == 1 && s[start] == '0' && start == 1) {
            value_buf[0] = '0';  // "-0" -> int 0 -> token "0"
            emit_value(1);
            return;
          }
          emit_value(n);
          return;
        }
        if (n > 64) { fallback = true; return; }
        char txt[72];
        std::memcpy(txt, s, (size_t)n);
        txt[n] = '\0';
        char* endp = nullptr;
        const double d = std::strtod(txt, &endp);
        if (endp != txt + n || !std::isfinite(d)) {
          fallback = true;  // overflow to inf etc.: Python lane decides
          return;
        }
        const int w = bs_float_repr_token(d, (char*)value_buf, (int)buf_cap);
        if (w < 0) { fallback = true; return; }
        emit_value(w);
        return;
      }
    }
  }

  void parse_value() {
    if (error || fallback || done) return;
    if (++depth > kMaxDepth) { fallback = true; return; }
    skip_ws();
    if (at_end()) { error = true; depth--; return; }
    const uint8_t c = *p;
    if (c == '{') {
      p++;
      // Sink-scoped per-object state (verify: duplicate-key level); the
      // destructor restores on EVERY exit path of this branch.
      typename SinkT::ObjectScope obj_scope(*sink);
      skip_ws();
      if (!at_end() && *p == '}') { p++; depth--; return; }
      while (!error && !fallback && !done) {
        skip_ws();
        const int64_t klen = parse_string(key_buf, false);
        if (klen < 0) { depth--; return; }
        sink->on_key(*this, key_buf, klen);
        if (error || fallback) { depth--; return; }
        skip_ws();
        if (at_end() || *p != ':') { error = true; depth--; return; }
        p++;
        // Push path segment. Ingest joins like unique_fields (delimiter
        // only when the prefix STRING is non-empty); verify joins
        // component-wise (delimiter whenever a segment is already pushed,
        // so empty keys keep their component identity — walk_json_for_*
        // split on the delimiter).
        const int64_t saved = path_len;
        if (path_len + 1 + klen > buf_cap) { error = true; depth--; return; }
        const bool join = SinkT::kComponentJoin ? (seg_depth > 0) : (path_len > 0);
        if (join) path[path_len++] = delimiter;
        std::memcpy(path + path_len, key_buf, klen);
        path_len += klen;
        seg_depth++;
        sink->on_push(*this);
        parse_value();
        sink->on_pop(*this);
        seg_depth--;
        path_len = saved;
        if (error || fallback || done) { depth--; return; }
        skip_ws();
        if (!at_end() && *p == ',') { p++; continue; }
        if (!at_end() && *p == '}') { p++; depth--; return; }
        error = true;
        depth--;
        return;
      }
    } else if (c == '[') {
      p++;
      skip_ws();
      if (!at_end() && *p == ']') { p++; depth--; return; }
      while (!error && !fallback && !done) {
        parse_value();  // same path: indices dropped
        if (error || fallback || done) { depth--; return; }
        skip_ws();
        if (!at_end() && *p == ',') { p++; continue; }
        if (!at_end() && *p == ']') { p++; depth--; return; }
        error = true;
        depth--;
        return;
      }
    } else if (c == '"') {
      const int64_t vlen = parse_string(value_buf, true);
      if (vlen < 0) { depth--; return; }
      if (SinkT::kEmitEmptyPath || path_len > 0) emit_value(vlen);
    } else {
      if (SinkT::kEmitEmptyPath || path_len > 0) {
        parse_primitive();
      } else {
        skip_value();
      }
    }
    depth--;
  }
};

// Ingest sink: emits deduplicated murmur3 hash pairs for the three
// keyspaces (field path / token / field::token) per primitive value.
struct IngestSink {
  static const bool kComponentJoin = false;  // match unique_fields joining
  static const bool kEmitEmptyPath = false;  // unique_fields skips prefix ""

  HashSink* fields;
  HashSink* tokens;
  HashSink* fts;

  struct ObjectScope {
    ObjectScope(IngestSink&) {}
  };

  void on_key(Parser<IngestSink>&, const uint8_t*, int64_t) {}
  void on_push(Parser<IngestSink>&) {}
  void on_pop(Parser<IngestSink>&) {}

  void on_value(Parser<IngestSink>& P, int64_t vlen) {
    // Emit field path once per primitive (dedup collapses repeats).
    uint64_t fh[2];
    murmur3_x64_128(P.path, (uint64_t)P.path_len, 0, fh);
    fields->add(fh[0], fh[1]);
    // Tokenize value_buf (already lowered) on whitespace.
    int64_t i = 0;
    while (i < vlen) {
      while (i < vlen && is_ws(P.value_buf[i])) i++;
      const int64_t start = i;
      while (i < vlen && !is_ws(P.value_buf[i])) i++;
      if (i > start) {
        uint64_t th[2];
        murmur3_x64_128(P.value_buf + start, (uint64_t)(i - start), 0, th);
        tokens->add(th[0], th[1]);
        // field::token — build in key_buf: path + "::" + token
        const int64_t tok_len = i - start;
        if (P.path_len + 2 + tok_len <= P.buf_cap) {
          std::memcpy(P.key_buf, P.path, P.path_len);
          P.key_buf[P.path_len] = ':';
          P.key_buf[P.path_len + 1] = ':';
          std::memcpy(P.key_buf + P.path_len + 2, P.value_buf + start, tok_len);
          uint64_t fth[2];
          murmur3_x64_128(P.key_buf, (uint64_t)(P.path_len + 2 + tok_len), 0, fth);
          fts->add(fth[0], fth[1]);
        } else {
          P.error = true;
          return;
        }
      }
    }
  }
};

// Verify sink: exact row verification of the bloom-query leaf conditions
// against one row (the native counterpart of tokenizer.py row walks —
// walk_json_for_field / walk_json_for_value / walk_json_for_field_value).
// Kind 0=FIELD, 1=TOKEN, 2=FIELD_TOKEN.
struct VCond {
  uint8_t kind;
  const uint8_t* field;
  int64_t flen;
  const uint8_t* tok;
  int64_t tlen;
};

struct VerifySink {
  static const bool kComponentJoin = true;   // component-wise path matching
  static const bool kEmitEmptyPath = true;   // walk_json_for_value ignores paths

  const VCond* conds;
  int64_t n_conds;
  uint8_t* out;       // [n_conds] this row's per-condition matches
  int32_t* active;    // [n_conds] FIELD_TOKEN subtree activation depth or -1
  bool field_conds;   // any FIELD / FIELD_TOKEN condition present

  // Duplicate-key detection: json.loads keeps the LAST duplicate, the
  // native walk sees every one — defer such rows to Python. Keys of the
  // current object nesting stored len-prefixed on a stack; each object
  // level scans only its own slice.
  uint8_t* keystack;
  int64_t keystack_len;
  int64_t keystack_cap;
  int64_t level_start;  // current object's first key offset

  struct ObjectScope {
    VerifySink& s;
    int64_t saved_start;
    int64_t saved_len;
    explicit ObjectScope(VerifySink& sink)
        : s(sink), saved_start(sink.level_start), saved_len(sink.keystack_len) {
      s.level_start = s.keystack_len;
    }
    ~ObjectScope() {
      s.level_start = saved_start;
      s.keystack_len = saved_len;
    }
  };

  void on_key(Parser<VerifySink>& P, const uint8_t* key, int64_t klen) {
    if (field_conds && std::memchr(key, P.delimiter, (size_t)klen) != nullptr) {
      // A key containing the delimiter breaks joined-path == component
      // equivalence ({"a.b":1} must NOT match field "a.b").
      P.fallback = true;
      return;
    }
    // Scan this object level for a duplicate.
    int64_t off = level_start;
    while (off < keystack_len) {
      int64_t len;
      std::memcpy(&len, keystack + off, 8);
      if (len == klen && std::memcmp(keystack + off + 8, key, (size_t)klen) == 0) {
        P.fallback = true;  // duplicate key: last-wins semantics need Python
        return;
      }
      off += 8 + len;
    }
    if (keystack_len + 8 + klen > keystack_cap) { P.fallback = true; return; }
    std::memcpy(keystack + keystack_len, &klen, 8);
    std::memcpy(keystack + keystack_len + 8, key, (size_t)klen);
    keystack_len += 8 + klen;
  }

  void on_push(Parser<VerifySink>& P) {
    for (int64_t c = 0; c < n_conds; c++) {
      const VCond& cd = conds[c];
      if (cd.kind == 0) {
        // FIELD: the full component chain exists (value may be anything,
        // including null — walk_json_for_field returns true at depth ==
        // len(components) regardless of the value).
        // NOTE: no early exit on all-matched — the rest of the row must
        // still be walked for duplicate keys (the one case where MORE
        // content can UNMATCH: json.loads keeps the last duplicate, so a
        // later dup can remove the subtree a condition matched in).
        if (!out[c] && cd.flen == P.path_len &&
            std::memcmp(cd.field, P.path, (size_t)P.path_len) == 0) {
          out[c] = 1;
        }
      } else if (cd.kind == 2) {
        if (active[c] < 0 && cd.flen == P.path_len &&
            std::memcmp(cd.field, P.path, (size_t)P.path_len) == 0) {
          active[c] = P.seg_depth;  // token search scoped to this subtree
        }
      }
    }
  }

  void on_pop(Parser<VerifySink>& P) {
    for (int64_t c = 0; c < n_conds; c++) {
      if (active[c] == P.seg_depth) active[c] = -1;
    }
  }

  void on_value(Parser<VerifySink>& P, int64_t vlen) {
    // Tokenize the (lowered) value text; every token tests TOKEN
    // conditions and the FIELD_TOKEN conditions whose subtree is active.
    int64_t i = 0;
    while (i < vlen) {
      while (i < vlen && is_ws(P.value_buf[i])) i++;
      const int64_t start = i;
      while (i < vlen && !is_ws(P.value_buf[i])) i++;
      const int64_t tok_len = i - start;
      if (tok_len == 0) continue;
      for (int64_t c = 0; c < n_conds; c++) {
        const VCond& cd = conds[c];
        if (out[c]) continue;
        if (cd.kind == 1 || (cd.kind == 2 && active[c] >= 0)) {
          if (cd.tlen == tok_len &&
              std::memcmp(cd.tok, P.value_buf + start, (size_t)tok_len) == 0) {
            out[c] = 1;  // no early exit: see on_push NOTE (duplicate keys)
          }
        }
      }
    }
  }
};

}  // namespace ingest

// Tokenize + hash a batch of serialized rows. Returns 0 on success, -1 if an
// output capacity was exceeded (caller doubles and retries). Rows that need
// Python handling (unicode content or parse trouble) get row_fallback[i]=1
// and contribute no hashes.
BS_EXPORT int64_t bs_ingest_tokenize(
    const uint8_t* data, const int64_t* row_offsets, const int64_t* row_lengths,
    int64_t n_rows, uint8_t delimiter,
    uint64_t* field_out, int64_t field_cap, int64_t* n_field,
    uint64_t* token_out, int64_t token_cap, int64_t* n_token,
    uint64_t* ft_out, int64_t ft_cap, int64_t* n_ft,
    uint8_t* row_fallback) {
  // Dedup sets start small and grow by rehash with the batch's actual
  // distinct-key count; only the out arrays are caps-sized (caller memory).
  const int64_t kInitSet = 1 << 13;
  const int64_t kBuf = 1 << 20;
  uint8_t* scratch = (uint8_t*)std::malloc(3 * kBuf);
  uint64_t* fset = (uint64_t*)std::calloc((size_t)(2 * kInitSet), 8);
  uint64_t* tset = (uint64_t*)std::calloc((size_t)(2 * kInitSet), 8);
  uint64_t* ftset = (uint64_t*)std::calloc((size_t)(2 * kInitSet), 8);
  if (!scratch || !fset || !tset || !ftset) {
    std::free(scratch);
    std::free(fset);
    std::free(tset);
    std::free(ftset);
    return -2;
  }

  ingest::HashSink fields{field_out, field_cap, 0, fset, kInitSet, false, false};
  ingest::HashSink tokens{token_out, token_cap, 0, tset, kInitSet, false, false};
  ingest::HashSink fts{ft_out, ft_cap, 0, ftset, kInitSet, false, false};

  ingest::IngestSink sink{&fields, &tokens, &fts};

  int64_t rc = 0;
  for (int64_t r = 0; r < n_rows; r++) {
    ingest::Parser<ingest::IngestSink> parser;
    parser.p = data + row_offsets[r];
    parser.end = parser.p + row_lengths[r];
    parser.fallback = false;
    parser.error = false;
    parser.done = false;
    parser.path = scratch;
    parser.path_len = 0;
    parser.value_buf = scratch + kBuf;
    parser.key_buf = scratch + 2 * kBuf;
    parser.buf_cap = kBuf - 8;
    parser.seg_depth = 0;
    parser.depth = 0;
    parser.sink = &sink;
    parser.delimiter = delimiter;
    parser.parse_value();
    if (fields.oom || tokens.oom || fts.oom) {
      rc = -2;
      break;
    }
    if (fields.overflow || tokens.overflow || fts.overflow) {
      rc = -1;
      break;
    }
    // Full consumption: json.loads (the spec) rejects trailing bytes
    // ('Extra data'), so '{"a":1}{"b":2}' must route to the Python path
    // (which raises) instead of silently indexing the first object only.
    if (!parser.error && !parser.fallback) {
      const uint8_t* q = parser.p;
      while (q < parser.end &&
             (*q == ' ' || *q == '\t' || *q == '\n' || *q == '\r')) q++;
      if (q != parser.end) parser.fallback = true;
    }
    row_fallback[r] = (parser.error || parser.fallback) ? 1 : 0;
  }
  *n_field = fields.count;
  *n_token = tokens.count;
  *n_ft = fts.count;
  std::free(fields.set_keys);
  std::free(tokens.set_keys);
  std::free(fts.set_keys);
  std::free(scratch);
  return rc;
}

// Exact row verification of bloom-query leaf conditions over a batch of
// serialized rows (the native counterpart of tokenizer.py::row_matches_*
// walks over json.loads output — cited spec: reference tokenizer.go:107-456).
// Kinds: 0=FIELD, 1=TOKEN, 2=FIELD_TOKEN. field/token operands are
// concatenated with offsets[n_conds+1] fencing. out is uint8[n_conds *
// n_rows] (condition-major). Rows the native walk can't verify bit-exactly
// (non-ASCII, \uXXXX escapes, non-canonical numbers, duplicate keys, keys
// containing the delimiter, depth > kMaxDepth, non-object top level, parse
// trouble) get row_fallback[r]=1 and out undefined for that row — the
// caller re-verifies them in Python. Returns 0, or -2 on allocation failure.
BS_EXPORT int64_t bs_verify_rows(
    const uint8_t* data, const int64_t* row_offsets, const int64_t* row_lengths,
    int64_t n_rows, uint8_t delimiter,
    const uint8_t* kinds,
    const uint8_t* field_bytes, const int64_t* field_offsets,
    const uint8_t* token_bytes, const int64_t* token_offsets,
    int64_t n_conds,
    uint8_t* out, uint8_t* row_fallback) {
  const int64_t kBuf = 1 << 20;
  uint8_t* scratch = (uint8_t*)std::malloc(4 * kBuf);
  ingest::VCond* conds =
      (ingest::VCond*)std::malloc(sizeof(ingest::VCond) * (size_t)n_conds);
  int32_t* active = (int32_t*)std::malloc(4 * (size_t)n_conds);
  uint8_t* row_out = (uint8_t*)std::malloc((size_t)n_conds);
  if (!scratch || !conds || !active || !row_out) {
    std::free(scratch);
    std::free(conds);
    std::free(active);
    std::free(row_out);
    return -2;
  }
  bool field_conds = false;
  for (int64_t c = 0; c < n_conds; c++) {
    conds[c] = ingest::VCond{
        kinds[c],
        field_bytes + field_offsets[c], field_offsets[c + 1] - field_offsets[c],
        token_bytes + token_offsets[c], token_offsets[c + 1] - token_offsets[c],
    };
    if (kinds[c] != 1) field_conds = true;
  }

  for (int64_t r = 0; r < n_rows; r++) {
    std::memset(row_out, 0, (size_t)n_conds);
    for (int64_t c = 0; c < n_conds; c++) active[c] = -1;

    ingest::VerifySink sink;
    sink.conds = conds;
    sink.n_conds = n_conds;
    sink.out = row_out;
    sink.active = active;
    sink.field_conds = field_conds;
    sink.keystack = scratch + 3 * kBuf;
    sink.keystack_len = 0;
    sink.keystack_cap = kBuf;
    sink.level_start = 0;

    ingest::Parser<ingest::VerifySink> parser;
    parser.p = data + row_offsets[r];
    parser.end = parser.p + row_lengths[r];
    parser.fallback = false;
    parser.error = false;
    parser.done = false;
    parser.path = scratch;
    parser.path_len = 0;
    parser.value_buf = scratch + kBuf;
    parser.key_buf = scratch + 2 * kBuf;
    parser.buf_cap = kBuf - 8;
    parser.seg_depth = 0;
    parser.depth = 0;
    parser.sink = &sink;
    parser.delimiter = delimiter;

    // Rows must be JSON objects: bare top-level primitives/arrays keep the
    // Python walk semantics and are rare — defer them.
    parser.skip_ws();
    if (parser.at_end() || *parser.p != '{') {
      row_fallback[r] = 1;
      continue;
    }
    parser.parse_value();
    // Full consumption: trailing bytes mean json.loads — the semantic
    // spec — would raise, so the Python path must decide, not a silent
    // first-object verification. Runs UNCONDITIONALLY: sinks never stop
    // the parse early (VerifySink must see every duplicate key), so there
    // is no legitimate partially-consumed success.
    if (!parser.error && !parser.fallback) {
      const uint8_t* q = parser.p;
      while (q < parser.end &&
             (*q == ' ' || *q == '\t' || *q == '\n' || *q == '\r')) q++;
      if (q != parser.end) parser.fallback = true;
    }
    const bool fb = parser.error || parser.fallback;
    row_fallback[r] = fb ? 1 : 0;
    if (!fb) {
      for (int64_t c = 0; c < n_conds; c++) out[c * n_rows + r] = row_out[c];
    }
  }
  std::free(scratch);
  std::free(conds);
  std::free(active);
  std::free(row_out);
  return 0;
}

// ---------------------------------------------------------------------------
// One-call block pipeline: CRC verify -> decompress -> row split -> needle
// scan, entirely native (the ctypes call releases the GIL, so the query
// worker pool scales on multicore hosts). The bloom AST still evaluates in
// Python over the returned per-needle bitmasks.
// ---------------------------------------------------------------------------

// Hosts without zstd's headers build without BS_HAVE_ZSTD: zstd blocks
// then report "unsupported codec" (-5) and decode in Python instead.
#if defined(BS_HAVE_ZSTD)
#include <zstd.h>

static int64_t decompress_zstd_stream(const uint8_t* comp, int64_t comp_len,
                                      uint8_t* out, int64_t out_cap) {
  ZSTD_DCtx* dctx = ZSTD_createDCtx();
  if (!dctx) return -2;
  ZSTD_inBuffer in{comp, (size_t)comp_len, 0};
  ZSTD_outBuffer ob{out, (size_t)out_cap, 0};
  size_t last_rc = 0;
  while (in.pos < in.size) {
    const size_t rc = ZSTD_decompressStream(dctx, &ob, &in);
    if (ZSTD_isError(rc)) {
      ZSTD_freeDCtx(dctx);
      return -2;
    }
    last_rc = rc;
    if (ob.pos == ob.size && in.pos < in.size) {
      ZSTD_freeDCtx(dctx);
      return -4;  // output capacity too small
    }
  }
  ZSTD_freeDCtx(dctx);
  // rc == 0 means the frame completed; nonzero after input exhausted means
  // a TRUNCATED stream — returning the partial bytes as success would
  // silently drop rows past the truncation point (false negatives) for
  // verify_crc=0 callers.
  if (last_rc != 0) return -2;
  return (int64_t)ob.pos;
}
#endif  // BS_HAVE_ZSTD

static int64_t decompress_snappy_stream(const uint8_t* comp, int64_t comp_len,
                                        uint8_t* out, int64_t out_cap) {
  int64_t ipos = 0;
  int64_t opos = 0;
  while (ipos < comp_len) {
    if (ipos + 4 > comp_len) return -2;
    uint32_t clen;
    std::memcpy(&clen, comp + ipos, 4);
    ipos += 4;
    if (ipos + (int64_t)clen > comp_len) return -2;
    const int64_t expected =
        bs_snappy_uncompressed_length(comp + ipos, (int64_t)clen);
    if (expected < 0 || opos + expected > out_cap) return -4;
    const int64_t written = bs_snappy_decompress_block(comp + ipos, (int64_t)clen,
                                                       out + opos, out_cap - opos);
    if (written != expected) return -2;
    opos += written;
    ipos += (int64_t)clen;
  }
  return opos;
}

// Returns decompressed length >= 0, or: -1 CRC mismatch, -2 malformed
// compressed data, -3 malformed row stream, -4 capacity exceeded,
// -5 unsupported codec, -6 scan resource failure (intact block — caller
// falls back to the Python pipeline). codec: 0 none, 1 snappy (chunked
// framing), 2 zstd.
BS_EXPORT int64_t bs_process_block(
    const uint8_t* comp, int64_t comp_len, int32_t codec,
    uint32_t expected_crc, int32_t verify_crc,
    uint8_t* out, int64_t out_cap,
    int64_t* row_offsets, int64_t* row_lengths, int64_t max_rows,
    int64_t* n_rows,
    const uint8_t* needles, const int64_t* needle_offsets, int64_t n_needles,
    uint8_t* scan_out) {
  if (verify_crc && bs_crc32c(comp, comp_len, 0) != expected_crc) return -1;

  int64_t dlen;
  if (codec == 0) {
    if (comp_len > out_cap) return -4;
    std::memcpy(out, comp, (size_t)comp_len);
    dlen = comp_len;
  } else if (codec == 1) {
    dlen = decompress_snappy_stream(comp, comp_len, out, out_cap);
  } else if (codec == 2) {
#if defined(BS_HAVE_ZSTD)
    dlen = decompress_zstd_stream(comp, comp_len, out, out_cap);
#else
    return -5;
#endif
  } else {
    return -5;
  }
  if (dlen < 0) return dlen;

  const int64_t count = bs_split_rows(out, dlen, max_rows, row_offsets, row_lengths);
  if (count < 0) return -3;
  *n_rows = count;

  if (n_needles > 0 && count > 0) {
    const int64_t rc = bs_scan_candidates(out, dlen, needles, needle_offsets,
                                          n_needles, row_offsets, row_lengths,
                                          count, scan_out);
    // Scan failure here is a RESOURCE problem (its only error is a malloc
    // of the lowercase buffer), not corruption: -6 so the caller degrades
    // to the Python pipeline instead of raising 'malformed block data'
    // against an intact block.
    if (rc != 0) return -6;
  }
  return dlen;
}

// ---------------------------------------------------------------------------
// Serving-mode stream packing (rowcache.py pin): chunk a block's raw row
// buffer into fixed chunk_bytes device rows with (chunk_bytes - stride)
// bytes of overlap, ASCII-lowercasing in the same pass, so every <=overlap+1
// byte window starting in a chunk's first `stride` bytes is fully contained
// in that chunk. Rows whose bytes cannot PROVE a needle's absence (non-ASCII
// bytes; "\u" / "\/" pairs checked with the next byte lowered so "\U" flags
// like "\u") are flagged always-candidate — the same conservative rule as
// the host scanner (bs_scan_candidates above) and the numpy spec path in
// rowcache.py. Unlike the fixed-width row matrix this replaces, rows are
// NOT padded to a width bucket: the stream carries ~1.07x the raw bytes
// instead of ~3.6x, which is the difference in HBM footprint, upload time,
// and scan traffic.
// ---------------------------------------------------------------------------
BS_EXPORT void bs_pack_stream(
    const uint8_t* data, int64_t data_len,
    const int64_t* row_offsets, const int64_t* row_lengths, int64_t n_rows,
    int64_t stride, int64_t chunk_bytes,
    uint8_t* chunks,            // [ceil(data_len/stride), chunk_bytes], pre-zeroed
    uint8_t* always_candidate)  // [n_rows], pre-zeroed
{
  const uint64_t HI = 0x8080808080808080ULL;
  const uint64_t L7 = 0x7F7F7F7F7F7F7F7FULL;
  // Lowercase the whole buffer once into the chunk rows (the overlap tail
  // of each chunk is re-copied from the already-lowered previous chunk).
  const int64_t n_chunks = data_len > 0 ? (data_len + stride - 1) / stride : 0;
  const int64_t overlap = chunk_bytes - stride;
  for (int64_t c = 0; c < n_chunks; c++) {
    const int64_t src_off = c * stride;
    const int64_t len = std::min<int64_t>(stride, data_len - src_off);
    const uint8_t* src = data + src_off;
    uint8_t* dst = chunks + c * chunk_bytes;
    int64_t i = 0;
    for (; i + 8 <= len; i += 8) {
      uint64_t w;
      std::memcpy(&w, src + i, 8);
      const uint64_t x7 = w & L7;
      const uint64_t ge_A = (x7 + 0x3F3F3F3F3F3F3F3FULL) & HI;
      const uint64_t gt_Z = (x7 + 0x2525252525252525ULL) & HI;
      const uint64_t up = ge_A & ~gt_Z & ~(w & HI);
      w += (up >> 2);
      std::memcpy(dst + i, &w, 8);
    }
    for (; i < len; i++) dst[i] = scan_simd::lower1(src[i]);
    if (c > 0) {
      // Previous chunk's overlap tail = this chunk's first bytes, already
      // lowered (zero-filled past end of data by the caller's pre-zeroing).
      std::memcpy(chunks + (c - 1) * chunk_bytes + stride, dst,
                  (size_t)std::min<int64_t>(overlap, len));
    }
  }
  // Conservative per-row flags (independent of the chunk layout).
  const uint64_t BS = 0x5C5C5C5C5C5C5C5CULL;
  for (int64_t r = 0; r < n_rows; r++) {
    const int64_t len = row_lengths[r];
    const int64_t off = row_offsets[r];
    if (off < 0 || len < 0 || off + len > data_len) {  // defensive: include
      always_candidate[r] = 1;
      continue;
    }
    const uint8_t* src = data + off;
    uint64_t non_ascii = 0;
    bool has_backslash = false;
    int64_t i = 0;
    for (; i + 8 <= len; i += 8) {
      uint64_t w;
      std::memcpy(&w, src + i, 8);
      non_ascii |= (w & HI);
      const uint64_t d = w ^ BS;
      if ((((d - 0x0101010101010101ULL) & ~d) & HI) != 0) has_backslash = true;
    }
    for (; i < len; i++) {
      const uint8_t c = src[i];
      if (c & 0x80) non_ascii = 1;
      if (c == '\\') has_backslash = true;
    }
    if (non_ascii) {
      always_candidate[r] = 1;
    } else if (has_backslash) {
      for (int64_t j = 0; j + 1 < len; j++) {
        const uint8_t nxt = scan_simd::lower1(src[j + 1]);
        if (src[j] == '\\' && (nxt == 'u' || nxt == '/')) {
          always_candidate[r] = 1;
          break;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Byte-level top-level numeric field extraction for the serialized ingest
// fast lane's minmax indexes (engine.py _ingest_serialized_rows). The Python
// spec is: v = json.loads(row)[field]; convert_to_min_max_int64(v)
// (minmax.py:32-46 — int -> (v,v) clamped; finite float -> (floor,ceil)
// clamped; bool/str/other -> no value). json.loads keeps the LAST duplicate
// key, so the walker does too. Any construct the walker cannot reproduce
// bit-exactly flags the row for the Python fallback — minmax bounds MUST
// cover actual values (a missed value would let prefiltering exclude a block
// containing a match: a false negative), so under-approximation is not an
// option here the way it is for filters.

namespace {

// Skip one JSON value (string/number/keyword/object/array). Returns false on
// malformed input.
inline bool mm_skip_value(const uint8_t*& p, const uint8_t* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  if (p >= end) return false;
  const uint8_t c = *p;
  if (c == '"') {
    p++;
    while (p < end) {
      if (*p == '\\') {
        p += 2;
        continue;
      }
      if (*p == '"') {
        p++;
        return true;
      }
      p++;
    }
    return false;
  }
  if (c == '{' || c == '[') {
    int depth = 0;
    while (p < end) {
      const uint8_t d = *p;
      if (d == '"') {
        if (!mm_skip_value(p, end)) return false;
        continue;
      }
      if (d == '{' || d == '[') depth++;
      if (d == '}' || d == ']') {
        depth--;
        if (depth == 0) {
          p++;
          return true;
        }
      }
      p++;
    }
    return false;
  }
  // primitive: run to a structural boundary, then VALIDATE it — accepting
  // arbitrary garbage here let bs_extract_minmax return trusted status for
  // rows whose non-target values make json.loads raise (the fast lane then
  // indexed rows the dict lane rejects). false routes the row to the
  // Python path, which raises identically to the spec.
  const uint8_t* s0 = p;
  while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != ' ' &&
         *p != '\t' && *p != '\n' && *p != '\r')
    p++;
  const int64_t len = p - s0;
  if (len <= 0) return false;
  auto is_kw = [&](const char* kw, int64_t kl) {
    return len == kl && std::memcmp(s0, kw, (size_t)kl) == 0;
  };
  if (is_kw("true", 4) || is_kw("false", 5) || is_kw("null", 4) ||
      is_kw("NaN", 3) || is_kw("Infinity", 8) || is_kw("-Infinity", 9))
    return true;
  // Strict JSON number grammar.
  int64_t i = 0;
  if (s0[i] == '-') i++;
  if (i >= len) return false;
  if (s0[i] == '0') i++;
  else if (s0[i] >= '1' && s0[i] <= '9') { while (i < len && s0[i] >= '0' && s0[i] <= '9') i++; }
  else return false;
  if (i < len && s0[i] == '.') {
    i++;
    if (i >= len || s0[i] < '0' || s0[i] > '9') return false;
    while (i < len && s0[i] >= '0' && s0[i] <= '9') i++;
  }
  if (i < len && (s0[i] == 'e' || s0[i] == 'E')) {
    i++;
    if (i < len && (s0[i] == '+' || s0[i] == '-')) i++;
    if (i >= len || s0[i] < '0' || s0[i] > '9') return false;
    while (i < len && s0[i] >= '0' && s0[i] <= '9') i++;
  }
  return i == len;
}

// Decode a JSON key into dst (cap bytes). Returns decoded length, -1 on
// malformed input, -2 when the key cannot be represented in ASCII (it then
// cannot equal an ASCII field name; the caller skips it).
inline int64_t mm_parse_key(const uint8_t*& p, const uint8_t* end, uint8_t* dst,
                            int64_t cap) {
  if (p >= end || *p != '"') return -1;
  p++;
  int64_t n = 0;
  bool non_ascii = false;
  while (p < end && *p != '"') {
    uint8_t c = *p++;
    if (c == '\\') {
      if (p >= end) return -1;
      const uint8_t e = *p++;
      switch (e) {
        case '"': c = '"'; break;
        case '\\': c = '\\'; break;
        case '/': c = '/'; break;
        case 'b': c = 0x08; break;
        case 'f': c = 0x0c; break;
        case 'n': c = 0x0a; break;
        case 'r': c = 0x0d; break;
        case 't': c = 0x09; break;
        case 'u': {
          if (end - p < 4) return -1;
          uint32_t cp = 0;
          for (int i = 0; i < 4; i++) {
            const uint8_t h = *p++;
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= h - '0';
            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
            else return -1;
          }
          if (cp >= 0x80) { non_ascii = true; c = '?'; break; }
          c = (uint8_t)cp;
          break;
        }
        default: return -1;
      }
    } else if (c >= 0x80) {
      non_ascii = true;
    }
    if (n >= cap) return -1;
    dst[n++] = c;
  }
  if (p >= end) return -1;
  p++;  // closing quote
  return non_ascii ? -2 : n;
}

constexpr int64_t kInt64Max = INT64_MAX;
constexpr int64_t kInt64Min = INT64_MIN;

// Parse a JSON number matching Python semantics. Returns:
//   1 with (lo,hi) bounds, 0 if the value is non-numeric (bool/str/null/...),
//  -1 if the row needs the Python fallback.
inline int mm_parse_number(const uint8_t*& p, const uint8_t* end, int64_t* lo,
                           int64_t* hi) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  if (p >= end) return -1;
  const uint8_t c = *p;
  if (c == '"' || c == '{' || c == '[' || c == 't' || c == 'f' || c == 'n') {
    return mm_skip_value(p, end) ? 0 : -1;
  }
  // NaN / Infinity / -Infinity (json.loads non-strict): non-finite -> None.
  if (c == 'N' || c == 'I' || (c == '-' && end - p >= 2 && p[1] == 'I')) {
    return mm_skip_value(p, end) ? 0 : -1;
  }
  char buf[384];
  int64_t n = 0;
  bool has_dot = false, has_exp = false;
  while (p < end && ((*p >= '0' && *p <= '9') || *p == '-' || *p == '+' ||
                     *p == '.' || *p == 'e' || *p == 'E')) {
    if (*p == '.') has_dot = true;
    if (*p == 'e' || *p == 'E') has_exp = true;
    if (n >= (int64_t)sizeof(buf) - 1) return -1;  // absurd length: fallback
    buf[n++] = (char)*p++;
  }
  if (n == 0) return -1;
  buf[n] = '\0';
  // Strict JSON number grammar: '-'? (0|[1-9][0-9]*) ('.'[0-9]+)?
  // ([eE][+-]?[0-9]+)?. strtod is laxer than json.loads ("+5", "5.", ".5",
  // "007"); anything non-conforming falls back so Python raises/handles
  // identically to the dict lane.
  {
    int64_t i = (buf[0] == '-') ? 1 : 0;
    if (i >= n || buf[i] < '0' || buf[i] > '9') return -1;
    if (buf[i] == '0' && i + 1 < n && buf[i + 1] >= '0' && buf[i + 1] <= '9')
      return -1;
    while (i < n && buf[i] >= '0' && buf[i] <= '9') i++;
    if (i < n && buf[i] == '.') {
      i++;
      if (i >= n || buf[i] < '0' || buf[i] > '9') return -1;
      while (i < n && buf[i] >= '0' && buf[i] <= '9') i++;
    }
    if (i < n && (buf[i] == 'e' || buf[i] == 'E')) {
      i++;
      if (i < n && (buf[i] == '+' || buf[i] == '-')) i++;
      if (i >= n || buf[i] < '0' || buf[i] > '9') return -1;
      while (i < n && buf[i] >= '0' && buf[i] <= '9') i++;
    }
    if (i != n) return -1;
  }
  if (!has_dot && !has_exp) {
    // Integer: arbitrary precision in Python, clamped to int64. Saturate.
    const bool neg = buf[0] == '-';
    int64_t i = neg ? 1 : 0;
    if (i >= n) return -1;
    uint64_t acc = 0;
    bool sat = false;
    for (; i < n; i++) {
      if (buf[i] < '0' || buf[i] > '9') return -1;
      if (acc > (UINT64_MAX - 9) / 10) { sat = true; break; }
      acc = acc * 10 + (uint64_t)(buf[i] - '0');
    }
    int64_t v;
    if (sat) {
      v = neg ? kInt64Min : kInt64Max;
    } else if (neg) {
      v = (acc > (uint64_t)kInt64Max + 1) ? kInt64Min : (int64_t)(0 - acc);
    } else {
      v = (acc > (uint64_t)kInt64Max) ? kInt64Max : (int64_t)acc;
    }
    *lo = *hi = v;
    return 1;
  }
  // Float: correctly-rounded strtod == CPython float(); then floor/ceil
  // clamped to int64 (clamp_int64 semantics).
  char* endp = nullptr;
  const double d = std::strtod(buf, &endp);
  if (endp != buf + n) return -1;
  if (!std::isfinite(d)) return 0;  // convert_to_min_max_int64 -> None
  const double fl = std::floor(d), ce = std::ceil(d);
  *lo = (fl >= 9.223372036854775807e18) ? kInt64Max
        : (fl < -9.223372036854775808e18) ? kInt64Min
                                          : (int64_t)fl;
  *hi = (ce >= 9.223372036854775807e18) ? kInt64Max
        : (ce < -9.223372036854775808e18) ? kInt64Min
                                          : (int64_t)ce;
  return 1;
}

}  // namespace

// status per row: 0 = field absent / non-numeric, 1 = numeric value in
// (lo,hi), 2 = Python fallback required. Returns 0, or -2 on bad args.
BS_EXPORT int64_t bs_extract_minmax(
    const uint8_t* data, const int64_t* row_offsets, const int64_t* row_lengths,
    int64_t n_rows, const uint8_t* field, int64_t field_len, int64_t* lo_out,
    int64_t* hi_out, uint8_t* status_out) {
  if (field_len <= 0 || field_len > 256) return -2;
  for (int64_t i = 0; i < field_len; i++) {
    if (field[i] >= 0x80) return -2;  // ASCII-only fast path
  }
  uint8_t key[257];
  for (int64_t r = 0; r < n_rows; r++) {
    const uint8_t* p = data + row_offsets[r];
    const uint8_t* end = p + row_lengths[r];
    status_out[r] = 0;
    lo_out[r] = 0;
    hi_out[r] = 0;
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
    if (p >= end || *p != '{') {
      status_out[r] = 2;  // non-object row: Python decides
      continue;
    }
    p++;
    bool bad = false;
    while (true) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
      if (p < end && *p == '}') break;
      const int64_t klen = mm_parse_key(p, end, key, 256);
      if (klen == -1) { bad = true; break; }
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
      if (p >= end || *p != ':') { bad = true; break; }
      p++;
      const bool is_target =
          klen == field_len && std::memcmp(key, field, (size_t)field_len) == 0;
      if (is_target) {
        int64_t lo = 0, hi = 0;
        const int rc = mm_parse_number(p, end, &lo, &hi);
        if (rc < 0) { bad = true; break; }
        // Last duplicate key wins, matching json.loads: overwrite.
        status_out[r] = (uint8_t)rc;
        if (rc == 1) { lo_out[r] = lo; hi_out[r] = hi; }
      } else {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
        if (!mm_skip_value(p, end)) { bad = true; break; }
      }
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
      if (p < end && *p == ',') { p++; continue; }
      if (p < end && *p == '}') break;
      bad = true;
      break;
    }
    if (!bad) {
      // Full consumption after the closing brace: json.loads (the spec)
      // rejects trailing bytes, so '{"a":1}{"a":9}' must go to the Python
      // path rather than contribute only the first object's value to the
      // minmax index (an under-wide index can exclude a matching block).
      if (p < end && *p == '}') p++;
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
      if (p != end) bad = true;
    }
    if (bad) status_out[r] = 2;
  }
  return 0;
}

BS_EXPORT int64_t bs_version() { return 1; }
