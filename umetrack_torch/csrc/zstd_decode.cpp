// A zstd frame decoder (RFC 8878) and CRC32C, with a plain C interface.
//
// The port reads the JAX package's orbax checkpoints (OCDBT manifests and
// nodes, zarr chunks), whose bodies are zstd frames, without a compression
// package: this file is built with g++ at first use (ops/_build.py) and
// bound with ctypes (utils/_zstd.py).  It decodes what a conforming encoder
// writes: skippable and concatenated frames, raw / RLE / compressed blocks,
// raw / RLE / Huffman literals (direct or FSE-coded weights, 1 or 4
// streams, the treeless repeat), sequences in predefined / RLE / FSE /
// repeat modes, the three repeat offsets, matches reaching into earlier
// blocks of the frame, and the XXH64 content checksum.  Frames that need a
// dictionary are refused.  Every read is bounds-checked: corrupt or
// truncated input yields an error status and a message, never a crash.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error {
  int code;
  std::string message;
};

enum Status : int {
  kOk = 0,
  kTruncated = 1,
  kCorrupt = 2,
  kChecksum = 3,
  kDictionary = 4,
  kUnsupported = 5,
  kNoMemory = 6,
};

[[noreturn]] void fail(int code, const std::string& message) { throw Error{code, message}; }
[[noreturn]] void corrupt(const char* what) { fail(kCorrupt, std::string("corrupt input: ") + what); }

int highest_bit(uint64_t v) {  // index of the highest set bit; v > 0
  return 63 - __builtin_clzll(v);
}

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t load64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
uint32_t load32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
uint64_t xxh_round(uint64_t acc, uint64_t input) { return rotl(acc + input * P2, 31) * P1; }
uint64_t xxh_merge(uint64_t acc, uint64_t v) { return (acc ^ xxh_round(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xxh_round(0, load64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(load32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- CRC32C

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  static const Crc32cTable table;
  const auto& t = table.t;
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {  // slicing by 8
    uint64_t v = load64(p) ^ crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^ t[2][(v >> 40) & 0xFF] ^
          t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
  }
  for (; n > 0; --n, ++p) crc = (crc >> 8) ^ t[0][(crc ^ *p) & 0xFF];
  return ~crc;
}

// ---------------------------------------------------------------- bit readers

// Reads a span forward, little-endian within bytes (FSE table descriptions).
struct ForwardBits {
  const uint8_t* src;
  size_t size;
  size_t bit = 0;
  uint32_t read(int n) {
    if (bit + n > size * 8) fail(kTruncated, "truncated input: FSE table description");
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++bit) v |= uint32_t((src[bit >> 3] >> (bit & 7)) & 1) << i;
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Reads a span backward from its final marker bit (Huffman and FSE
// streams).  Bits before the start of the span read as 0, which the
// formats use at their ends; callers check how far they went.
struct BackwardBits {
  const uint8_t* src;
  int64_t size;
  int64_t pos;  // bits [0, pos) are unread
  BackwardBits(const uint8_t* s, int64_t n) : src(s), size(n) {
    if (n <= 0) corrupt("empty bitstream");
    uint8_t last = s[n - 1];
    if (last == 0) corrupt("bitstream without an end marker");
    pos = n * 8 - (8 - highest_bit(last));
  }
  uint64_t read(int n) {  // n <= 56
    if (n == 0) return 0;
    pos -= n;
    int64_t start = pos;
    int width = n;
    if (start < 0) {
      width += int(start);
      start = 0;
      if (width <= 0) return 0;
    }
    int64_t byte = start >> 3;
    uint64_t v;
    if (byte + 8 <= size) {
      v = load64(src + byte);
    } else {
      v = 0;
      for (int64_t i = byte; i < size; ++i) v |= uint64_t(src[i]) << (8 * (i - byte));
    }
    v = (v >> (start & 7)) & ((uint64_t(1) << width) - 1);
    return pos < 0 ? v << (-pos) : v;
  }
};

// ---------------------------------------------------------------- FSE

struct FseTable {
  int log = 0;
  std::vector<uint8_t> symbol, bits;
  std::vector<uint16_t> base;
};

constexpr int kMaxFseSymbols = 256;
constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kMaxBlock = 128u << 10;

void build_fse(FseTable& t, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.bits.assign(size, 0);
  t.base.assign(size, 0);
  uint32_t next[kMaxFseSymbols];
  uint32_t high = size;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high == 0) corrupt("FSE table overfull");
      t.symbol[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint32_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos >= high);
    }
  }
  if (pos != 0) corrupt("FSE table spread");
  for (uint32_t i = 0; i < size; ++i) {
    uint32_t n = next[t.symbol[i]]++;
    int nb = log - highest_bit(n);
    t.bits[i] = uint8_t(nb);
    t.base[i] = uint16_t((n << nb) - size);
  }
}

// Reads an FSE table description; returns the bytes it took.
size_t read_fse_table(FseTable& t, const uint8_t* src, size_t n, int max_log, int max_symbol) {
  ForwardBits in{src, n};
  int log = 5 + int(in.read(4));
  if (log > max_log) corrupt("FSE accuracy log too large");
  int32_t remaining = 1 << log;
  int16_t norm[kMaxFseSymbols];
  int nsym = 0;
  while (remaining > 0) {
    if (nsym > max_symbol) corrupt("FSE table has too many symbols");
    int nbits = highest_bit(uint64_t(remaining) + 1) + 1;
    uint32_t v = in.read(nbits);
    const uint32_t lower = (1u << (nbits - 1)) - 1;
    const uint32_t threshold = (1u << nbits) - 1 - uint32_t(remaining + 1);
    if ((v & lower) < threshold) {
      in.bit -= 1;
      v &= lower;
    } else if (v > lower) {
      v -= threshold;
    }
    int prob = int(v) - 1;
    remaining -= prob < 0 ? -prob : prob;
    norm[nsym++] = int16_t(prob);
    if (prob == 0) {
      for (;;) {
        uint32_t repeat = in.read(2);
        for (uint32_t i = 0; i < repeat; ++i) {
          if (nsym > max_symbol) corrupt("FSE table has too many symbols");
          norm[nsym++] = 0;
        }
        if (repeat != 3) break;
      }
    }
  }
  if (remaining != 0 || nsym > max_symbol + 1) corrupt("FSE probabilities do not sum to the table size");
  build_fse(t, norm, nsym, log);
  return in.bytes_used();
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.symbol.assign(1, symbol);
  t.bits.assign(1, 0);
  t.base.assign(1, 0);
}

// ---------------------------------------------------------------- Huffman

constexpr int kMaxHufBits = 11;

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;
  bool valid() const { return max_bits > 0; }
};

void build_huffman(HufTable& t, const uint8_t* weights, int nweights) {
  uint32_t total = 0;
  for (int i = 0; i < nweights; ++i) {
    if (weights[i] > kMaxHufBits) corrupt("Huffman weight too large");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) corrupt("Huffman weights are all zero");
  const int max_bits = highest_bit(total) + 1;
  if (max_bits > kMaxHufBits) corrupt("Huffman table too deep");
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) corrupt("Huffman weights do not complete a tree");
  uint8_t nbits[256];
  const int nsym = nweights + 1;
  if (nsym > 256) corrupt("too many Huffman symbols");
  for (int i = 0; i < nweights; ++i) nbits[i] = weights[i] ? uint8_t(max_bits + 1 - weights[i]) : 0;
  nbits[nweights] = uint8_t(max_bits + 1 - (highest_bit(left) + 1));
  uint32_t count[kMaxHufBits + 2] = {0};
  for (int i = 0; i < nsym; ++i) count[nbits[i]]++;
  const uint32_t size = 1u << max_bits;
  t.max_bits = max_bits;
  t.symbol.assign(size, 0);
  t.bits.assign(size, 0);
  uint32_t start[kMaxHufBits + 2];
  start[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    start[b - 1] = start[b] + count[b] * (1u << (max_bits - b));
    if (start[b - 1] > size) corrupt("Huffman code space overflow");
    std::memset(&t.bits[start[b]], b, start[b - 1] - start[b]);
  }
  if (start[0] != size) corrupt("Huffman code space not filled");
  for (int i = 0; i < nsym; ++i) {
    if (!nbits[i]) continue;
    uint32_t len = 1u << (max_bits - nbits[i]);
    std::memset(&t.symbol[start[nbits[i]]], i, len);
    start[nbits[i]] += len;
  }
}

// Reads a Huffman tree description; returns the bytes it took.
size_t read_huffman_table(HufTable& t, const uint8_t* src, size_t n) {
  if (n < 1) fail(kTruncated, "truncated input: Huffman tree description");
  const uint8_t header = src[0];
  uint8_t weights[256];
  int nweights = 0;
  size_t used;
  if (header >= 128) {
    nweights = header - 127;
    used = 1 + size_t(nweights + 1) / 2;
    if (used > n) fail(kTruncated, "truncated input: Huffman weights");
    for (int i = 0; i < nweights; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 0xF);
    }
  } else {
    used = 1 + size_t(header);
    if (used > n) fail(kTruncated, "truncated input: Huffman weights");
    FseTable fse;
    size_t desc = read_fse_table(fse, src + 1, header, 6, 255);
    if (desc >= header) corrupt("Huffman weight stream missing");
    BackwardBits in(src + 1 + desc, int64_t(header - desc));
    uint32_t s1 = uint32_t(in.read(fse.log)), s2 = uint32_t(in.read(fse.log));
    for (;;) {
      if (nweights >= 255) corrupt("too many Huffman weights");
      weights[nweights++] = fse.symbol[s1];
      s1 = fse.base[s1] + uint32_t(in.read(fse.bits[s1]));
      if (in.pos < 0) {
        weights[nweights++] = fse.symbol[s2];
        break;
      }
      if (nweights >= 255) corrupt("too many Huffman weights");
      weights[nweights++] = fse.symbol[s2];
      s2 = fse.base[s2] + uint32_t(in.read(fse.bits[s2]));
      if (in.pos < 0) {
        if (nweights >= 255) corrupt("too many Huffman weights");
        weights[nweights++] = fse.symbol[s1];
        break;
      }
    }
  }
  build_huffman(t, weights, nweights);
  return used;
}

// Decodes one Huffman stream into exactly `count` bytes at `out`.
void huffman_stream(const HufTable& t, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackwardBits in(src, int64_t(n));
  const uint32_t mask = (1u << t.max_bits) - 1;
  uint32_t state = uint32_t(in.read(t.max_bits));
  for (size_t i = 0; i < count; ++i) {
    out[i] = t.symbol[state];
    int nb = t.bits[state];
    state = ((state << nb) | uint32_t(in.read(nb))) & mask;
  }
  if (in.pos != -int64_t(t.max_bits)) corrupt("Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------- sequences

constexpr uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,
                                  12, 13, 14, 15, 16, 18, 20, 22, 24, 28,  32,  40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// What a frame's blocks carry over to the next block.
struct FrameState {
  HufTable huffman;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

// Reads one of the three sequence tables in `mode`; returns the bytes it took.
size_t read_sequence_table(FseTable& t, bool& have, int mode, const uint8_t* src, size_t n,
                           const int16_t* defaults, int ndefaults, int default_log, int max_log,
                           int max_symbol) {
  switch (mode) {
    case 0:
      build_fse(t, defaults, ndefaults, default_log);
      have = true;
      return 0;
    case 1:
      if (n < 1) fail(kTruncated, "truncated input: RLE sequence table");
      if (src[0] > max_symbol) corrupt("RLE sequence symbol out of range");
      rle_fse(t, src[0]);
      have = true;
      return 1;
    case 2: {
      size_t used = read_fse_table(t, src, n, max_log, max_symbol);
      have = true;
      return used;
    }
    default:
      if (!have) corrupt("repeat sequence table without an earlier table");
      return 0;
  }
}

struct Output {
  std::vector<uint8_t> buf;
  size_t size = 0;
  void reserve_more(size_t n) {
    if (size + n > buf.size()) buf.resize(std::max(size + n, buf.size() * 2 + 4096));
  }
};

void decode_compressed_block(const uint8_t* src, size_t n, FrameState& st, Output& out,
                             size_t frame_start, std::vector<uint8_t>& literals) {
  // ---- literals section
  if (n < 1) fail(kTruncated, "truncated input: literals header");
  const uint8_t b0 = src[0];
  const int ltype = b0 & 3, sf = (b0 >> 2) & 3;
  size_t pos, regen;
  if (ltype < 2) {
    size_t header = (sf == 0 || sf == 2) ? 1 : (sf == 1 ? 2 : 3);
    if (n < header) fail(kTruncated, "truncated input: literals header");
    if (header == 1) regen = b0 >> 3;
    else if (header == 2) regen = (b0 >> 4) + (size_t(src[1]) << 4);
    else regen = (b0 >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    pos = header;
    if (regen > kMaxBlock) corrupt("literals larger than a block");
    literals.resize(regen);
    if (ltype == 0) {
      if (pos + regen > n) fail(kTruncated, "truncated input: raw literals");
      std::memcpy(literals.data(), src + pos, regen);
      pos += regen;
    } else {
      if (pos + 1 > n) fail(kTruncated, "truncated input: RLE literals");
      std::memset(literals.data(), src[pos], regen);
      pos += 1;
    }
  } else {
    size_t header = sf < 2 ? 3 : (sf == 2 ? 4 : 5);
    if (n < header) fail(kTruncated, "truncated input: literals header");
    uint64_t h = 0;
    for (size_t i = 0; i < header; ++i) h |= uint64_t(src[i]) << (8 * i);
    size_t csize;
    if (header == 3) { regen = (h >> 4) & 0x3FF; csize = (h >> 14) & 0x3FF; }
    else if (header == 4) { regen = (h >> 4) & 0x3FFF; csize = (h >> 18) & 0x3FFF; }
    else { regen = (h >> 4) & 0x3FFFF; csize = (h >> 22) & 0x3FFFF; }
    const int streams = sf == 0 ? 1 : 4;
    if (regen > kMaxBlock) corrupt("literals larger than a block");
    pos = header;
    if (pos + csize > n) fail(kTruncated, "truncated input: compressed literals");
    const uint8_t* p = src + pos;
    size_t left = csize;
    if (ltype == 2) {
      size_t used = read_huffman_table(st.huffman, p, left);
      p += used;
      left -= used;
    } else if (!st.huffman.valid()) {
      corrupt("treeless literals without an earlier Huffman table");
    }
    literals.resize(regen);
    if (streams == 1) {
      huffman_stream(st.huffman, p, left, literals.data(), regen);
    } else {
      if (left < 6) fail(kTruncated, "truncated input: literal jump table");
      size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
      if (6 + s1 + s2 + s3 > left) corrupt("literal jump table beyond the literals");
      size_t s4 = left - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) corrupt("too few literals for four streams");
      const uint8_t* q = p + 6;
      huffman_stream(st.huffman, q, s1, literals.data(), seg);
      huffman_stream(st.huffman, q + s1, s2, literals.data() + seg, seg);
      huffman_stream(st.huffman, q + s1 + s2, s3, literals.data() + 2 * seg, seg);
      huffman_stream(st.huffman, q + s1 + s2 + s3, s4, literals.data() + 3 * seg, regen - 3 * seg);
    }
    pos += csize;
  }

  // ---- sequences section
  if (pos >= n) fail(kTruncated, "truncated input: sequences header");
  size_t nseq = src[pos++];
  if (nseq >= 128) {
    if (nseq < 255) {
      if (pos >= n) fail(kTruncated, "truncated input: sequences header");
      nseq = ((nseq - 128) << 8) + src[pos++];
    } else {
      if (pos + 2 > n) fail(kTruncated, "truncated input: sequences header");
      nseq = src[pos] + (size_t(src[pos + 1]) << 8) + 0x7F00;
      pos += 2;
    }
  }
  const uint8_t* lit = literals.data();
  size_t lit_left = literals.size();
  if (nseq == 0) {
    if (pos != n) corrupt("bytes after an empty sequences section");
    out.reserve_more(lit_left);
    std::memcpy(out.buf.data() + out.size, lit, lit_left);
    out.size += lit_left;
    return;
  }
  if (pos >= n) fail(kTruncated, "truncated input: sequence modes");
  const uint8_t modes = src[pos++];
  if (modes & 3) corrupt("reserved bits set in the sequence modes");
  pos += read_sequence_table(st.ll, st.have_ll, modes >> 6, src + pos, n - pos, kLLDefault, 36, 6, 9, 35);
  pos += read_sequence_table(st.of, st.have_of, (modes >> 4) & 3, src + pos, n - pos, kOFDefault, 29, 5, 8, 31);
  pos += read_sequence_table(st.ml, st.have_ml, (modes >> 2) & 3, src + pos, n - pos, kMLDefault, 53, 6, 9, 52);
  if (pos >= n) fail(kTruncated, "truncated input: sequence bitstream");
  BackwardBits in(src + pos, int64_t(n - pos));
  uint32_t sll = uint32_t(in.read(st.ll.log));
  uint32_t sof = uint32_t(in.read(st.of.log));
  uint32_t sml = uint32_t(in.read(st.ml.log));
  for (size_t i = 0; i < nseq; ++i) {
    const uint8_t of_code = st.of.symbol[sof], ml_code = st.ml.symbol[sml], ll_code = st.ll.symbol[sll];
    if (of_code > 31) corrupt("offset code out of range");
    if (ll_code > 35 || ml_code > 52) corrupt("length code out of range");
    uint64_t of_value = (uint64_t(1) << of_code) + in.read(of_code);
    size_t ml = kMLBase[ml_code] + size_t(in.read(kMLBits[ml_code]));
    size_t ll = kLLBase[ll_code] + size_t(in.read(kLLBits[ll_code]));
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      st.rep[2] = st.rep[1];
      st.rep[1] = st.rep[0];
      st.rep[0] = offset;
    } else {
      uint32_t idx = uint32_t(of_value - 1) + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = st.rep[0];
      } else {
        offset = idx < 3 ? st.rep[idx] : st.rep[0] - 1;
        if (idx > 1) st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = st.ll.base[sll] + uint32_t(in.read(st.ll.bits[sll]));
      sml = st.ml.base[sml] + uint32_t(in.read(st.ml.bits[sml]));
      sof = st.of.base[sof] + uint32_t(in.read(st.of.bits[sof]));
    }
    if (in.pos < 0) corrupt("sequence bitstream overrun");
    if (ll > lit_left) corrupt("sequence takes more literals than the block has");
    out.reserve_more(ll + ml);
    uint8_t* dst = out.buf.data() + out.size;
    std::memcpy(dst, lit, ll);
    lit += ll;
    lit_left -= ll;
    dst += ll;
    out.size += ll;
    if (offset == 0 || offset > out.size - frame_start) corrupt("match offset before the frame's start");
    const uint8_t* from = dst - offset;
    if (offset >= ml) {
      std::memcpy(dst, from, ml);
    } else {
      for (size_t k = 0; k < ml; ++k) dst[k] = from[k];
    }
    out.size += ml;
  }
  if (in.pos != 0) corrupt("sequence bitstream not consumed exactly");
  out.reserve_more(lit_left);
  std::memcpy(out.buf.data() + out.size, lit, lit_left);
  out.size += lit_left;
}

// Decodes the frame at src[0:n] into `out`; returns the bytes it took.
size_t decode_frame(const uint8_t* src, size_t n, Output& out) {
  if (n < 4) fail(kTruncated, "truncated input: frame magic");
  const uint32_t magic = load32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
    if (n < 8) fail(kTruncated, "truncated input: skippable frame header");
    uint64_t len = load32(src + 4);
    if (8 + len > n) fail(kTruncated, "truncated input: skippable frame");
    return size_t(8 + len);
  }
  if (magic != kMagic) corrupt("not a zstd frame (bad magic number)");
  size_t pos = 4;
  if (pos >= n) fail(kTruncated, "truncated input: frame header");
  const uint8_t fhd = src[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 0x08) corrupt("reserved bit set in the frame header");
  if (!single) {
    if (pos >= n) fail(kTruncated, "truncated input: window descriptor");
    pos++;  // the window only bounds an encoder: matches are checked against the frame's output
  }
  const size_t dict_bytes[4] = {0, 1, 2, 4};
  if (pos + dict_bytes[dict_flag] > n) fail(kTruncated, "truncated input: dictionary id");
  uint32_t dict_id = 0;
  for (size_t i = 0; i < dict_bytes[dict_flag]; ++i) dict_id |= uint32_t(src[pos + i]) << (8 * i);
  pos += dict_bytes[dict_flag];
  if (dict_id != 0)
    fail(kDictionary, "frame needs dictionary " + std::to_string(dict_id) + ": dictionaries are not supported");
  const size_t fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : (size_t(1) << fcs_flag);
  if (pos + fcs_bytes > n) fail(kTruncated, "truncated input: frame content size");
  uint64_t content_size = 0;
  for (size_t i = 0; i < fcs_bytes; ++i) content_size |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_bytes == 2) content_size += 256;
  pos += fcs_bytes;
  const bool known = fcs_bytes > 0;
  const size_t frame_start = out.size;
  if (known) {
    // A block of 3 header bytes yields at most kMaxBlock bytes.
    if (content_size / kMaxBlock > n) corrupt("frame content size larger than its blocks can hold");
    out.reserve_more(size_t(content_size));
  }
  FrameState st;
  std::vector<uint8_t> literals;
  for (;;) {
    if (pos + 3 > n) fail(kTruncated, "truncated input: block header");
    const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
    pos += 3;
    const int last = bh & 1, btype = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (btype == 3) corrupt("reserved block type");
    if (btype == 1) {
      if (bsize > kMaxBlock) corrupt("block larger than 128 KiB");
      if (pos + 1 > n) fail(kTruncated, "truncated input: RLE block");
      out.reserve_more(bsize);
      std::memset(out.buf.data() + out.size, src[pos], bsize);
      out.size += bsize;
      pos += 1;
    } else {
      if (bsize > kMaxBlock) corrupt("block larger than 128 KiB");
      if (pos + bsize > n) fail(kTruncated, "truncated input: block");
      if (btype == 0) {
        out.reserve_more(bsize);
        std::memcpy(out.buf.data() + out.size, src + pos, bsize);
        out.size += bsize;
      } else {
        decode_compressed_block(src + pos, bsize, st, out, frame_start, literals);
      }
      pos += bsize;
    }
    if (known && out.size - frame_start > content_size) corrupt("frame longer than its content size");
    if (last) break;
  }
  if (known && out.size - frame_start != content_size) corrupt("frame shorter than its content size");
  if (checksum) {
    if (pos + 4 > n) fail(kTruncated, "truncated input: content checksum");
    const uint32_t want = load32(src + pos);
    const uint32_t got = uint32_t(xxh64(out.buf.data() + frame_start, out.size - frame_start, 0));
    if (want != got) fail(kChecksum, "content checksum mismatch");
    pos += 4;
  }
  return pos;
}

struct Result {
  Output out;
  int status = kOk;
  std::string message;
};

}  // namespace

extern "C" {

// Decodes every frame of src[0:n]; never returns NULL unless memory runs
// out.  Read the outcome with zd_status / zd_message, the bytes with
// zd_data / zd_size, and release the result with zd_free.
void* zd_decompress(const uint8_t* src, int64_t n) {
  Result* r = new (std::nothrow) Result;
  if (!r) return nullptr;
  try {
    size_t pos = 0;
    if (n < 0) corrupt("negative input size");
    if (n == 0) fail(kTruncated, "truncated input: no frame");
    while (pos < size_t(n)) pos += decode_frame(src + pos, size_t(n) - pos, r->out);
  } catch (const Error& e) {
    r->status = e.code;
    r->message = e.message;
  } catch (const std::bad_alloc&) {
    r->status = kNoMemory;
    r->message = "out of memory";
  } catch (const std::length_error&) {
    r->status = kNoMemory;
    r->message = "output too large";
  }
  return r;
}

int zd_status(void* h) { return static_cast<Result*>(h)->status; }
const char* zd_message(void* h) { return static_cast<Result*>(h)->message.c_str(); }
int64_t zd_size(void* h) { return int64_t(static_cast<Result*>(h)->out.size); }
const uint8_t* zd_data(void* h) { return static_cast<Result*>(h)->out.buf.data(); }
void zd_free(void* h) { delete static_cast<Result*>(h); }

uint32_t zd_crc32c(const uint8_t* src, int64_t n, uint32_t crc) { return crc32c(src, size_t(n), crc); }
uint64_t zd_xxh64(const uint8_t* src, int64_t n, uint64_t seed) { return xxh64(src, size_t(n), seed); }

}  // extern "C"
