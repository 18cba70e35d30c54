// A Zstandard decoder written from RFC 8878, for the orbax checkpoints of
// the JAX package: their OCDBT manifests and b-tree nodes and their zarr
// chunks are zstd frames.  It depends on nothing but the C++ standard
// library, so a machine without libzstd or the zstandard package reads them.
//
// It decodes:
//   - frame headers: window descriptor, content size, single-segment flag;
//   - raw, RLE and compressed blocks;
//   - literals that are raw, RLE, or Huffman-coded with 1 or 4 streams,
//     treeless literals (the previous table) included;
//   - sequences whose FSE tables are predefined, RLE, compressed or
//     repeated, with the three repeat offsets;
//   - concatenated frames and skippable frames;
//   - the XXH64 content checksum, verified when its flag is set.
// It refuses a frame that names a dictionary and any malformed input.
//
// Python binds it with ctypes (utils/zstd.py); ops/_build.py::build_host
// compiles it at first use into build/native/.
//
// C ABI:
//   int   vfz_decompress(const uint8_t* src, size_t n, uint8_t** out,
//                        size_t* out_n, char* err, size_t err_n);
//         0 on success (*out malloc'd, free it with vfz_free), 1 on error
//         (the reason in err).
//   void  vfz_free(void* p);

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& what) : std::runtime_error(what) {}
};

void need(bool ok, const char* what) {
  if (!ok) throw Corrupt(what);
}

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

uint64_t load_le(const uint8_t* p, size_t avail) {
  uint64_t v = 0;
  if (avail >= 8) {
    std::memcpy(&v, p, 8);
    return v;
  }
  for (size_t i = 0; i < avail; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---- XXH64 -----------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
uint64_t xmerge(uint64_t h, uint64_t v) {
  h ^= xround(0, v);
  return h * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (end - p >= 32) {
      v1 = xround(v1, load_le(p, 8));
      v2 = xround(v2, load_le(p + 8, 8));
      v3 = xround(v3, load_le(p + 16, 8));
      v4 = xround(v4, load_le(p + 24, 8));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h ^= xround(0, load_le(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= (load_le(p, 4) & 0xFFFFFFFFULL) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- bit streams -----------------------------------------------------------

// A forward bit reader (FSE table descriptions), least significant bit of
// the first byte first.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  ForwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int k) const {
    size_t byte = pos >> 3;
    uint64_t v = byte < n ? load_le(p + byte, n - byte) : 0;
    return uint32_t((v >> (pos & 7)) & ((1ULL << k) - 1));
  }
  void skip(int k) {
    pos += k;
    need(pos <= 8 * n, "FSE table description runs past its block");
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  size_t bytes_used() const { return (pos + 7) / 8; }
};

// A backward bit stream (Huffman and FSE payloads): the stream is a little-
// endian number whose highest set bit, in its last byte, marks the start;
// reads take the highest bits left.  Bits below the stream's beginning read
// as zeros; `left` going negative means the stream was overread.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t left;
  BackBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    need(n > 0, "empty bit stream");
    need(p[n - 1] != 0, "bit stream without its start marker");
    left = int64_t(8 * (n - 1)) + highbit(p[n - 1]);
  }
  // bits [pos, pos + k) of the number, zero below bit 0; k <= 56
  uint64_t bits_at(int64_t pos, int k) const {
    if (k == 0) return 0;
    if (pos < 0) {
      int have = k + int(pos);
      if (have <= 0) return 0;
      return bits_at(0, have) << (-pos);
    }
    size_t byte = size_t(pos) >> 3;
    uint64_t v = byte < n ? load_le(p + byte, n - byte) : 0;
    return (v >> (pos & 7)) & ((1ULL << k) - 1);
  }
  uint64_t peek(int k) const { return bits_at(left - k, k); }
  uint64_t read(int k) {
    uint64_t v = peek(k);
    left -= k;
    return v;
  }
};

// ---- FSE -------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint32_t baseline;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> cells;
  bool ready = false;
};

void fse_build(FseTable& t, const std::vector<int16_t>& norm, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.cells.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  uint32_t high = size - 1;
  int64_t total = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      need(total < int64_t(size), "FSE probabilities exceed the table");
      t.cells[high--].symbol = uint16_t(s);
      next[s] = 1;
      total += 1;
    } else {
      next[s] = uint32_t(norm[s]);
      total += norm[s];
    }
  }
  need(total == int64_t(size), "FSE probabilities do not fill the table");
  const uint32_t mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  uint32_t pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[pos].symbol = uint16_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  need(pos == 0, "FSE symbols spread unevenly");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t s = t.cells[u].symbol;
    uint32_t state = next[s]++;
    int nb = log - highbit(state);
    t.cells[u].nbits = uint8_t(nb);
    t.cells[u].baseline = (state << nb) - size;
  }
  t.ready = true;
}

// Reads an FSE table description; returns the bytes it took.
size_t fse_read(FseTable& t, const uint8_t* p, size_t n, int max_log,
                int max_symbol) {
  ForwardBits br(p, n);
  int log = int(br.read(4)) + 5;
  need(log <= max_log, "FSE accuracy log too large");
  int32_t remaining = (1 << log) + 1;
  int32_t threshold = 1 << log;
  int nbits = log + 1;
  std::vector<int16_t> norm;
  bool prev_zero = false;
  while (remaining > 1) {
    need(int(norm.size()) <= max_symbol, "FSE symbol out of range");
    if (prev_zero) {
      for (;;) {
        uint32_t repeat = br.read(2);
        for (uint32_t i = 0; i < repeat; ++i) norm.push_back(0);
        if (repeat != 3) break;
      }
      need(int(norm.size()) <= max_symbol, "FSE symbol out of range");
    }
    int32_t max = (2 * threshold - 1) - remaining;
    int32_t count;
    uint32_t low = br.peek(nbits - 1);
    if (int32_t(low) < max) {
      count = int32_t(low);
      br.skip(nbits - 1);
    } else {
      count = int32_t(br.peek(nbits));
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm.push_back(int16_t(count));
    prev_zero = count == 0;
    while (remaining < threshold && threshold > 1) {
      nbits -= 1;
      threshold >>= 1;
    }
  }
  need(remaining == 1, "FSE probabilities do not sum to the table");
  need(int(norm.size()) <= max_symbol + 1, "FSE symbol out of range");
  fse_build(t, norm, log);
  return br.bytes_used();
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.cells.assign(1, FseEntry{symbol, 0, 0});
  t.ready = true;
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(const FseTable& table, BackBits& bits) {
    t = &table;
    state = uint32_t(bits.read(table.log));
  }
  uint16_t symbol() const { return t->cells[state].symbol; }
  void update(BackBits& bits) {
    const FseEntry& e = t->cells[state];
    state = e.baseline + uint32_t(bits.read(e.nbits));
  }
};

// ---- Huffman ---------------------------------------------------------------

constexpr int kMaxHuffBits = 11;

struct HuffTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, nbits;
  bool ready = false;
};

// Reads a Huffman tree description; returns the bytes it took.
size_t huff_read(HuffTable& h, const uint8_t* p, size_t n) {
  need(n >= 1, "truncated Huffman tree description");
  std::vector<uint8_t> weights;
  size_t used;
  uint8_t header = p[0];
  if (header >= 128) {
    size_t count = header - 127;
    used = 1 + (count + 1) / 2;
    need(used <= n, "truncated Huffman weights");
    for (size_t i = 0; i < count; ++i) {
      uint8_t b = p[1 + i / 2];
      weights.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
  } else {
    used = 1 + size_t(header);
    need(header > 0 && used <= n, "truncated Huffman weights");
    FseTable t;
    size_t head = fse_read(t, p + 1, header, 6, 255);
    need(head < header, "Huffman weights without a bit stream");
    BackBits bits(p + 1 + head, header - head);
    FseState s1, s2;
    s1.init(t, bits);
    s2.init(t, bits);
    need(bits.left >= 0, "Huffman weight stream overread");
    for (;;) {
      need(weights.size() < 255, "too many Huffman weights");
      weights.push_back(uint8_t(s1.symbol()));
      s1.update(bits);
      if (bits.left < 0) {
        weights.push_back(uint8_t(s2.symbol()));
        break;
      }
      weights.push_back(uint8_t(s2.symbol()));
      s2.update(bits);
      if (bits.left < 0) {
        weights.push_back(uint8_t(s1.symbol()));
        break;
      }
    }
  }
  need(weights.size() <= 255, "too many Huffman weights");
  uint32_t total = 0;
  for (uint8_t w : weights) {
    need(w <= kMaxHuffBits, "Huffman weight too large");
    if (w) total += 1u << (w - 1);
  }
  need(total > 0, "Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  need(max_bits <= kMaxHuffBits, "Huffman code too long");
  uint32_t rest = (1u << max_bits) - total;
  need((rest & (rest - 1)) == 0, "Huffman weights leave no power of two");
  weights.push_back(uint8_t(highbit(rest) + 1));
  const uint32_t size = 1u << max_bits;
  h.max_bits = max_bits;
  h.symbol.assign(size, 0);
  h.nbits.assign(size, 0);
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (size_t s = 0; s < weights.size(); ++s) {
      if (weights[s] != w) continue;
      uint32_t span = 1u << (w - 1);
      need(pos + span <= size, "Huffman codes overflow the table");
      std::memset(&h.symbol[pos], int(s), span);
      std::memset(&h.nbits[pos], max_bits + 1 - w, span);
      pos += span;
    }
  }
  need(pos == size, "Huffman codes do not fill the table");
  h.ready = true;
  return used;
}

// One Huffman stream being decoded: its bytes and the bits left.
struct HuffStream {
  const uint8_t* p;
  size_t n;
  int64_t left;
  HuffStream(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    left = BackBits(p_, n_).left;
  }
  // the next max_bits bits, zero below the stream's beginning
  uint32_t peek(int mb, uint64_t mask) const {
    const int64_t pos = left - mb;
    if (pos >= 0 && size_t(pos >> 3) + 8 <= n) {  // the common case
      uint64_t word;
      std::memcpy(&word, p + (pos >> 3), 8);
      return uint32_t((word >> (pos & 7)) & mask);
    }
    return uint32_t(BackBits(p, n).bits_at(pos, mb));
  }
};

// Decodes `count[s]` symbols of each of the `k` streams into `out[s]`; the
// streams advance together, so that their table lookups overlap.
void huff_streams(const HuffTable& h, int k, HuffStream* st, uint8_t** out,
                  const size_t* count) {
  const int mb = h.max_bits;
  const uint64_t mask = (1ULL << mb) - 1;
  const uint8_t* symbol = h.symbol.data();
  const uint8_t* nbits = h.nbits.data();
  size_t common = count[0];
  for (int s = 1; s < k; ++s) common = count[s] < common ? count[s] : common;
  size_t i = 0;
  if (k == 4) {
    for (; i < common; ++i) {
      const uint32_t v0 = st[0].peek(mb, mask), v1 = st[1].peek(mb, mask),
                     v2 = st[2].peek(mb, mask), v3 = st[3].peek(mb, mask);
      out[0][i] = symbol[v0];
      out[1][i] = symbol[v1];
      out[2][i] = symbol[v2];
      out[3][i] = symbol[v3];
      st[0].left -= nbits[v0];
      st[1].left -= nbits[v1];
      st[2].left -= nbits[v2];
      st[3].left -= nbits[v3];
    }
  }
  for (int s = 0; s < k; ++s) {
    for (size_t j = i; j < count[s]; ++j) {
      const uint32_t v = st[s].peek(mb, mask);
      out[s][j] = symbol[v];
      st[s].left -= nbits[v];
    }
    need(st[s].left == 0, "Huffman stream not consumed exactly");
  }
}

// ---- sequences -------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,  12,   13,   14,   15,   16,   18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,   34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr size_t kMaxBlock = 128 * 1024;

struct FrameState {
  HuffTable huff;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

size_t seq_table(FseTable& t, int mode, const uint8_t* p, size_t n,
                 const int16_t* def, int def_n, int def_log, int max_log,
                 int max_symbol) {
  switch (mode) {
    case 0:
      fse_build(t, std::vector<int16_t>(def, def + def_n), def_log);
      return 0;
    case 1:
      need(n >= 1, "truncated RLE sequence table");
      need(p[0] <= max_symbol, "RLE sequence symbol out of range");
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read(t, p, n, max_log, max_symbol);
    default:
      need(t.ready, "repeated sequence table without a previous one");
      return 0;
  }
}

// Decodes one compressed block of `n` bytes onto `out`, whose frame began at
// `frame_start`.
void decode_block(FrameState& fs, const uint8_t* p, size_t n,
                  std::vector<uint8_t>& out, size_t frame_start) {
  // literals section
  need(n >= 1, "empty compressed block");
  const int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen, csize = 0, head;
  std::vector<uint8_t> litbuf;
  const uint8_t* lits;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      regen = p[0] >> 3;
      head = 1;
    } else if (sf == 1) {
      need(n >= 2, "truncated literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      head = 2;
    } else {
      need(n >= 3, "truncated literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      head = 3;
    }
    need(regen <= kMaxBlock, "literals larger than a block");
    if (ltype == 0) {
      need(head + regen <= n, "raw literals run past the block");
      lits = p + head;
      head += regen;
    } else {
      need(head + 1 <= n, "truncated RLE literals");
      litbuf.assign(regen, p[head]);
      lits = litbuf.data();
      head += 1;
    }
  } else {
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      need(n >= 3, "truncated literals header");
      uint32_t h = p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
      head = 3;
    } else if (sf == 2) {
      need(n >= 4, "truncated literals header");
      uint32_t h = uint32_t(load_le(p, 4));
      regen = (h >> 4) & 0x3FFF;
      csize = h >> 18;
      head = 4;
    } else {
      need(n >= 5, "truncated literals header");
      uint64_t h = load_le(p, 5);
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
      head = 5;
    }
    need(regen <= kMaxBlock, "literals larger than a block");
    need(head + csize <= n, "compressed literals run past the block");
    const uint8_t* q = p + head;
    size_t qn = csize;
    if (ltype == 2) {
      size_t used = huff_read(fs.huff, q, qn);
      q += used;
      qn -= used;
    } else {
      need(fs.huff.ready, "treeless literals without a previous table");
    }
    litbuf.resize(regen);
    if (streams == 1) {
      HuffStream st(q, qn);
      uint8_t* dst = litbuf.data();
      huff_streams(fs.huff, 1, &st, &dst, &regen);
    } else {
      need(qn >= 6 && regen >= 4, "truncated four-stream literals");
      size_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2),
             s3 = load_le(q + 4, 2);
      need(6 + s1 + s2 + s3 < qn, "four-stream jump table past the block");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      need(3 * seg <= regen, "four-stream literals too short");
      const uint8_t* d = q + 6;
      HuffStream st[4] = {HuffStream(d, s1), HuffStream(d + s1, s2),
                          HuffStream(d + s1 + s2, s3),
                          HuffStream(d + s1 + s2 + s3, s4)};
      uint8_t* dst[4] = {litbuf.data(), litbuf.data() + seg,
                         litbuf.data() + 2 * seg, litbuf.data() + 3 * seg};
      const size_t count[4] = {seg, seg, seg, regen - 3 * seg};
      huff_streams(fs.huff, 4, st, dst, count);
    }
    lits = litbuf.data();
    head += csize;
  }

  // sequences section
  const uint8_t* q = p + head;
  size_t qn = n - head;
  need(qn >= 1, "missing sequences section");
  size_t nseq;
  if (q[0] < 128) {
    nseq = q[0];
    q += 1;
    qn -= 1;
  } else if (q[0] < 255) {
    need(qn >= 2, "truncated sequence count");
    nseq = (size_t(q[0] - 128) << 8) + q[1];
    q += 2;
    qn -= 2;
  } else {
    need(qn >= 3, "truncated sequence count");
    nseq = q[1] + (size_t(q[2]) << 8) + 0x7F00;
    q += 3;
    qn -= 3;
  }
  if (nseq == 0) {
    need(qn == 0, "bytes after an empty sequences section");
    out.insert(out.end(), lits, lits + regen);
    return;
  }
  need(qn >= 1, "missing sequence table modes");
  const uint8_t modes = q[0];
  need((modes & 3) == 0, "reserved bits set in the sequence modes");
  q += 1;
  qn -= 1;
  size_t used = seq_table(fs.ll, modes >> 6, q, qn, kLLDefault, 36, 6, 9, 35);
  q += used;
  qn -= used;
  used = seq_table(fs.of, (modes >> 4) & 3, q, qn, kOFDefault, 29, 5, 8, 31);
  q += used;
  qn -= used;
  used = seq_table(fs.ml, (modes >> 2) & 3, q, qn, kMLDefault, 53, 6, 9, 52);
  q += used;
  qn -= used;

  BackBits bits(q, qn);
  FseState ll, of, ml;
  ll.init(fs.ll, bits);
  of.init(fs.of, bits);
  ml.init(fs.ml, bits);
  size_t lit_pos = 0;
  uint32_t* rep = fs.rep;
  for (size_t i = 0; i < nseq; ++i) {
    uint32_t of_code = of.symbol(), ll_code = ll.symbol(),
             ml_code = ml.symbol();
    need(of_code <= 31, "offset code out of range");
    need(ll_code <= 35 && ml_code <= 52, "length code out of range");
    uint64_t of_value = (1ULL << of_code) + bits.read(int(of_code));
    size_t match = kMLBase[ml_code] + bits.read(kMLBits[ml_code]);
    size_t litlen = kLLBase[ll_code] + bits.read(kLLBits[ll_code]);
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
    } else {
      uint32_t idx = uint32_t(of_value) - 1 + (litlen == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? uint64_t(rep[0]) - 1 : rep[idx];
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
      }
    }
    need(offset > 0, "zero match offset");
    rep[0] = uint32_t(offset);
    if (i + 1 < nseq) {
      ll.update(bits);
      ml.update(bits);
      of.update(bits);
    }
    need(bits.left >= 0, "sequence stream overread");
    need(lit_pos + litlen <= regen, "sequences use more literals than decoded");
    out.insert(out.end(), lits + lit_pos, lits + lit_pos + litlen);
    lit_pos += litlen;
    size_t have = out.size() - frame_start;
    need(offset <= have, "match offset before the frame's start");
    size_t from = out.size() - size_t(offset);
    out.resize(out.size() + match);
    uint8_t* dst = out.data() + out.size() - match;
    const uint8_t* src = out.data() + from;
    if (offset >= match) {
      std::memcpy(dst, src, match);
    } else {
      for (size_t k = 0; k < match; ++k) dst[k] = src[k];
    }
  }
  need(bits.left == 0, "sequence stream not consumed exactly");
  out.insert(out.end(), lits + lit_pos, lits + regen);
}

// Decodes the frame at p[0:n]; returns the bytes it took.
size_t decode_frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  need(n >= 4, "truncated frame magic");
  uint32_t magic = uint32_t(load_le(p, 4));
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    need(n >= 8, "truncated skippable frame");
    uint64_t size = load_le(p + 4, 4);
    need(8 + size <= n, "skippable frame runs past the input");
    return size_t(8 + size);
  }
  need(magic == 0xFD2FB528u, "not a zstd frame (bad magic number)");
  size_t pos = 4;
  need(pos < n, "truncated frame header");
  const uint8_t fhd = p[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
            checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  need(((fhd >> 3) & 1) == 0, "reserved bit set in the frame header");
  uint64_t window = 0;
  if (!single) {
    need(pos < n, "truncated frame header");
    uint8_t wd = p[pos++];
    int exponent = wd >> 3, mantissa = wd & 7;
    need(exponent <= 31 - 10, "window too large");
    uint64_t base = 1ULL << (10 + exponent);
    window = base + (base / 8) * mantissa;
  }
  const int dict_size[4] = {0, 1, 2, 4};
  need(pos + dict_size[dict_flag] <= n, "truncated frame header");
  uint64_t dict_id = dict_size[dict_flag]
                         ? load_le(p + pos, dict_size[dict_flag]) : 0;
  pos += dict_size[dict_flag];
  if (dict_id != 0) throw Corrupt("the frame names a dictionary, which this "
                                  "decoder does not support");
  const int fcs_size[4] = {single ? 1 : 0, 2, 4, 8};
  const int fcs_n = fcs_size[fcs_flag];
  need(pos + fcs_n <= n, "truncated frame header");
  bool has_size = fcs_n > 0;
  uint64_t content = fcs_n ? load_le(p + pos, fcs_n) : 0;
  if (fcs_n == 2) content += 256;
  pos += fcs_n;
  if (single) window = content;
  const size_t block_max = size_t(window < kMaxBlock ? window : kMaxBlock);

  const size_t start = out.size();
  if (has_size && content < (1ULL << 31)) out.reserve(start + content);
  FrameState fs;
  for (;;) {
    need(pos + 3 <= n, "truncated block header");
    uint32_t bh = uint32_t(load_le(p + pos, 3));
    pos += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    need(type != 3, "reserved block type");
    if (type == 1) {
      need(pos + 1 <= n, "truncated RLE block");
      need(size <= block_max, "block larger than the window allows");
      out.insert(out.end(), size, p[pos]);
      pos += 1;
    } else {
      need(size <= block_max, "block larger than the window allows");
      need(pos + size <= n, "block runs past the input");
      if (type == 0) {
        out.insert(out.end(), p + pos, p + pos + size);
      } else {
        size_t before = out.size();
        decode_block(fs, p + pos, size, out, start);
        need(out.size() - before <= block_max,
             "decoded block larger than the window allows");
      }
      pos += size;
    }
    if (last) break;
  }
  if (has_size) {
    need(out.size() - start == content,
         "decoded size differs from the frame's content size");
  }
  if (checksum) {
    need(pos + 4 <= n, "truncated content checksum");
    uint32_t want = uint32_t(load_le(p + pos, 4));
    uint32_t got = uint32_t(xxh64(out.data() + start, out.size() - start, 0));
    need(want == got, "content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void set_error(char* err, size_t err_n, const char* what) {
  if (err && err_n) std::snprintf(err, err_n, "%s", what);
}

}  // namespace

extern "C" {

int vfz_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_n,
                   char* err, size_t err_n) {
  *out = nullptr;
  *out_n = 0;
  try {
    need(n > 0, "no zstd frame in empty input");
    std::vector<uint8_t> buf;
    size_t pos = 0;
    while (pos < n) pos += decode_frame(src + pos, n - pos, buf);
    uint8_t* mem = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size()
                                                                : 1));
    if (!mem) throw Corrupt("out of memory");
    if (!buf.empty()) std::memcpy(mem, buf.data(), buf.size());
    *out = mem;
    *out_n = buf.size();
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_n, e.what());
    return 1;
  }
}

void vfz_free(void* p) { std::free(p); }

}  // extern "C"
