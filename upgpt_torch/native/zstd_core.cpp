// A Zstandard decoder (RFC 8878) and CRC-32C, behind a C ABI.
//
// The reader of the JAX package's orbax checkpoints (convert/ocdbt.py,
// convert/orbax.py) needs both: tensorstore compresses every OCDBT node and
// every zarr chunk with zstd, and closes each OCDBT file with a CRC-32C.
// The decoder takes whole values into one flat output buffer the caller
// sizes, so a match reaches back into the frame's own output and no window
// buffer is kept. Every frame feature is read: content size present or
// absent, single segment, raw / RLE / compressed blocks, skippable frames,
// frames back to back; raw, RLE, Huffman (one or four streams) and treeless
// literals; predefined, RLE, FSE and repeat sequence tables with the three
// repeat offsets; the XXH64 content checksum. A frame that names a
// dictionary is refused. Malformed input returns a negative code; no read
// or write ever leaves the buffers it was given.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>

namespace {

enum : int64_t {
  kErrTruncated = -1,   // the input ends inside a frame
  kErrCorrupt = -2,     // a header, a table or a bitstream is malformed
  kErrDstSize = -3,     // the output does not fit the buffer
  kErrDictionary = -4,  // the frame needs a dictionary
  kErrChecksum = -5,    // the content checksum disagrees
  kErrMagic = -6,       // neither a zstd nor a skippable frame
  kErrSize = -7,        // the content disagrees with the header's size
  kUnknownSize = -8,    // (content size only) a frame declares no size
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kBlockMax = 128 * 1024;

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) {
  return rd16(p) | (uint32_t(rd16(p + 2)) << 16);
}
inline uint64_t rd64(const uint8_t* p) {
  return rd32(p) | (uint64_t(rd32(p + 4)) << 32);
}
inline uint64_t rdn(const uint8_t* p, int n) {  // n little-endian bytes
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v != 0

// ------------------------------------------------------------ bitstreams

// A bitstream read from its end towards its start (FSE and Huffman
// streams): the last byte's highest set bit marks the end, and bits below
// the stream's start read as zeros.
struct BackBits {
  const uint8_t* b = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits not yet consumed lie in [0, pos)

  bool init(const uint8_t* p, size_t len) {
    b = p;
    n = len;
    if (len == 0 || p[len - 1] == 0) return false;
    pos = int64_t(len - 1) * 8 + highbit(p[len - 1]);
    return true;
  }
  // 57 bits starting at bit `lo`, zeros outside the stream
  uint64_t window(int64_t lo) const {
    if (lo >= 0 && size_t(lo >> 3) + 8 <= n) {
      uint64_t v;
      std::memcpy(&v, b + (lo >> 3), 8);
      return v >> (lo & 7);
    }
    const int64_t fb = lo >= 0 ? lo / 8 : -((-lo + 7) / 8);
    uint64_t v = 0;
    for (int j = 0; j < 8; ++j) {
      const int64_t bi = fb + j;
      if (bi >= 0 && bi < int64_t(n)) v |= uint64_t(b[bi]) << (8 * j);
    }
    return v >> (lo - fb * 8);
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    pos -= k;
    return uint32_t(window(pos) & ((uint64_t(1) << k) - 1));
  }
  uint32_t peek(int k) const {
    return uint32_t(window(pos - k) & ((uint64_t(1) << k) - 1));
  }
};

// A bitstream read from its start (FSE table descriptions); bits past the
// end read as zeros and `pos` tells how far the reader went.
struct FwdBits {
  const uint8_t* b;
  size_t n;
  uint64_t pos = 0;

  uint32_t peek(int k) const {
    uint64_t v = 0;
    const uint64_t fb = pos >> 3;
    for (int j = 0; j < 5; ++j)
      if (fb + j < n) v |= uint64_t(b[fb + j]) << (8 * j);
    return uint32_t((v >> (pos & 7)) & ((uint64_t(1) << k) - 1));
  }
  uint32_t get(int k) {
    const uint32_t v = peek(k);
    pos += k;
    return v;
  }
};

// ------------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t next;  // base of the next state
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  int log = 0;
  FseEntry e[512];
};

// An FSE table description (RFC 8878 4.1.1): the normalized counts of
// symbols 0..max_sym. Returns the bytes read, or an error.
int64_t read_counts(const uint8_t* src, size_t n, int16_t* norm, int max_sym,
                    int max_log, int* log_out) {
  if (n < 1) return kErrTruncated;
  FwdBits r{src, n};
  const int log = int(r.get(4)) + 5;
  if (log > max_log) return kErrCorrupt;
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  int sym = 0;
  while (remaining > 1) {
    if (sym > max_sym) return kErrCorrupt;
    const int max = 2 * threshold - 1 - remaining;
    const int v = int(r.peek(nb));
    int val;
    if ((v & (threshold - 1)) < max) {
      val = v & (threshold - 1);
      r.pos += nb - 1;
    } else {
      val = v & (2 * threshold - 1);
      if (val >= threshold) val -= max;
      r.pos += nb;
    }
    const int count = val - 1;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) return kErrCorrupt;
    norm[sym++] = int16_t(count);
    if (count == 0) {
      for (;;) {  // the 2-bit repeat flags of zero probabilities
        const int rep = int(r.get(2));
        for (int i = 0; i < rep; ++i) {
          if (sym > max_sym) return kErrCorrupt;
          norm[sym++] = 0;
        }
        if (rep != 3) break;
        if (r.pos > 8 * n) return kErrCorrupt;
      }
    }
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
    if (r.pos > 8 * n) return kErrCorrupt;
  }
  while (sym <= max_sym) norm[sym++] = 0;
  *log_out = log;
  return int64_t((r.pos + 7) / 8);
}

bool build_fse(FseTable& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  int high = size - 1;
  uint16_t next[64];
  for (int u = 0; u < size; ++u) t.e[u] = FseEntry{0, 0, 0};
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) return false;
      t.e[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].symbol = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    const int s = t.e[u].symbol;
    const uint32_t x = next[s]++;
    if (x == 0) return false;
    const int bits = log - highbit(x);
    if (bits < 0) return false;
    t.e[u].bits = uint8_t(bits);
    t.e[u].next = uint16_t((x << bits) - size);
  }
  t.log = log;
  return true;
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.e[0] = FseEntry{0, symbol, 0};
}

// --------------------------------------------------------------- Huffman

struct HufTable {
  bool valid = false;
  int bits = 0;
  uint16_t entry[1 << 11];  // symbol | code length << 8, by the next `bits`
};

// A Huffman tree description (RFC 8878 4.2.1). Returns the bytes read.
int64_t read_huffman(const uint8_t* src, size_t n, HufTable& h) {
  if (n < 1) return kErrTruncated;
  uint8_t w[256];
  int nw = 0;
  int64_t used;
  const int head = src[0];
  if (head >= 128) {  // 4-bit weights, two to a byte
    nw = head - 127;
    const size_t bytes = size_t(nw + 1) / 2;
    if (1 + bytes > n) return kErrTruncated;
    for (int i = 0; i < nw; ++i) {
      const uint8_t byte = src[1 + i / 2];
      w[i] = (i % 2 == 0) ? byte >> 4 : byte & 15;
    }
    used = int64_t(1 + bytes);
  } else {  // FSE-compressed weights, two interleaved states
    const size_t csize = size_t(head);
    if (1 + csize > n) return kErrTruncated;
    int16_t norm[16];
    int log;
    const int64_t k = read_counts(src + 1, csize, norm, 12, 6, &log);
    if (k < 0) return k;
    if (size_t(k) > csize) return kErrCorrupt;
    FseTable t;
    if (!build_fse(t, norm, 13, log)) return kErrCorrupt;
    BackBits bb;
    if (!bb.init(src + 1 + k, csize - size_t(k))) return kErrCorrupt;
    uint32_t s1 = bb.read(log), s2 = bb.read(log);
    for (;;) {
      if (nw > 253) return kErrCorrupt;
      w[nw++] = t.e[s1].symbol;
      s1 = t.e[s1].next + bb.read(t.e[s1].bits);
      if (bb.pos < 0) {
        w[nw++] = t.e[s2].symbol;
        break;
      }
      w[nw++] = t.e[s2].symbol;
      s2 = t.e[s2].next + bb.read(t.e[s2].bits);
      if (bb.pos < 0) {
        w[nw++] = t.e[s1].symbol;
        break;
      }
    }
    used = int64_t(1 + csize);
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) return kErrCorrupt;
    if (w[i]) total += uint32_t(1) << (w[i] - 1);
  }
  if (total == 0) return kErrCorrupt;
  const int bits = highbit(total) + 1;
  if (bits > 11) return kErrCorrupt;
  const uint32_t rest = (uint32_t(1) << bits) - total;
  if (rest == 0 || (rest & (rest - 1))) return kErrCorrupt;
  if (nw > 255) return kErrCorrupt;
  w[nw++] = uint8_t(highbit(rest) + 1);
  uint32_t start[13] = {0}, count[13] = {0};
  for (int i = 0; i < nw; ++i) ++count[w[i]];
  uint32_t pos = 0;
  for (int wt = 1; wt <= bits; ++wt) {
    start[wt] = pos;
    pos += count[wt] << (wt - 1);
  }
  if (pos != (uint32_t(1) << bits)) return kErrCorrupt;
  for (int s = 0; s < nw; ++s) {
    const int wt = w[s];
    if (!wt) continue;
    const uint32_t len = uint32_t(1) << (wt - 1);
    const uint16_t e = uint16_t(s | (bits + 1 - wt) << 8);
    for (uint32_t j = 0; j < len; ++j) h.entry[start[wt] + j] = e;
    start[wt] += len;
  }
  h.bits = bits;
  h.valid = true;
  return used;
}

// One Huffman stream being decoded: its bitstream, where its symbols go
// and how many are left.
struct HufStream {
  BackBits bb;
  uint8_t* out;
  size_t left;
};

// Five codes of at most 11 bits from one 57-bit load, while the stream has
// five symbols left and the load lies inside it (pos >= 57 keeps it there).
inline bool decode5(const HufTable& h, HufStream& s) {
  if (s.left < 5 || s.bb.pos < 57) return false;
  const int bits = h.bits;
  const uint64_t mask = (uint64_t(1) << bits) - 1;
  const int64_t lo = s.bb.pos - 57;
  const uint64_t v = s.bb.window(lo);
  int rest = 57;
  for (int k = 0; k < 5; ++k) {
    const uint16_t e = h.entry[(v >> (rest - bits)) & mask];
    s.out[k] = uint8_t(e);
    rest -= e >> 8;
  }
  s.bb.pos = lo + rest;
  s.out += 5;
  s.left -= 5;
  return true;
}

// The rest of a stream, one code at a time; true where the stream ends
// exactly at its first bit.
bool finish(const HufTable& h, HufStream& s) {
  while (decode5(h, s)) {
  }
  for (; s.left; --s.left) {
    const uint16_t e = h.entry[s.bb.peek(h.bits)];
    *s.out++ = uint8_t(e);
    s.bb.pos -= e >> 8;
  }
  return s.bb.pos == 0;
}

bool huffman_stream(const HufTable& h, const uint8_t* src, size_t n,
                    uint8_t* out, size_t count) {
  HufStream s{BackBits(), out, count};
  return s.bb.init(src, n) && finish(h, s);
}

// Four streams decoded in turns, so their dependency chains overlap.
bool huffman_streams4(const HufTable& h, const uint8_t* const src[4],
                      const size_t n[4], uint8_t* out, const size_t count[4]) {
  HufStream s[4];
  for (int i = 0; i < 4; ++i) {
    s[i].out = out;
    s[i].left = count[i];
    out += count[i];
    if (!s[i].bb.init(src[i], n[i])) return false;
  }
  while (decode5(h, s[0]) & decode5(h, s[1]) & decode5(h, s[2]) &
         decode5(h, s[3])) {
  }
  return finish(h, s[0]) && finish(h, s[1]) && finish(h, s[2]) &&
         finish(h, s[3]);
}

// ------------------------------------------------------------- sequences

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
    16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

enum { LL = 0, OF = 1, ML = 2 };
const int kMaxSym[3] = {35, 31, 52};
const int kMaxLog[3] = {9, 8, 9};

struct Predefined {
  FseTable t[3];
  Predefined() {
    build_fse(t[LL], kLLDefault, 36, 6);
    build_fse(t[OF], kOFDefault, 29, 5);
    build_fse(t[ML], kMLDefault, 53, 6);
  }
};
const Predefined kPredefined;

// What a frame's blocks share: the last Huffman table, the last sequence
// tables, the repeat offsets, and room for a block's literals.
struct FrameState {
  HufTable huf;
  FseTable seq[3];
  bool seq_valid[3] = {false, false, false};
  uint64_t rep[3] = {1, 4, 8};
  uint8_t literals[kBlockMax + 64];

  void reset() {
    huf.valid = false;
    seq_valid[0] = seq_valid[1] = seq_valid[2] = false;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
  }
};

// The literals section (RFC 8878 3.1.1.3.1). Returns the bytes read.
int64_t read_literals(const uint8_t* src, size_t n, FrameState& fs,
                      const uint8_t** lit, size_t* lit_size) {
  if (n < 1) return kErrTruncated;
  const int type = src[0] & 3, format = (src[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    size_t head, size;
    if ((format & 1) == 0) {
      head = 1;
      size = src[0] >> 3;
    } else if (format == 1) {
      if (n < 2) return kErrTruncated;
      head = 2;
      size = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      if (n < 3) return kErrTruncated;
      head = 3;
      size = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (size > kBlockMax) return kErrCorrupt;
    if (type == 0) {
      if (head + size > n) return kErrTruncated;
      *lit = src + head;
      *lit_size = size;
      return int64_t(head + size);
    }
    if (head + 1 > n) return kErrTruncated;
    std::memset(fs.literals, src[head], size);
    *lit = fs.literals;
    *lit_size = size;
    return int64_t(head + 1);
  }
  const size_t head = format < 2 ? 3 : size_t(format) + 2;
  const int streams = format == 0 ? 1 : 4;
  if (head > n) return kErrTruncated;
  const int bits = format < 2 ? 10 : (format == 2 ? 14 : 18);
  const uint64_t h = rdn(src, int(head));
  const size_t regen = size_t((h >> 4) & ((uint64_t(1) << bits) - 1));
  const size_t csize = size_t((h >> (4 + bits)) & ((uint64_t(1) << bits) - 1));
  if (regen > kBlockMax) return kErrCorrupt;
  if (head + csize > n) return kErrTruncated;
  const uint8_t* p = src + head;
  size_t rest = csize;
  if (type == 2) {
    const int64_t k = read_huffman(p, rest, fs.huf);
    if (k < 0) return k;
    if (size_t(k) > rest) return kErrCorrupt;
    p += k;
    rest -= size_t(k);
  } else if (!fs.huf.valid) {
    return kErrCorrupt;  // treeless literals before any tree
  }
  if (streams == 1) {
    if (!huffman_stream(fs.huf, p, rest, fs.literals, regen))
      return kErrCorrupt;
  } else {
    if (rest < 6) return kErrCorrupt;
    const size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
    p += 6;
    rest -= 6;
    if (s1 + s2 + s3 > rest) return kErrCorrupt;
    const size_t s4 = rest - s1 - s2 - s3;
    const size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) return kErrCorrupt;
    const size_t sizes[4] = {s1, s2, s3, s4};
    const uint8_t* const starts[4] = {p, p + s1, p + s1 + s2,
                                      p + s1 + s2 + s3};
    const size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
    if (!huffman_streams4(fs.huf, starts, sizes, fs.literals, counts))
      return kErrCorrupt;
  }
  *lit = fs.literals;
  *lit_size = regen;
  return int64_t(head + csize);
}

// A match: `len` bytes from `off` back, overlapping where off < len.
inline void copy_match(uint8_t* op, size_t off, size_t len) {
  const uint8_t* m = op - off;
  if (off >= len) {
    std::memcpy(op, m, len);
    return;
  }
  // period `off`: each pass copies everything written since `m`
  while (len) {
    const size_t k = size_t(op - m) < len ? size_t(op - m) : len;
    std::memcpy(op, m, k);
    op += k;
    len -= k;
  }
}

// A compressed block's sequences section and its execution (RFC 8878
// 3.1.1.3.2, 3.1.1.4, 3.1.1.5).
int64_t run_sequences(const uint8_t* src, size_t n, FrameState& fs,
                      const uint8_t* lit, size_t lit_size, uint8_t* frame,
                      uint8_t** opp, uint8_t* oend) {
  uint8_t* op = *opp;
  if (n < 1) return kErrTruncated;
  size_t nseq, head;
  const uint8_t b0 = src[0];
  if (b0 < 128) {
    nseq = b0;
    head = 1;
  } else if (b0 < 255) {
    if (n < 2) return kErrTruncated;
    nseq = (size_t(b0 - 128) << 8) + src[1];
    head = 2;
  } else {
    if (n < 3) return kErrTruncated;
    nseq = src[1] + (size_t(src[2]) << 8) + 0x7F00;
    head = 3;
  }
  const uint8_t* litp = lit;
  const uint8_t* lit_end = lit + lit_size;
  if (nseq > 0) {
    if (head + 1 > n) return kErrTruncated;
    const uint8_t modes = src[head++];
    if (modes & 3) return kErrCorrupt;
    const uint8_t* p = src + head;
    size_t rest = n - head;
    const int mode[3] = {modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3};
    for (int kind = 0; kind < 3; ++kind) {
      switch (mode[kind]) {
        case 0:
          fs.seq[kind] = kPredefined.t[kind];
          break;
        case 1:
          if (rest < 1) return kErrTruncated;
          if (*p > kMaxSym[kind]) return kErrCorrupt;
          rle_fse(fs.seq[kind], *p);
          ++p;
          --rest;
          break;
        case 2: {
          int16_t norm[64];
          int log;
          const int64_t k = read_counts(p, rest, norm, kMaxSym[kind],
                                        kMaxLog[kind], &log);
          if (k < 0) return k;
          if (size_t(k) > rest) return kErrCorrupt;
          if (!build_fse(fs.seq[kind], norm, kMaxSym[kind] + 1, log))
            return kErrCorrupt;
          p += k;
          rest -= size_t(k);
          break;
        }
        default:
          if (!fs.seq_valid[kind]) return kErrCorrupt;
      }
      fs.seq_valid[kind] = true;
    }
    const FseTable& tl = fs.seq[LL];
    const FseTable& to = fs.seq[OF];
    const FseTable& tm = fs.seq[ML];
    BackBits bb;
    if (!bb.init(p, rest)) return kErrCorrupt;
    uint32_t sl = bb.read(tl.log), so = bb.read(to.log), sm = bb.read(tm.log);
    uint64_t* rep = fs.rep;
    for (size_t i = 0; i < nseq; ++i) {
      const int oc = to.e[so].symbol, mc = tm.e[sm].symbol,
                lc = tl.e[sl].symbol;
      if (oc > 31 || mc > 52 || lc > 35) return kErrCorrupt;
      const uint64_t ov = (uint64_t(1) << oc) + bb.read(oc);
      const size_t ml = kMLBase[mc] + bb.read(kMLBits[mc]);
      const size_t ll = kLLBase[lc] + bb.read(kLLBits[lc]);
      if (i + 1 < nseq) {
        sl = tl.e[sl].next + bb.read(tl.e[sl].bits);
        sm = tm.e[sm].next + bb.read(tm.e[sm].bits);
        so = to.e[so].next + bb.read(to.e[so].bits);
      }
      if (bb.pos < 0) return kErrCorrupt;
      uint64_t off;
      if (ov > 3) {
        off = ov - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        const int idx = int(ov) - 1 + (ll == 0);
        if (idx == 0) {
          off = rep[0];
        } else {
          off = idx == 3 ? rep[0] - 1 : rep[idx];
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      if (ll > size_t(lit_end - litp)) return kErrCorrupt;
      if (ll + ml > size_t(oend - op)) return kErrDstSize;
      std::memcpy(op, litp, ll);
      op += ll;
      litp += ll;
      if (off == 0 || off > uint64_t(op - frame)) return kErrCorrupt;
      copy_match(op, size_t(off), ml);
      op += ml;
    }
    if (bb.pos != 0) return kErrCorrupt;
  } else if (head != n) {
    return kErrCorrupt;
  }
  const size_t tail = size_t(lit_end - litp);
  if (tail > size_t(oend - op)) return kErrDstSize;
  std::memcpy(op, litp, tail);
  *opp = op + tail;
  return 0;
}

// --------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
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

// ---------------------------------------------------------------- frames

struct FrameHeader {
  size_t size;  // header bytes after the magic number
  bool has_size;
  uint64_t content_size;
  bool checksum;
};

int64_t read_frame_header(const uint8_t* ip, size_t n, FrameHeader* fh) {
  if (n < 1) return kErrTruncated;
  const uint8_t d = ip[0];
  const int fcs_flag = d >> 6, single = (d >> 5) & 1, dict_flag = d & 3;
  if (d & 8) return kErrCorrupt;  // reserved bit
  static const int kDictBytes[4] = {0, 1, 2, 4};
  const int fcs_bytes =
      fcs_flag == 0 ? single : (fcs_flag == 1 ? 2 : (fcs_flag == 2 ? 4 : 8));
  const size_t size = 1 + (single ? 0 : 1) + kDictBytes[dict_flag] + fcs_bytes;
  if (size > n) return kErrTruncated;
  const uint8_t* p = ip + 1 + (single ? 0 : 1);
  if (rdn(p, kDictBytes[dict_flag]) != 0) return kErrDictionary;
  p += kDictBytes[dict_flag];
  uint64_t fcs = rdn(p, fcs_bytes);
  if (fcs_flag == 1) fcs += 256;
  fh->size = size;
  fh->has_size = fcs_bytes > 0;
  fh->content_size = fcs;
  fh->checksum = (d >> 2) & 1;
  return 0;
}

// One frame after its magic number; returns the bytes it took.
int64_t decode_frame(const uint8_t* ip, size_t n, FrameState& fs,
                     uint8_t** opp, uint8_t* oend) {
  FrameHeader fh;
  const int64_t err = read_frame_header(ip, n, &fh);
  if (err < 0) return err;
  uint8_t* const frame = *opp;
  uint8_t* op = frame;
  if (fh.has_size && fh.content_size > uint64_t(oend - op)) return kErrDstSize;
  const uint8_t* p = ip + fh.size;
  const uint8_t* end = ip + n;
  fs.reset();
  for (;;) {
    if (end - p < 3) return kErrTruncated;
    const uint32_t bh = rd24(p);
    p += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 0) {
      if (size > size_t(end - p)) return kErrTruncated;
      if (size > size_t(oend - op)) return kErrDstSize;
      std::memcpy(op, p, size);
      op += size;
      p += size;
    } else if (type == 1) {
      if (end - p < 1) return kErrTruncated;
      if (size > size_t(oend - op)) return kErrDstSize;
      std::memset(op, *p, size);
      op += size;
      p += 1;
    } else if (type == 2) {
      if (size > size_t(end - p)) return kErrTruncated;
      if (size > kBlockMax) return kErrCorrupt;
      const uint8_t* lit;
      size_t lit_size;
      const int64_t k = read_literals(p, size, fs, &lit, &lit_size);
      if (k < 0) return k;
      const int64_t r = run_sequences(p + k, size - size_t(k), fs, lit,
                                      lit_size, frame, &op, oend);
      if (r < 0) return r;
      p += size;
    } else {
      return kErrCorrupt;
    }
    if (last) break;
  }
  if (fh.has_size && uint64_t(op - frame) != fh.content_size) return kErrSize;
  if (fh.checksum) {
    if (end - p < 4) return kErrTruncated;
    if (uint32_t(xxh64(frame, size_t(op - frame))) != rd32(p))
      return kErrChecksum;
    p += 4;
  }
  *opp = op;
  return int64_t(p - ip);
}

// ---------------------------------------------------------------- CRC-32C

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};
const Crc32cTables kCrc;

}  // namespace

extern "C" {

// Decode every frame of `src` (zstd frames and skippable frames, back to
// back) into `dst`; returns the bytes written or a negative error code.
int64_t upgpt_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                              size_t cap) {
  if (n == 0) return kErrTruncated;
  std::unique_ptr<FrameState> fs(new FrameState);
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  size_t i = 0;
  while (i < n) {
    if (n - i < 4) return kErrTruncated;
    const uint32_t magic = rd32(src + i);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - i < 8) return kErrTruncated;
      const size_t size = rd32(src + i + 4);
      if (size > n - i - 8) return kErrTruncated;
      i += 8 + size;
      continue;
    }
    if (magic != kMagic) return kErrMagic;
    i += 4;
    const int64_t k = decode_frame(src + i, n - i, *fs, &op, oend);
    if (k < 0) return k;
    i += size_t(k);
  }
  return int64_t(op - dst);
}

// The summed content size of `src`'s frames where each declares one,
// kUnknownSize where one does not, or a negative error code.
int64_t upgpt_zstd_content_size(const uint8_t* src, size_t n) {
  if (n == 0) return kErrTruncated;
  uint64_t total = 0;
  bool known = true;
  size_t i = 0;
  while (i < n) {
    if (n - i < 4) return kErrTruncated;
    const uint32_t magic = rd32(src + i);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - i < 8) return kErrTruncated;
      const size_t size = rd32(src + i + 4);
      if (size > n - i - 8) return kErrTruncated;
      i += 8 + size;
      continue;
    }
    if (magic != kMagic) return kErrMagic;
    i += 4;
    FrameHeader fh;
    const int64_t err = read_frame_header(src + i, n - i, &fh);
    if (err < 0) return err;
    known = known && fh.has_size;
    total += fh.content_size;
    i += fh.size;
    for (;;) {  // walk the block headers to the frame's end
      if (n - i < 3) return kErrTruncated;
      const uint32_t bh = rd24(src + i);
      i += 3;
      const size_t size = (bh >> 1 & 3) == 1 ? 1 : bh >> 3;
      if ((bh >> 1 & 3) == 3) return kErrCorrupt;
      if (size > n - i) return kErrTruncated;
      i += size;
      if (bh & 1) break;
    }
    if (fh.checksum) {
      if (n - i < 4) return kErrTruncated;
      i += 4;
    }
  }
  if (!known) return kUnknownSize;
  if (total > uint64_t(INT64_MAX)) return kErrCorrupt;
  return int64_t(total);
}

// CRC-32C (Castagnoli, reflected, initial and final XOR 0xFFFFFFFF).
uint32_t upgpt_crc32c(const uint8_t* p, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  for (; n >= 8; p += 8, n -= 8) {
    const uint64_t v = rd64(p) ^ crc;
    crc = kCrc.t[7][v & 0xFF] ^ kCrc.t[6][(v >> 8) & 0xFF] ^
          kCrc.t[5][(v >> 16) & 0xFF] ^ kCrc.t[4][(v >> 24) & 0xFF] ^
          kCrc.t[3][(v >> 32) & 0xFF] ^ kCrc.t[2][(v >> 40) & 0xFF] ^
          kCrc.t[1][(v >> 48) & 0xFF] ^ kCrc.t[0][v >> 56];
  }
  for (; n; ++p, --n) crc = kCrc.t[0][(crc ^ *p) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

}  // extern "C"
