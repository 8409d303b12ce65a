// Native BGZF + BAM decoder (the htslib role, SURVEY.md §2b "samtools /
// htslib": BAM ingest for phasing pileups and polish read partitions).
//
// Design: BGZF blocks are independent deflate streams whose uncompressed
// size (ISIZE) is in the block trailer, so decode is two passes:
//   1. single-threaded scan of block framing -> (offset, csize, isize),
//   2. multithreaded raw-inflate of all blocks into one pre-sized blob,
// then a single linear pass turns BAM records into COLUMNAR arrays
// (flags/refs/positions as int32 vectors, names/cigar/seq/qual as flat
// blobs + offset tables).  Columns cross the ctypes boundary as plain
// pointers; Python wraps them zero-copy with numpy and converts to the
// packed int8 device layout without per-record Python objects.
#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Block {
  int64_t src_off;   // offset of deflate payload within file data
  int32_t csize;     // compressed payload bytes
  int64_t dst_off;   // offset within the decompressed blob
  int32_t isize;     // uncompressed bytes
};

bool read_file(const char* path, std::vector<uint8_t>& data) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return false;
  std::fseek(fh, 0, SEEK_END);
  long n = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  data.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(data.data(), 1, static_cast<size_t>(n), fh) : 0;
  std::fclose(fh);
  return got == static_cast<size_t>(n);
}

uint16_t rd16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}
uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

// Scan BGZF framing; returns false on malformed input.
bool scan_blocks(const std::vector<uint8_t>& data, std::vector<Block>& blocks,
                 int64_t* total_out) {
  int64_t pos = 0, total = 0;
  const int64_t n = static_cast<int64_t>(data.size());
  while (pos < n) {
    if (pos + 18 > n || data[pos] != 0x1f || data[pos + 1] != 0x8b)
      return false;
    const uint16_t xlen = rd16(&data[pos + 10]);
    int64_t e = pos + 12, xend = pos + 12 + xlen;
    if (xend > n) return false;
    int64_t bsize = -1;
    while (e + 4 <= xend) {
      const uint8_t si1 = data[e], si2 = data[e + 1];
      const uint16_t slen = rd16(&data[e + 2]);
      if (si1 == 66 && si2 == 67 && slen >= 2)
        bsize = static_cast<int64_t>(rd16(&data[e + 4])) + 1;
      e += 4 + slen;
    }
    if (bsize < 0 || pos + bsize > n) return false;
    const int64_t payload = pos + 12 + xlen;
    const int32_t csize = static_cast<int32_t>(pos + bsize - 8 - payload);
    const int32_t isize = static_cast<int32_t>(rd32(&data[pos + bsize - 4]));
    if (csize < 0) return false;
    blocks.push_back({payload, csize, total, isize});
    total += isize;
    pos += bsize;
  }
  *total_out = total;
  return true;
}

bool inflate_block(const uint8_t* src, int32_t csize, uint8_t* dst,
                   int32_t isize) {
  if (isize == 0) return true;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = static_cast<uInt>(csize);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(isize);
  const int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.avail_out == 0;
}

// BAM 4-bit nibble "=ACMGRSVTWYHKDBN" -> framework int8 code (PAD=4).
const int8_t kNib2Code[16] = {4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4};

// byte -> two decoded codes, so seq decode runs one table hit per 2 bases
struct Pair2 {
  int8_t hi, lo;
};
struct PairTable {
  Pair2 t[256];
  PairTable() {
    for (int b = 0; b < 256; ++b)
      t[b] = {kNib2Code[b >> 4], kNib2Code[b & 0xF]};
  }
};
const PairTable kPairs;

template <typename T>
T* copy_out(const std::vector<T>& v) {
  T* p = static_cast<T*>(std::malloc(std::max<size_t>(v.size(), 1) *
                                     sizeof(T)));
  if (p && !v.empty()) std::memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}

}  // namespace

extern "C" {

struct BamResult {
  // header
  char* text;
  int64_t text_len;
  char* ref_names;      // '\0'-joined
  int64_t ref_names_len;
  int64_t* ref_lens;
  int64_t n_ref;
  // records (columnar)
  int64_t n_rec;
  char* names;          // '\0'-joined
  int64_t names_len;
  int32_t* flag;
  int32_t* ref_id;
  int32_t* pos;
  int32_t* mapq;
  uint32_t* cigar;      // flattened (len<<4 | op) words
  int64_t* cigar_off;   // n_rec + 1
  int8_t* seq;          // flattened int8 codes
  uint8_t* qual;        // flattened phred (0xFF when absent)
  int64_t* seq_off;     // n_rec + 1
  int32_t error;        // 0 ok; 1 io; 2 bgzf; 3 inflate; 4 bam
};

static BamResult* fail(BamResult* r, int32_t code) {
  r->error = code;
  return r;
}

BamResult* bam_decode(const char* path, int32_t n_threads) {
  BamResult* r = static_cast<BamResult*>(std::calloc(1, sizeof(BamResult)));
  std::vector<uint8_t> data;
  if (!read_file(path, data)) return fail(r, 1);

  std::vector<Block> blocks;
  int64_t total = 0;
  if (!scan_blocks(data, blocks, &total)) return fail(r, 2);

  std::vector<uint8_t> blob(static_cast<size_t>(total));
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  nt = std::min<int>(nt, std::max<int>(1, static_cast<int>(blocks.size())));
  std::atomic<size_t> next{0};
  std::atomic<bool> ok{true};
  auto worker = [&] {
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= blocks.size() || !ok.load(std::memory_order_relaxed)) return;
      const Block& b = blocks[i];
      if (!inflate_block(&data[b.src_off], b.csize, &blob[b.dst_off],
                         b.isize))
        ok.store(false, std::memory_order_relaxed);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  if (!ok.load()) return fail(r, 3);

  // ---- BAM parse ----------------------------------------------------------
  const uint8_t* p = blob.data();
  const int64_t n = static_cast<int64_t>(blob.size());
  if (n < 12 || std::memcmp(p, "BAM\x01", 4) != 0) return fail(r, 4);
  int64_t off = 4;
  auto need = [&](int64_t k) { return off + k <= n; };
  if (!need(4)) return fail(r, 4);
  const int32_t l_text = static_cast<int32_t>(rd32(p + off));
  off += 4;
  if (l_text < 0 || !need(l_text)) return fail(r, 4);
  r->text_len = l_text;
  r->text = static_cast<char*>(std::malloc(std::max(l_text, 1)));
  std::memcpy(r->text, p + off, l_text);
  off += l_text;
  if (!need(4)) return fail(r, 4);
  const int32_t n_ref = static_cast<int32_t>(rd32(p + off));
  off += 4;
  if (n_ref < 0) return fail(r, 4);
  std::vector<char> ref_names;
  std::vector<int64_t> ref_lens;
  for (int32_t i = 0; i < n_ref; ++i) {
    if (!need(4)) return fail(r, 4);
    const int32_t l_name = static_cast<int32_t>(rd32(p + off));
    off += 4;
    if (l_name <= 0 || !need(l_name + 4)) return fail(r, 4);
    ref_names.insert(ref_names.end(), reinterpret_cast<const char*>(p + off),
                     reinterpret_cast<const char*>(p + off + l_name));
    // keep the stored trailing '\0' as the join separator
    off += l_name;
    ref_lens.push_back(static_cast<int32_t>(rd32(p + off)));
    off += 4;
  }
  r->n_ref = n_ref;
  r->ref_names_len = static_cast<int64_t>(ref_names.size());
  r->ref_names = copy_out(ref_names);
  r->ref_lens = copy_out(ref_lens);

  std::vector<char> names;
  std::vector<int32_t> flag, ref_id, pos, mapq;
  std::vector<uint32_t> cigar;
  std::vector<int64_t> cigar_off{0}, seq_off{0};
  std::vector<int8_t> seq;
  std::vector<uint8_t> qual;
  while (off < n) {
    if (!need(4)) return fail(r, 4);
    const int32_t bsz = static_cast<int32_t>(rd32(p + off));
    off += 4;
    if (bsz < 32 || !need(bsz)) return fail(r, 4);
    const uint8_t* q = p + off;
    const int32_t rid = static_cast<int32_t>(rd32(q + 0));
    const int32_t rpos = static_cast<int32_t>(rd32(q + 4));
    const uint8_t l_rn = q[8];
    const uint8_t mq = q[9];
    const uint16_t n_cig = rd16(q + 12);
    const uint16_t flg = rd16(q + 14);
    const int32_t l_seq = static_cast<int32_t>(rd32(q + 16));
    int64_t o = 32;
    if (l_rn < 1 || o + l_rn + 4LL * n_cig > bsz) return fail(r, 4);
    names.insert(names.end(), reinterpret_cast<const char*>(q + o),
                 reinterpret_cast<const char*>(q + o + l_rn));  // incl '\0'
    o += l_rn;
    for (uint16_t k = 0; k < n_cig; ++k, o += 4)
      cigar.push_back(rd32(q + o));
    cigar_off.push_back(static_cast<int64_t>(cigar.size()));
    const int64_t nseq = (static_cast<int64_t>(l_seq) + 1) / 2;
    if (l_seq < 0 || o + nseq + l_seq > bsz) return fail(r, 4);
    const size_t base = seq.size();
    seq.resize(base + l_seq);
    int8_t* dst = seq.data() + base;
    const int32_t pairs = l_seq / 2;
    for (int32_t k = 0; k < pairs; ++k) {
      const Pair2 pr = kPairs.t[q[o + k]];
      dst[2 * k] = pr.hi;
      dst[2 * k + 1] = pr.lo;
    }
    if (l_seq & 1) dst[l_seq - 1] = kNib2Code[q[o + pairs] >> 4];
    o += nseq;
    qual.insert(qual.end(), q + o, q + o + l_seq);
    seq_off.push_back(static_cast<int64_t>(seq.size()));
    flag.push_back(flg);
    ref_id.push_back(rid);
    pos.push_back(rpos);
    mapq.push_back(mq);
    off += bsz;
  }
  r->n_rec = static_cast<int64_t>(flag.size());
  r->names_len = static_cast<int64_t>(names.size());
  r->names = copy_out(names);
  r->flag = copy_out(flag);
  r->ref_id = copy_out(ref_id);
  r->pos = copy_out(pos);
  r->mapq = copy_out(mapq);
  r->cigar = copy_out(cigar);
  r->cigar_off = copy_out(cigar_off);
  r->seq = copy_out(seq);
  r->qual = copy_out(qual);
  r->seq_off = copy_out(seq_off);
  r->error = 0;
  return r;
}

void bam_result_free(BamResult* r) {
  if (!r) return;
  std::free(r->text);
  std::free(r->ref_names);
  std::free(r->ref_lens);
  std::free(r->names);
  std::free(r->flag);
  std::free(r->ref_id);
  std::free(r->pos);
  std::free(r->mapq);
  std::free(r->cigar);
  std::free(r->cigar_off);
  std::free(r->seq);
  std::free(r->qual);
  std::free(r->seq_off);
  std::free(r);
}

// Multithreaded BGZF encode: split payload into <=0xFF00 chunks, deflate
// each on a worker, emit framed blocks + the canonical EOF block.  Used by
// the BAM writer fast path (partitioned per-contig BAM emission).
struct BgzfBuf {
  uint8_t* data;
  int64_t len;
  int32_t error;
};

BgzfBuf* bgzf_encode(const uint8_t* payload, int64_t n, int32_t level,
                     int32_t n_threads) {
  static const uint8_t kEof[28] = {0x1f, 0x8b, 0x08, 0x04, 0,    0, 0, 0,
                                   0,    0xff, 0x06, 0x00, 0x42, 0x43, 0x02,
                                   0,    0x1b, 0x00, 0x03, 0,    0, 0, 0,
                                   0,    0,    0,    0,    0};
  BgzfBuf* r = static_cast<BgzfBuf*>(std::calloc(1, sizeof(BgzfBuf)));
  const int64_t kChunk = 0xFF00;
  const int64_t n_blocks = n ? (n + kChunk - 1) / kChunk : 0;
  std::vector<std::vector<uint8_t>> comp(static_cast<size_t>(n_blocks));
  std::atomic<int64_t> next{0};
  std::atomic<bool> ok{true};
  auto worker = [&] {
    std::vector<uint8_t> buf(static_cast<size_t>(
        compressBound(static_cast<uLong>(kChunk)) + 64));
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n_blocks || !ok.load(std::memory_order_relaxed)) return;
      const int64_t lo = i * kChunk;
      const int64_t len = std::min(kChunk, n - lo);
      z_stream zs;
      std::memset(&zs, 0, sizeof(zs));
      if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) != Z_OK) {
        ok.store(false);
        return;
      }
      zs.next_in = const_cast<uint8_t*>(payload + lo);
      zs.avail_in = static_cast<uInt>(len);
      zs.next_out = buf.data();
      zs.avail_out = static_cast<uInt>(buf.size());
      const int rc = deflate(&zs, Z_FINISH);
      const int64_t csize = static_cast<int64_t>(buf.size()) - zs.avail_out;
      deflateEnd(&zs);
      if (rc != Z_STREAM_END || csize + 26 > 0x10000) {
        ok.store(false);
        return;
      }
      const uint32_t crc = static_cast<uint32_t>(
          crc32(crc32(0L, Z_NULL, 0), payload + lo,
                static_cast<uInt>(len)));
      std::vector<uint8_t>& out = comp[static_cast<size_t>(i)];
      const int64_t bsize = csize + 26;
      out.resize(static_cast<size_t>(bsize));
      const uint8_t head[12] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                                0x06, 0x00};
      std::memcpy(out.data(), head, 12);
      out[12] = 'B';
      out[13] = 'C';
      out[14] = 2;
      out[15] = 0;
      const uint16_t bs16 = static_cast<uint16_t>(bsize - 1);
      out[16] = static_cast<uint8_t>(bs16 & 0xFF);
      out[17] = static_cast<uint8_t>(bs16 >> 8);
      std::memcpy(out.data() + 18, buf.data(), static_cast<size_t>(csize));
      uint8_t* tail = out.data() + 18 + csize;
      const uint32_t isz = static_cast<uint32_t>(len);
      for (int b = 0; b < 4; ++b) tail[b] = (crc >> (8 * b)) & 0xFF;
      for (int b = 0; b < 4; ++b) tail[4 + b] = (isz >> (8 * b)) & 0xFF;
    }
  };
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  nt = std::min<int64_t>(nt, std::max<int64_t>(1, n_blocks));
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  if (!ok.load()) {
    r->error = 1;
    return r;
  }
  int64_t total = sizeof(kEof);
  for (const auto& c : comp) total += static_cast<int64_t>(c.size());
  r->data = static_cast<uint8_t*>(std::malloc(static_cast<size_t>(total)));
  int64_t w = 0;
  for (const auto& c : comp) {
    std::memcpy(r->data + w, c.data(), c.size());
    w += static_cast<int64_t>(c.size());
  }
  std::memcpy(r->data + w, kEof, sizeof(kEof));
  r->len = total;
  r->error = 0;
  return r;
}

void bgzf_buf_free(BgzfBuf* r) {
  if (!r) return;
  std::free(r->data);
  std::free(r);
}

}  // extern "C"
