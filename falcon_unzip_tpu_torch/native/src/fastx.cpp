// Native FASTA/FASTQ parser: the host data-loader fast path.
//
// Role parity: the reference leans on C-backed IO throughout (htslib,
// falcon-kit FastaReader backed by C string handling; SURVEY.md §2b).
// This library parses FASTA/FASTQ into the framework's packed int8 tensor
// layout (A=0 C=1 G=2 T=3, other=4) in a single buffered pass, exposed to
// Python via ctypes (no pybind11 in the image).
//
// Build: make -C falcon_unzip_tpu/native   (produces libfalcon_io.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Tables {
  int8_t enc[256];
  Tables() {
    memset(enc, 4, sizeof(enc));
    enc[(unsigned)'A'] = enc[(unsigned)'a'] = 0;
    enc[(unsigned)'C'] = enc[(unsigned)'c'] = 1;
    enc[(unsigned)'G'] = enc[(unsigned)'g'] = 2;
    enc[(unsigned)'T'] = enc[(unsigned)'t'] = 3;
  }
};
const Tables kTables;

}  // namespace

extern "C" {

typedef struct {
  int8_t* seq;       // concatenated encoded bases
  int64_t* offsets;  // n + 1 entries
  char* names;       // '\0'-joined record names
  int64_t names_len;
  int64_t n;         // number of records
  int64_t total;     // total bases
  char* quals;       // concatenated qual chars (FASTQ) or nullptr
} FastxResult;

// Parse a (plain, uncompressed) FASTA or FASTQ file.
// Returns nullptr on error; caller frees with fastx_free().
FastxResult* fastx_parse(const char* path) {
  FILE* fh = fopen(path, "rb");
  if (!fh) return nullptr;

  std::vector<int8_t> seq;
  std::vector<int64_t> offsets(1, 0);
  std::string names;
  std::string quals;
  seq.reserve(1 << 20);

  std::string line;
  line.reserve(1 << 16);
  char buf[1 << 16];
  bool is_fastq = false;
  int first = fgetc(fh);
  if (first == EOF) {
    fclose(fh);
    return nullptr;
  }
  is_fastq = (first == '@');
  ungetc(first, fh);

  auto read_line = [&](std::string& out) -> bool {
    out.clear();
    while (fgets(buf, sizeof(buf), fh)) {
      size_t len = strlen(buf);
      bool nl = len && buf[len - 1] == '\n';
      if (nl) len--;
      if (len && buf[len - 1] == '\r') len--;
      out.append(buf, len);
      if (nl) return true;
    }
    return !out.empty();
  };

  if (!is_fastq) {
    bool in_record = false;
    while (read_line(line)) {
      if (line.empty()) continue;
      if (line[0] == '>') {
        if (in_record) offsets.push_back((int64_t)seq.size());
        size_t sp = line.find_first_of(" \t");
        names.append(line, 1, (sp == std::string::npos ? line.size() : sp) - 1);
        names.push_back('\0');
        in_record = true;
      } else if (in_record) {
        for (char c : line) seq.push_back(kTables.enc[(unsigned char)c]);
      }
    }
    if (in_record) offsets.push_back((int64_t)seq.size());
  } else {
    while (read_line(line)) {
      if (line.empty() || line[0] != '@') continue;
      size_t sp = line.find_first_of(" \t");
      names.append(line, 1, (sp == std::string::npos ? line.size() : sp) - 1);
      names.push_back('\0');
      if (!read_line(line)) break;           // sequence
      for (char c : line) seq.push_back(kTables.enc[(unsigned char)c]);
      offsets.push_back((int64_t)seq.size());
      if (!read_line(line)) break;           // '+'
      if (!read_line(line)) break;           // quals
      quals.append(line);
    }
  }
  fclose(fh);

  FastxResult* r = (FastxResult*)malloc(sizeof(FastxResult));
  r->n = (int64_t)offsets.size() - 1;
  r->total = (int64_t)seq.size();
  r->seq = (int8_t*)malloc(seq.size() ? seq.size() : 1);
  memcpy(r->seq, seq.data(), seq.size());
  r->offsets = (int64_t*)malloc(offsets.size() * sizeof(int64_t));
  memcpy(r->offsets, offsets.data(), offsets.size() * sizeof(int64_t));
  r->names = (char*)malloc(names.size() ? names.size() : 1);
  memcpy(r->names, names.data(), names.size());
  r->names_len = (int64_t)names.size();
  if (is_fastq && !quals.empty()) {
    r->quals = (char*)malloc(quals.size());
    memcpy(r->quals, quals.data(), quals.size());
  } else {
    r->quals = nullptr;
  }
  return r;
}

void fastx_free(FastxResult* r) {
  if (!r) return;
  free(r->seq);
  free(r->offsets);
  free(r->names);
  free(r->quals);
  free(r);
}

}  // extern "C"
