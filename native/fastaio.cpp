// Native FASTA ingest: parse + validate + 2-bit-encode at memory bandwidth.
//
// Replacement for the reference's buffered char-at-a-time parser
// (streamfastaparser.cpp:29-93) on the host side of the pipeline: the
// device consumes codes far faster than a char-at-a-time loop makes
// them, so the host encoder must not be the bottleneck. Single pass over the raw bytes with a 256-entry code
// table; semantics identical to the reference:
//   - header = first whitespace-delimited token after '>'
//   - whitespace in bodies skipped; chars uppercased via the table
//   - valid chars "ACGTURYKMSWBDHWNXV" (case-insensitive); ACGT -> 0..3,
//     other valid -> 4 (N); anything else -> error
//
// C ABI (used from Python via ctypes):
//   tp_encode_fasta(path, out) -> 0 ok / negative errno-ish codes
//   caller reads record spans from the result struct, then frees it.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct CodeTable {
  uint8_t code[256];
  CodeTable() {
    memset(code, 255, sizeof(code));
    const char* ws = " \t\r\n\v\f";
    for (const char* p = ws; *p; ++p) code[(uint8_t)*p] = 254;
    const char* valid = "ACGTURYKMSWBDHWNXV";
    for (const char* p = valid; *p; ++p) {
      code[(uint8_t)*p] = 4;
      code[(uint8_t)(*p + 32)] = 4;  // lowercase
    }
    const char* lit = "ACGT";
    for (int i = 0; i < 4; ++i) {
      code[(uint8_t)lit[i]] = (uint8_t)i;
      code[(uint8_t)(lit[i] + 32)] = (uint8_t)i;
    }
  }
};
const CodeTable kTable;

}  // namespace

extern "C" {

struct TpFastaResult {
  uint8_t* codes;        // concatenated encoded bodies
  int64_t codes_len;
  int64_t* rec_offsets;  // n_records+1 offsets into codes
  int64_t n_records;
  char* headers;         // '\0'-joined header tokens
  int64_t headers_len;
  char error[256];
};

// Encode one file into a CALLER-PROVIDED codes buffer (cap bytes; the
// file size is always enough). Streams the file through a small reused
// chunk, so the only multi-GB memory touched is the caller's buffer —
// which Python hands in from its warm shared-anon pool
// (twopaco_tpu/hostmem.py: private-anon first-touch costs ~12-25 s/GB
// on the target VM, shared-anon ~0.9 s/GB, and a pooled buffer is
// free). result->codes is left NULL: the caller owns the codes.
// Returns 0 on success; negative with result->error otherwise.
int tp_encode_fasta_into(const char* path, uint8_t* codes, int64_t cap,
                         TpFastaResult* out) {
  memset(out, 0, sizeof(*out));
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(out->error, sizeof(out->error), "Can't open file %s", path);
    return -1;
  }
  const size_t CH = 8 << 20;
  std::vector<uint8_t> buf(CH);
  std::vector<int64_t> offsets;
  std::string headers;
  std::string hdr_line;
  int64_t n_codes = 0;
  enum { BODY, HEADER } st = BODY;
  bool first = true;
  bool in_any_record = false;
  for (;;) {
    size_t got = fread(buf.data(), 1, CH, f);
    if (got == 0) {
      // distinguish EOF from an I/O error: a transient read failure
      // must not silently truncate the genome (byte-parity invariant)
      if (ferror(f)) {
        fclose(f);
        snprintf(out->error, sizeof(out->error),
                 "Short read (I/O error) in %s", path);
        return -2;
      }
      break;
    }
    size_t i = 0;
    if (first) {
      if (buf[0] != '>') {
        fclose(f);
        snprintf(out->error, sizeof(out->error),
                 "The FASTA header should start with a '>'");
        return -3;
      }
      first = false;
    }
    while (i < got) {
      if (st == HEADER) {
        size_t j = i;
        while (j < got && buf[j] != '\n') ++j;
        hdr_line.append((const char*)buf.data() + i, j - i);
        i = j;
        if (i < got) {  // newline: header line complete, body starts
          ++i;
          size_t hs = 0, n = hdr_line.size();
          while (hs < n && (hdr_line[hs] == ' ' || hdr_line[hs] == '\t'))
            ++hs;
          size_t he = hs;
          while (he < n && hdr_line[he] != ' ' && hdr_line[he] != '\t' &&
                 hdr_line[he] != '\r')
            ++he;
          headers.append(hdr_line, hs, he - hs);
          headers.push_back('\0');
          offsets.push_back(n_codes);
          st = BODY;
        }
        continue;
      }
      // BODY (or before the first record): next record at any '>',
      // even mid-line (reference streamfastaparser.cpp:73-77)
      const uint8_t* gt =
          (const uint8_t*)memchr(buf.data() + i, '>', got - i);
      size_t stop = gt ? (size_t)(gt - buf.data()) : got;
      if (in_any_record) {
        if (n_codes + (int64_t)(stop - i) > cap) {
          fclose(f);
          snprintf(out->error, sizeof(out->error),
                   "codes buffer too small (%lld)", (long long)cap);
          return -5;
        }
        uint8_t bad = 0;
        int64_t n = n_codes;
        for (size_t j = i; j < stop; ++j) {
          uint8_t c = kTable.code[buf[j]];
          codes[n] = c;
          n += (c < 5);  // branchless append; 254 (ws) overwritten
          bad |= (uint8_t)(c == 255);
        }
        if (bad) {
          for (size_t j = i; j < stop; ++j) {
            if (kTable.code[buf[j]] == 255) {
              snprintf(out->error, sizeof(out->error),
                       "Found an invalid character '%c' in %s",
                       buf[j], path);
              break;
            }
          }
          fclose(f);
          return -4;
        }
        n_codes = n;
      }
      i = stop;
      if (gt) {  // start of the next record
        ++i;
        st = HEADER;
        hdr_line.clear();
        in_any_record = true;
      }
    }
  }
  fclose(f);
  if (st == HEADER) {  // EOF inside the header line: empty body
    size_t hs = 0, n = hdr_line.size();
    while (hs < n && (hdr_line[hs] == ' ' || hdr_line[hs] == '\t')) ++hs;
    size_t he = hs;
    while (he < n && hdr_line[he] != ' ' && hdr_line[he] != '\t' &&
           hdr_line[he] != '\r')
      ++he;
    headers.append(hdr_line, hs, he - hs);
    headers.push_back('\0');
    offsets.push_back(n_codes);
  }
  offsets.push_back(n_codes);
  out->codes = NULL;  // caller-owned
  out->codes_len = n_codes;
  out->n_records = (int64_t)offsets.size() - 1;
  out->rec_offsets = (int64_t*)malloc(offsets.size() * sizeof(int64_t));
  memcpy(out->rec_offsets, offsets.data(),
         offsets.size() * sizeof(int64_t));
  out->headers_len = (int64_t)headers.size();
  out->headers = (char*)malloc(headers.size() ? headers.size() : 1);
  memcpy(out->headers, headers.data(), headers.size());
  return 0;
}

// Encode one file. Returns 0 on success; on failure a negative code with
// result->error describing the problem.
int tp_encode_fasta(const char* path, TpFastaResult* out) {
  memset(out, 0, sizeof(*out));
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(out->error, sizeof(out->error), "Can't open file %s", path);
    return -1;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)sz);
  if (sz > 0 && fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    fclose(f);
    snprintf(out->error, sizeof(out->error), "Short read on %s", path);
    return -2;
  }
  fclose(f);

  std::vector<uint8_t> codes;
  codes.reserve(buf.size());
  std::vector<int64_t> offsets;
  std::string headers;

  size_t i = 0;
  const size_t n = buf.size();
  if (n == 0) {
    out->rec_offsets = (int64_t*)malloc(sizeof(int64_t));
    out->rec_offsets[0] = 0;
    return 0;
  }
  if (buf[0] != '>') {
    snprintf(out->error, sizeof(out->error),
             "The FASTA header should start with a '>'");
    return -3;
  }
  while (i < n) {
    // at a record start: buf[i] == '>'
    ++i;
    size_t line_end = i;
    while (line_end < n && buf[line_end] != '\n') ++line_end;
    // header token: first whitespace-delimited token
    size_t hs = i;
    while (hs < line_end && (buf[hs] == ' ' || buf[hs] == '\t')) ++hs;
    size_t he = hs;
    while (he < line_end && buf[he] != ' ' && buf[he] != '\t' &&
           buf[he] != '\r')
      ++he;
    headers.append((const char*)buf.data() + hs, he - hs);
    headers.push_back('\0');
    offsets.push_back((int64_t)codes.size());

    i = line_end < n ? line_end + 1 : n;
    // any '>' in a body — even mid-line — starts the next record: the
    // reference's GetChar ends the record on '>' unconditionally
    // (streamfastaparser.cpp:73-77), verified by the acceptance fuzz
    // against the reference binary (tests/test_fasta_fuzz.py)
    while (i < n && buf[i] != '>') {
      uint8_t c = kTable.code[buf[i]];
      if (c < 5) {
        codes.push_back(c);
      } else if (c == 255) {
        snprintf(out->error, sizeof(out->error),
                 "Found an invalid character '%c' in %s", buf[i], path);
        return -4;
      }
      ++i;
    }
  }
  offsets.push_back((int64_t)codes.size());

  out->codes_len = (int64_t)codes.size();
  out->codes = (uint8_t*)malloc(codes.size() ? codes.size() : 1);
  memcpy(out->codes, codes.data(), codes.size());
  out->n_records = (int64_t)offsets.size() - 1;
  out->rec_offsets = (int64_t*)malloc(offsets.size() * sizeof(int64_t));
  memcpy(out->rec_offsets, offsets.data(), offsets.size() * sizeof(int64_t));
  out->headers_len = (int64_t)headers.size();
  out->headers = (char*)malloc(headers.size() ? headers.size() : 1);
  memcpy(out->headers, headers.data(), headers.size());
  return 0;
}

void tp_free_result(TpFastaResult* r) {
  free(r->codes);
  free(r->rec_offsets);
  free(r->headers);
  memset(r, 0, sizeof(*r));
}

// 12-byte junction records (uint32 pos + int64 id, little-endian) with
// separator records auto-inserted at chromosome increments — exactly
// the reference JunctionPositionWriter (junctionapi.h:118-132). `out`
// must hold 12 * (n + chrs[n-1] - now_chr) bytes; returns bytes
// written. One pass instead of numpy's strided scatter + copy chain.
int64_t tp_emit_records(const int64_t* chrs, const uint32_t* pos,
                        const int64_t* ids, int64_t n, int64_t now_chr,
                        uint8_t* out) {
  uint8_t* p = out;
  int64_t cur = now_chr;
  const uint32_t sep_pos = 0xFFFFFFFFu;
  const int64_t sep_id = INT64_MAX;
  for (int64_t i = 0; i < n; ++i) {
    for (; cur < chrs[i]; ++cur) {
      memcpy(p, &sep_pos, 4);
      memcpy(p + 4, &sep_id, 8);
      p += 12;
    }
    memcpy(p, &pos[i], 4);
    memcpy(p + 4, &ids[i], 8);
    p += 12;
  }
  return (int64_t)(p - out);
}

}  // extern "C"
