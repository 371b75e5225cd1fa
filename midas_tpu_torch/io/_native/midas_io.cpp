// Native FASTQ/FASTA batch reader for midas_tpu_torch.
//
// Role: the hot host-side loop of the whole framework. The reference
// pipes reads through a Python subprocess into C aligners
// (midas/run/stream_seqs.py:43-65 | hs-blastn, species.py:29-49); in
// midas_tpu_torch the aligner is the GPU, so the only host work per batch is
// parse + 2-bit encode — which in pure Python tops out around 50k
// reads/s, far below the device's appetite. This parser fills the
// caller's preallocated numpy buffers directly and sustains millions
// of reads/s.
//
// Grammar: lh3-readfq equivalent (multi-line FASTA, 4-line or
// multi-line FASTQ, qual=None -> phred 40 fill), matching
// midas_tpu_torch/io/seqio.py::read_fastx, which mirrors the reference's
// embedded readfq (midas/run/stream_seqs.py:10-41). Truncated final
// FASTQ records degrade to qual-less reads exactly like readfq.
//
// gz/plain transparency via zlib gzopen (which reads uncompressed
// files too). bz2 stays on the Python fallback path.
//
// C ABI (ctypes):
//   void*  mio_open(const char* path, int read_length, long max_reads)
//   long   mio_next_batch(void* h, long B, long L,
//                         int8_t* codes, int8_t* quals,
//                         int32_t* lengths, float* mean_qual,
//                         char* names, long names_cap, int32_t* status)
//          -> reads written; -1 = error (bad handle or corrupt gzip
//             stream); -2 = a single name exceeds names_cap (the parsed
//             record is held pending — grow the buffer and retry).
//          status: 0 = batch filled, 1 = stream exhausted (EOF or
//          max_reads), 2 = stopped early because names filled up (a
//          parsed record is held pending for the next call).
//          names: '\n'-separated, no trailing separator
//   void   mio_close(void* h)
//   long   mio_write_sites(...)  (the snps site writer; see its comment)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

constexpr int8_t PAD_CODE = 4;

struct LineReader {
  gzFile f = nullptr;
  std::vector<char> buf;
  size_t pos = 0, len = 0;
  bool eof = false;
  bool err = false;  // corrupt/truncated gzip stream (gzread < 0)

  explicit LineReader(const char* path) : buf(1 << 20) {
    f = gzopen(path, "rb");
  }
  ~LineReader() {
    if (f) gzclose(f);
  }
  bool ok() const { return f != nullptr; }

  bool fill() {
    if (eof) return false;
    int n = gzread(f, buf.data(), (unsigned)buf.size());
    if (n <= 0) {
      if (n < 0) {
        int zerrno = 0;
        gzerror(f, &zerrno);
        err = true;  // real stream error, not EOF — propagate, don't truncate
      }
      eof = true;
      return false;
    }
    pos = 0;
    len = (size_t)n;
    return true;
  }

  // Append the next line (without '\n'; a trailing '\r' is stripped so
  // CRLF input matches the text-mode universal-newline Python parsers)
  // to out. Returns false at EOF with nothing read.
  bool getline(std::string& out) {
    out.clear();
    bool any = false;
    for (;;) {
      if (pos >= len && !fill()) {
        if (any && !out.empty() && out.back() == '\r') out.pop_back();
        return any;
      }
      char* start = buf.data() + pos;
      char* nl = (char*)memchr(start, '\n', len - pos);
      if (nl) {
        out.append(start, nl - start);
        pos = (size_t)(nl - buf.data()) + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      out.append(start, len - pos);
      pos = len;
      any = true;
    }
  }
};

struct Reader {
  LineReader lr;
  int read_length;   // 0 = no trim/drop
  long max_reads;    // <0 = unlimited
  long emitted = 0;
  long truncated = 0;  // reads longer than the batch width L
  std::string last;  // pending header line ('>'/'@' line), empty if none
  std::string line, seq, qual;
  // record parsed but not yet emitted (names buffer was full)
  bool has_pending = false;
  std::string p_name, p_seq, p_qual;
  bool p_has_qual = false;

  Reader(const char* path, int rl, long mr)
      : lr(path), read_length(rl), max_reads(mr) {}

  // readfq step: parse one record. Returns false at stream end.
  bool next(std::string& name, std::string& s, std::string& q,
            bool& has_qual) {
    if (last.empty()) {
      while (lr.getline(line)) {
        if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
          last = line;
          break;
        }
      }
      if (last.empty()) return false;
    }
    size_t sp = last.find(' ');
    name.assign(last, 1, sp == std::string::npos ? std::string::npos : sp - 1);
    s.clear();
    last.clear();
    bool have_last = false;
    while (lr.getline(line)) {
      if (!line.empty() &&
          (line[0] == '@' || line[0] == '+' || line[0] == '>')) {
        last = line;
        have_last = true;
        break;
      }
      s += line;
    }
    if (!have_last || last[0] != '+') {
      has_qual = false;  // FASTA (or trailing header-less EOF)
      return true;
    }
    // FASTQ quality lines until length matches
    last.clear();
    q.clear();
    while (q.size() < s.size() && lr.getline(line)) q += line;
    if (q.size() >= s.size()) {
      has_qual = true;
      q.resize(s.size());
    } else {
      has_qual = false;  // truncated record: degrade like readfq
    }
    return true;
  }
};

int8_t g_base_code[256];
struct InitTables {
  InitTables() {
    memset(g_base_code, PAD_CODE, sizeof(g_base_code));
    const char* b = "ACGT";
    for (int i = 0; i < 4; i++) {
      g_base_code[(unsigned char)b[i]] = (int8_t)i;
      g_base_code[(unsigned char)(b[i] + 32)] = (int8_t)i;
    }
  }
} g_init_tables;

}  // namespace

extern "C" {

long mio_truncated(void* h) {
  Reader* r = (Reader*)h;
  return r ? r->truncated : 0;
}

void* mio_open(const char* path, int read_length, long max_reads) {
  Reader* r = new Reader(path, read_length, max_reads);
  if (!r->lr.ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

long mio_next_batch(void* h, long B, long L, int8_t* codes, int8_t* quals,
                    int32_t* lengths, float* mean_qual, char* names,
                    long names_cap, int32_t* status) {
  Reader* r = (Reader*)h;
  if (!r) return -1;
  *status = 0;
  memset(codes, PAD_CODE, (size_t)(B * L));
  memset(quals, 0, (size_t)(B * L));
  memset(lengths, 0, (size_t)B * sizeof(int32_t));
  memset(mean_qual, 0, (size_t)B * sizeof(float));
  long nb = 0, npos = 0;
  std::string name, s, q;
  bool has_qual;
  while (nb < B) {
    if (r->has_pending) {
      name.swap(r->p_name);
      s.swap(r->p_seq);
      q.swap(r->p_qual);
      has_qual = r->p_has_qual;
      r->has_pending = false;
    } else {
      if (r->max_reads >= 0 && r->emitted >= r->max_reads) {
        *status = 1;
        break;
      }
      if (!r->next(name, s, q, has_qual)) {
        if (r->lr.err) return -1;  // corrupt gzip stream, not EOF
        *status = 1;
        break;
      }
      if (r->read_length > 0) {
        if ((long)s.size() < (long)r->read_length) continue;
        s.resize(r->read_length);
        if (has_qual) q.resize(r->read_length);
      }
    }
    if (npos + (long)name.size() + 1 > names_cap) {
      // The record has already been consumed from the stream — stash it
      // so it is emitted on the retry / next call instead of dropped.
      r->p_name.swap(name);
      r->p_seq.swap(s);
      r->p_qual.swap(q);
      r->p_has_qual = has_qual;
      r->has_pending = true;
      if (nb == 0) return -2;  // caller must grow the names buffer
      *status = 2;
      break;
    }
    long n = (long)s.size();
    if (n > L) { n = L; r->truncated++; }
    int8_t* crow = codes + nb * L;
    for (long i = 0; i < n; i++)
      crow[i] = g_base_code[(unsigned char)s[i]];
    int8_t* qrow = quals + nb * L;
    long qsum = 0;
    if (has_qual) {
      for (long i = 0; i < n; i++) {
        int v = (unsigned char)q[i] - 33;
        qrow[i] = (int8_t)v;
        qsum += v;
      }
    } else {
      memset(qrow, 40, (size_t)n);
      qsum = 40 * n;
    }
    lengths[nb] = (int32_t)n;
    mean_qual[nb] = n ? (float)qsum / (float)n : 0.0f;
    memcpy(names + npos, name.data(), name.size());
    npos += (long)name.size();
    names[npos++] = '\n';
    nb++;
    r->emitted++;
  }
  if (npos > 0) names[npos - 1] = '\0';
  else if (names_cap > 0) names[0] = '\0';
  return nb;
}

void mio_close(void* h) { delete (Reader*)h; }

// Scan an ENTIRE file for its longest read — the padded-batch bucket
// must cover the longest read in the library, and sampling only the
// file head silently truncated libraries whose long reads appear later
// (mixed-length or length-sorted input). A dedicated scan loop (no
// array fills) runs at several million reads/s, so a full pass costs
// seconds even on 10M-read files. Returns the max length (0 for an
// empty file), -1 on open failure.
long mio_max_read_len(const char* path) {
  Reader r(path, 0, -1);
  if (!r.lr.ok()) return -1;
  std::string name, s, q;
  bool hq;
  long mx = 0;
  while (r.next(name, s, q, hq)) {
    if ((long)s.size() > mx) mx = (long)s.size();
  }
  if (r.lr.err) return -1;
  return mx;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The snps site writer: one species' <species>.snps.gz, the rows of
// midas_tpu_torch/profile/snps.py::_site_rows,
//   name \t pos (1-based) \t allele (ACGTN) \t depth \t a \t c \t g \t t \n
// after a header line, as ONE gzip member deflated at level 9.
//
// The species' sites (its contigs concatenated in the caller's order) are
// cut into chunks of SITES_PER_CHUNK sites (~1 MiB of text; a chunk may
// span contigs). Each worker thread takes a chunk, formats its rows and
// deflates them as raw deflate at level 9, primed with the last 32 KiB of
// the text before the chunk, which the worker formats itself from the
// preceding sites (the pigz scheme); every chunk but the last ends in a
// sync flush, the last in Z_FINISH. The chunks, in order, are one deflate
// stream; a gzip header and a trailer of the CRC32 (combined over the
// chunks) and ISIZE make the file. The chunking and priming are fixed, so
// the compressed bytes do not depend on the number of threads.
namespace {

constexpr int64_t SITES_PER_CHUNK = 1 << 15;
constexpr size_t DICT_BYTES = 32768;   // deflate's window
constexpr size_t ROW_FIXED = 6 * 20 + 9;   // a row's most bytes beyond the name

struct SiteTable {
  const char* header;
  size_t header_len;
  int64_t n_contigs;
  const char* names;          // concatenated, name_off[j] .. name_off[j + 1]
  const int64_t* name_off;
  const int64_t* lo;          // contig j's sites are pack indices [lo, hi)
  const int64_t* hi;
  std::vector<int64_t> first;   // the species-wide index of contig j's first site
  const int8_t* codes;
  const int64_t* depth;
  const char* counts;         // 4 rows of `stride` elements of `itemsize` bytes
  int itemsize;
  int64_t stride;

  int64_t n_sites() const { return first[n_contigs]; }

  int64_t count(int row, int64_t i) const {
    const char* p = counts + (row * stride + i) * itemsize;
    if (itemsize == 4) return *(const int32_t*)p;
    return *(const int64_t*)p;
  }
};

inline char* put_int(char* p, int64_t v) {
  uint64_t u = (uint64_t)v;
  if (v < 0) {
    *p++ = '-';
    u = 0 - u;
  }
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + u % 10);
    u /= 10;
  } while (u);
  while (n) *p++ = tmp[--n];
  return p;
}

// Append the rows of species-wide sites [s0, s1) to out. False on an
// allele code outside 0..4.
bool format_rows(const SiteTable& T, int64_t s0, int64_t s1,
                 std::string& out) {
  if (s0 >= s1) return true;
  int64_t j = std::upper_bound(T.first.begin(), T.first.end(), s0) -
              T.first.begin() - 1;
  int64_t s = s0;
  while (s < s1) {
    while (T.first[j + 1] <= s) j++;   // skips empty contigs
    int64_t end = std::min(s1, T.first[j + 1]);
    const char* name = T.names + T.name_off[j];
    size_t nlen = (size_t)(T.name_off[j + 1] - T.name_off[j]);
    size_t at = out.size();
    out.resize(at + (size_t)(end - s) * (nlen + ROW_FIXED));
    char* p = &out[at];
    for (int64_t k = s; k < end; k++) {
      int64_t pos = k - T.first[j];          // 0-based within the contig
      int64_t i = T.lo[j] + pos;             // pack index
      int8_t c = T.codes[i];
      if (c < 0 || c > 4) return false;
      memcpy(p, name, nlen);
      p += nlen;
      *p++ = '\t';
      p = put_int(p, pos + 1);
      *p++ = '\t';
      *p++ = "ACGTN"[c];
      *p++ = '\t';
      p = put_int(p, T.depth[i]);
      for (int r = 0; r < 4; r++) {
        *p++ = '\t';
        p = put_int(p, T.count(r, i));
      }
      *p++ = '\n';
    }
    out.resize((size_t)(p - out.data()));
    s = end;
  }
  return true;
}

// The last DICT_BYTES of the text before species-wide site s0 (header
// included): formats as few preceding sites as reach that length.
bool dict_before(const SiteTable& T, int64_t s0, std::string& dict) {
  int64_t back = 2048;
  for (;;) {
    int64_t from = std::max<int64_t>(0, s0 - back);
    dict.clear();
    if (from == 0) dict.assign(T.header, T.header_len);
    if (!format_rows(T, from, s0, dict)) return false;
    if (dict.size() >= DICT_BYTES || from == 0) break;
    back *= 2;
  }
  if (dict.size() > DICT_BYTES) dict.erase(0, dict.size() - DICT_BYTES);
  return true;
}

struct Chunk {
  std::string gz;
  uLong crc = 0;
  size_t len = 0;
};

// Format and deflate chunk k of n. 0, or a negative error code.
int make_chunk(const SiteTable& T, int64_t k, int64_t n, Chunk& out,
               std::string& text, std::string& dict) {
  int64_t s0 = k * SITES_PER_CHUNK;
  int64_t s1 = std::min(T.n_sites(), s0 + SITES_PER_CHUNK);
  text.clear();
  if (k == 0) text.assign(T.header, T.header_len);
  if (!format_rows(T, s0, s1, text)) return -3;
  if (k > 0 && !dict_before(T, s0, dict)) return -3;
  out.len = text.size();
  out.crc = crc32(0L, (const Bytef*)text.data(), (uInt)text.size());
  z_stream z;
  memset(&z, 0, sizeof(z));
  if (deflateInit2(&z, 9, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return -2;
  if (k > 0 &&
      deflateSetDictionary(&z, (const Bytef*)dict.data(), (uInt)dict.size()) !=
          Z_OK) {
    deflateEnd(&z);
    return -2;
  }
  int flush = k + 1 == n ? Z_FINISH : Z_SYNC_FLUSH;
  out.gz.resize(deflateBound(&z, (uLong)text.size()) + 64);
  z.next_in = (Bytef*)text.data();
  z.avail_in = (uInt)text.size();
  size_t done = 0;
  for (;;) {
    z.next_out = (Bytef*)&out.gz[done];
    z.avail_out = (uInt)(out.gz.size() - done);
    int rc = deflate(&z, flush);
    done = out.gz.size() - z.avail_out;
    if (rc == Z_STREAM_ERROR) {
      deflateEnd(&z);
      return -2;
    }
    bool finished = flush == Z_FINISH ? rc == Z_STREAM_END
                                      : (z.avail_in == 0 && z.avail_out > 0);
    if (finished) break;
    out.gz.resize(out.gz.size() * 2);
  }
  out.gz.resize(done);
  deflateEnd(&z);
  return 0;
}

void put_le32(unsigned char* p, uint32_t v) {
  for (int i = 0; i < 4; i++) p[i] = (unsigned char)(v >> (8 * i));
}

}  // namespace

extern "C" {

// Write one species' .snps.gz (see the comment above the namespace).
//   path, header (header_len bytes, its '\n' included)
//   n_contigs contigs: names (concatenated; contig j is name_off[j] ..
//     name_off[j + 1]) and pack indices [lo[j], hi[j])
//   codes (int8, 0..4), depth (int64): indexed by pack index
//   counts: 4 rows of `stride` elements of itemsize 4 (int32) or 8 (int64)
//   threads: worker threads, capped at the number of chunks
//   stats[5] out: sites, chunks, threads, text bytes, file bytes
// Returns 0; -1 the file could not be written; -2 a zlib error; -3 an
// allele code outside 0..4; -4 a bad argument.
long mio_write_sites(const char* path, const char* header, long header_len,
                     long n_contigs, const char* names,
                     const int64_t* name_off, const int64_t* lo,
                     const int64_t* hi, const int8_t* codes,
                     const int64_t* depth, const void* counts, int itemsize,
                     long stride, int threads, int64_t* stats) {
  if ((itemsize != 4 && itemsize != 8) || n_contigs < 0 || header_len < 0)
    return -4;
  SiteTable T{header, (size_t)header_len, n_contigs, names, name_off, lo, hi,
              {}, codes, depth, (const char*)counts, itemsize, stride};
  T.first.resize((size_t)n_contigs + 1);
  T.first[0] = 0;
  for (long j = 0; j < n_contigs; j++) {
    if (hi[j] < lo[j]) return -4;
    T.first[j + 1] = T.first[j] + (hi[j] - lo[j]);
  }
  int64_t n_chunks =
      std::max<int64_t>(1, (T.n_sites() + SITES_PER_CHUNK - 1) /
                               SITES_PER_CHUNK);
  int n_threads = (int)std::max<int64_t>(1, std::min<int64_t>(threads,
                                                              n_chunks));
  std::vector<Chunk> chunks((size_t)n_chunks);
  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};
  auto work = [&]() {
    std::string text, dict;
    for (;;) {
      int64_t k = next.fetch_add(1);
      if (k >= n_chunks || err.load()) return;
      int rc = make_chunk(T, k, n_chunks, chunks[(size_t)k], text, dict);
      if (rc) err.store(rc);
    }
  };
  std::vector<std::thread> pool;
  try {
    for (int t = 1; t < n_threads; t++) pool.emplace_back(work);
  } catch (const std::exception&) {
    // no more threads to be had: the ones started and this one share the chunks
  }
  n_threads = (int)pool.size() + 1;
  work();
  for (auto& t : pool) t.join();
  if (err.load()) return err.load();

  uLong crc = 0;
  uint64_t text_bytes = 0;
  for (const Chunk& c : chunks) {
    crc = crc32_combine(crc, c.crc, (z_off_t)c.len);
    text_bytes += c.len;
  }
  // gzip header: deflate, no flags, no mtime, XFL 2 (best compression),
  // OS 3 (Unix)
  const unsigned char head[10] = {0x1f, 0x8b, 8, 0, 0, 0, 0, 0, 2, 3};
  unsigned char tail[8];
  put_le32(tail, (uint32_t)crc);
  put_le32(tail + 4, (uint32_t)text_bytes);
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint64_t file_bytes = sizeof(head) + sizeof(tail);
  bool ok = fwrite(head, 1, sizeof(head), f) == sizeof(head);
  for (const Chunk& c : chunks) {
    ok = ok && fwrite(c.gz.data(), 1, c.gz.size(), f) == c.gz.size();
    file_bytes += c.gz.size();
  }
  ok = ok && fwrite(tail, 1, sizeof(tail), f) == sizeof(tail);
  ok = (fclose(f) == 0) && ok;
  if (!ok) return -1;
  stats[0] = T.n_sites();
  stats[1] = n_chunks;
  stats[2] = n_threads;
  stats[3] = (int64_t)text_bytes;
  stats[4] = (int64_t)file_bytes;
  return 0;
}

}  // extern "C"
