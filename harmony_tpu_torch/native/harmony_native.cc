// harmony_tpu_torch native runtime pieces (C ABI, loaded via ctypes).
//
// A copy of the reference package's native/harmony_native.cc: the port's
// checkpoint files are the reference's bytes, so both packages build the same
// source. The host-side data planes:
//
//   * ht_parse_libsvm — the data-loader hot loop (text records → dense
//     feature matrix), ~20-40x the CPython per-token cost of the pure-Python
//     parser (ref path: HdfsSplitFetcher.fetchData → DataParser).
//   * ht_blk_write / ht_blk_read — per-block checkpoint files with a CRC32
//     integrity footer, the durable-commit analogue of ChkpManagerSlave's
//     temp→HDFS two-stage files (evaluator/impl/ChkpManagerSlave.java:50-63).
//     Read verifies the checksum so a torn/corrupt block fails restore
//     loudly instead of feeding garbage into a model table.
//
// Build: g++ -O3 -shared -fPIC (driven lazily by harmony_tpu_torch/native).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32 (IEEE 802.3, table-driven)
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];
static int crc_ready = 0;

static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_ready = 1;
}

uint32_t ht_crc32(const uint8_t* data, uint64_t len) {
  if (!crc_ready) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; i++)
    c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// LibSVM parsing: "label idx:val idx:val ...\n" → dense x [rows, F] + y
// ---------------------------------------------------------------------------

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

// Returns number of rows parsed, -1 if more than max_rows lines present,
// or -2 on a malformed record (unparseable label or feature token) — strict
// parity with the Python parser, which raises on corrupt data instead of
// silently training on it. Out-of-range feature indices are ignored (also
// parity).
int64_t ht_parse_libsvm(const char* buf, uint64_t len, int32_t num_features,
                        int32_t base, float* x, float* y, int64_t max_rows) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') { p++; continue; }  // blank line
    if (row >= max_rows) return -1;
    char* next = nullptr;
    y[row] = strtof(p, &next);
    if (next == p) return -2;  // label is not a number
    p = next;
    float* xrow = x + (uint64_t)row * num_features;
    while (p < end && *p != '\n') {
      p = skip_ws(p, end);
      if (p >= end || *p == '\n') break;
      long idx = strtol(p, &next, 10);
      if (next == p || next >= end || *next != ':') return -2;
      p = next + 1;  // past ':'
      float val = strtof(p, &next);
      if (next == p) return -2;  // "idx:" with no value
      p = next;
      long j = idx - base;
      if (j >= 0 && j < num_features) xrow[j] = val;
    }
    if (p < end) p++;  // consume '\n'
    row++;
  }
  return row;
}

// ---------------------------------------------------------------------------
// Block files.
//   v1 "HTB1": [magic u32][dtype u32][ndim u32][shape u64 x ndim]
//              [payload bytes][crc32 u32 of payload]
//   v2 "HTB2": [magic u32][dtype u32][ndim u32][shape u64 x ndim]
//              [raw u64][comp u64][payload comp bytes][crc32 u32 of RAW]
//   v2 adds zlib payload compression (comp == raw means stored raw; the
//   writer keeps whichever is smaller). The CRC always covers the RAW
//   bytes, so a bad inflate fails the same check as bit rot. Durable
//   commit to object stores is the reason this exists: the two-stage
//   protocol (ChkpManagerSlave.java:50-63 temp->HDFS) moves every block
//   over the network twice.
// ---------------------------------------------------------------------------

static const uint32_t BLK_MAGIC = 0x48544231u;   // "HTB1"
static const uint32_t BLK_MAGIC2 = 0x48544232u;  // "HTB2"
#define BLK_MAX_NDIM 8

// 0 on success, negative on error.
int32_t ht_blk_write(const char* path, const void* data, uint64_t nbytes,
                     const uint64_t* shape, int32_t ndim, int32_t dtype_code) {
  if (ndim < 0 || ndim > BLK_MAX_NDIM) return -2;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t head[3] = {BLK_MAGIC, (uint32_t)dtype_code, (uint32_t)ndim};
  uint32_t crc = ht_crc32((const uint8_t*)data, nbytes);
  int ok = fwrite(head, sizeof(head), 1, f) == 1 &&
           (ndim == 0 || fwrite(shape, sizeof(uint64_t), ndim, f) == (size_t)ndim) &&
           (nbytes == 0 || fwrite(data, 1, nbytes, f) == nbytes) &&
           fwrite(&crc, sizeof(crc), 1, f) == 1;
  ok = (fflush(f) == 0) && ok;
  ok = (fclose(f) == 0) && ok;
  return ok ? 0 : -3;
}

// v2 writer: zlib-compress the payload at `level` (1..9; <=0 stores raw).
// Keeps whichever of raw/compressed is smaller. 0 on success.
int32_t ht_blk_write2(const char* path, const void* data, uint64_t nbytes,
                      const uint64_t* shape, int32_t ndim, int32_t dtype_code,
                      int32_t level) {
  if (ndim < 0 || ndim > BLK_MAX_NDIM) return -2;
  uint8_t* comp_buf = nullptr;
  uint64_t comp_n = nbytes;  // == raw means "stored raw"
  if (level > 0 && nbytes > 0) {
    uLongf bound = compressBound((uLong)nbytes);
    comp_buf = (uint8_t*)malloc(bound);
    if (!comp_buf) return -7;
    uLongf got = bound;
    if (compress2(comp_buf, &got, (const Bytef*)data, (uLong)nbytes,
                  level > 9 ? 9 : level) == Z_OK &&
        (uint64_t)got < nbytes) {
      comp_n = (uint64_t)got;
    } else {
      free(comp_buf);
      comp_buf = nullptr;  // incompressible: store raw
    }
  }
  FILE* f = fopen(path, "wb");
  if (!f) {
    free(comp_buf);
    return -1;
  }
  uint32_t head[3] = {BLK_MAGIC2, (uint32_t)dtype_code, (uint32_t)ndim};
  uint64_t sizes[2] = {nbytes, comp_n};
  uint32_t crc = ht_crc32((const uint8_t*)data, nbytes);
  const void* payload = comp_buf ? (const void*)comp_buf : data;
  int ok = fwrite(head, sizeof(head), 1, f) == 1 &&
           (ndim == 0 || fwrite(shape, sizeof(uint64_t), ndim, f) == (size_t)ndim) &&
           fwrite(sizes, sizeof(uint64_t), 2, f) == 2 &&
           (comp_n == 0 || fwrite(payload, 1, comp_n, f) == comp_n) &&
           fwrite(&crc, sizeof(crc), 1, f) == 1;
  ok = (fflush(f) == 0) && ok;
  ok = (fclose(f) == 0) && ok;
  free(comp_buf);
  return ok ? 0 : -3;
}

// Phase 1 (out == NULL): fills *dtype_out, *ndim_out, shape_out and returns
// the RAW payload byte count. Phase 2 (out != NULL, out_cap >= nbytes):
// copies (v2: inflates) the payload, verifies the raw CRC. Returns nbytes
// on success; negative on error (-4 bad magic / truncated header,
// -5 payload/out_cap mismatch, -6 CRC mismatch — the corrupt-block signal,
// -7 OOM, -8 inflate failure).
int64_t ht_blk_read(const char* path, void* out, uint64_t out_cap,
                    uint64_t* shape_out, int32_t* ndim_out,
                    int32_t* dtype_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t head[3];
  if (fread(head, sizeof(head), 1, f) != 1 ||
      (head[0] != BLK_MAGIC && head[0] != BLK_MAGIC2) ||
      head[2] > BLK_MAX_NDIM) {
    fclose(f);
    return -4;
  }
  int is_v2 = head[0] == BLK_MAGIC2;
  int32_t ndim = (int32_t)head[2];
  uint64_t shape[BLK_MAX_NDIM];
  if (ndim > 0 && fread(shape, sizeof(uint64_t), ndim, f) != (size_t)ndim) {
    fclose(f);
    return -4;
  }
  uint64_t raw_n = 0, comp_n = 0;
  if (is_v2) {
    uint64_t sizes[2];
    if (fread(sizes, sizeof(uint64_t), 2, f) != 2) { fclose(f); return -4; }
    raw_n = sizes[0];
    comp_n = sizes[1];
    // Sanity-bound the header-carried sizes BEFORE anyone allocates from
    // them: a bit flip in raw_n must fail like any other corruption, not
    // drive an unbounded allocation in the caller. zlib's worst-case
    // expansion is < 1032x (+ small constant); comp > raw never happens
    // (the writer stores raw in that case).
    if (comp_n > raw_n ||
        (comp_n != raw_n && raw_n > comp_n * 1032 + 1024)) {
      fclose(f);
      return -4;
    }
  }
  long data_start = ftell(f);
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -4; }
  long file_end = ftell(f);
  int64_t stored = file_end - data_start - (long)sizeof(uint32_t);
  if (stored < 0) { fclose(f); return -4; }
  if (!is_v2) {
    raw_n = comp_n = (uint64_t)stored;
  } else if ((uint64_t)stored != comp_n) {
    fclose(f);
    return -4;  // truncated payload
  }
  if (dtype_out) *dtype_out = (int32_t)head[1];
  if (ndim_out) *ndim_out = ndim;
  if (shape_out)
    for (int32_t i = 0; i < ndim; i++) shape_out[i] = shape[i];
  if (!out) {  // metadata probe
    fclose(f);
    return (int64_t)raw_n;
  }
  if (raw_n > out_cap) { fclose(f); return -5; }
  if (fseek(f, data_start, SEEK_SET) != 0) { fclose(f); return -4; }
  int64_t rc = (int64_t)raw_n;
  if (comp_n == raw_n) {  // stored raw (v1, or incompressible v2)
    if (raw_n > 0 && fread(out, 1, (size_t)raw_n, f) != (size_t)raw_n) rc = -4;
  } else {
    uint8_t* comp_buf = (uint8_t*)malloc(comp_n ? comp_n : 1);
    if (!comp_buf) { fclose(f); return -7; }
    if (fread(comp_buf, 1, (size_t)comp_n, f) != (size_t)comp_n) {
      rc = -4;
    } else {
      uLongf got = (uLongf)raw_n;
      if (uncompress((Bytef*)out, &got, comp_buf, (uLong)comp_n) != Z_OK ||
          (uint64_t)got != raw_n)
        rc = -8;
    }
    free(comp_buf);
  }
  uint32_t crc_stored = 0;
  if (rc >= 0 && fread(&crc_stored, sizeof(crc_stored), 1, f) != 1) rc = -4;
  fclose(f);
  if (rc >= 0 &&
      ht_crc32((const uint8_t*)out, raw_n) != crc_stored)
    return -6;
  return rc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Prefetching split loader: an ordered background reader pool.
//
// The reference overlaps training with data arrival only at bulk-load time
// (HDFS client threads inside TableLoadMsg handling); here a C++ worker pool
// reads split byte-ranges ahead of the training loop with bounded lookahead,
// delivering splits IN ORDER so epoch composition stays deterministic.
// Record-boundary semantics replicate harmony_tpu/data/splits.py
// _fetch_range exactly (LineRecordReader alignment: a record belongs to the
// split containing its first byte; the last record is finished by reading
// past the range end) — parity is pinned by tests/test_native.py.
// ---------------------------------------------------------------------------

#include <condition_variable>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

int fetch_range_cc(const std::string& path, uint64_t offset, uint64_t length,
                   std::string& out) {
  if (length == 0) return 0;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return -1;
  std::string chunk;
  if (offset > 0) {
    if (fseeko(f, (off_t)(offset - 1), SEEK_SET) != 0) { fclose(f); return -1; }
    chunk.resize(length + 1);
    size_t got = fread(&chunk[0], 1, length + 1, f);
    chunk.resize(got);
    size_t nl = chunk.find('\n');
    if (nl == std::string::npos) { fclose(f); return 0; }  // mid-record range
    chunk.erase(0, nl + 1);
    if (chunk.empty()) { fclose(f); return 0; }  // no record starts here
  } else {
    chunk.resize(length);
    size_t got = fread(&chunk[0], 1, length, f);
    chunk.resize(got);
  }
  if (chunk.empty() || chunk.back() != '\n') {
    char buf[4096];
    for (;;) {
      size_t got = fread(buf, 1, sizeof buf, f);
      if (!got) break;
      char* nl = (char*)memchr(buf, '\n', got);
      if (nl) { chunk.append(buf, nl - buf + 1); break; }
      chunk.append(buf, got);
    }
  }
  fclose(f);
  out += chunk;
  return 0;
}

struct Piece { std::string path; uint64_t offset, length; };

struct Prefetcher {
  std::vector<std::vector<Piece>> splits;   // per split: its pieces
  int32_t depth;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  size_t next_claim = 0;    // next split index a worker may take
  size_t next_deliver = 0;  // next split index ht_prefetch_next returns
  std::map<size_t, std::pair<std::string, int>> results;  // idx -> (bytes, err)
  bool closing = false;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          return closing ||
                 (next_claim < splits.size() &&
                  next_claim < next_deliver + (size_t)depth);
        });
        if (closing) return;
        idx = next_claim++;
      }
      std::string bytes;
      int err = 0;
      for (const Piece& p : splits[idx]) {
        if (fetch_range_cc(p.path, p.offset, p.length, bytes) != 0) {
          err = -1;
          break;
        }
        // Terminate each piece's contribution: a file with no trailing
        // newline must not fuse its last record with the next piece's
        // first (the Python path splits per piece, so parity needs this).
        if (!bytes.empty() && bytes.back() != '\n') bytes.push_back('\n');
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        results[idx] = {std::move(bytes), err};
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ht_prefetch_open(const char* const* paths, const uint64_t* offsets,
                       const uint64_t* lengths, const int32_t* piece_counts,
                       int32_t n_splits, int32_t depth, int32_t n_workers) {
  if (n_splits < 0 || depth < 1 || n_workers < 1) return nullptr;
  Prefetcher* pf = new Prefetcher();
  pf->depth = depth;
  size_t k = 0;
  pf->splits.resize((size_t)n_splits);
  for (int32_t i = 0; i < n_splits; i++) {
    for (int32_t j = 0; j < piece_counts[i]; j++, k++) {
      pf->splits[i].push_back(Piece{paths[k], offsets[k], lengths[k]});
    }
  }
  int32_t nw = n_workers < n_splits ? n_workers : (n_splits ? n_splits : 1);
  for (int32_t i = 0; i < nw; i++)
    pf->workers.emplace_back([pf] { pf->worker(); });
  return pf;
}

// Returns the byte length of the next split (in submission order) and sets
// *out to a malloc'd buffer the caller frees with ht_prefetch_buf_free.
// -1 = all splits delivered; -2 = read error on this split.
int64_t ht_prefetch_next(void* h, uint8_t** out) {
  Prefetcher* pf = (Prefetcher*)h;
  std::string bytes;
  int err;
  {
    std::unique_lock<std::mutex> lk(pf->mu);
    if (pf->next_deliver >= pf->splits.size()) return -1;
    size_t idx = pf->next_deliver;
    pf->cv_done.wait(lk, [&] { return pf->results.count(idx) > 0; });
    auto it = pf->results.find(idx);
    bytes = std::move(it->second.first);
    err = it->second.second;
    pf->results.erase(it);
    pf->next_deliver++;
  }
  pf->cv_work.notify_all();  // lookahead window advanced
  if (err != 0) return -2;
  // One deliberate copy: the split's bytes move from the worker's string
  // into a C-owned buffer the caller frees; with bounded lookahead the
  // transient is depth x split-size, which the depth knob already caps.
  uint8_t* buf = (uint8_t*)malloc(bytes.size() ? bytes.size() : 1);
  if (!buf) return -3;  // OOM surfaces as an error, not a memcpy crash
  memcpy(buf, bytes.data(), bytes.size());
  *out = buf;
  return (int64_t)bytes.size();
}

void ht_prefetch_buf_free(uint8_t* p) { free(p); }

void ht_prefetch_close(void* h) {
  Prefetcher* pf = (Prefetcher*)h;
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->closing = true;
  }
  pf->cv_work.notify_all();
  for (std::thread& t : pf->workers) t.join();
  delete pf;
}

}  // extern "C"
