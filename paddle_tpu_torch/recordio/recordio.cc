// RecordIO: chunked record container with per-chunk CRC + compression.
//
// Role parity: reference paddle/fluid/recordio/{header,chunk,writer,
// scanner}.{h,cc} — re-designed, not ported: one flat C API (consumed from
// Python over ctypes instead of pybind), zlib instead of snappy (always
// present next to a C++ toolchain), and corrupt/truncated tail chunks are
// skipped on read exactly like the reference's fault-tolerant scanner.
//
// On-disk layout, little-endian:
//   chunk := header payload
//   header := magic:u32 compressor:u32 num_records:u32
//             uncompressed_len:u32 stored_len:u32 crc32:u32
//   payload (after optional zlib) := { len:u32 bytes[len] } * num_records
//
// crc32 is over the STORED (possibly compressed) payload bytes, so a
// truncated write is detected without decompressing.
//
// Build: g++ -O2 -shared -fPIC -o librecordio.so recordio.cc -lz

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x54505231;  // "TPR1"

enum Compressor : uint32_t {
  kNoCompress = 0,
  kZlib = 2,  // value matches the reference's kGzip slot
};

struct Writer {
  FILE* f = nullptr;
  uint32_t compressor = kZlib;
  size_t max_records = 1000;
  size_t max_bytes = 1 << 20;
  std::string buf;          // concatenated {len,bytes} records
  uint32_t num_records = 0;

  void flush_chunk() {
    if (num_records == 0) return;
    std::string stored;
    if (compressor == kZlib) {
      uLongf cap = compressBound(buf.size());
      stored.resize(cap);
      if (compress2(reinterpret_cast<Bytef*>(&stored[0]), &cap,
                    reinterpret_cast<const Bytef*>(buf.data()), buf.size(),
                    Z_DEFAULT_COMPRESSION) != Z_OK) {
        stored = buf;  // fall back to raw on any zlib failure
      } else {
        stored.resize(cap);
      }
    } else {
      stored = buf;
    }
    uint32_t crc =
        crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
              stored.size());
    uint32_t header[6] = {kMagic,
                          compressor,
                          num_records,
                          static_cast<uint32_t>(buf.size()),
                          static_cast<uint32_t>(stored.size()),
                          crc};
    fwrite(header, sizeof(header), 1, f);
    fwrite(stored.data(), 1, stored.size(), f);
    buf.clear();
    num_records = 0;
  }
};

struct Scanner {
  FILE* f = nullptr;
  std::string chunk;        // decompressed current chunk payload
  size_t pos = 0;           // cursor within chunk
  uint32_t remaining = 0;   // records left in current chunk
  std::string record;       // last record handed out

  bool load_next_chunk() {
    for (;;) {
      uint32_t header[6];
      if (fread(header, sizeof(header), 1, f) != 1) return false;  // EOF
      if (header[0] != kMagic) return false;  // stream out of sync: stop
      uint32_t compressor = header[1];
      uint32_t nrec = header[2];
      uint32_t raw_len = header[3];
      uint32_t stored_len = header[4];
      uint32_t crc = header[5];
      std::string stored(stored_len, '\0');
      if (stored_len > 0 &&
          fread(&stored[0], 1, stored_len, f) != stored_len)
        return false;  // truncated tail chunk: skip (fault tolerance)
      if (crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
                stored.size()) != crc)
        continue;  // corrupt chunk: skip to the next one
      if (compressor == kZlib) {
        chunk.resize(raw_len);
        uLongf out_len = raw_len;
        if (uncompress(reinterpret_cast<Bytef*>(&chunk[0]), &out_len,
                       reinterpret_cast<const Bytef*>(stored.data()),
                       stored.size()) != Z_OK)
          continue;
        chunk.resize(out_len);
      } else {
        chunk = std::move(stored);
      }
      pos = 0;
      remaining = nrec;
      if (remaining > 0) return true;
    }
  }

  // returns length or -1 at EOF; record bytes stay valid until next call
  int64_t next() {
    while (remaining == 0) {
      if (!load_next_chunk()) return -1;
    }
    if (pos + 4 > chunk.size()) return -1;  // malformed: stop
    uint32_t len;
    memcpy(&len, chunk.data() + pos, 4);
    pos += 4;
    if (pos + len > chunk.size()) return -1;
    record.assign(chunk, pos, len);
    pos += len;
    remaining--;
    return static_cast<int64_t>(len);
  }
};

}  // namespace

extern "C" {

void* rio_writer_open(const char* path, uint32_t compressor,
                      uint32_t max_records) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  w->compressor = compressor;
  if (max_records > 0) w->max_records = max_records;
  return w;
}

int rio_write(void* h, const char* buf, uint32_t len) {
  Writer* w = static_cast<Writer*>(h);
  uint32_t le_len = len;
  w->buf.append(reinterpret_cast<const char*>(&le_len), 4);
  w->buf.append(buf, len);
  w->num_records++;
  if (w->num_records >= w->max_records || w->buf.size() >= w->max_bytes)
    w->flush_chunk();
  return 0;
}

void rio_writer_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  w->flush_chunk();
  fclose(w->f);
  delete w;
}

void* rio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Scanner* s = new Scanner();
  s->f = f;
  return s;
}

// returns record length, or -1 at EOF.  *out points at internal storage
// valid until the next call.
int64_t rio_next(void* h, const char** out) {
  Scanner* s = static_cast<Scanner*>(h);
  int64_t len = s->next();
  *out = (len >= 0) ? s->record.data() : nullptr;
  return len;
}

void rio_scanner_close(void* h) {
  Scanner* s = static_cast<Scanner*>(h);
  fclose(s->f);
  delete s;
}

}  // extern "C"
