// Append-only event journal: the native IO plane of the EVLOG storage
// driver (the slot the reference fills with HBase/Postgres server
// processes; here a single-writer-safe local log + mmap-friendly scan).
//
// Frame format (little-endian):
//   [u32 magic 0x50494F45 'PIOE'][u32 payload_len][u32 crc32(payload)][payload]
//
// Concurrency: appends take an exclusive POSIX flock, so multiple
// processes (event server + importers) can append to one journal. Scans
// validate magic + CRC and stop cleanly at a torn tail, so readers never
// need a lock.

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x50494F45u;
constexpr size_t kHeader = 12;

uint32_t crc_table[256];
bool crc_ready = false;

void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_ready = true;
}

uint32_t crc32(const uint8_t* buf, size_t len) {
  if (!crc_ready) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF;
  p[2] = (v >> 16) & 0xFF; p[3] = (v >> 24) & 0xFF;
}

uint32_t get_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
         ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

// Full write with short-write retry.
bool write_all(int fd, const uint8_t* buf, size_t len) {
  size_t done = 0;
  while (done < len) {
    ssize_t n = write(fd, buf + done, len - done);
    if (n <= 0) return false;
    done += (size_t)n;
  }
  return true;
}

// Shared locked-append: open O_APPEND, take the exclusive lock, write
// both spans fully, fsync. Returns the start offset, or -1.
long long locked_append(const char* path, const uint8_t* head,
                        size_t head_len, const uint8_t* body,
                        size_t body_len) {
  int fd = open(path, O_WRONLY | O_APPEND | O_CREAT, 0644);
  if (fd < 0) return -1;
  if (flock(fd, LOCK_EX) != 0) { close(fd); return -1; }
  off_t offset = lseek(fd, 0, SEEK_END);
  bool ok = (head_len == 0 || write_all(fd, head, head_len)) &&
            (body_len == 0 || write_all(fd, body, body_len));
  if (ok && fsync(fd) != 0) ok = false;
  if (!ok) {
    // a partial write (ENOSPC, signal) would leave a torn frame
    // mid-file; every later O_APPEND frame would land AFTER it and be
    // invisible to readers (scans stop at the first bad frame). Roll
    // the file back to the pre-append boundary while the lock is held.
    if (ftruncate(fd, offset) == 0) fsync(fd);
  }
  flock(fd, LOCK_UN);
  close(fd);
  return ok ? (long long)offset : -1;
}

}  // namespace

extern "C" {

// Append one payload; returns the frame's file offset, or -1 on error.
long long el_append(const char* path, const uint8_t* buf, long long len) {
  if (len < 0) return -1;
  uint8_t header[kHeader];
  put_u32(header, kMagic);
  put_u32(header + 4, (uint32_t)len);
  put_u32(header + 8, crc32(buf, (size_t)len));
  return locked_append(path, header, kHeader, buf, (size_t)len);
}

// Append a pre-framed blob (a concatenation of valid frames built by the
// caller) in ONE write under the exclusive lock — the bulk-ingest path
// (one lock/fsync per batch instead of per event). Returns the blob's
// file offset, or -1 on error.
long long el_append_blob(const char* path, const uint8_t* buf,
                         long long len) {
  if (len < 0) return -1;
  return locked_append(path, nullptr, 0, buf, (size_t)len);
}

// Fill offsets[]/lengths[] (payload offsets, i.e. past the header) for up
// to `cap` valid frames; returns the count, or -1 on IO error. Stops at
// the first invalid/torn frame.
long long el_index(const char* path, long long* offsets, long long* lengths,
                   long long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    return access(path, F_OK) == 0 ? -1 : 0;  // missing file = empty log
  }
  long long count = 0;
  long long pos = 0;
  uint8_t header[kHeader];
  // payload staging buffer grows as needed for CRC validation
  size_t buf_cap = 1 << 16;
  uint8_t* buf = new uint8_t[buf_cap];
  while (count < cap) {
    if (fread(header, 1, kHeader, f) != kHeader) break;
    if (get_u32(header) != kMagic) break;
    uint32_t len = get_u32(header + 4);
    uint32_t crc = get_u32(header + 8);
    if (len > (1u << 30)) break;  // absurd frame: treat as torn
    if (len > buf_cap) {
      delete[] buf;
      buf_cap = len;
      buf = new uint8_t[buf_cap];
    }
    if (fread(buf, 1, len, f) != len) break;       // torn tail
    if (crc32(buf, len) != crc) break;             // corrupt frame
    offsets[count] = pos + (long long)kHeader;
    lengths[count] = (long long)len;
    count++;
    pos += (long long)kHeader + (long long)len;
  }
  delete[] buf;
  fclose(f);
  return count;
}

// Number of valid frames (same walk as el_index without output arrays).
long long el_count(const char* path) {
  long long offsets_dummy[1];
  long long lengths_dummy[1];
  // walk with a large cap by chunking through el_index semantics is
  // wasteful; do the walk inline
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  long long count = 0;
  uint8_t header[kHeader];
  size_t buf_cap = 1 << 16;
  uint8_t* buf = new uint8_t[buf_cap];
  while (true) {
    if (fread(header, 1, kHeader, f) != kHeader) break;
    if (get_u32(header) != kMagic) break;
    uint32_t len = get_u32(header + 4);
    uint32_t crc = get_u32(header + 8);
    if (len > (1u << 30)) break;
    if (len > buf_cap) {
      delete[] buf;
      buf_cap = len;
      buf = new uint8_t[buf_cap];
    }
    if (fread(buf, 1, len, f) != len) break;
    if (crc32(buf, len) != crc) break;
    count++;
  }
  delete[] buf;
  fclose(f);
  (void)offsets_dummy; (void)lengths_dummy;
  return count;
}

// Truncate the journal (EventStore.remove).
int el_truncate(const char* path) {
  int fd = open(path, O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return -1;
  if (flock(fd, LOCK_EX) != 0) { close(fd); return -1; }
  int rc = ftruncate(fd, 0);
  flock(fd, LOCK_UN);
  close(fd);
  return rc;
}

}  // extern "C"
