// Native RawArray (.ra) reader/writer + IEEE-754 half conversions.
//
// The port's own copy of the JAX package's host I/O helper
// (`tron_tpu/_native/ra_native.cpp`), the counterpart of the reference's
// host-native I/O layer (`src/ra.cu`, `src/float16.cu`): the .ra byte format
// is specified in ra.h:38-72 (little-endian u64 header {magic, flags,
// eltype, elbyte, size, ndims, dims...} + contiguous data, reads/writes
// chunked at 2^31 bytes).  Exposed through a plain C ABI, built with g++ on
// first use and bound with ctypes by tron_tpu_torch/io/native.py; the
// Python seek/read/pwrite path there and in tron_tpu_torch/io/ra.py is its
// plain version.
//
// Written from the format spec; fixes the reference's ra_free double-free
// (ra.cu:165-174) by owning all allocations on this side of the ABI.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x7961727261776172ULL;  // "rawarray"
constexpr uint64_t kKnownFlags = 0x3;               // big-endian | compressed
constexpr size_t kMaxChunk = 1ULL << 31;

bool read_exact(int fd, void* buf, size_t count) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (count > 0) {
    size_t want = count < kMaxChunk ? count : kMaxChunk;
    ssize_t got = read(fd, p, want);
    if (got <= 0) return false;
    p += got;
    count -= static_cast<size_t>(got);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t count) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (count > 0) {
    size_t want = count < kMaxChunk ? count : kMaxChunk;
    ssize_t put = write(fd, p, want);
    if (put <= 0) return false;
    p += put;
    count -= static_cast<size_t>(put);
  }
  return true;
}

}  // namespace

extern "C" {

typedef struct {
  uint64_t flags;
  uint64_t eltype;
  uint64_t elbyte;
  uint64_t size;
  uint64_t ndims;
  uint64_t* dims;  // owned by this library; release via ra_nat_free
  uint8_t* data;   // owned by this library; release via ra_nat_free
} ra_nat_t;

// Error codes: 0 ok, -1 io, -2 bad magic, -3 unsupported flags, -4 alloc.
int ra_nat_read_impl(const char* path, ra_nat_t* a, int header_only) {
  memset(a, 0, sizeof(*a));
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  uint64_t head[6];
  if (!read_exact(fd, head, sizeof(head))) { close(fd); return -1; }
  if (head[0] != kMagic) { close(fd); return -2; }
  a->flags = head[1];
  a->eltype = head[2];
  a->elbyte = head[3];
  a->size = head[4];
  a->ndims = head[5];
  if (a->flags & ~kKnownFlags)
    fprintf(stderr, "ra_native: warning: unknown format flags 0x%llx\n",
            static_cast<unsigned long long>(a->flags & ~kKnownFlags));
  if (a->flags & kKnownFlags) { close(fd); return -3; }  // no BE/compressed
  a->dims = static_cast<uint64_t*>(malloc(a->ndims * sizeof(uint64_t)));
  if (!a->dims) { close(fd); return -4; }
  if (!read_exact(fd, a->dims, a->ndims * sizeof(uint64_t))) {
    close(fd); return -1;
  }
  if (header_only) { close(fd); return 0; }
  a->data = static_cast<uint8_t*>(malloc(a->size ? a->size : 1));
  if (!a->data) { close(fd); return -4; }
  if (!read_exact(fd, a->data, a->size)) { close(fd); return -1; }
  close(fd);
  return 0;
}

int ra_nat_read(const char* path, ra_nat_t* a) { return ra_nat_read_impl(path, a, 0); }
int ra_nat_query(const char* path, ra_nat_t* a) { return ra_nat_read_impl(path, a, 1); }

int ra_nat_write(const char* path, const ra_nat_t* a) {
  int fd = open(path, O_WRONLY | O_TRUNC | O_CREAT, 0644);
  if (fd < 0) return -1;
  uint64_t head[6] = {kMagic, a->flags, a->eltype, a->elbyte, a->size, a->ndims};
  bool ok = write_exact(fd, head, sizeof(head)) &&
            write_exact(fd, a->dims, a->ndims * sizeof(uint64_t)) &&
            write_exact(fd, a->data, a->size);
  close(fd);
  return ok ? 0 : -1;
}

void ra_nat_free(ra_nat_t* a) {
  free(a->dims);
  free(a->data);
  a->dims = nullptr;
  a->data = nullptr;
}

// ---- IEEE-754 binary16 <-> binary32, round-to-nearest-even --------------

uint16_t f32_bits_to_f16_bits(uint32_t f) {
  uint32_t sign = (f >> 16) & 0x8000u;
  uint32_t exp = (f >> 23) & 0xFFu;
  uint32_t man = f & 0x7FFFFFu;
  if (exp == 0xFF) {  // inf/nan
    return static_cast<uint16_t>(sign | 0x7C00u | (man ? 0x200u | (man >> 13) : 0));
  }
  int e = static_cast<int>(exp) - 127 + 15;
  if (e >= 0x1F) return static_cast<uint16_t>(sign | 0x7C00u);  // overflow -> inf
  if (e <= 0) {
    if (e < -10) return static_cast<uint16_t>(sign);  // underflow -> 0
    // subnormal: shift with implicit bit, round to nearest even
    man |= 0x800000u;
    int shift = 14 - e;
    uint32_t half = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t mid = 1u << (shift - 1);
    if (rem > mid || (rem == mid && (half & 1))) half++;
    return static_cast<uint16_t>(sign | half);
  }
  // normal: round mantissa 23 -> 10 bits, ties to even
  uint32_t half = (static_cast<uint32_t>(e) << 10) | (man >> 13);
  uint32_t rem = man & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;  // may carry into exp: fine
  return static_cast<uint16_t>(sign | half);
}

uint32_t f16_bits_to_f32_bits(uint16_t h) {
  uint32_t sign = (static_cast<uint32_t>(h) & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t man = h & 0x3FFu;
  if (exp == 0x1F) return sign | 0x7F800000u | (man << 13);
  if (exp == 0) {
    if (man == 0) return sign;
    // subnormal: normalize
    int e = -1;
    do { man <<= 1; e++; } while (!(man & 0x400u));
    man &= 0x3FFu;
    return sign | (static_cast<uint32_t>(127 - 15 - e) << 23) | (man << 13);
  }
  return sign | ((exp - 15 + 127) << 23) | (man << 13);
}

void f32_to_f16(const float* src, uint16_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t bits;
    memcpy(&bits, &src[i], 4);
    dst[i] = f32_bits_to_f16_bits(bits);
  }
}

void f16_to_f32(const uint16_t* src, float* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t bits = f16_bits_to_f32_bits(src[i]);
    memcpy(&dst[i], &bits, 4);
  }
}

}  // extern "C"

extern "C" {

// Read `count` bytes of the data payload starting at byte `offset` into a
// caller-provided buffer — the streaming window loader for sliding-window
// recon over large acquisitions (reads only the needed profile range, the
// role the reference's per-frame async H2D copies play, src/tron.cu:746-748).
// Returns 0 ok, -1 io, -2 bad magic, -5 out of range.
int ra_nat_read_region(const char* path, uint64_t offset, uint64_t count,
                       uint8_t* buf) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  uint64_t head[6];
  if (!read_exact(fd, head, sizeof(head))) { close(fd); return -1; }
  if (head[0] != kMagic) { close(fd); return -2; }
  uint64_t size = head[4], ndims = head[5];
  if (offset + count > size) { close(fd); return -5; }
  off_t data_start = static_cast<off_t>(8 * (6 + ndims));
  if (lseek(fd, data_start + static_cast<off_t>(offset), SEEK_SET) < 0) {
    close(fd);
    return -1;
  }
  bool ok = read_exact(fd, buf, count);
  close(fd);
  return ok ? 0 : -1;
}

// Write `count` bytes of the data payload starting at byte `offset` from a
// caller-provided buffer — the output half of the streaming driver: the
// writer thread lands each reconstructed frame block into its .ra region
// while the device computes the next one (the role pinned-memory async D2H
// + per-frame output copies play in the reference, src/tron.cu:767-781).
// The file must already carry a valid header (io.ra.RaWriter writes it).
// Returns 0 ok, -1 io, -2 bad magic, -5 out of range.
int ra_nat_write_region(const char* path, uint64_t offset, uint64_t count,
                        const uint8_t* buf) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return -1;
  uint64_t head[6];
  if (!read_exact(fd, head, sizeof(head))) { close(fd); return -1; }
  if (head[0] != kMagic) { close(fd); return -2; }
  uint64_t size = head[4], ndims = head[5];
  if (offset + count > size) { close(fd); return -5; }
  off_t pos = static_cast<off_t>(8 * (6 + ndims) + offset);
  const uint8_t* p = buf;
  while (count > 0) {
    size_t want = count < kMaxChunk ? count : kMaxChunk;
    ssize_t put = pwrite(fd, p, want, pos);
    if (put <= 0) { close(fd); return -1; }
    p += put;
    pos += put;
    count -= static_cast<uint64_t>(put);
  }
  close(fd);
  return 0;
}

}  // extern "C"
