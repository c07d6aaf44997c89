// Host codecs of the port's IO tier: a plain C interface over the repo's
// own decoders in native/src (snappy, LZ4 block, LZO1X, and zstd through
// the system libzstd), plus the PLAIN BYTE_ARRAY length walk of a parquet
// page. Host C++ only: _build.py compiles it with the host compiler,
// with native/src on the include path, and links libzstd only when its
// header and library are found (CODECS_HAVE_ZSTD).
//
// Every entry returns a negative value on failure; codecs_last_error()
// then holds the decoder's message for this thread.
#include <cstdint>
#include <exception>
#include <string>

#include "lz4.h"
#include "lzo.h"
#include "snappy.h"
#ifdef CODECS_HAVE_ZSTD
#include "zstd_codec.h"
#endif

#define CODECS_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

thread_local std::string g_last_error;

template <typename F>
int64_t guarded(F&& f, int64_t error_value) {
  try {
    return f();
  } catch (const std::exception& e) {
    g_last_error = e.what();
  } catch (...) {
    g_last_error = "unknown codec error";
  }
  return error_value;
}

}  // namespace

CODECS_EXPORT const char* codecs_last_error() { return g_last_error.c_str(); }

CODECS_EXPORT int64_t codecs_has_zstd() {
#ifdef CODECS_HAVE_ZSTD
  return 1;
#else
  return 0;
#endif
}

CODECS_EXPORT int64_t codecs_snappy_length(const uint8_t* src, int64_t src_len) {
  return guarded([&]() -> int64_t { return srjt::snappy_uncompressed_length(src, src_len); }, -1);
}

CODECS_EXPORT int64_t codecs_snappy(const uint8_t* src, int64_t src_len, uint8_t* dst,
                                    int64_t dst_len) {
  return guarded(
      [&]() -> int64_t {
        srjt::snappy_uncompress(src, src_len, dst, dst_len);
        return dst_len;
      },
      -1);
}

CODECS_EXPORT int64_t codecs_lz4_block(const uint8_t* src, int64_t src_len, uint8_t* dst,
                                       int64_t dst_capacity) {
  return guarded(
      [&]() -> int64_t { return srjt::lz4_decompress_block(src, src_len, dst, dst_capacity); }, -1);
}

CODECS_EXPORT int64_t codecs_lzo1x(const uint8_t* src, int64_t src_len, uint8_t* dst,
                                   int64_t dst_capacity) {
  return guarded(
      [&]() -> int64_t { return srjt::lzo1x_decompress(src, src_len, dst, dst_capacity); }, -1);
}

CODECS_EXPORT int64_t codecs_zstd(const uint8_t* src, int64_t src_len, uint8_t* dst,
                                  int64_t dst_capacity) {
#ifdef CODECS_HAVE_ZSTD
  return guarded(
      [&]() -> int64_t { return srjt::zstd_decompress(src, src_len, dst, dst_capacity); }, -1);
#else
  (void)src, (void)src_len, (void)dst, (void)dst_capacity;
  g_last_error = "built without zstd";
  return -1;
#endif
}

// Declared content size of a zstd frame: -1 when the frame does not say,
// -2 on failure.
CODECS_EXPORT int64_t codecs_zstd_content_size(const uint8_t* src, int64_t src_len) {
#ifdef CODECS_HAVE_ZSTD
  return guarded([&]() -> int64_t { return srjt::zstd_frame_content_size(src, src_len); }, -2);
#else
  (void)src, (void)src_len;
  g_last_error = "built without zstd";
  return -2;
#endif
}

// Parquet PLAIN BYTE_ARRAY page walk: [u32 len][bytes]... -> per-value
// lengths. Returns the value count, or -1 on a malformed page (capacity
// overflow, a truncated trailing value or trailing garbage), as the JAX
// package's native walk does.
CODECS_EXPORT int64_t codecs_byte_array_lens(const uint8_t* data, int64_t size,
                                             int32_t* out_lens, int64_t capacity) {
  int64_t pos = 0;
  int64_t count = 0;
  while (pos + 4 <= size) {
    uint32_t len = static_cast<uint32_t>(data[pos]) | (static_cast<uint32_t>(data[pos + 1]) << 8) |
                   (static_cast<uint32_t>(data[pos + 2]) << 16) |
                   (static_cast<uint32_t>(data[pos + 3]) << 24);
    if (pos + 4 + static_cast<int64_t>(len) > size) return -1;
    if (count >= capacity) return -1;
    out_lens[count++] = static_cast<int32_t>(len);
    pos += 4 + len;
  }
  if (pos != size) return -1;
  return count;
}
