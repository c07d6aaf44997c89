// Stands in for native/src/zstd_codec.cc in the port's build of the
// native runtime where the host compiler finds no zstd.h: the rest of the
// library builds, and a zstd frame raises naming the missing header.
#include "zstd_codec.h"

#include <stdexcept>

namespace srjt {

int64_t zstd_decompress(const uint8_t*, int64_t, uint8_t*, int64_t) {
  throw std::runtime_error("zstd: this libsrjt.so was built without zstd (no zstd.h on the host)");
}

int64_t zstd_frame_content_size(const uint8_t*, int64_t) {
  throw std::runtime_error("zstd: this libsrjt.so was built without zstd (no zstd.h on the host)");
}

}  // namespace srjt
