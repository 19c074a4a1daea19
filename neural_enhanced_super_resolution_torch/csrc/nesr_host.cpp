// nesr_host: the host stager of the PyTorch port.
//
// The same three routines as the JAX package's csrc/nesr_host.cpp, with
// a plain C ABI for ctypes:
//
//   * nesr_extract_tiles_u8: overlap-halo tile extraction into one packed
//     contiguous batch buffer (reflect-101 halos), multithreaded. It fills
//     the pinned host buffer that the streamed tiler copies to the card
//     chunk by chunk (parallel/tiling.process_tiled_to_host).
//   * nesr_stitch_tiles_u8: the inverse: crop halos and write tile cores
//     back into an image buffer, multithreaded.
//   * nesr_stack12_u8: the 12-channel BGR variant stack of the ESRGAN input
//     (original, x1.1, x0.9, 3x3 Gaussian blur) as float32 in one pass.
//
// Built with g++ -O3 -shared at first use by runtime/native.py into the
// kernels' build directory.

#include <algorithm>
#include <atomic>
#include <functional>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int reflect101(int idx, int n) {
  // OpenCV BORDER_REFLECT_101: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...
  if (n == 1) return 0;
  while (idx < 0 || idx >= n) {
    if (idx < 0) idx = -idx;
    if (idx >= n) idx = 2 * (n - 1) - idx;
  }
  return idx;
}

void parallel_for(int n, const std::function<void(int)>& fn) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int workers = std::max(1, std::min(n, hw));
  if (workers <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(workers);
  std::atomic<int> next{0};
  for (int w = 0; w < workers; ++w) {
    threads.emplace_back([&]() {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// image: (H, W, C) uint8 row-major. out: (ny*nx, k, k, C) with
// k = tile + 2*halo, tiles in row-major (ty, tx) order. H, W must be
// multiples of tile (caller pads). Halos reflect at image borders.
void nesr_extract_tiles_u8(const uint8_t* image, int h, int w, int c,
                           int tile, int halo, uint8_t* out) {
  const int ny = h / tile;
  const int nx = w / tile;
  const int k = tile + 2 * halo;
  const size_t row_bytes = static_cast<size_t>(k) * c;

  parallel_for(ny * nx, [&](int t) {
    const int ty = t / nx;
    const int tx = t % nx;
    uint8_t* dst = out + static_cast<size_t>(t) * k * k * c;
    const int y0 = ty * tile - halo;
    const int x0 = tx * tile - halo;
    for (int ky = 0; ky < k; ++ky) {
      const int sy = reflect101(y0 + ky, h);
      const uint8_t* src_row = image + (static_cast<size_t>(sy) * w) * c;
      uint8_t* dst_row = dst + static_cast<size_t>(ky) * row_bytes;
      // fast path: fully interior row segment
      if (x0 >= 0 && x0 + k <= w) {
        std::memcpy(dst_row, src_row + static_cast<size_t>(x0) * c,
                    row_bytes);
      } else {
        for (int kx = 0; kx < k; ++kx) {
          const int sx = reflect101(x0 + kx, w);
          std::memcpy(dst_row + static_cast<size_t>(kx) * c,
                      src_row + static_cast<size_t>(sx) * c, c);
        }
      }
    }
  });
}

// tiles: (ny*nx, ko, ko, C) uint8 with ko = tile_out + 2*halo_out.
// out: (ny*tile_out, nx*tile_out, C).
void nesr_stitch_tiles_u8(const uint8_t* tiles, int ny, int nx, int tile_out,
                          int halo_out, int c, uint8_t* out) {
  const int ko = tile_out + 2 * halo_out;
  const int out_w = nx * tile_out;

  parallel_for(ny * nx, [&](int t) {
    const int ty = t / nx;
    const int tx = t % nx;
    const uint8_t* src =
        tiles + static_cast<size_t>(t) * ko * ko * c +
        (static_cast<size_t>(halo_out) * ko + halo_out) * c;
    uint8_t* dst = out + ((static_cast<size_t>(ty) * tile_out) * out_w +
                          static_cast<size_t>(tx) * tile_out) * c;
    for (int y = 0; y < tile_out; ++y) {
      std::memcpy(dst + static_cast<size_t>(y) * out_w * c,
                  src + static_cast<size_t>(y) * ko * c,
                  static_cast<size_t>(tile_out) * c);
    }
  });
}

// rgb: (H, W, 3) uint8. out: (H, W, 12) float32 in [0,1] — BGR stack:
// [bgr, clamp(bgr*1.1), clamp(bgr*0.9), blur3(bgr)], the ESRGAN step's
// "stack12" input. The blur matches cv2.GaussianBlur(ksize=3, sigma=0):
// kernel [1,2,1]/4 separable with reflect-101 borders, rounded back to
// uint8 before normalising (the blur runs on the uint8 image).
void nesr_stack12_u8(const uint8_t* rgb, int h, int w, float* out) {
  // Pass 1: horizontal [1,2,1]/4 into a uint16 temp (x4 fixed point).
  std::vector<uint16_t> tmp(static_cast<size_t>(h) * w * 3);
  parallel_for(h, [&](int y) {
    const uint8_t* row = rgb + static_cast<size_t>(y) * w * 3;
    uint16_t* trow = tmp.data() + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int xl = reflect101(x - 1, w), xr = reflect101(x + 1, w);
      for (int ch = 0; ch < 3; ++ch) {
        trow[x * 3 + ch] = static_cast<uint16_t>(
            row[xl * 3 + ch] + 2 * row[x * 3 + ch] + row[xr * 3 + ch]);
      }
    }
  });
  // Pass 2: vertical + assemble all 12 channels.
  parallel_for(h, [&](int y) {
    const int yu = reflect101(y - 1, h), yd = reflect101(y + 1, h);
    const uint8_t* row = rgb + static_cast<size_t>(y) * w * 3;
    const uint16_t* tu = tmp.data() + static_cast<size_t>(yu) * w * 3;
    const uint16_t* tc = tmp.data() + static_cast<size_t>(y) * w * 3;
    const uint16_t* td = tmp.data() + static_cast<size_t>(yd) * w * 3;
    float* orow = out + static_cast<size_t>(y) * w * 12;
    for (int x = 0; x < w; ++x) {
      for (int ch = 0; ch < 3; ++ch) {
        // RGB -> BGR channel flip
        const float v = row[x * 3 + (2 - ch)] / 255.0f;
        orow[x * 12 + ch] = v;
        orow[x * 12 + 3 + ch] = std::min(1.0f, v * 1.1f);
        orow[x * 12 + 6 + ch] = v * 0.9f;
        // vertical [1,2,1]/4 on the x4 horizontal sums -> /16, round
        const int src_ch = 2 - ch;
        const unsigned acc = tu[x * 3 + src_ch] + 2u * tc[x * 3 + src_ch] +
                             td[x * 3 + src_ch];
        const unsigned rounded = (acc + 8u) >> 4;  // round-half-up /16
        orow[x * 12 + 9 + ch] = rounded / 255.0f;
      }
    }
  });
}

}  // extern "C"
