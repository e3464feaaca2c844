// Host-side data staging runtime of the PyTorch port (C ABI, consumed via
// ctypes from strainer_gan_tpu_torch/native/__init__.py).
//
// The port's own copy of strainer_gan_tpu/native/host_staging.cc, function
// for function, so both packages stage the same bytes.  The dataset is
// staged ONCE into a uint8 NHWC array; this library is the fast path for
// that step: multithreaded PIL-compatible triangle-filter resizing, center
// crops, and large index gathers.  All functions are pure C ABI over
// caller-owned buffers: no Python objects, no allocation handoff.  The
// numpy versions in data/datasets.py (``*_plain``) repeat its arithmetic,
// roundings included, for the flags the binding builds it with.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -march=native -pthread (see
// __init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Parallel for over [0, n) with a simple static partition.
template <typename F>
void parallel_for(int64_t n, int threads, F&& fn) {
  if (threads <= 1 || n < 2) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  threads = std::min<int64_t>(threads, n);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([lo, hi, &fn] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

// Triangle (linear) filter, PIL-style: support widens by the scale factor
// when downsampling so the kernel antialiases.
struct ResampleAxis {
  std::vector<int> lo;             // first source index per output pixel
  std::vector<int> len;            // number of taps
  std::vector<std::vector<float>> w;  // normalized weights
};

ResampleAxis build_axis(int in_size, int out_size) {
  ResampleAxis ax;
  ax.lo.resize(out_size);
  ax.len.resize(out_size);
  ax.w.resize(out_size);
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // triangle filter support
  for (int x = 0; x < out_size; ++x) {
    double center = (x + 0.5) * scale;
    int xmin = std::max(0, static_cast<int>(center - support + 0.5));
    int xmax = std::min(in_size, static_cast<int>(center + support + 0.5));
    ax.lo[x] = xmin;
    ax.len[x] = xmax - xmin;
    auto& wx = ax.w[x];
    wx.resize(ax.len[x]);
    double total = 0.0;
    for (int i = 0; i < ax.len[x]; ++i) {
      double arg = (xmin + i + 0.5 - center) / filterscale;
      double val = std::max(0.0, 1.0 - std::abs(arg));
      wx[i] = static_cast<float>(val);
      total += val;
    }
    if (total > 0) {
      for (auto& v : wx) v = static_cast<float>(v / total);
    }
  }
  return ax;
}

inline uint8_t clamp_u8(float v) {
  int r = static_cast<int>(v + 0.5f);
  return static_cast<uint8_t>(std::min(255, std::max(0, r)));
}

}  // namespace

extern "C" {

// Resize a batch of HWC uint8 images with a PIL-compatible triangle filter.
// src: n*h*w*c, dst: n*oh*ow*c.
void sg_resize_bilinear_u8(const uint8_t* src, int64_t n, int h, int w, int c,
                           uint8_t* dst, int oh, int ow, int threads) {
  ResampleAxis ay = build_axis(h, oh);
  ResampleAxis axx = build_axis(w, ow);
  int64_t in_img = static_cast<int64_t>(h) * w * c;
  int64_t out_img = static_cast<int64_t>(oh) * ow * c;

  parallel_for(n, threads, [&](int64_t i) {
    const uint8_t* im = src + i * in_img;
    uint8_t* out = dst + i * out_img;
    // horizontal pass into a float intermediate (h x ow x c)
    std::vector<float> tmp(static_cast<size_t>(h) * ow * c);
    for (int y = 0; y < h; ++y) {
      const uint8_t* row = im + static_cast<int64_t>(y) * w * c;
      float* trow = tmp.data() + static_cast<size_t>(y) * ow * c;
      for (int x = 0; x < ow; ++x) {
        const auto& wx = axx.w[x];
        int lo = axx.lo[x];
        for (int ch = 0; ch < c; ++ch) {
          float acc = 0.f;
          for (int k = 0; k < axx.len[x]; ++k) {
            acc += wx[k] * row[(lo + k) * c + ch];
          }
          trow[x * c + ch] = acc;
        }
      }
    }
    // vertical pass
    for (int y = 0; y < oh; ++y) {
      const auto& wy = ay.w[y];
      int lo = ay.lo[y];
      uint8_t* orow = out + static_cast<int64_t>(y) * ow * c;
      for (int x = 0; x < ow; ++x) {
        for (int ch = 0; ch < c; ++ch) {
          float acc = 0.f;
          for (int k = 0; k < ay.len[y]; ++k) {
            acc += wy[k] * tmp[(static_cast<size_t>(lo + k) * ow + x) * c + ch];
          }
          orow[x * c + ch] = clamp_u8(acc);
        }
      }
    }
  });
}

// Center-crop a batch of HWC uint8 images to (size, size).
void sg_center_crop_u8(const uint8_t* src, int64_t n, int h, int w, int c,
                       uint8_t* dst, int size, int threads) {
  if (size > h || size > w) return;  // would read out of bounds
  int top = (h - size) / 2;
  int left = (w - size) / 2;
  int64_t in_img = static_cast<int64_t>(h) * w * c;
  int64_t out_img = static_cast<int64_t>(size) * size * c;
  parallel_for(n, threads, [&](int64_t i) {
    const uint8_t* im = src + i * in_img;
    uint8_t* out = dst + i * out_img;
    for (int y = 0; y < size; ++y) {
      std::memcpy(out + static_cast<int64_t>(y) * size * c,
                  im + (static_cast<int64_t>(top + y) * w + left) * c,
                  static_cast<size_t>(size) * c);
    }
  });
}

// Parallel gather: dst[i] = src[idx[i]] for fixed-size items (contamination
// mixture assembly over hundreds of MB of image data).
void sg_gather_u8(const uint8_t* src, const int64_t* idx, int64_t n_idx,
                  int64_t item_bytes, uint8_t* dst, int threads) {
  parallel_for(n_idx, threads, [&](int64_t i) {
    std::memcpy(dst + i * item_bytes, src + idx[i] * item_bytes,
                static_cast<size_t>(item_bytes));
  });
}

}  // extern "C"
