// evstream — native event-stream accumulator.
//
// C++ equivalent of the reference deployment's event accumulator nodes
// (evfly_ros/src/node.cpp: per-event ±1 into a uint8 frame with base 128,
// drained and reset by a 30 Hz timer; evfly_dv_ros/src/node.cpp adds
// overflow clamping).  Exposed through a minimal C ABI consumed via ctypes
// (evfly_tpu_torch/stream/accumulator.py); the host-side accumulator feeds
// frames to the streaming step on the GPU, replacing the ROS topic hop with
// an in-process call.  A copy of evfly_tpu/native/evstream.cpp, built by
// evfly_tpu_torch/native/_build.py.
//
// The accumulator keeps a saturating int16 working buffer so bursts beyond
// the uint8 range clamp exactly like the DVS node, and drain() snapshots +
// resets in one pass.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct EvStream {
  int height;
  int width;
  int base;
  std::vector<int16_t> acc;  // working buffer, clamped to [0, 255] on drain
  std::mutex mu;

  EvStream(int h, int w, int b) : height(h), width(w), base(b), acc(h * w, b) {}

  void accumulate(const int32_t* xs, const int32_t* ys, const int8_t* pol,
                  int64_t n) {
    std::lock_guard<std::mutex> lock(mu);
    for (int64_t i = 0; i < n; ++i) {
      const int32_t x = xs[i];
      const int32_t y = ys[i];
      if (x < 0 || x >= width || y < 0 || y >= height) continue;
      int16_t& v = acc[static_cast<size_t>(y) * width + x];
      int32_t next = v + (pol[i] > 0 ? 1 : -1);
      if (next < 0) next = 0;
      if (next > 255) next = 255;
      v = static_cast<int16_t>(next);
    }
  }

  void drain(uint8_t* out) {
    std::lock_guard<std::mutex> lock(mu);
    const size_t n = acc.size();
    for (size_t i = 0; i < n; ++i) {
      out[i] = static_cast<uint8_t>(acc[i]);
      acc[i] = static_cast<int16_t>(base);
    }
  }
};

}  // namespace

extern "C" {

void* evstream_create(int height, int width, int base) {
  return new EvStream(height, width, base);
}

void evstream_destroy(void* handle) { delete static_cast<EvStream*>(handle); }

void evstream_accumulate(void* handle, const int32_t* xs, const int32_t* ys,
                         const int8_t* pol, int64_t n) {
  static_cast<EvStream*>(handle)->accumulate(xs, ys, pol, n);
}

void evstream_drain(void* handle, uint8_t* out) {
  static_cast<EvStream*>(handle)->drain(out);
}

}  // extern "C"
