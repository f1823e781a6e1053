// evt3 — native Prophesee EVT3 raw-recording decoder.
//
// Real-data ingestion for the L7 pipeline (SURVEY.md §2.2): the reference
// consumes Prophesee event streams through ROS driver nodes feeding rosbags
// (data_gather/depth_and_events.py); without ROS, the on-disk format those
// cameras record is EVT3 (.raw) — a 16-bit-word compressed stream (public
// Prophesee "EVT 3.0" format).  This decoder turns a .raw file (or memory
// buffer) into flat (t_us, x, y, p) arrays for
// evfly_tpu/data/realdata.package_real_sequence, which voxelizes windows on
// the TPU and packages the h5 trajectory schema.
//
// Native because the decode is a branchy per-16-bit-word state machine over
// potentially hundreds of MB — the one CPU core must not spend minutes in a
// Python loop (the same reason the reference's accumulators are C++ nodes).
//
// Format summary (Prophesee EVT 3.0, little-endian u16 words, type in the
// upper 4 bits):
//   0x0 EVT_ADDR_Y   bits[10:0]=y
//   0x2 EVT_ADDR_X   bit[11]=polarity, bits[10:0]=x  -> one event
//   0x3 VECT_BASE_X  bit[11]=polarity, bits[10:0]=x base for vectors
//   0x4 VECT_12      bits[11:0]=validity mask for 12 consecutive x; base+=12
//   0x5 VECT_8       bits[7:0]=validity mask for 8 consecutive x;  base+=8
//   0x6 EVT_TIME_LOW  bits[11:0]=t[11:0] (us)
//   0x8 EVT_TIME_HIGH bits[11:0]=t[23:12] (us); decoder tracks 24-bit
//       rollover (every ~16.8 s) by counting TIME_HIGH wrap-arounds
//   0xA EXT_TRIGGER, 0xE OTHERS, 0xF CONTINUED — skipped
// Files start with an ASCII header of '%'-prefixed lines (terminated by the
// first non-'%' byte); "% geometry WxH" / "format EVT3;...;width=W;height=H"
// lines carry the sensor geometry.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Evt3Data {
  std::vector<int64_t> t;
  std::vector<uint16_t> x, y;
  std::vector<int8_t> p;
  int width = 0, height = 0;
};

// parse "key=value" style geometry out of header lines
void parse_header_line(const std::string& line, Evt3Data& d) {
  // "% geometry 640x480"
  size_t g = line.find("geometry");
  if (g != std::string::npos) {
    int w = 0, h = 0;
    if (std::sscanf(line.c_str() + g, "geometry %dx%d", &w, &h) == 2) {
      d.width = w;
      d.height = h;
    }
    return;
  }
  size_t wpos = line.find("width=");
  if (wpos != std::string::npos) d.width = std::atoi(line.c_str() + wpos + 6);
  size_t hpos = line.find("height=");
  if (hpos != std::string::npos) d.height = std::atoi(line.c_str() + hpos + 7);
}

// returns offset of the first byte after the ASCII '%' header
size_t parse_header(const uint8_t* buf, size_t n, Evt3Data& d) {
  size_t off = 0;
  while (off < n && buf[off] == '%') {
    size_t eol = off;
    while (eol < n && buf[eol] != '\n') ++eol;
    parse_header_line(std::string(reinterpret_cast<const char*>(buf + off),
                                  eol - off),
                      d);
    off = eol < n ? eol + 1 : n;
  }
  return off;
}

void decode_words(const uint8_t* buf, size_t nbytes, Evt3Data& d,
                  int64_t max_events) {
  const size_t nwords = nbytes / 2;
  uint16_t cur_y = 0;
  uint16_t base_x = 0;
  int8_t vect_pol = 1;
  // 24-bit us timestamp with rollover tracking
  uint32_t time_low = 0, time_high = 0;
  int64_t time_high_overflows = 0;
  uint32_t last_time_high = 0;
  bool seen_time_high = false;

  auto now_us = [&]() -> int64_t {
    return (time_high_overflows << 24) |
           (static_cast<int64_t>(time_high) << 12) | time_low;
  };
  // cap enforced inside push: a VECT_12/VECT_8 word can otherwise expand up
  // to 11 events past max_events (advisor r2)
  auto push = [&](uint16_t ex, int8_t pol) {
    if (max_events >= 0 && static_cast<int64_t>(d.t.size()) >= max_events)
      return;
    d.t.push_back(now_us());
    d.x.push_back(ex);
    d.y.push_back(cur_y);
    d.p.push_back(pol);
  };

  for (size_t i = 0; i < nwords; ++i) {
    if (max_events >= 0 && static_cast<int64_t>(d.t.size()) >= max_events) break;
    uint16_t w;
    std::memcpy(&w, buf + 2 * i, 2);  // little-endian host assumed (x86/ARM)
    const uint16_t type = w >> 12;
    const uint16_t payload = w & 0x0FFF;
    switch (type) {
      case 0x0:  // EVT_ADDR_Y
        cur_y = payload & 0x07FF;
        break;
      case 0x2:  // EVT_ADDR_X: single event
        push(payload & 0x07FF, (w & 0x0800) ? 1 : -1);
        break;
      case 0x3:  // VECT_BASE_X
        base_x = payload & 0x07FF;
        vect_pol = (w & 0x0800) ? 1 : -1;
        break;
      case 0x4:  // VECT_12
        for (int b = 0; b < 12; ++b)
          if (payload & (1u << b)) push(base_x + b, vect_pol);
        base_x += 12;
        break;
      case 0x5:  // VECT_8
        for (int b = 0; b < 8; ++b)
          if (w & (1u << b)) push(base_x + b, vect_pol);
        base_x += 8;
        break;
      case 0x6:  // EVT_TIME_LOW
        time_low = payload;
        break;
      case 0x8:  // EVT_TIME_HIGH
        if (seen_time_high && payload < last_time_high &&
            last_time_high - payload > 2048)  // genuine 24-bit rollover,
          ++time_high_overflows;              // not out-of-order jitter
        last_time_high = payload;
        seen_time_high = true;
        time_high = payload;
        break;
      default:  // EXT_TRIGGER / OTHERS / CONTINUED: no pixel events
        break;
    }
  }
}

}  // namespace

extern "C" {

void* evt3_decode_buffer(const uint8_t* buf, long long nbytes,
                         long long max_events) {
  auto* d = new Evt3Data();
  size_t off = parse_header(buf, static_cast<size_t>(nbytes), *d);
  decode_words(buf + off, static_cast<size_t>(nbytes) - off, *d, max_events);
  return d;
}

void* evt3_decode_file(const char* path, long long max_events) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  // ftell returns -1 for non-seekable/special paths; vector(size_t(-1))
  // would throw bad_alloc inside the Python process (advisor r2)
  if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return nullptr; }
  long sz = std::ftell(f);
  if (sz < 0 || std::fseek(f, 0, SEEK_SET) != 0) {
    std::fclose(f);
    return nullptr;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(sz));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) return nullptr;
  return evt3_decode_buffer(buf.data(), static_cast<long long>(got), max_events);
}

long long evt3_count(void* h) {
  return static_cast<long long>(static_cast<Evt3Data*>(h)->t.size());
}

void evt3_geometry(void* h, int* w, int* ht) {
  auto* d = static_cast<Evt3Data*>(h);
  *w = d->width;
  *ht = d->height;
}

void evt3_copy(void* h, int64_t* t, uint16_t* x, uint16_t* y, int8_t* p) {
  auto* d = static_cast<Evt3Data*>(h);
  const size_t n = d->t.size();
  std::memcpy(t, d->t.data(), n * sizeof(int64_t));
  std::memcpy(x, d->x.data(), n * sizeof(uint16_t));
  std::memcpy(y, d->y.data(), n * sizeof(uint16_t));
  std::memcpy(p, d->p.data(), n * sizeof(int8_t));
}

void evt3_free(void* h) { delete static_cast<Evt3Data*>(h); }

}  // extern "C"
