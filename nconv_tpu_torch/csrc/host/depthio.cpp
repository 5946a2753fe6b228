// Host data path of the port: the PNG row unfilter, the sample conversions
// of the depth and RGB readers, crops, masks and the streaming engine's wire
// encoders, as plain C for ctypes (nconv_tpu_torch/data/native.py).
//
// Inflate stays in Python's zlib, so nothing here links libpng or zlib. The
// unfilter takes the decompressed stream (each row a filter byte, then
// `stride` filtered bytes) and writes the bare rows; the conversions read
// those rows (16-bit samples big-endian, as stored). The encoders are the
// integer forms of the JAX package's native/depthio.cpp, bit for bit.
//
// Built with the host compiler, not nvcc: g++ -O3 -shared -fPIC -std=c++17.
// ctypes releases the GIL around every call, so a thread pool decodes in
// parallel. One entry, nct_encode_frame_dense, is parallel inside: it cuts a
// two-stream frame into row bands and runs them on a pool of std::threads
// that lives as long as the process (the C++ runtime's threads; nothing else
// is linked).

#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <system_error>
#include <thread>

namespace {

inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - c - c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

inline uint8_t clip_u8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// The 8-bit value of channel `ch` (0..2, RGB order) of pixel i of a row, as
// PIL's convert("RGB") gives it: grey replicated (16-bit grey clipped to
// 255), 16-bit colour cut to its high byte, alpha dropped, palette looked up
// (indices past the palette give black).
inline uint8_t rgb_sample(const uint8_t* row, long i, int ch, int ctype, int depth, const uint8_t* lut) {
  const int bytes = depth / 8;
  switch (ctype) {
    case 0: {
      if (depth == 8) return row[i];
      const int v = (row[2 * i] << 8) | row[2 * i + 1];
      return static_cast<uint8_t>(v > 255 ? 255 : v);
    }
    case 2: return row[(3 * i + ch) * bytes];
    case 3: return lut[3 * row[i] + ch];
    case 4: return row[2 * i * bytes];
    default: return row[(4 * i + ch) * bytes];  // 6
  }
}

inline void encode_depth(const float* depth, uint16_t* out, long n, float scale) {
  for (long i = 0; i < n; ++i) {
    float v = depth[i] * scale;
    if (v < 0.0f) v = 0.0f;
    if (v > 65535.0f) v = 65535.0f;
    out[i] = static_cast<uint16_t>(v);
  }
}

// One dense two-stream frame: item k < 2 * bands is row band k / 2 of
// stream k % 2, its RGB rows copied and its depth rows encoded.
struct DenseFrame {
  const uint8_t* rgb[2];
  const float* depth[2];
  uint8_t* rgb_out[2];
  uint16_t* depth_out[2];
  long height, width;
  int bands;
  float scale;

  void item(int k) const {
    const int s = k % 2;
    const long b = k / 2, y0 = height * b / bands, y1 = height * (b + 1) / bands;
    const long px = y0 * width, n = (y1 - y0) * width;
    std::memcpy(rgb_out[s] + 3 * px, rgb[s] + 3 * px, 3 * (size_t)n);
    encode_depth(depth[s] + px, depth_out[s] + px, n, scale);
  }
};

// Worker threads that take the items of one frame at a time beside the
// calling thread, each item as it comes free, so that a worker that wakes
// late takes fewer. Workers are detached and wait on a condition variable
// between frames; the pool is never destroyed, so nothing joins them when
// the process exits. A forked child has none of its parent's threads: the
// first call in a new process builds a new pool (the old one is left as
// it was; its locks may be held by threads the child does not have).
class Pool {
 public:
  explicit Pool(pid_t pid) : pid(pid) {}

  const pid_t pid;

  // Every item of `frame` on the calling thread and at most threads - 1
  // workers, returning once all are done. A call that finds the pool busy
  // (another thread's frame) runs its items alone.
  void run(const DenseFrame& frame, int threads) {
    const int n = 2 * frame.bands;
    std::unique_lock<std::mutex> call(call_, std::try_to_lock);
    if (call.owns_lock() && threads > 1) grow(threads - 1);
    if (!call.owns_lock() || started_ == 0 || threads < 2) {
      for (int k = 0; k < n; ++k) frame.item(k);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(m_);
      frame_ = &frame;
      n_ = n;
      want_ = threads - 1;
      next_.store(0, std::memory_order_relaxed);
      ++generation_;
    }
    wake_.notify_all();
    for (int k; (k = next_.fetch_add(1)) < n;) frame.item(k);
    // Every item is taken; the workers still in one end within an item's
    // time, so wait for them here rather than sleep and be woken. Yield,
    // not spin: a worker woken onto this thread's core runs only when it
    // gives the core up.
    for (;;) {
      while (busy_.load(std::memory_order_acquire) != 0) std::this_thread::yield();
      std::lock_guard<std::mutex> lk(m_);
      if (busy_.load(std::memory_order_acquire) == 0) {
        frame_ = nullptr;  // a worker that wakes from here on finds no frame
        n_ = 0;
        return;
      }
    }
  }

 private:
  void grow(int workers) {
    while (started_ < workers) {
      try {
        std::thread(&Pool::work, this).detach();
      } catch (const std::system_error&) {
        return;  // no more threads to be had: run with those there are
      }
      ++started_;
    }
  }

  void work() {
    unsigned long seen = 0;
    std::unique_lock<std::mutex> lk(m_);
    for (;;) {
      wake_.wait(lk, [&] { return generation_ != seen; });
      seen = generation_;
      // A frame's items are taken only by workers counted in busy_, which
      // join under m_ while frame_ is set: run() clears it under m_ once
      // busy_ is 0, so no worker holds an item of a frame that returned.
      if (frame_ == nullptr || busy_.load(std::memory_order_relaxed) >= want_) continue;
      const DenseFrame* frame = frame_;
      const int n = n_;
      busy_.fetch_add(1, std::memory_order_relaxed);
      lk.unlock();
      for (int k; (k = next_.fetch_add(1)) < n;) frame->item(k);
      busy_.fetch_sub(1, std::memory_order_release);
      lk.lock();
    }
  }

  std::mutex call_;  // one frame at a time
  int started_ = 0;  // workers started (under call_)
  std::mutex m_;
  std::condition_variable wake_;
  const DenseFrame* frame_ = nullptr;  // these three and generation_ under m_
  int n_ = 0, want_ = 0;
  unsigned long generation_ = 0;
  std::atomic<int> busy_{0};  // workers in the frame: joined under m_, left by themselves
  std::atomic<int> next_{0};
};

std::atomic<Pool*> g_pool{nullptr};

Pool* pool() {
  const pid_t pid = getpid();
  Pool* p = g_pool.load(std::memory_order_acquire);
  if (p != nullptr && p->pid == pid) return p;
  Pool* fresh = new Pool(pid);
  if (g_pool.compare_exchange_strong(p, fresh, std::memory_order_acq_rel)) return fresh;
  delete fresh;  // another thread of this process built one first
  return p;
}

}  // namespace

extern "C" {

// raw: height rows of 1 + stride bytes; out: height x stride bytes. bpp is
// the bytes a pixel (at least 1). Returns 0, or 1 + the first row whose
// filter type is not 0-4 (rows before it are written).
int nct_png_unfilter(const uint8_t* raw, int height, long stride, int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* f = raw + (size_t)y * (stride + 1);
    const int kind = f[0];
    ++f;
    uint8_t* cur = out + (size_t)y * stride;
    switch (kind) {
      case 0:
        std::memcpy(cur, f, stride);
        break;
      case 1:
        for (long i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(f[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(f[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(f[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(f[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prev = cur;
  }
  return 0;
}

// n greyscale samples of `depth` bits (16: big-endian) -> float32 value *
// (1 / scale), the JAX package's depthio_load_depth_f32 conversion.
void nct_depth_f32(const uint8_t* rows, long n, int depth, float scale, float* out) {
  const float inv = 1.0f / scale;
  if (depth == 16) {
    for (long i = 0; i < n; ++i) out[i] = static_cast<float>((rows[2 * i] << 8) | rows[2 * i + 1]) * inv;
  } else {
    for (long i = 0; i < n; ++i) out[i] = static_cast<float>(rows[i]) * inv;
  }
}

// n pixels of colour type ctype (0, 2, 3, 4, 6) at `depth` bits -> RGB (or
// BGR) float32 0..255 into out (n x 3). palette: n_palette RGB entries
// (ctype 3). Returns 0, or -1 for a colour type or depth this does not read.
int nct_rgb(const uint8_t* rows, long n, int ctype, int depth, const uint8_t* palette, int n_palette, int bgr,
            float* out) {
  if ((depth != 8 && depth != 16) || (ctype != 0 && ctype != 2 && ctype != 3 && ctype != 4 && ctype != 6) ||
      (ctype == 3 && depth != 8))
    return -1;
  uint8_t lut[256 * 3] = {};
  if (ctype == 3) std::memcpy(lut, palette, 3 * (size_t)(n_palette < 256 ? n_palette : 256));
  for (long i = 0; i < n; ++i)
    for (int ch = 0; ch < 3; ++ch) out[3 * i + (bgr ? 2 - ch : ch)] = rgb_sample(rows, i, ch, ctype, depth, lut);
  return 0;
}

// Top-aligned rows / centred columns crop (the datasets' convention):
// in (h, w, c) -> out (oh, ow, c).
void nct_crop_top_center(const float* in, int h, int w, int c, int oh, int ow, float* out) {
  const int tp = h - oh, lp = (w - ow) / 2;
  for (int y = 0; y < oh; ++y)
    std::memcpy(out + (size_t)y * ow * c, in + ((size_t)(y + tp) * w + lp) * c, sizeof(float) * ow * c);
}

// depth *= mask, in place (the caller passes a fresh copy).
void nct_apply_mask(float* depth, const float* mask, long n) {
  for (long i = 0; i < n; ++i) depth[i] *= mask[i];
}

// float depth (meters) -> uint16 wire: d * scale clipped to [0, 65535],
// truncated.
void nct_encode_depth_wire(const float* depth, uint16_t* out, long n, float scale) {
  encode_depth(depth, out, n, scale);
}

// Both streams' dense wire in one call: each (height, width, 3) uint8 RGB
// frame copied, each (height, width) float depth encoded as by
// nct_encode_depth_wire, bitwise. Each stream is cut into `bands` row bands
// (at least 1), taken by the calling thread and at most threads - 1
// workers of the process's pool (threads 1-64); returns once every band is
// written. Returns 0, or -1 for a count out of range.
int nct_encode_frame_dense(const uint8_t* rgb0, const float* depth0, const uint8_t* rgb1, const float* depth1,
                           uint8_t* rgb_out0, uint16_t* depth_out0, uint8_t* rgb_out1, uint16_t* depth_out1,
                           int height, int width, float scale, int bands, int threads) {
  if (bands < 1 || threads < 1 || threads > 64) return -1;
  if (bands > height) bands = height > 0 ? height : 1;  // a band of no rows does nothing
  const DenseFrame frame{{rgb0, rgb1}, {depth0, depth1}, {rgb_out0, rgb_out1}, {depth_out0, depth_out1},
                         height, width, bands, scale};
  pool()->run(frame, threads);
  return 0;
}

// COO depth wire in one pass: (flat index, d * scale clipped) of the first
// `capacity` nonzero points in row-major order, the rest of both buffers
// zero. Returns the count of every nonzero point (over capacity: dropped).
long nct_encode_depth_coo(const float* depth, long n, long capacity, float scale, int32_t* idx_out,
                          uint16_t* val_out) {
  long k = 0;
  for (long i = 0; i < n; ++i) {
    const float d = depth[i];
    if (d == 0.0f) continue;
    if (k < capacity) {
      float v = d * scale;
      if (v < 0.0f) v = 0.0f;
      if (v > 65535.0f) v = 65535.0f;
      idx_out[k] = static_cast<int32_t>(i);
      val_out[k] = static_cast<uint16_t>(v);
    }
    ++k;
  }
  const long fill = k < capacity ? k : capacity;
  std::memset(idx_out + fill, 0, sizeof(int32_t) * (size_t)(capacity - fill));
  std::memset(val_out + fill, 0, sizeof(uint16_t) * (size_t)(capacity - fill));
  return k;
}

// HWC uint8 RGB (even h, w) -> planar YUV 4:2:0, BT.601 full range in 16-bit
// fixed point: luma per pixel, chroma of each 2x2 block's sum (coefficients
// a quarter of the per-pixel ones).
void nct_encode_yuv420(const uint8_t* rgb, int h, int w, uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const int cw = w / 2;
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = rgb + (size_t)yy * w * 3;
    uint8_t* yrow = y_out + (size_t)yy * w;
    for (int x = 0; x < w; ++x) {
      const int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
      yrow[x] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
    }
  }
  for (int cy = 0; cy < h / 2; ++cy) {
    const uint8_t* r0 = rgb + (size_t)(2 * cy) * w * 3;
    const uint8_t* r1 = r0 + (size_t)w * 3;
    uint8_t* urow = u_out + (size_t)cy * cw;
    uint8_t* vrow = v_out + (size_t)cy * cw;
    for (int cx = 0; cx < cw; ++cx) {
      const int o = 6 * cx;
      const int r = r0[o] + r0[o + 3] + r1[o] + r1[o + 3];
      const int g = r0[o + 1] + r0[o + 4] + r1[o + 1] + r1[o + 4];
      const int b = r0[o + 2] + r0[o + 5] + r1[o + 2] + r1[o + 5];
      urow[cx] = clip_u8(((-2764 * r - 5428 * g + 8192 * b + 32768) >> 16) + 128);
      vrow[cx] = clip_u8(((8192 * r - 6860 * g - 1332 * b + 32768) >> 16) + 128);
    }
  }
}

// HWC uint8 RGB (even w) -> planar YUV 4:2:2, chroma co-sited at the even
// columns.
void nct_encode_yuv422(const uint8_t* rgb, int h, int w, uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const int cw = w / 2;
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = rgb + (size_t)yy * w * 3;
    uint8_t* yrow = y_out + (size_t)yy * w;
    uint8_t* urow = u_out + (size_t)yy * cw;
    uint8_t* vrow = v_out + (size_t)yy * cw;
    for (int x = 0; x < w; ++x) {
      const int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
      yrow[x] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
    }
    for (int cx = 0; cx < cw; ++cx) {
      const int o = 6 * cx;
      const int r = row[o], g = row[o + 1], b = row[o + 2];
      urow[cx] = clip_u8(((-11059 * r - 21709 * g + 32768 * b + 32768) >> 16) + 128);
      vrow[cx] = clip_u8(((32768 * r - 27439 * g - 5329 * b + 32768) >> 16) + 128);
    }
  }
}

}  // extern "C"
