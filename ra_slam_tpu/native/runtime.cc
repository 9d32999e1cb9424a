// Native runtime for ra_slam_tpu: host-side IO and pipelining.
//
// The reference implements its runtime in C++: the .sens decoder
// (/root/reference/third_party/scannet/sensorData.hpp), the
// mutex+condvar frame queue feeding the TSDF integration thread
// (/root/reference/modules/tsdf_module.cc:88-115), and the
// double-buffered async data logger (/root/reference/utils/data_logger.hpp).
// This library provides the same capabilities behind a plain C ABI
// consumed from Python via ctypes; the device compute path stays in JAX.
//
//   * SensFile     — thread-safe random-access .sens reader: header parse,
//                    frame offset index, zlib depth inflate + libjpeg color
//                    decode using pread (no shared file cursor).
//   * Prefetcher   — N decode threads filling a bounded, strictly-ordered
//                    ring of decoded frames; the consumer pops frame i
//                    before i+1 (SLAM needs ordered frames), overlapping
//                    host decode with device compute.
//   * ByteQueue    — bounded blob queue with drop-on-overrun counting
//                    (the data-logger semantics: drop + warn, never block
//                    the producer).
//
// Build: g++ -O3 -shared -fPIC runtime.cc -o libra_slam_native.so -lz -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>
#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// SensFile
// ---------------------------------------------------------------------------

struct SensFrameIdx {
  float c2w[16];
  uint64_t ts_color_us;
  uint64_t color_off, color_len;
  uint64_t depth_off, depth_len;
};

struct SensFile {
  int fd = -1;
  uint32_t color_w = 0, color_h = 0, depth_w = 0, depth_h = 0;
  int32_t color_comp = 0, depth_comp = 0;
  float depth_shift = 1000.f;
  float intrinsic[16];  // depth intrinsic, row-major 4x4
  std::vector<SensFrameIdx> frames;
};

static bool read_exact(int fd, void* dst, size_t n, uint64_t off) {
  size_t got = 0;
  auto* p = static_cast<uint8_t*>(dst);
  while (got < n) {
    ssize_t r = pread(fd, p + got, n - got, off + got);
    if (r <= 0) return false;
    got += static_cast<size_t>(r);
  }
  return true;
}

void* sens_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto* s = new SensFile();
  s->fd = fd;

  uint64_t off = 0;
  uint32_t version;
  uint64_t name_len;
  if (!read_exact(fd, &version, 4, off)) goto fail;
  off += 4;
  if (!read_exact(fd, &name_len, 8, off)) goto fail;
  off += 8 + name_len;  // skip sensor name

  {
    float calib[4][16];  // color K, color E, depth K, depth E
    for (auto& m : calib) {
      if (!read_exact(fd, m, 64, off)) goto fail;
      off += 64;
    }
    std::memcpy(s->intrinsic, calib[2], 64);
  }
  if (!read_exact(fd, &s->color_comp, 4, off)) goto fail;
  off += 4;
  if (!read_exact(fd, &s->depth_comp, 4, off)) goto fail;
  off += 4;
  {
    uint32_t whwh[4];
    if (!read_exact(fd, whwh, 16, off)) goto fail;
    off += 16;
    s->color_w = whwh[0];
    s->color_h = whwh[1];
    s->depth_w = whwh[2];
    s->depth_h = whwh[3];
  }
  if (!read_exact(fd, &s->depth_shift, 4, off)) goto fail;
  off += 4;

  {
    uint64_t n_frames;
    if (!read_exact(fd, &n_frames, 8, off)) goto fail;
    off += 8;
    s->frames.resize(n_frames);
    for (uint64_t i = 0; i < n_frames; ++i) {
      auto& fr = s->frames[i];
      uint64_t hdr[4];  // tsColor, tsDepth, colorBytes, depthBytes
      if (!read_exact(fd, fr.c2w, 64, off)) goto fail;
      off += 64;
      if (!read_exact(fd, hdr, 32, off)) goto fail;
      off += 32;
      fr.ts_color_us = hdr[0];
      fr.color_off = off;
      fr.color_len = hdr[2];
      fr.depth_off = off + hdr[2];
      fr.depth_len = hdr[3];
      off += hdr[2] + hdr[3];
    }
  }
  return s;
fail:
  close(fd);
  delete s;
  return nullptr;
}

void sens_close(void* h) {
  auto* s = static_cast<SensFile*>(h);
  if (!s) return;
  close(s->fd);
  delete s;
}

int sens_info(void* h, int* n_frames, int* cw, int* ch, int* dw, int* dh,
              float* depth_shift, float* intrinsic16) {
  auto* s = static_cast<SensFile*>(h);
  if (!s) return -1;
  *n_frames = static_cast<int>(s->frames.size());
  *cw = s->color_w;
  *ch = s->color_h;
  *dw = s->depth_w;
  *dh = s->depth_h;
  *depth_shift = s->depth_shift;
  std::memcpy(intrinsic16, s->intrinsic, 64);
  return 0;
}

int sens_pose(void* h, int idx, float* c2w16) {
  auto* s = static_cast<SensFile*>(h);
  if (!s || idx < 0 || idx >= (int)s->frames.size()) return -1;
  std::memcpy(c2w16, s->frames[idx].c2w, 64);
  return 0;
}

double sens_timestamp(void* h, int idx) {
  auto* s = static_cast<SensFile*>(h);
  if (!s || idx < 0 || idx >= (int)s->frames.size()) return -1.0;
  return s->frames[idx].ts_color_us * 1e-6;
}

// libjpeg error handling: longjmp out instead of exit()
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf env;
};
static void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->env, 1);
}

static bool decode_jpeg(const uint8_t* blob, size_t n, uint8_t* rgb_out,
                        uint32_t w, uint32_t h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, blob, n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_width != w || cinfo.output_height != h) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb_out + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// PNG color frames (sensorData.hpp TYPE_PNG): libpng16 simplified API.
static bool decode_png(const uint8_t* blob, size_t n, uint8_t* rgb_out,
                       uint32_t w, uint32_t h) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, blob, n)) return false;
  if (img.width != w || img.height != h) {
    png_image_free(&img);
    return false;
  }
  img.format = PNG_FORMAT_RGB;
  const bool ok =
      png_image_finish_read(&img, nullptr, rgb_out, 0, nullptr) != 0;
  png_image_free(&img);
  return ok;
}

// Decode frame idx: rgb_out [color_h * color_w * 3] u8,
// depth_out [depth_h * depth_w] u16. Thread-safe (pread).
int sens_decode(void* h, int idx, uint8_t* rgb_out, uint16_t* depth_out) {
  auto* s = static_cast<SensFile*>(h);
  if (!s || idx < 0 || idx >= (int)s->frames.size()) return -1;
  const auto& fr = s->frames[idx];

  std::vector<uint8_t> blob(fr.color_len);
  if (!read_exact(s->fd, blob.data(), fr.color_len, fr.color_off)) return -2;
  if (s->color_comp == 2) {  // JPEG
    if (!decode_jpeg(blob.data(), blob.size(), rgb_out, s->color_w, s->color_h))
      return -3;
  } else if (s->color_comp == 1) {  // PNG
    if (!decode_png(blob.data(), blob.size(), rgb_out, s->color_w, s->color_h))
      return -3;
  } else {  // raw
    std::memcpy(rgb_out, blob.data(),
                std::min<size_t>(blob.size(), size_t(s->color_w) * s->color_h * 3));
  }

  std::vector<uint8_t> dblob(fr.depth_len);
  if (!read_exact(s->fd, dblob.data(), fr.depth_len, fr.depth_off)) return -2;
  const size_t depth_bytes = size_t(s->depth_w) * s->depth_h * 2;
  if (s->depth_comp == 1) {  // zlib ushort
    uLongf out_len = depth_bytes;
    if (uncompress(reinterpret_cast<Bytef*>(depth_out), &out_len, dblob.data(),
                   dblob.size()) != Z_OK ||
        out_len != depth_bytes)
      return -4;
  } else {  // raw ushort
    std::memcpy(depth_out, dblob.data(), std::min(dblob.size(), depth_bytes));
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Ordered prefetcher
// ---------------------------------------------------------------------------

struct DecodedFrame {
  std::vector<uint8_t> rgb;
  std::vector<uint16_t> depth;
  float c2w[16];
  double ts = 0;
  int status = 0;
  bool ready = false;
};

struct Prefetcher {
  SensFile* sens = nullptr;
  int capacity = 0;
  std::atomic<int> next_job{0};   // next frame index to decode
  int next_out = 0;               // next frame index to hand out
  std::vector<DecodedFrame> ring;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};

  void worker() {
    const size_t rgb_n = size_t(sens->color_w) * sens->color_h * 3;
    const size_t d_n = size_t(sens->depth_w) * sens->depth_h;
    std::vector<uint8_t> rgb(rgb_n);
    std::vector<uint16_t> depth(d_n);
    while (!stop.load()) {
      int i = next_job.fetch_add(1);
      if (i >= (int)sens->frames.size()) return;
      int st = sens_decode(sens, i, rgb.data(), depth.data());
      std::unique_lock<std::mutex> lk(mu);
      // wait until slot i is within the consumer's window
      cv_space.wait(lk, [&] { return stop.load() || i < next_out + capacity; });
      if (stop.load()) return;
      auto& slot = ring[i % capacity];
      slot.rgb.swap(rgb);
      slot.depth.swap(depth);
      std::memcpy(slot.c2w, sens->frames[i].c2w, 64);
      slot.ts = sens->frames[i].ts_color_us * 1e-6;
      slot.status = st;
      slot.ready = true;
      rgb.resize(rgb_n);
      depth.resize(d_n);
      cv_ready.notify_all();
    }
  }
};

void* prefetch_create(void* sens_h, int num_threads, int capacity) {
  auto* s = static_cast<SensFile*>(sens_h);
  if (!s || capacity < 1) return nullptr;
  auto* p = new Prefetcher();
  p->sens = s;
  p->capacity = capacity;
  p->ring.resize(capacity);
  for (int t = 0; t < num_threads; ++t)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocking ordered pop. Returns the frame index, or -1 at end of stream,
// or -2 on decode error for that frame.
int prefetch_next(void* h, uint8_t* rgb_out, uint16_t* depth_out, float* c2w16,
                  double* ts) {
  auto* p = static_cast<Prefetcher*>(h);
  if (!p) return -1;
  int i = p->next_out;
  if (i >= (int)p->sens->frames.size()) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  auto& slot = p->ring[i % p->capacity];
  p->cv_ready.wait(lk, [&] { return slot.ready; });
  std::memcpy(rgb_out, slot.rgb.data(), slot.rgb.size());
  std::memcpy(depth_out, slot.depth.data(), slot.depth.size() * 2);
  std::memcpy(c2w16, slot.c2w, 64);
  *ts = slot.ts;
  int st = slot.status;
  slot.ready = false;
  p->next_out = i + 1;
  p->cv_space.notify_all();
  return st == 0 ? i : -2;
}

void prefetch_destroy(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  if (!p) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
  }
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& w : p->workers) w.join();
  delete p;
}

// ---------------------------------------------------------------------------
// Bounded byte queue (data-logger semantics: drop on overrun, count drops)
// ---------------------------------------------------------------------------

struct ByteQueue {
  std::deque<std::vector<uint8_t>> items;
  size_t capacity;
  std::atomic<long> dropped{0};
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv;
};

void* queue_create(int capacity) {
  auto* q = new ByteQueue();
  q->capacity = capacity;
  return q;
}

// 0 = queued, 1 = dropped (queue full; producer never blocks)
int queue_push(void* h, const void* data, long nbytes) {
  auto* q = static_cast<ByteQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  if (q->closed) return 1;
  if (q->items.size() >= q->capacity) {
    q->dropped.fetch_add(1);
    return 1;
  }
  const auto* p = static_cast<const uint8_t*>(data);
  q->items.emplace_back(p, p + nbytes);
  q->cv.notify_one();
  return 0;
}

// Returns item size (bytes copied into out, up to max_bytes),
// 0 on timeout, -1 when closed and drained.
long queue_pop(void* h, void* out, long max_bytes, double timeout_s) {
  auto* q = static_cast<ByteQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [&] { return !q->items.empty() || q->closed; };
  if (timeout_s < 0) {
    q->cv.wait(lk, pred);
  } else if (!q->cv.wait_for(lk, std::chrono::duration<double>(timeout_s),
                             pred)) {
    return 0;
  }
  if (q->items.empty()) return -1;  // closed + drained
  auto item = std::move(q->items.front());
  q->items.pop_front();
  long n = std::min<long>(item.size(), max_bytes);
  std::memcpy(out, item.data(), n);
  return n;
}

void queue_close(void* h) {
  auto* q = static_cast<ByteQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->cv.notify_all();
}

long queue_dropped(void* h) {
  return static_cast<ByteQueue*>(h)->dropped.load();
}

long queue_size(void* h) {
  auto* q = static_cast<ByteQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

void queue_destroy(void* h) { delete static_cast<ByteQueue*>(h); }

}  // extern "C"
