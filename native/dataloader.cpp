// Native data-loader for orbslam3_tpu: PNG grayscale decode + CSV parsing +
// multi-threaded prefetch.
//
// Role parity with the reference's native IO path (OpenCV imread called from
// /root/reference/src/io/euroc.rs:122-125 and the csv crate): image decode
// and dataset streaming stay off the Python interpreter and off the device,
// feeding frames to the device input pipeline ahead of time.
//
// Exposed as a plain C ABI consumed via ctypes (orbslam3_tpu/io/native.py).
//
// PNG support: 8-bit greyscale / RGB / RGBA / palette-less, non-interlaced
// (covers EuRoC cam PNGs), all five scanline filters, zlib inflate.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <tuple>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- PNG
static bool inflate_all(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = static_cast<uInt>(n);
  uint8_t buf[1 << 16];
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    zs.next_out = buf;
    zs.avail_out = sizeof(buf);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), buf, buf + (sizeof(buf) - zs.avail_out));
  }
  inflateEnd(&zs);
  return true;
}

static inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode a PNG file into an 8-bit grayscale buffer. Returns 0 on success.
// out must hold width*height bytes (query with png_info first).
int png_info(const char* path, int* width, int* height) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[33];
  if (fread(hdr, 1, 33, f) != 33 || memcmp(hdr, "\x89PNG\r\n\x1a\n", 8) != 0) {
    fclose(f);
    return -2;
  }
  fclose(f);
  *width = static_cast<int>(be32(hdr + 16));
  *height = static_cast<int>(be32(hdr + 20));
  return 0;
}

int png_decode_gray(const char* path, uint8_t* out, int out_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(static_cast<size_t>(sz));
  if (fread(data.data(), 1, data.size(), f) != data.size()) {
    fclose(f);
    return -2;
  }
  fclose(f);
  if (data.size() < 45 || memcmp(data.data(), "\x89PNG\r\n\x1a\n", 8) != 0) return -3;

  uint32_t w = be32(&data[16]), h = be32(&data[20]);
  uint8_t bit_depth = data[24], color_type = data[25], interlace = data[28];
  if (bit_depth != 8 || interlace != 0) return -4;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return -5;
  }
  if (out_cap < static_cast<int>(w * h)) return -6;

  // concat IDAT chunks
  std::vector<uint8_t> compressed;
  size_t pos = 8;
  while (pos + 8 <= data.size()) {
    uint32_t len = be32(&data[pos]);
    const uint8_t* type = &data[pos + 4];
    if (memcmp(type, "IDAT", 4) == 0 && pos + 8 + len <= data.size()) {
      compressed.insert(compressed.end(), &data[pos + 8], &data[pos + 8 + len]);
    }
    if (memcmp(type, "IEND", 4) == 0) break;
    pos += 12 + len;
  }
  std::vector<uint8_t> raw;
  raw.reserve(static_cast<size_t>(w) * h * ch + h);
  if (!inflate_all(compressed.data(), compressed.size(), raw)) return -7;
  const size_t stride = static_cast<size_t>(w) * ch;
  if (raw.size() < (stride + 1) * h) return -8;

  // defilter in place into a scanline buffer, then to gray
  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* line = &raw[(stride + 1) * y];
    uint8_t filter = line[0];
    const uint8_t* src = line + 1;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= static_cast<size_t>(ch) ? cur[x - ch] : 0;
      int b = prev[x];
      int c = x >= static_cast<size_t>(ch) ? prev[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -9;
      }
      cur[x] = static_cast<uint8_t>(v);
    }
    uint8_t* dst = out + static_cast<size_t>(y) * w;
    if (ch == 1) {
      memcpy(dst, cur.data(), w);
    } else if (ch == 2) {
      for (uint32_t x = 0; x < w; x++) dst[x] = cur[x * 2];
    } else {
      for (uint32_t x = 0; x < w; x++) {
        const uint8_t* px = &cur[x * ch];
        dst[x] = static_cast<uint8_t>((299 * px[0] + 587 * px[1] + 114 * px[2]) / 1000);
      }
    }
    std::swap(prev, cur);
  }
  return 0;
}

// ---------------------------------------------------------------- CSV
// Parse an IMU csv (timestamp_ns, wx, wy, wz, ax, ay, az). Returns count or <0.
long imu_csv_parse(const char* path, int64_t* ts, float* gyro, float* acc,
                   long cap) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char line[512];
  long n = 0;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == '#' || line[0] == '\n') continue;
    if (n >= cap) break;
    long long t;
    float v[6];
    if (sscanf(line, "%lld,%f,%f,%f,%f,%f,%f", &t, &v[0], &v[1], &v[2], &v[3],
               &v[4], &v[5]) == 7) {
      ts[n] = t;
      memcpy(gyro + 3 * n, v, 3 * sizeof(float));
      memcpy(acc + 3 * n, v + 3, 3 * sizeof(float));
      n++;
    }
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------- prefetcher
// A background-thread image prefetcher: decodes PNG frames ahead of the
// consumer (the role crossbeam channels + OS readahead play for the
// reference's frame loop in src/main.rs:64-77).
struct Prefetcher {
  std::vector<std::string> paths;
  int width = 0, height = 0;
  size_t next_submit = 0;
  // (frame index, decode status 0/-1, pixels)
  std::queue<std::tuple<size_t, int, std::vector<uint8_t>>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<size_t> next_job{0};
  size_t max_queue = 8;
  size_t next_consume = 0;
  std::vector<std::tuple<size_t, int, std::vector<uint8_t>>> stash;

  void worker() {
    while (!stop.load()) {
      size_t j = next_job.fetch_add(1);
      if (j >= paths.size()) return;
      std::vector<uint8_t> buf(static_cast<size_t>(width) * height);
      // a failed/truncated PNG must not serve uninitialized memory as
      // frame data: zero-fill and surface the status to the consumer
      int rc = png_decode_gray(paths[j].c_str(), buf.data(),
                               static_cast<int>(buf.size()));
      if (rc != 0) std::fill(buf.begin(), buf.end(), 0);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
      if (stop.load()) return;
      ready.emplace(j, rc == 0 ? 0 : -1, std::move(buf));
      cv_ready.notify_all();
    }
  }
};

void* prefetcher_create(const char** paths, long n, int width, int height,
                        int threads) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->width = width;
  p->height = height;
  for (int i = 0; i < threads; i++) p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until frame `index` is available; frames must be consumed in order.
int prefetcher_get(void* handle, long index, uint8_t* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  const size_t want = static_cast<size_t>(index);
  const size_t bytes = static_cast<size_t>(p->width) * p->height;
  // check stash first (out-of-order arrivals)
  while (true) {
    for (size_t i = 0; i < p->stash.size(); i++) {
      if (std::get<0>(p->stash[i]) == want) {
        memcpy(out, std::get<2>(p->stash[i]).data(), bytes);
        int st = std::get<1>(p->stash[i]);
        p->stash.erase(p->stash.begin() + i);
        return st == 0 ? 0 : 1;  // 1 = decode failed, buffer zeroed
      }
    }
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->ready.empty()) {
      p->cv_ready.wait(lk, [&] { return !p->ready.empty() || p->stop.load(); });
      if (p->stop.load()) return -1;
    }
    auto item = std::move(p->ready.front());
    p->ready.pop();
    p->cv_space.notify_all();
    lk.unlock();
    if (std::get<0>(item) == want) {
      memcpy(out, std::get<2>(item).data(), bytes);
      return std::get<1>(item) == 0 ? 0 : 1;  // 1 = decode failed
    }
    p->stash.emplace_back(std::move(item));
  }
}

void prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_ready.notify_all();
  p->cv_space.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
