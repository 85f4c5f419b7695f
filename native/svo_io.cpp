// svo_io: native data-plane for stereo_vo.
//
// The reference's data loader is a C++ node (kitti_node.cpp: cv::imread of
// image_0/image_1 PNGs + paced publishing). This library is this framework's
// equivalent: a dependency-light grayscale PNG decoder (zlib only) and a
// multi-threaded prefetching replay loader with an in-order ring buffer, so
// image decode overlaps device compute without Python-thread (GIL) overhead.
//
// Exposed via a C ABI consumed from Python with ctypes
// (stereo_vo/data/native_loader.py).

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- PNG decode

struct PngImage {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> gray;  // width*height, row-major
};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit PNG (grayscale, gray+alpha, RGB or RGBA; no interlace) to
// grayscale. Returns 0 on success.
int decode_png_gray(const std::vector<uint8_t>& file, PngImage* out) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (file.size() < 8 || std::memcmp(file.data(), kSig, 8) != 0) return -1;

  size_t pos = 8;
  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= file.size()) {
    uint32_t len = be32(&file[pos]);
    if (pos + 12 + len > file.size()) return -2;
    const char* type = reinterpret_cast<const char*>(&file[pos + 4]);
    const uint8_t* data = &file[pos + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return -3;
      width = int(be32(data));
      height = int(be32(data + 4));
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
      if (bit_depth != 8 || interlace != 0) return -4;  // unsupported
      if (color_type != 0 && color_type != 2 && color_type != 4 &&
          color_type != 6)
        return -5;  // palette unsupported
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (width <= 0 || height <= 0 || idat.empty()) return -6;

  int channels = (color_type == 0) ? 1 : (color_type == 2) ? 3
                 : (color_type == 4) ? 2 : 4;
  size_t stride = size_t(width) * channels;
  std::vector<uint8_t> raw((stride + 1) * height);

  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return -7;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int zret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zret != Z_STREAM_END || zs.avail_out != 0) return -8;

  // unfilter in place into a contiguous pixel buffer
  std::vector<uint8_t> pixels(stride * height);
  const int bpp = channels;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = &raw[size_t(y) * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* row = src + 1;
    uint8_t* dst = &pixels[size_t(y) * stride];
    const uint8_t* up = y > 0 ? &pixels[size_t(y - 1) * stride] : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(dst, row, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = uint8_t(row[x] + (x >= size_t(bpp) ? dst[x - bpp] : 0));
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = uint8_t(row[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = up ? up[x] : 0;
          dst[x] = uint8_t(row[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
          dst[x] = uint8_t(row[x] + paeth(a, b, c));
        }
        break;
      default:
        return -9;
    }
  }

  out->width = width;
  out->height = height;
  out->gray.resize(size_t(width) * height);
  if (channels == 1) {
    out->gray = std::move(pixels);
  } else if (channels == 2) {  // gray + alpha
    for (size_t i = 0; i < out->gray.size(); ++i) out->gray[i] = pixels[2 * i];
  } else {  // RGB(A) -> BT.601 luma, OpenCV-compatible rounding
    for (size_t i = 0; i < out->gray.size(); ++i) {
      const uint8_t* px = &pixels[i * channels];
      out->gray[i] =
          uint8_t((299 * px[0] + 587 * px[1] + 114 * px[2] + 500) / 1000);
    }
  }
  return 0;
}

int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return -3; }
  long n = std::ftell(f);
  // ftell returns -1 for directories / non-seekable streams; resizing to
  // size_t(-1) would throw bad_alloc across the extern "C" ABI into ctypes
  if (n < 0 || std::fseek(f, 0, SEEK_SET) != 0) { std::fclose(f); return -3; }
  out->resize(size_t(n));
  size_t got = std::fread(out->data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n) ? 0 : -2;
}

// ------------------------------------------------------------- replay loader

struct Slot {
  PngImage left, right;
  int status = 0;
  bool ready = false;
};

struct Loader {
  std::vector<std::string> lefts, rights;
  std::vector<Slot> slots;
  size_t capacity;
  std::atomic<size_t> next_to_decode{0};
  size_t next_to_consume = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void work() {
    while (!stop.load()) {
      size_t idx = next_to_decode.fetch_add(1);
      if (idx >= lefts.size()) return;
      // wait until the ring slot is free
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || idx < next_to_consume + capacity;
        });
        if (stop.load()) return;
      }
      Slot tmp;
      std::vector<uint8_t> buf;
      tmp.status = read_file(lefts[idx].c_str(), &buf);
      if (tmp.status == 0) tmp.status = decode_png_gray(buf, &tmp.left);
      if (tmp.status == 0) {
        tmp.status = read_file(rights[idx].c_str(), &buf);
        if (tmp.status == 0) tmp.status = decode_png_gray(buf, &tmp.right);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        Slot& s = slots[idx % capacity];
        s = std::move(tmp);
        s.ready = true;
      }
      cv_ready.notify_all();
    }
  }
};

std::vector<std::string> list_pngs(const char* dir) {
  std::vector<std::string> out;
  DIR* d = opendir(dir);
  if (!d) return out;
  while (dirent* e = readdir(d)) {
    std::string name = e->d_name;
    if (name.size() > 4 && name.substr(name.size() - 4) == ".png")
      out.push_back(std::string(dir) + "/" + name);
  }
  closedir(d);
  std::sort(out.begin(), out.end());
  return out;
}

}  // namespace

extern "C" {

// Decode one PNG to grayscale. Returns 0 on success; fills w/h. `out` must
// hold at least max_bytes; fails with -100 if the image is larger.
int svo_png_read_gray(const char* path, uint8_t* out, int* w, int* h,
                      long max_bytes) {
  std::vector<uint8_t> buf;
  int rc = read_file(path, &buf);
  if (rc != 0) return rc;
  PngImage img;
  rc = decode_png_gray(buf, &img);
  if (rc != 0) return rc;
  if (long(img.gray.size()) > max_bytes) return -100;
  std::memcpy(out, img.gray.data(), img.gray.size());
  *w = img.width;
  *h = img.height;
  return 0;
}

void* svo_loader_open(const char* left_dir, const char* right_dir,
                      int prefetch, int n_threads) {
  auto* ld = new Loader();
  ld->lefts = list_pngs(left_dir);
  ld->rights = list_pngs(right_dir);
  size_t n = std::min(ld->lefts.size(), ld->rights.size());
  ld->lefts.resize(n);
  ld->rights.resize(n);
  ld->capacity = size_t(std::max(prefetch, 1));
  ld->slots.resize(ld->capacity);
  int nt = std::max(1, std::min(n_threads, 16));
  for (int i = 0; i < nt; ++i)
    ld->workers.emplace_back([ld] { ld->work(); });
  return ld;
}

long svo_loader_count(void* handle) {
  return long(static_cast<Loader*>(handle)->lefts.size());
}

// Blocking in-order fetch of the next decoded pair. Returns 0 on success,
// 1 when the sequence is exhausted, <0 on decode error.
int svo_loader_next(void* handle, uint8_t* left, uint8_t* right, int* w,
                    int* h, long max_bytes) {
  auto* ld = static_cast<Loader*>(handle);
  if (ld->next_to_consume >= ld->lefts.size()) return 1;
  size_t idx = ld->next_to_consume;
  Slot taken;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_ready.wait(lk, [&] { return ld->slots[idx % ld->capacity].ready; });
    Slot& s = ld->slots[idx % ld->capacity];
    taken = std::move(s);
    s.ready = false;
    ld->next_to_consume = idx + 1;
  }
  ld->cv_space.notify_all();
  if (taken.status != 0) return taken.status;
  if (long(taken.left.gray.size()) > max_bytes ||
      long(taken.right.gray.size()) > max_bytes)
    return -100;
  std::memcpy(left, taken.left.gray.data(), taken.left.gray.size());
  std::memcpy(right, taken.right.gray.data(), taken.right.gray.size());
  *w = taken.left.width;
  *h = taken.left.height;
  return 0;
}

void svo_loader_close(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  ld->stop.store(true);
  ld->cv_space.notify_all();
  ld->cv_ready.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
