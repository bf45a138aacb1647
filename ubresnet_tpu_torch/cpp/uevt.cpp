// uevt.cpp — native UEVT event-file reader + threaded batch filler.
//
// Equivalent of the reference's larcv C++ data layer
// (larcv::IOManager random access + ThreadProcessor/ThreadDatumFiller
// prefetch threads, SURVEY.md §2.2): mmap-based zero-parse reads, N
// pthreads assembling training batches (image/label/weight) into a
// bounded ring of buffers, with class remap, ADC threshold, and mirror
// augmentation done in native code off the Python GIL.
//
// File layout: see ubresnet_tpu_torch/data/uevt.py (little-endian,
// packed).
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread uevt.cpp, done at
// first use by ubresnet_tpu_torch/utils/native_build.py; ctypes binds
// it in ubresnet_tpu_torch/data/native.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

#pragma pack(push, 1)
struct Header {
  char magic[4];
  uint32_t version;
  uint64_t n_entries;
  uint64_t index_off;
};
struct ImgHdr {
  char producer[32];
  uint32_t run, subrun, event, plane;
  double min_x, min_y, max_x, max_y;
  uint32_t rows, cols, dtype;
};
struct IdxEntry {
  uint64_t offset, nbytes;
  uint32_t run, subrun, event;
};
#pragma pack(pop)

size_t dtype_size(uint32_t dt) { return (dt == 1 || dt == 3) ? 2 : 4; }

// IEEE binary16 -> binary32 (dtype 3; scores written with
// --f16-scores). Handles subnormals/inf/nan; exactness pinned by
// tests/test_native.py against numpy's float16 cast.
float half_to_float(uint16_t v) {
  uint32_t sign = (uint32_t)(v >> 15) << 31;
  uint32_t exp = (v >> 10) & 0x1f;
  uint32_t man = v & 0x3ff;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) {
      f = sign;  // +-0
    } else {
      int e = 0;  // subnormal: value = man/2^10 * 2^-14
      while (!(man & 0x400)) {
        man <<= 1;
        e++;
      }
      man &= 0x3ff;
      f = sign | ((uint32_t)(127 - 14 - e) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    f = sign | 0x7f800000u | (man << 13);  // inf/nan
  } else {
    f = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  memcpy(&out, &f, 4);
  return out;
}

struct File {
  int fd = -1;
  const uint8_t *base = nullptr;
  size_t size = 0;
  const IdxEntry *index = nullptr;
  uint64_t n_entries = 0;

  bool open(const char *path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = st.st_size;
    if (size < sizeof(Header)) return false;
    base = (const uint8_t *)mmap(nullptr, size, PROT_READ, MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) return false;
    Header h;
    memcpy(&h, base, sizeof(h));
    if (memcmp(h.magic, "UEVT", 4) != 0 || h.version != 1) return false;
    // index table must lie inside the map (fields are file-controlled)
    if (h.index_off > size ||
        h.n_entries > (size - h.index_off) / sizeof(IdxEntry))
      return false;
    n_entries = h.n_entries;
    index = (const IdxEntry *)(base + h.index_off);
    return true;
  }
  void close() {
    if (base && base != MAP_FAILED) munmap((void *)base, size);
    if (fd >= 0) ::close(fd);
  }

  // find image by producer (+plane, -1 = any) in an entry; returns
  // payload pointer or nullptr. fills hdr.
  const uint8_t *find(uint64_t entry, const char *producer, int plane,
                      ImgHdr *hdr) const {
    if (entry >= n_entries) return nullptr;
    // entry span and every image walked inside it must stay within the
    // map: offsets/counts/dims all come from the (untrusted) file
    uint64_t off = index[entry].offset, span = index[entry].nbytes;
    if (off > size || span > size - off) return nullptr;
    const uint8_t *p = base + off;
    const uint8_t *end = p + span;
    if (size_t(end - p) < 4) return nullptr;
    uint32_t n_images;
    memcpy(&n_images, p, 4);
    p += 4;
    for (uint32_t i = 0; i < n_images; i++) {
      if (size_t(end - p) < sizeof(ImgHdr)) return nullptr;
      ImgHdr h;
      memcpy(&h, p, sizeof(h));
      const uint8_t *payload = p + sizeof(h);
      size_t nb = (size_t)h.rows * h.cols * dtype_size(h.dtype);
      if (nb > size_t(end - payload)) return nullptr;
      if (strncmp(h.producer, producer, 32) == 0 &&
          (plane < 0 || (int)h.plane == plane)) {
        *hdr = h;
        return payload;
      }
      p = payload + nb;
    }
    return nullptr;
  }
};

// decode payload into float32 (or int32 for labels) dest of rows*cols
void decode_f32(const ImgHdr &h, const uint8_t *payload, float *dst) {
  size_t n = (size_t)h.rows * h.cols;
  if (h.dtype == 0) {
    memcpy(dst, payload, n * 4);
  } else if (h.dtype == 1) {
    const uint16_t *s = (const uint16_t *)payload;
    for (size_t i = 0; i < n; i++) dst[i] = (float)s[i];
  } else if (h.dtype == 3) {
    const uint16_t *s = (const uint16_t *)payload;
    for (size_t i = 0; i < n; i++) dst[i] = half_to_float(s[i]);
  } else {
    const int32_t *s = (const int32_t *)payload;
    for (size_t i = 0; i < n; i++) dst[i] = (float)s[i];
  }
}
void decode_i32(const ImgHdr &h, const uint8_t *payload, int32_t *dst) {
  size_t n = (size_t)h.rows * h.cols;
  if (h.dtype == 2) {
    memcpy(dst, payload, n * 4);
  } else if (h.dtype == 1) {
    const uint16_t *s = (const uint16_t *)payload;
    for (size_t i = 0; i < n; i++) dst[i] = (int32_t)s[i];
  } else if (h.dtype == 3) {
    const uint16_t *s = (const uint16_t *)payload;
    for (size_t i = 0; i < n; i++) dst[i] = (int32_t)half_to_float(s[i]);
  } else {
    const float *s = (const float *)payload;
    for (size_t i = 0; i < n; i++) dst[i] = (int32_t)s[i];
  }
}

struct Batch {
  std::vector<float> image;
  std::vector<int32_t> label;
  std::vector<float> weight;
};

struct Filler {
  std::vector<File *> files;          // borrowed
  std::vector<std::pair<File *, uint64_t>> entries;
  std::string img_prod, lbl_prod, wgt_prod;
  int plane = -1;
  int batch = 4, rows = 0, cols = 0;
  int n_threads = 2, n_buffers = 4;
  bool mirror = false;
  float adc_threshold = 0.0f;
  std::vector<int32_t> class_map;  // empty = identity
  uint64_t seed = 0;

  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::queue<Batch *> ready;
  std::vector<Batch *> pool;
  std::atomic<bool> stop{false};

  void start() {
    for (int i = 0; i < n_buffers; i++) pool.push_back(new Batch());
    for (int t = 0; t < n_threads; t++)
      threads.emplace_back([this, t] { worker(t); });
  }

  void worker(int tid) {
    std::mt19937_64 rng(seed + tid);
    size_t n = entries.size();
    size_t px = (size_t)rows * cols;
    while (!stop.load()) {
      Batch *b = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_put.wait(lk, [this] { return stop.load() || !pool.empty(); });
        if (stop.load()) return;
        b = pool.back();
        pool.pop_back();
      }
      b->image.resize((size_t)batch * px);
      b->label.resize((size_t)batch * px);
      b->weight.resize((size_t)batch * px);
      for (int i = 0; i < batch; i++) {
        auto [f, e] = entries[rng() % n];
        float *img = b->image.data() + (size_t)i * px;
        int32_t *lbl = b->label.data() + (size_t)i * px;
        float *wgt = b->weight.data() + (size_t)i * px;
        ImgHdr h;
        const uint8_t *p = f->find(e, img_prod.c_str(), plane, &h);
        if (p && (int)h.rows == rows && (int)h.cols == cols)
          decode_f32(h, p, img);
        else
          memset(img, 0, px * 4);
        p = f->find(e, lbl_prod.c_str(), plane, &h);
        if (p && (int)h.rows == rows && (int)h.cols == cols)
          decode_i32(h, p, lbl);
        else
          memset(lbl, 0, px * 4);
        p = wgt_prod.empty() ? nullptr
                             : f->find(e, wgt_prod.c_str(), plane, &h);
        if (p && (int)h.rows == rows && (int)h.cols == cols)
          decode_f32(h, p, wgt);
        else
          for (size_t j = 0; j < px; j++) wgt[j] = 1.0f;

        if (!class_map.empty())
          for (size_t j = 0; j < px; j++) {
            int32_t v = lbl[j];
            lbl[j] = (v >= 0 && v < (int32_t)class_map.size()) ? class_map[v]
                                                               : v;
          }
        if (adc_threshold > 0.0f)
          for (size_t j = 0; j < px; j++)
            if (img[j] < adc_threshold) img[j] = 0.0f;
        if (mirror && (rng() & 1)) {  // horizontal flip (col reversal)
          for (int r = 0; r < rows; r++) {
            float *ir = img + (size_t)r * cols;
            int32_t *lr = lbl + (size_t)r * cols;
            float *wr = wgt + (size_t)r * cols;
            for (int c = 0; c < cols / 2; c++) {
              std::swap(ir[c], ir[cols - 1 - c]);
              std::swap(lr[c], lr[cols - 1 - c]);
              std::swap(wr[c], wr[cols - 1 - c]);
            }
          }
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push(b);
      }
      cv_get.notify_one();
    }
  }

  // copy next ready batch into caller buffers; blocks. returns 0 ok.
  int next(float *img, int32_t *lbl, float *wgt) {
    Batch *b = nullptr;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_get.wait(lk, [this] { return stop.load() || !ready.empty(); });
      if (stop.load() && ready.empty()) return -1;
      b = ready.front();
      ready.pop();
    }
    size_t px = (size_t)rows * cols * batch;
    memcpy(img, b->image.data(), px * 4);
    memcpy(lbl, b->label.data(), px * 4);
    memcpy(wgt, b->weight.data(), px * 4);
    {
      std::lock_guard<std::mutex> lk(mu);
      pool.push_back(b);
    }
    cv_put.notify_one();
    return 0;
  }

  void shutdown() {
    stop.store(true);
    cv_put.notify_all();
    cv_get.notify_all();
    for (auto &t : threads) t.join();
    while (!ready.empty()) {
      pool.push_back(ready.front());
      ready.pop();
    }
    for (auto *b : pool) delete b;
    pool.clear();
  }
};

}  // namespace

extern "C" {

void *uevt_open(const char *path) {
  File *f = new File();
  if (!f->open(path)) {
    f->close();
    delete f;
    return nullptr;
  }
  return f;
}

void uevt_close(void *h) {
  File *f = (File *)h;
  f->close();
  delete f;
}

long uevt_n_entries(void *h) { return (long)((File *)h)->n_entries; }

// read one image as float32 into dst (must be rows*cols); returns 0 ok,
// fills meta_out[7] = {min_x,min_y,max_x,max_y,rows,cols,plane}.
int uevt_read_image_f32(void *h, long entry, const char *producer, int plane,
                        float *dst, double *meta_out, int *rse_out) {
  ImgHdr hdr;
  const uint8_t *p = ((File *)h)->find(entry, producer, plane, &hdr);
  if (!p) return -1;
  decode_f32(hdr, p, dst);
  if (meta_out) {
    meta_out[0] = hdr.min_x;
    meta_out[1] = hdr.min_y;
    meta_out[2] = hdr.max_x;
    meta_out[3] = hdr.max_y;
    meta_out[4] = hdr.rows;
    meta_out[5] = hdr.cols;
    meta_out[6] = hdr.plane;
  }
  if (rse_out) {
    rse_out[0] = hdr.run;
    rse_out[1] = hdr.subrun;
    rse_out[2] = hdr.event;
  }
  return 0;
}

// image dims of the first matching image (for buffer sizing)
int uevt_image_dims(void *h, long entry, const char *producer, int plane,
                    int *rows, int *cols) {
  ImgHdr hdr;
  const uint8_t *p = ((File *)h)->find(entry, producer, plane, &hdr);
  if (!p) return -1;
  *rows = hdr.rows;
  *cols = hdr.cols;
  return 0;
}

void *filler_create(void **file_handles, int n_files, const char *img_prod,
                    const char *lbl_prod, const char *wgt_prod, int plane,
                    int batch, int rows, int cols, int n_threads,
                    int n_buffers, int mirror, float adc_threshold,
                    const int32_t *class_map, int class_map_len,
                    uint64_t seed) {
  Filler *f = new Filler();
  for (int i = 0; i < n_files; i++) {
    File *file = (File *)file_handles[i];
    f->files.push_back(file);
    for (uint64_t e = 0; e < file->n_entries; e++)
      f->entries.push_back({file, e});
  }
  if (f->entries.empty()) {
    delete f;
    return nullptr;
  }
  f->img_prod = img_prod;
  f->lbl_prod = lbl_prod;
  f->wgt_prod = wgt_prod ? wgt_prod : "";
  f->plane = plane;
  f->batch = batch;
  f->rows = rows;
  f->cols = cols;
  f->n_threads = n_threads;
  f->n_buffers = n_buffers;
  f->mirror = mirror != 0;
  f->adc_threshold = adc_threshold;
  if (class_map && class_map_len > 0)
    f->class_map.assign(class_map, class_map + class_map_len);
  f->seed = seed;
  f->start();
  return f;
}

int filler_next(void *h, float *img, int32_t *lbl, float *wgt) {
  return ((Filler *)h)->next(img, lbl, wgt);
}

void filler_destroy(void *h) {
  Filler *f = (Filler *)h;
  f->shutdown();
  delete f;
}

}  // extern "C"
