// Native batch loader of the PyTorch port: a C++ threaded batch producer
// that mmaps a packed float32 .npy stack of point clouds [S, N_stored, 3]
// (written by dpfx_torch/tools/pack_dataset.py) and serves training
// batches [B, n_points, 3] -- random epoch shuffling, per-item random point
// subsampling without replacement, optional per-shape normalization --
// through a bounded queue filled by worker threads, so host-side batch prep
// overlaps the device step. Exposed through a C ABI consumed via ctypes
// (dpfx_torch/native/__init__.py); no Python objects cross the boundary.
// The code below is the JAX package's loader (dpfx/native/src) unchanged,
// so the same seed serves the same batches from either package.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (see build_native()).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct NpyArray {
  int fd = -1;
  void* map = nullptr;
  size_t map_len = 0;
  const float* data = nullptr;  // [s, n, c]
  int64_t s = 0, n = 0, c = 0;
};

// Minimal .npy v1/v2 header parser for C-order little-endian float32.
bool parse_npy(const char* path, NpyArray* out, std::string* err) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) { *err = "open failed"; return false; }
  struct stat st;
  if (fstat(fd, &st) != 0) { *err = "fstat failed"; ::close(fd); return false; }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) { *err = "mmap failed"; ::close(fd); return false; }
  const unsigned char* p = static_cast<const unsigned char*>(map);
  if (st.st_size < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    *err = "not a .npy file"; munmap(map, st.st_size); ::close(fd); return false;
  }
  int major = p[6];
  size_t hlen, hoff;
  if (major == 1) { hlen = p[8] | (p[9] << 8); hoff = 10; }
  else {
    if (st.st_size < 12) { *err = "truncated npy v2 header"; munmap(map, st.st_size); ::close(fd); return false; }
    hlen = p[8] | (p[9] << 8) | (p[10] << 16) | (size_t(p[11]) << 24); hoff = 12;
  }
  if ((size_t)st.st_size < hoff + hlen) {
    *err = "truncated npy header"; munmap(map, st.st_size); ::close(fd); return false;
  }
  std::string header(reinterpret_cast<const char*>(p + hoff), hlen);
  if (header.find("'<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    *err = "need C-order little-endian float32 npy";
    munmap(map, st.st_size); ::close(fd); return false;
  }
  size_t sh = header.find("'shape': (");
  if (sh == std::string::npos) { *err = "no shape"; munmap(map, st.st_size); ::close(fd); return false; }
  sh += 10;
  int64_t dims[4] = {0, 0, 0, 0};
  int nd = 0;
  while (nd < 4) {
    while (sh < header.size() && (header[sh] == ' ' || header[sh] == ',')) sh++;
    if (sh >= header.size() || header[sh] == ')') break;
    dims[nd++] = strtoll(header.c_str() + sh, nullptr, 10);
    while (sh < header.size() && header[sh] != ',' && header[sh] != ')') sh++;
  }
  if (nd != 3) { *err = "need rank-3 [S,N,3] array"; munmap(map, st.st_size); ::close(fd); return false; }
  if (dims[0] <= 0 || dims[1] <= 0 || dims[2] <= 0 || dims[2] > 8) {
    *err = "bad shape"; munmap(map, st.st_size); ::close(fd); return false;
  }
  // a truncated/corrupt payload would make the workers read out of bounds
  uint64_t need = (uint64_t)dims[0] * dims[1] * dims[2] * sizeof(float);
  if ((uint64_t)st.st_size < hoff + hlen + need) {
    *err = "npy payload shorter than header shape implies (truncated file?)";
    munmap(map, st.st_size); ::close(fd); return false;
  }
  out->fd = fd;
  out->map = map;
  out->map_len = st.st_size;
  out->data = reinterpret_cast<const float*>(p + hoff + hlen);
  out->s = dims[0]; out->n = dims[1]; out->c = dims[2];
  return true;
}

struct Batch {
  std::vector<float> data;  // [b, n_points, c]
};

struct Batcher {
  NpyArray arr;
  int64_t batch_size, n_points;
  int normalize;  // 0 none, 1 per_shape
  uint64_t seed;
  int64_t max_queue;
  std::vector<std::thread> workers;
  std::deque<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  // epoch order shared by workers
  std::vector<int64_t> order;
  std::atomic<int64_t> cursor{0};
  int64_t epoch = 0;
  std::mutex order_mu;

  void reshuffle_locked() {
    std::mt19937_64 g(seed * 1000003ULL + epoch);
    order.resize(arr.s);
    for (int64_t i = 0; i < arr.s; i++) order[i] = i;
    std::shuffle(order.begin(), order.end(), g);
    cursor.store(0);
    epoch++;
  }

  // claim `batch_size` item indices, reshuffling at epoch boundaries
  void claim(std::vector<int64_t>* idx) {
    std::lock_guard<std::mutex> lk(order_mu);
    idx->clear();
    for (int64_t k = 0; k < batch_size; k++) {
      int64_t c = cursor.fetch_add(1);
      if (c >= (int64_t)order.size()) {
        reshuffle_locked();
        c = cursor.fetch_add(1);
      }
      idx->push_back(order[c]);
    }
  }

  void fill(Batch* b, const std::vector<int64_t>& idx, uint64_t salt) {
    const int64_t np = n_points, c = arr.c, n = arr.n;
    b->data.resize(batch_size * np * c);
    std::vector<int32_t> pts(n);
    for (int64_t bi = 0; bi < batch_size; bi++) {
      std::mt19937_64 g(seed ^ (salt * 0x9E3779B97F4A7C15ULL + bi) ^ (idx[bi] << 20));
      const float* src = arr.data + idx[bi] * n * c;
      float* dst = b->data.data() + bi * np * c;
      // partial Fisher-Yates: first np entries = sample w/o replacement
      for (int64_t i = 0; i < n; i++) pts[i] = (int32_t)i;
      for (int64_t i = 0; i < np; i++) {
        std::uniform_int_distribution<int64_t> u(i, n - 1);
        std::swap(pts[i], pts[u(g)]);
        const float* s3 = src + pts[i] * c;
        float* d3 = dst + i * c;
        for (int64_t j = 0; j < c; j++) d3[j] = s3[j];
      }
      if (normalize == 1) {
        // per-shape: center at mean, scale by max radius
        double mean[8] = {0};
        for (int64_t i = 0; i < np; i++)
          for (int64_t j = 0; j < c; j++) mean[j] += dst[i * c + j];
        for (int64_t j = 0; j < c; j++) mean[j] /= np;
        double maxr2 = 0;
        for (int64_t i = 0; i < np; i++) {
          double r2 = 0;
          for (int64_t j = 0; j < c; j++) {
            double d = dst[i * c + j] - mean[j];
            r2 += d * d;
          }
          if (r2 > maxr2) maxr2 = r2;
        }
        float inv = (float)(1.0 / std::max(std::sqrt(maxr2), 1e-9));
        for (int64_t i = 0; i < np; i++)
          for (int64_t j = 0; j < c; j++)
            dst[i * c + j] = (float)((dst[i * c + j] - mean[j]) * inv);
      }
    }
  }

  void worker(int wid) {
    uint64_t salt = wid * 1000003ULL;
    std::vector<int64_t> idx;
    while (!stop.load()) {
      claim(&idx);
      Batch b;
      fill(&b, idx, salt++);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return stop.load() || (int64_t)queue.size() < max_queue; });
      if (stop.load()) return;
      queue.push_back(std::move(b));
      cv_pop.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// returns handle or null; err_buf receives message
void* dpfx_batcher_open(const char* npy_path, int64_t batch_size, int64_t n_points,
                        int normalize, uint64_t seed, int n_workers,
                        char* err_buf, int err_len) {
  auto* b = new Batcher();
  std::string err;
  if (!parse_npy(npy_path, &b->arr, &err)) {
    snprintf(err_buf, err_len, "%s", err.c_str());
    delete b;
    return nullptr;
  }
  if (n_points > b->arr.n) {
    snprintf(err_buf, err_len, "n_points %lld > stored %lld",
             (long long)n_points, (long long)b->arr.n);
    delete b;
    return nullptr;
  }
  b->batch_size = batch_size;
  b->n_points = n_points;
  b->normalize = normalize;
  b->seed = seed;
  b->max_queue = std::max(2 * n_workers, 4);
  {
    std::lock_guard<std::mutex> lk(b->order_mu);
    b->reshuffle_locked();
  }
  for (int i = 0; i < n_workers; i++)
    b->workers.emplace_back([b, i] { b->worker(i); });
  return b;
}

// shape query: s, n_stored, c
void dpfx_batcher_shape(void* h, int64_t* out3) {
  auto* b = static_cast<Batcher*>(h);
  out3[0] = b->arr.s; out3[1] = b->arr.n; out3[2] = b->arr.c;
}

// blocking pop into caller buffer [batch_size, n_points, c] f32
void dpfx_batcher_next(void* h, float* out) {
  auto* b = static_cast<Batcher*>(h);
  Batch batch;
  {
    std::unique_lock<std::mutex> lk(b->mu);
    b->cv_pop.wait(lk, [&] { return !b->queue.empty(); });
    batch = std::move(b->queue.front());
    b->queue.pop_front();
    b->cv_push.notify_one();
  }
  memcpy(out, batch.data.data(), batch.data.size() * sizeof(float));
}

void dpfx_batcher_close(void* h) {
  auto* b = static_cast<Batcher*>(h);
  b->stop.store(true);
  b->cv_push.notify_all();
  b->cv_pop.notify_all();
  for (auto& t : b->workers) t.join();
  if (b->arr.map) munmap(b->arr.map, b->arr.map_len);
  if (b->arr.fd >= 0) ::close(b->arr.fd);
  delete b;
}

}  // extern "C"
