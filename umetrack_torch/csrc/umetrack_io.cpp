// Native host-side IO for the torch_data reader (umetrack_torch/data/native.py):
// mmap'd idx/bin reading and a multi-threaded prefetch ring.  The port's own
// copy of the JAX package's native/umetrack_io.cpp, the same C ABI.
//
// The reference delegated its IO muscle to Python asyncio plumbing
// (lib/data_utils/async_utils.py, nested_async.py) — an event loop on a
// daemon thread shuttling byte ranges through thread pools, all under the
// GIL.  Here the equivalent capability is real native code: the idx header
// is parsed once, the bin file is mmap'd, worker threads prefault pages and
// hand frame spans to the consumer through a bounded ring, and the GIL is
// never held on the byte path (Python only sees ctypes pointers it wraps as
// zero-copy numpy arrays).
//
// C ABI (ctypes-friendly):
//   ut_open / ut_close            — open a .torch.idx/.torch.bin pair
//   ut_len / ut_frame_ptr / ...   — zero-copy frame access
//   ut_ring_create / ut_ring_next / ut_ring_destroy — prefetch pipeline
//
// Build: g++ -O2 -shared -fPIC -pthread, at first use, by ops/_build.py::build_host
// into umetrack_torch/_build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int64_t kMagic = 0x584449544E54;

struct IdxBin {
  std::vector<int64_t> byte_offsets;  // N+1
  std::vector<int64_t> dim_offsets;   // N+1 (into dims)
  std::vector<int64_t> dims;          // flattened shapes
  int64_t n = 0;
  int64_t dtype_code = 0;
  int64_t itemsize = 0;
  uint8_t* data = nullptr;  // mmap of .bin
  size_t data_size = 0;
  int fd = -1;
  std::string error;
};

bool read_file_int64(const char* path, std::vector<int64_t>& out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  if (size <= 0 || size % 8 != 0) {
    std::fclose(fp);
    return false;
  }
  out.resize(size / 8);
  size_t got = std::fread(out.data(), 8, out.size(), fp);
  std::fclose(fp);
  return got == out.size();
}

}  // namespace

extern "C" {

void* ut_open(const char* idx_path, const char* bin_path) {
  auto* f = new IdxBin();
  std::vector<int64_t> raw;
  if (!read_file_int64(idx_path, raw) || raw.size() < 6) {
    delete f;
    return nullptr;
  }
  const int64_t version = raw[1];
  if (!((version == 1 && raw[0] == kMagic) || (version == 0 && raw[0] == 0))) {
    delete f;
    return nullptr;
  }
  f->dtype_code = raw[2];
  f->itemsize = raw[3];
  f->n = raw[4];
  const int64_t s = raw[5];
  if ((int64_t)raw.size() < 6 + 2 * (f->n + 1) + s) {
    delete f;
    return nullptr;
  }
  size_t ofs = 6;
  f->dim_offsets.assign(raw.begin() + ofs, raw.begin() + ofs + f->n + 1);
  ofs += f->n + 1;
  f->byte_offsets.resize(f->n + 1);
  for (int64_t i = 0; i <= f->n; ++i) {
    f->byte_offsets[i] = raw[ofs + i] * f->itemsize;
  }
  ofs += f->n + 1;
  f->dims.assign(raw.begin() + ofs, raw.begin() + ofs + s);

  f->fd = ::open(bin_path, O_RDONLY);
  if (f->fd < 0) {
    delete f;
    return nullptr;
  }
  struct stat st;
  if (fstat(f->fd, &st) != 0) {
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->data_size = (size_t)st.st_size;
  f->data = (uint8_t*)mmap(nullptr, f->data_size, PROT_READ, MAP_SHARED,
                           f->fd, 0);
  if (f->data == MAP_FAILED) {
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  // Hint kernel readahead for sequential-ish access.
  madvise(f->data, f->data_size, MADV_WILLNEED);
  return f;
}

void ut_close(void* handle) {
  auto* f = (IdxBin*)handle;
  if (!f) return;
  if (f->data) munmap(f->data, f->data_size);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

int64_t ut_len(void* handle) { return ((IdxBin*)handle)->n; }
int64_t ut_dtype_code(void* handle) { return ((IdxBin*)handle)->dtype_code; }
int64_t ut_itemsize(void* handle) { return ((IdxBin*)handle)->itemsize; }

int64_t ut_frame_ndim(void* handle, int64_t i) {
  auto* f = (IdxBin*)handle;
  return f->dim_offsets[i + 1] - f->dim_offsets[i];
}

void ut_frame_dims(void* handle, int64_t i, int64_t* out) {
  auto* f = (IdxBin*)handle;
  const int64_t lo = f->dim_offsets[i];
  const int64_t hi = f->dim_offsets[i + 1];
  for (int64_t k = lo; k < hi; ++k) *out++ = f->dims[k];
}

// Zero-copy pointer to frame bytes (valid until ut_close).
const uint8_t* ut_frame_ptr(void* handle, int64_t i, int64_t* size_out) {
  auto* f = (IdxBin*)handle;
  if (i < 0 || i >= f->n) return nullptr;
  *size_out = f->byte_offsets[i + 1] - f->byte_offsets[i];
  return f->data + f->byte_offsets[i];
}

// ------------------------- prefetch ring ------------------------------------

namespace {

struct RingItem {
  int64_t index;
  const uint8_t* ptr;
  int64_t size;
};

struct Ring {
  IdxBin* file;
  std::vector<int64_t> order;
  size_t capacity;
  std::atomic<size_t> next_job{0};

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<RingItem> ready;
  size_t finished_workers = 0;  // guarded by mu
  bool stop = false;

  std::vector<std::thread> workers;
};

void ring_worker(Ring* r) {
  for (;;) {
    size_t job = r->next_job.fetch_add(1);
    if (job >= r->order.size()) break;
    const int64_t idx = r->order[job];
    int64_t size = 0;
    const uint8_t* p = ut_frame_ptr(r->file, idx, &size);
    // Prefault the pages so the consumer's memcpy never blocks on IO.
    volatile uint8_t sink = 0;
    for (int64_t o = 0; o < size; o += 4096) sink ^= p[o];
    (void)sink;

    std::unique_lock<std::mutex> lock(r->mu);
    r->cv_push.wait(lock, [&] {
      return r->stop || r->ready.size() < r->capacity;
    });
    if (r->stop) break;
    r->ready.push_back({idx, p, size});
    r->cv_pop.notify_one();
  }
  std::lock_guard<std::mutex> lock(r->mu);
  r->finished_workers++;
  r->cv_pop.notify_all();
}

}  // namespace

void* ut_ring_create(void* handle, const int64_t* order, int64_t n_order,
                     int64_t n_threads, int64_t capacity) {
  auto* r = new Ring();
  r->file = (IdxBin*)handle;
  r->order.assign(order, order + n_order);
  r->capacity = (size_t)capacity;
  for (int64_t i = 0; i < n_threads; ++i) {
    r->workers.emplace_back(ring_worker, r);
  }
  return r;
}

// Pops the next prefetched frame (any order within the window). Returns the
// frame index, or -1 when the stream is exhausted. Blocks otherwise.
int64_t ut_ring_next(void* ring, const uint8_t** ptr_out, int64_t* size_out) {
  auto* r = (Ring*)ring;
  std::unique_lock<std::mutex> lock(r->mu);
  for (;;) {
    if (!r->ready.empty()) {
      RingItem item = r->ready.front();
      r->ready.pop_front();
      r->cv_push.notify_one();
      *ptr_out = item.ptr;
      *size_out = item.size;
      return item.index;
    }
    if (r->finished_workers == r->workers.size()) return -1;
    r->cv_pop.wait(lock);
  }
}

void ut_ring_destroy(void* ring) {
  auto* r = (Ring*)ring;
  {
    std::lock_guard<std::mutex> lock(r->mu);
    r->stop = true;
  }
  r->next_job.store(r->order.size());
  r->cv_push.notify_all();
  r->cv_pop.notify_all();
  for (auto& t : r->workers) t.join();
  delete r;
}

}  // extern "C"
