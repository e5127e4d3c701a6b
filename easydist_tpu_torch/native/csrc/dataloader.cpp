// Tokenized-binary data loader with background prefetch (the port's copy
// of easydist_tpu/native/csrc/dataloader.cpp, the same sampling stream).
//
// The host-side input pipeline: memory-maps a flat token file, samples
// random windows with std::mt19937_64 + uniform_int_distribution, and
// fills a ring of ready batches from a producer thread so the card never
// waits on the host.  C ABI for ctypes (runtime/data.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Loader {
  // mapping
  void* map = nullptr;
  size_t file_bytes = 0;
  int fd = -1;
  int64_t n_tokens = 0;
  int token_bytes = 2;  // uint16 (GPT-2 style) or 4 (uint32)

  // batch geometry
  int64_t batch = 0, window = 0;  // window = seq + 1 (inputs+targets)

  // prefetch ring
  std::vector<std::vector<int32_t>> ring;
  size_t head = 0, tail = 0, count = 0;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::mt19937_64 rng;

  void produce_loop() {
    std::uniform_int_distribution<int64_t> dist(
        0, n_tokens - window - 1);
    while (!stop.load()) {
      // sample a batch outside the lock
      std::vector<int32_t> buf(static_cast<size_t>(batch) * window);
      for (int64_t b = 0; b < batch; ++b) {
        const int64_t start = dist(rng);
        for (int64_t t = 0; t < window; ++t) {
          const int64_t idx = start + t;
          int32_t tok;
          if (token_bytes == 2) {
            tok = reinterpret_cast<const uint16_t*>(map)[idx];
          } else {
            tok = reinterpret_cast<const int32_t*>(map)[idx];
          }
          buf[static_cast<size_t>(b) * window + t] = tok;
        }
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_produce.wait(lock, [&] { return stop.load() || count < ring.size(); });
      if (stop.load()) return;
      ring[head].swap(buf);
      head = (head + 1) % ring.size();
      ++count;
      cv_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* ed_loader_open(const char* path, int token_bytes, int64_t batch,
                     int64_t window, int64_t n_prefetch, uint64_t seed) {
  auto* L = new Loader();
  L->fd = ::open(path, O_RDONLY);
  if (L->fd < 0) {
    delete L;
    return nullptr;
  }
  struct stat st;
  if (fstat(L->fd, &st) != 0 || st.st_size < token_bytes * (window + 1)) {
    ::close(L->fd);
    delete L;
    return nullptr;
  }
  L->file_bytes = static_cast<size_t>(st.st_size);
  L->map = mmap(nullptr, L->file_bytes, PROT_READ, MAP_PRIVATE, L->fd, 0);
  if (L->map == MAP_FAILED) {
    ::close(L->fd);
    delete L;
    return nullptr;
  }
  L->token_bytes = token_bytes;
  L->n_tokens = static_cast<int64_t>(L->file_bytes / token_bytes);
  L->batch = batch;
  L->window = window;
  L->ring.resize(static_cast<size_t>(n_prefetch));
  L->rng.seed(seed);
  L->worker = std::thread([L] { L->produce_loop(); });
  return L;
}

// Copies one ready batch ([batch, window] int32) into out; blocks until
// available.  Returns 0 on success.
int ed_loader_next(void* handle, int32_t* out) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(L->mu);
  L->cv_consume.wait(lock, [&] { return L->count > 0; });
  std::memcpy(out, L->ring[L->tail].data(),
              sizeof(int32_t) * static_cast<size_t>(L->batch) * L->window);
  L->tail = (L->tail + 1) % L->ring.size();
  --L->count;
  L->cv_produce.notify_one();
  return 0;
}

int64_t ed_loader_num_tokens(void* handle) {
  return static_cast<Loader*>(handle)->n_tokens;
}

void ed_loader_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_produce.notify_all();
  L->cv_consume.notify_all();
  if (L->worker.joinable()) L->worker.join();
  if (L->map != nullptr && L->map != MAP_FAILED) munmap(L->map, L->file_bytes);
  if (L->fd >= 0) ::close(L->fd);
  delete L;
}

}  // extern "C"
