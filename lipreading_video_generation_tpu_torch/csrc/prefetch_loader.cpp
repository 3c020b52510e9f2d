// Prefetch loader: a C++ thread pool that reads fixed-size records, one
// file each, into a bounded ring while the caller consumes them, with no
// Python on the IO path.
//
// The port's own copy of the JAX package's prefetch loader: the
// same C API, so data/native_loader.py binds it the same way, built into the
// port's _build/ directory and never shared with the JAX package's library.
//
// C API (ctypes-bound from ../data/native_loader.py):
//   pl_create(paths, n, record_bytes, capacity, threads) -> handle
//   pl_next(handle, out, timeout_ms) -> record index, -1 at the end or on a
//                                       timeout, -2-index on a read failure
//   pl_destroy(handle)
//
// Build: g++ -O2 -shared -fPIC -pthread prefetch_loader.cpp -o libprefetch.so

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Record {
  int index;
  std::vector<unsigned char> data;
};

struct Loader {
  std::vector<std::string> paths;
  size_t record_bytes;
  size_t capacity;
  std::deque<Record> queue;
  std::mutex mu;
  std::condition_variable cv_push;  // signalled when queue has room
  std::condition_variable cv_pop;   // signalled when queue has data
  std::atomic<size_t> next_file{0};
  std::atomic<int> live_producers{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> threads;

  void producer() {
    for (;;) {
      size_t i = next_file.fetch_add(1);
      if (i >= paths.size() || stop.load()) break;
      Record rec;
      rec.index = static_cast<int>(i);
      rec.data.resize(record_bytes);
      FILE* f = std::fopen(paths[i].c_str(), "rb");
      if (f == nullptr) {
        rec.index = -2 - static_cast<int>(i);  // encode read failure
      } else {
        size_t got = std::fread(rec.data.data(), 1, record_bytes, f);
        std::fclose(f);
        if (got != record_bytes) rec.index = -2 - static_cast<int>(i);
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_push.wait(lock, [&] { return queue.size() < capacity || stop.load(); });
      if (stop.load()) break;
      queue.push_back(std::move(rec));
      cv_pop.notify_one();
    }
    if (live_producers.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lock(mu);
      cv_pop.notify_all();  // wake consumers: no more data coming
    }
  }
};

}  // namespace

extern "C" {

void* pl_create(const char** paths, int n_files, size_t record_bytes,
                int capacity, int num_threads) {
  auto* l = new Loader();
  l->paths.reserve(n_files);
  for (int i = 0; i < n_files; ++i) l->paths.emplace_back(paths[i]);
  l->record_bytes = record_bytes;
  l->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 4;
  int nt = num_threads > 0 ? num_threads : 2;
  l->live_producers.store(nt);
  for (int t = 0; t < nt; ++t) l->threads.emplace_back(&Loader::producer, l);
  return l;
}

// Pops one record into `out` (record_bytes long). Returns the record's file
// index, -1 when all files are consumed, or -2-index on a read failure.
int pl_next(void* handle, unsigned char* out, int timeout_ms) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(l->mu);
  bool ok = l->cv_pop.wait_for(
      lock, std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 60000),
      [&] { return !l->queue.empty() || l->live_producers.load() == 0; });
  if (!ok || l->queue.empty()) return -1;
  Record rec = std::move(l->queue.front());
  l->queue.pop_front();
  l->cv_push.notify_one();
  lock.unlock();
  if (rec.index >= 0) std::memcpy(out, rec.data.data(), l->record_bytes);
  return rec.index;
}

void pl_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  {
    std::lock_guard<std::mutex> lock(l->mu);
    l->cv_push.notify_all();
    l->cv_pop.notify_all();
  }
  for (auto& t : l->threads) t.join();
  delete l;
}

}  // extern "C"
