// Native threaded WAV prefetcher — the data-loader runtime component
// (role of the reference's torch DataLoader worker pool feeding
// `src/dataloader.py`'s ESC-50 pipeline): a C++ thread pool decodes WAV
// files AHEAD of Python consumption into a bounded, ORDERED queue, so the
// host-side IO+decode overlaps device compute without touching the GIL.
//
// Ordering contract: items are delivered strictly in submission order
// (index 0, 1, 2, ...) regardless of which worker finished first — the
// consumer of a training epoch needs deterministic batches.
//
// API (C linkage; see wam_tpu_torch/native/__init__.py for the ctypes bindings):
//   pf_create(paths, n, workers, capacity, max_frames) -> handle (0 on err)
//   pf_next_size(handle)
//       -> frames*channels of the NEXT ordinal item (blocking) WITHOUT
//          consuming it, so the caller can size its buffer exactly;
//          negative codes as pf_next (the erroneous item stays queued —
//          the following pf_next consumes and reports it).
//   pf_next(handle, out, max_samples, &sample_rate, &channels)
//       -> frames written for the NEXT ordinal item (blocking),
//          -1 ONLY when the path list is exhausted; per-item failures are
//          distinct negative codes that can never collide with -1:
//            -11/-12/-13 : wavio decode error (wav error code - 10)
//            -5          : file longer than max_frames (raise the limit)
//            -6          : frames*channels exceeds the caller's buffer
//                          (item NOT consumed — grow and retry)
//            -8          : pf_destroy ran concurrently (stopping); the
//                          handle must be considered dead
//          Truncation is never silent — parity with read_wav's full decode
//          is an error, not a clamp.
//   pf_destroy(handle)
//
// pf_destroy may race an ALREADY-IN-FLIGHT pf_next/pf_next_size on the
// same handle: it wakes blocked consumers (they return -8) and DRAINS
// them — the delete only happens once every in-flight call has left. The
// drain cannot see a call that has not yet locked the mutex, so the
// caller must still guarantee no NEW pf_next/pf_next_size call starts
// once pf_destroy has been CALLED (the Python wrapper serializes call
// starts against close() with a lock for exactly this reason).
//
// Decoding reuses wavio.cpp's wav_read_f32/wav_info (both sources are
// compiled into one shared library).

#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int wav_info(const char* path, int* sample_rate, int* channels, long* frames);
long wav_read_f32(const char* path, float* out, long capacity_frames);
}

namespace {

struct Item {
  long frames = -3;  // <0: decode error code
  int sample_rate = 0;
  int channels = 0;
  std::vector<float> samples;
};

struct Prefetcher {
  std::vector<std::string> paths;
  long max_frames = 0;
  size_t capacity = 0;

  std::mutex mu;
  std::condition_variable cv_space;  // workers wait for queue space
  std::condition_variable cv_ready;  // consumer waits for the next ordinal
  std::condition_variable cv_drained;  // pf_destroy waits for consumers
  std::map<size_t, Item> ready;      // finished items keyed by index
  size_t next_submit = 0;            // next index a worker should take
  size_t next_consume = 0;           // next index the consumer wants
  int consumers_in_call = 0;         // pf_next/pf_next_size currently inside
  bool stopping = false;
  std::vector<std::thread> workers;

  // RAII guard counting consumers so pf_destroy can drain them before
  // deleting. Must be constructed and destructed WITH mu held; everything a
  // consumer touches after the guard drops must be thread-local.
  struct ConsumerGuard {
    Prefetcher* pf;
    explicit ConsumerGuard(Prefetcher* p) : pf(p) { ++pf->consumers_in_call; }
    ~ConsumerGuard() {
      if (--pf->consumers_in_call == 0 && pf->stopping)
        pf->cv_drained.notify_all();
    }
  };

  void worker_loop() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        // bound work-ahead: never run more than `capacity` items past the
        // consumer (finished-but-unconsumed + in-flight)
        cv_space.wait(lk, [&] {
          return stopping || (next_submit < paths.size() &&
                              next_submit < next_consume + capacity);
        });
        if (stopping || next_submit >= paths.size()) return;
        idx = next_submit++;
      }

      Item item;
      long frames_in_file = 0;
      int info_rc = wav_info(paths[idx].c_str(), &item.sample_rate,
                             &item.channels, &frames_in_file);
      if (info_rc != 0) {
        item.frames = info_rc - 10;  // -11/-12: never collides with -1
      } else if (frames_in_file > max_frames ||
                 frames_in_file * static_cast<long>(item.channels) >
                     2 * max_frames) {
        // bound SAMPLES too: a corrupt header claiming a huge channel
        // count must become a catchable error, not a giant allocation
        item.frames = -5;
      } else {
        try {
          item.samples.resize(static_cast<size_t>(frames_in_file) *
                              item.channels);
          long got = wav_read_f32(paths[idx].c_str(), item.samples.data(),
                                  frames_in_file);
          item.frames = got < 0 ? got - 10 : got;
        } catch (const std::exception&) {
          // bad_alloc etc. must not escape a std::thread (std::terminate)
          item.frames = -7;
          item.samples.clear();
        }
      }

      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(idx, std::move(item));
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* pf_create(const char** paths, long n, int n_workers, long capacity,
                long max_frames) {
  if (n < 0 || n_workers < 1 || capacity < 1 || max_frames < 1) return nullptr;
  auto* pf = new Prefetcher();
  pf->paths.reserve(n);
  for (long i = 0; i < n; ++i) pf->paths.emplace_back(paths[i]);
  pf->max_frames = max_frames;
  pf->capacity = static_cast<size_t>(capacity);
  int workers = n_workers;
  if (static_cast<long>(workers) > n && n > 0) workers = static_cast<int>(n);
  for (int i = 0; i < workers; ++i)
    pf->workers.emplace_back(&Prefetcher::worker_loop, pf);
  return pf;
}

long pf_next_size(void* handle) {
  auto* pf = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(pf->mu);
  Prefetcher::ConsumerGuard guard(pf);  // destructs before lk unlocks
  if (pf->stopping) return -8;
  if (pf->next_consume >= pf->paths.size()) return -1;  // exhausted
  size_t want = pf->next_consume;
  pf->cv_ready.wait(lk, [&] { return pf->stopping || pf->ready.count(want) > 0; });
  if (pf->stopping) return -8;
  const Item& item = pf->ready[want];
  if (item.frames < 0) return item.frames;
  return item.frames * item.channels;
}

long pf_next(void* handle, float* out, long max_samples, int* sample_rate,
             int* channels) {
  auto* pf = static_cast<Prefetcher*>(handle);
  Item item;
  {
    std::unique_lock<std::mutex> lk(pf->mu);
    Prefetcher::ConsumerGuard guard(pf);  // destructs before lk unlocks
    if (pf->stopping) return -8;
    if (pf->next_consume >= pf->paths.size()) return -1;  // exhausted
    size_t want = pf->next_consume;
    pf->cv_ready.wait(lk, [&] { return pf->stopping || pf->ready.count(want) > 0; });
    if (pf->stopping) return -8;
    Item& peek = pf->ready[want];
    if (peek.frames >= 0 && peek.frames * peek.channels > max_samples) {
      return -6;  // buffer small; item stays queued — grow and retry
    }
    item = std::move(peek);
    pf->ready.erase(want);
    pf->next_consume = want + 1;
    // notify under the lock: after the guard drops, this thread must not
    // touch pf again (pf_destroy may be freeing it)
    pf->cv_space.notify_all();  // consuming freed work-ahead budget
  }

  if (item.frames < 0) return item.frames;
  *sample_rate = item.sample_rate;
  *channels = item.channels;
  std::memcpy(out, item.samples.data(),
              static_cast<size_t>(item.frames) * item.channels *
                  sizeof(float));
  return item.frames;
}

void pf_destroy(void* handle) {
  auto* pf = static_cast<Prefetcher*>(handle);
  {
    std::unique_lock<std::mutex> lk(pf->mu);
    pf->stopping = true;
    pf->cv_space.notify_all();
    pf->cv_ready.notify_all();
    // drain in-flight pf_next/pf_next_size calls: they wake on cv_ready,
    // observe stopping, return -8, and drop their ConsumerGuard under mu —
    // only then is deleting pf safe
    pf->cv_drained.wait(lk, [&] { return pf->consumers_in_call == 0; });
  }
  for (auto& t : pf->workers) t.join();
  delete pf;
}

}  // extern "C"
