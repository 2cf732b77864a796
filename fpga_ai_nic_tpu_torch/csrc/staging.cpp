// Native batch-staging engine: the host-side buffer plane of the runtime.
//
// Role parity: the reference's C++ driver owns host buffer staging — OPAE
// pinned allocations plus the per-iteration activation layout loops that
// feed the device DMA (sw/mlp_mpi_example_f32.cpp:381-424,452-460).  The
// TPU-native equivalent is assembling shuffled minibatches: dst[i, :] =
// src[idx[i], :], the row-gather every epoch loop performs before
// device_put.  In Python/numpy that gather is a single-threaded memcpy
// holding the GIL; here it runs on a team of threads inside a worker
// thread, so batch k+1 stages while the interpreter dispatches batch k — the same
// copy/compute overlap the reference gets from its 4-CL read bursts
// running behind the ring (readme.pdf §2.1).
//
// Design: a fixed pool of reusable aligned slot buffers + one worker
// thread draining a job queue (each gather splits its rows over a team of
// std::threads, one a MiB copied up to the cores, so one drain thread
// saturates memory bandwidth; the JAX package's copy uses an OpenMP team,
// which needs libgomp, absent on some hosts).  States: FREE -> QUEUED ->
// READY -> (release) FREE.  The C ABI below is loaded via ctypes
// (runtime/staging.py); no Python headers involved.
//
// Build: built at first use by runtime/native.py (g++ -O3 -pthread
// -shared -fPIC) into _build/ beside the package.

#include <algorithm>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

enum class SlotState : int { FREE = 0, QUEUED = 1, READY = 2 };

struct Job {
  int slot;
  const unsigned char* src;
  const int64_t* idx;     // caller keeps alive until wait() returns
  int64_t n_rows;
  int64_t row_bytes;
};

struct Pool {
  std::vector<unsigned char*> buffers;
  std::vector<size_t> capacity;    // per-slot byte capacity
  std::vector<SlotState> state;
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv;      // slot state changes / queue pushes
  std::thread worker;
  bool stop = false;

  Pool(const int64_t* sizes, int n_slots) {
    buffers.reserve(n_slots);
    for (int i = 0; i < n_slots; ++i) {
      void* p = nullptr;
      // 4096: page alignment so the runtime's host->device DMA never
      // straddles a partial first page
      if (posix_memalign(&p, 4096, static_cast<size_t>(sizes[i])) != 0)
        p = nullptr;
      buffers.push_back(static_cast<unsigned char*>(p));
      capacity.push_back(static_cast<size_t>(sizes[i]));
      state.push_back(SlotState::FREE);
    }
    worker = std::thread([this] { run(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
    }
    cv.notify_all();
    worker.join();
    for (auto* b : buffers) free(b);
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> g(mu);
        cv.wait(g, [this] { return stop || !queue.empty(); });
        if (stop) return;
        job = queue.front();
        queue.pop_front();
      }
      gather(job);
      {
        std::lock_guard<std::mutex> g(mu);
        state[job.slot] = SlotState::READY;
      }
      cv.notify_all();
    }
  }

  void gather(const Job& j) {
    unsigned char* dst = buffers[j.slot];
    auto rows = [&j, dst](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(dst + i * j.row_bytes, j.src + j.idx[i] * j.row_bytes,
                    static_cast<size_t>(j.row_bytes));
    };
    // contiguous row ranges, at least a MiB each, at most one a core; this
    // thread takes the first
    const int64_t cores = std::max(1u, std::thread::hardware_concurrency());
    const int64_t team = std::max<int64_t>(1, std::min<int64_t>(
        cores, j.n_rows * j.row_bytes >> 20));
    const int64_t step = (j.n_rows + team - 1) / team;
    std::vector<std::thread> helpers;
    for (int64_t t = 1; t < team; ++t)
      helpers.emplace_back(rows, std::min(j.n_rows, t * step),
                           std::min(j.n_rows, (t + 1) * step));
    rows(0, std::min(j.n_rows, step));
    for (auto& h : helpers) h.join();
  }
};

}  // namespace

extern "C" {

// Per-slot sizes: mixed-width batch pytrees get right-sized slots (a
// uniform max-size pool would waste ~row_bytes ratio per small leaf).
void* stage_create_sized(const int64_t* slot_bytes, int n_slots) {
  if (n_slots < 1) return nullptr;
  for (int i = 0; i < n_slots; ++i)
    if (slot_bytes[i] < 1) return nullptr;
  Pool* p = new Pool(slot_bytes, n_slots);
  for (auto* b : p->buffers)
    if (b == nullptr) {
      delete p;
      return nullptr;
    }
  return p;
}

void* stage_create(int n_slots, int64_t slot_bytes) {
  if (n_slots < 1) return nullptr;
  std::vector<int64_t> sizes(n_slots, slot_bytes);
  return stage_create_sized(sizes.data(), n_slots);
}

void stage_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Claim the smallest FREE slot that fits (blocking) and enqueue the
// gather.  Returns slot id, or -1 if no slot could ever fit the job.
int stage_submit(void* pool, const void* src, const int64_t* idx,
                 int64_t n_rows, int64_t row_bytes) {
  Pool* p = static_cast<Pool*>(pool);
  const size_t need = static_cast<size_t>(n_rows * row_bytes);
  bool fits_any = false;
  for (size_t cap : p->capacity) fits_any |= (cap >= need);
  if (!fits_any) return -1;
  std::unique_lock<std::mutex> g(p->mu);
  int slot = -1;
  p->cv.wait(g, [&] {
    size_t best = SIZE_MAX;
    for (size_t i = 0; i < p->state.size(); ++i)
      if (p->state[i] == SlotState::FREE && p->capacity[i] >= need &&
          p->capacity[i] < best) {
        best = p->capacity[i];
        slot = static_cast<int>(i);
      }
    return slot >= 0;
  });
  p->state[slot] = SlotState::QUEUED;
  p->queue.push_back(Job{slot, static_cast<const unsigned char*>(src), idx,
                         n_rows, row_bytes});
  g.unlock();
  p->cv.notify_all();
  return slot;
}

// Block until the slot's gather completes; returns the buffer pointer.
void* stage_wait(void* pool, int slot) {
  Pool* p = static_cast<Pool*>(pool);
  std::unique_lock<std::mutex> g(p->mu);
  p->cv.wait(g, [&] { return p->state[slot] == SlotState::READY; });
  return p->buffers[slot];
}

// Return a READY slot to the pool (its buffer may be overwritten after).
void stage_release(void* pool, int slot) {
  Pool* p = static_cast<Pool*>(pool);
  {
    std::lock_guard<std::mutex> g(p->mu);
    p->state[slot] = SlotState::FREE;
  }
  p->cv.notify_all();
}

}  // extern "C"
