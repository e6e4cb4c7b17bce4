// Native host-side task runtime: closures, FIFO queues, worker threads, pool.
//
// Rebuild of the reference's multi-GPU context-pool runtime
// (reference multigpu/multigpu.c):
//   ctp_task        <- CUtask heap closure {fn, copied args, result,
//                      complete flag, mutex+condvar}    (multigpu.c:297-306)
//   ctp_task_destroy<- the *join*: blocks on the condvar until complete and
//                      returns the task's result        (multigpu.c:355-375)
//   queue           <- CUtaskqueue growable ring-buffer FIFO (multigpu.c:13-123)
//   worker          <- CUthread: pops and executes until a null sentinel
//                                                       (multigpu.c:168-196)
//   ctp_pool        <- CUmultiGPU: one worker per "context"; run-task-on-
//                      worker-i; synchronize-all         (multigpu.c:405-538)
//   sequential mode <- libcumultigpu_seq.a: same API, execute inline
//                                                       (multigpu_seq.c:144-153)
//
// The *device* schedule belongs to XLA, so this runtime's job is the
// host side the reference also needed: fanning out independent work
// (benchmark sweeps, oracle computation, data generation) and providing the
// deterministic sequential variant used as the test stand-in.
//
// Workers latch their first error and report it at destroy time, like the
// reference's thread->error (multigpu.c:139-159, 259-265).

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

extern "C" {

typedef int (*ctp_fn)(void* args);

enum ctp_status {
  CTP_OK = 0,
  CTP_ERROR_INVALID_VALUE = 1,
  CTP_ERROR_OUT_OF_MEMORY = 2,
  CTP_ERROR_OPERATING_SYSTEM = 3,
  CTP_ERROR_WORKER_FAILED = 4,
};

struct ctp_task {
  ctp_fn fn;
  void* args;           // owned copy
  int result = 0;
  bool complete = false;
  std::mutex mu;
  std::condition_variable cv;

  void run() {
    int r = fn(args);
    std::lock_guard<std::mutex> g(mu);
    result = r;
    complete = true;
    cv.notify_all();
  }
};

// ctp_task_create: heap closure with a private copy of args
// (the reference memcpy's args into the task, multigpu.c:321-349).
int ctp_task_create(ctp_task** out, ctp_fn fn, const void* args,
                    size_t args_size) {
  if (out == nullptr || fn == nullptr) return CTP_ERROR_INVALID_VALUE;
  auto* t = new (std::nothrow) ctp_task();
  if (t == nullptr) return CTP_ERROR_OUT_OF_MEMORY;
  t->fn = fn;
  t->args = nullptr;
  if (args_size > 0) {
    t->args = ::operator new(args_size, std::nothrow);
    if (t->args == nullptr) {
      delete t;
      return CTP_ERROR_OUT_OF_MEMORY;
    }
    std::memcpy(t->args, args, args_size);
  }
  *out = t;
  return CTP_OK;
}

// ctp_task_execute: run inline on the calling thread (multigpu.c:383-400).
int ctp_task_execute(ctp_task* t) {
  if (t == nullptr) return CTP_ERROR_INVALID_VALUE;
  t->run();
  return CTP_OK;
}

// ctp_task_destroy: JOIN — block until complete, hand back the result,
// free the task (multigpu.c:355-375).
int ctp_task_destroy(ctp_task* t, int* result) {
  if (t == nullptr) return CTP_ERROR_INVALID_VALUE;
  {
    std::unique_lock<std::mutex> g(t->mu);
    t->cv.wait(g, [&] { return t->complete; });
    if (result != nullptr) *result = t->result;
  }
  ::operator delete(t->args);
  delete t;
  return CTP_OK;
}

namespace {

struct Worker {
  std::deque<ctp_task*> queue;   // nullptr = shutdown sentinel
  std::mutex mu;
  std::condition_variable cv;
  std::thread thread;
  int error = CTP_OK;            // first task failure, latched

  void push(ctp_task* t) {
    {
      std::lock_guard<std::mutex> g(mu);
      queue.push_back(t);
    }
    cv.notify_one();
  }

  void main() {
    for (;;) {
      ctp_task* t;
      {
        std::unique_lock<std::mutex> g(mu);
        cv.wait(g, [&] { return !queue.empty(); });
        t = queue.front();
        queue.pop_front();
      }
      if (t == nullptr) return;  // sentinel (multigpu.c:168-196)
      t->run();
      if (t->result != CTP_OK && error == CTP_OK) error = t->result;
    }
  }
};

}  // namespace

struct ctp_pool {
  std::vector<Worker> workers;
  bool sequential = false;
};

int ctp_pool_create(ctp_pool** out, int n, int sequential) {
  if (out == nullptr || n <= 0) return CTP_ERROR_INVALID_VALUE;
  auto* p = new (std::nothrow) ctp_pool();
  if (p == nullptr) return CTP_ERROR_OUT_OF_MEMORY;
  p->sequential = sequential != 0;
  p->workers = std::vector<Worker>(n);
  if (!p->sequential) {
    for (auto& w : p->workers) w.thread = std::thread(&Worker::main, &w);
  }
  *out = p;
  return CTP_OK;
}

int ctp_pool_count(ctp_pool* p) {
  return p == nullptr ? 0 : static_cast<int>(p->workers.size());
}

// ctp_pool_run: submit a task to worker i (multigpu.c:497-505); in the
// sequential variant the task executes inline (multigpu_seq.c:144-153).
int ctp_pool_run(ctp_pool* p, int i, ctp_task* t) {
  if (p == nullptr || t == nullptr || i < 0 ||
      i >= static_cast<int>(p->workers.size()))
    return CTP_ERROR_INVALID_VALUE;
  if (p->sequential) {
    t->run();
    if (t->result != CTP_OK && p->workers[i].error == CTP_OK)
      p->workers[i].error = t->result;
    return CTP_OK;
  }
  p->workers[i].push(t);
  return CTP_OK;
}

// ctp_pool_synchronize: barrier — a no-op marker task per worker, joined
// (the reference synchronizes by joining per-thread marker tasks,
// multigpu.c:515-533).
static int noop(void*) { return CTP_OK; }

int ctp_pool_synchronize(ctp_pool* p) {
  if (p == nullptr) return CTP_ERROR_INVALID_VALUE;
  if (p->sequential) return CTP_OK;
  std::vector<ctp_task*> markers;
  for (auto& w : p->workers) {
    ctp_task* t;
    int rc = ctp_task_create(&t, noop, nullptr, 0);
    if (rc != CTP_OK) return rc;
    w.push(t);
    markers.push_back(t);
  }
  for (auto* t : markers) ctp_task_destroy(t, nullptr);
  return CTP_OK;
}

// ctp_pool_destroy: push shutdown sentinels, join threads, report the
// first latched worker error (multigpu.c:139-159 destroy-time reporting).
int ctp_pool_destroy(ctp_pool* p) {
  if (p == nullptr) return CTP_ERROR_INVALID_VALUE;
  int err = CTP_OK;
  if (!p->sequential) {
    for (auto& w : p->workers) w.push(nullptr);
    for (auto& w : p->workers) {
      if (w.thread.joinable()) w.thread.join();
      if (w.error != CTP_OK && err == CTP_OK) err = CTP_ERROR_WORKER_FAILED;
    }
  } else {
    for (auto& w : p->workers)
      if (w.error != CTP_OK && err == CTP_OK) err = CTP_ERROR_WORKER_FAILED;
  }
  delete p;
  return err;
}

const char* ctp_error_string(int code) {
  switch (code) {
    case CTP_OK: return "no error";
    case CTP_ERROR_INVALID_VALUE: return "invalid value";
    case CTP_ERROR_OUT_OF_MEMORY: return "out of memory";
    case CTP_ERROR_OPERATING_SYSTEM: return "operating system error";
    case CTP_ERROR_WORKER_FAILED: return "a worker task failed";
    default: return "unknown error";
  }
}

}  // extern "C"
