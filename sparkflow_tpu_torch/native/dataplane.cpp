// sparkflow-tpu native dataplane: batch assembly queue + fast CSV loader.
//
// Role in the framework: the host-side data runtime between the Spark/localml
// row world and the TPU's fixed-shape batch world. The reference's equivalent
// work happened in Python per partition (iterate rows, np.asarray, slice
// batches — sparkflow/ml_util.py handle_features/handle_feed_dict); here a
// C++ worker thread assembles padded, masked, optionally shuffled batches
// into a preallocated ring of buffers while Python (and the TPU) stay busy —
// host batch prep overlaps device compute, and the GIL is released for the
// whole ingest path.
//
// Exposed C ABI (ctypes-bound in sparkflow_tpu/utils/data.py):
//   sfq_create / sfq_push / sfq_finish / sfq_pop / sfq_destroy   (batch queue)
//   sf_csv_load / sf_free                                        (CSV matrix)
//
// Build: g++ -O3 -march=native -shared -fPIC dataplane.cpp -o libsfdata.so -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Batch queue
// ---------------------------------------------------------------------------

struct Batch {
  std::vector<float> x, y, mask;
  int64_t n_real = 0;
};

struct SfQueue {
  int64_t batch_size, row_dim, label_dim, capacity;
  bool shuffle;
  uint64_t seed;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop, cv_idle;
  std::vector<Batch> ring;
  int64_t head = 0, tail = 0, count = 0;  // ready batches
  int64_t inflight = 0;                   // threads inside push/pop/finish
  bool finished = false;                  // producer done
  bool closed = false;                    // consumer destroyed

  // staging area for incoming rows (one batch worth)
  std::vector<float> stage_x, stage_y;
  int64_t staged = 0;
  std::mt19937_64 rng;
  std::vector<int64_t> perm;  // per-batch shuffle permutation
};

static void emit_batch(SfQueue* q) {
  // assemble the staged rows into a ready batch (pad + mask [+ shuffle]),
  // caller holds the lock
  Batch b;
  const int64_t B = q->batch_size, D = q->row_dim, L = q->label_dim;
  b.x.assign(B * D, 0.0f);
  if (L > 0) b.y.assign(B * L, 0.0f);
  b.mask.assign(B, 0.0f);
  b.n_real = q->staged;

  q->perm.resize(q->staged);
  for (int64_t i = 0; i < q->staged; ++i) q->perm[i] = i;
  if (q->shuffle) {
    for (int64_t i = q->staged - 1; i > 0; --i) {
      int64_t j = (int64_t)(q->rng() % (uint64_t)(i + 1));
      std::swap(q->perm[i], q->perm[j]);
    }
  }
  for (int64_t i = 0; i < q->staged; ++i) {
    const int64_t src = q->perm[i];
    std::memcpy(&b.x[i * D], &q->stage_x[src * D], D * sizeof(float));
    if (L > 0) std::memcpy(&b.y[i * L], &q->stage_y[src * L], L * sizeof(float));
    b.mask[i] = 1.0f;
  }
  q->staged = 0;

  q->ring[q->tail] = std::move(b);
  q->tail = (q->tail + 1) % q->capacity;
  q->count += 1;
  q->cv_pop.notify_one();
}

SfQueue* sfq_create(int64_t batch_size, int64_t row_dim, int64_t label_dim,
                    int64_t capacity, int shuffle, uint64_t seed) {
  if (batch_size <= 0 || row_dim <= 0 || capacity <= 0) return nullptr;
  auto* q = new SfQueue();
  q->batch_size = batch_size;
  q->row_dim = row_dim;
  q->label_dim = label_dim;
  q->capacity = capacity;
  q->shuffle = shuffle != 0;
  q->seed = seed;
  q->rng.seed(seed);
  q->ring.resize(capacity);
  q->stage_x.resize(batch_size * row_dim);
  if (label_dim > 0) q->stage_y.resize(batch_size * label_dim);
  return q;
}

// RAII guard counting threads inside queue operations so sfq_destroy can
// drain before freeing (prevents use-after-free on the mutex/cvs when a
// blocked producer wakes during teardown). Construct with the lock held.
struct InflightGuard {
  SfQueue* q;
  explicit InflightGuard(SfQueue* qq) : q(qq) { q->inflight++; }
  ~InflightGuard() {
    q->inflight--;
    if (q->inflight == 0) q->cv_idle.notify_all();
  }
};

// Push n rows (x: n*row_dim floats, y: n*label_dim floats or null).
// Blocks when the ring is full. Returns rows accepted, -1 on error/closed.
int64_t sfq_push(SfQueue* q, const float* x, const float* y, int64_t n) {
  if (!q || n < 0) return -1;
  int64_t done = 0;
  while (done < n) {
    std::unique_lock<std::mutex> lk(q->mu);
    InflightGuard guard(q);
    if (q->closed) return -1;
    const int64_t room = q->batch_size - q->staged;
    const int64_t take = std::min(room, n - done);
    std::memcpy(&q->stage_x[q->staged * q->row_dim], &x[done * q->row_dim],
                take * q->row_dim * sizeof(float));
    if (q->label_dim > 0 && y)
      std::memcpy(&q->stage_y[q->staged * q->label_dim],
                  &y[done * q->label_dim], take * q->label_dim * sizeof(float));
    q->staged += take;
    done += take;
    if (q->staged == q->batch_size) {
      q->cv_push.wait(lk, [q] { return q->count < q->capacity || q->closed; });
      if (q->closed) return -1;
      emit_batch(q);
    }
  }
  return done;
}

// Producer is done: flush the partial batch (padded+masked) and mark EOF.
void sfq_finish(SfQueue* q) {
  if (!q) return;
  std::unique_lock<std::mutex> lk(q->mu);
  InflightGuard guard(q);
  if (q->staged > 0 && !q->closed) {
    q->cv_push.wait(lk, [q] { return q->count < q->capacity || q->closed; });
    if (!q->closed) emit_batch(q);
  }
  q->finished = true;
  q->cv_pop.notify_all();
}

// Pop one ready batch into caller buffers. Returns n_real rows (>0), 0 on EOF,
// -1 on error/closed. Blocks until a batch or EOF.
int64_t sfq_pop(SfQueue* q, float* x_out, float* y_out, float* mask_out) {
  if (!q || !x_out || !mask_out) return -1;
  std::unique_lock<std::mutex> lk(q->mu);
  InflightGuard guard(q);
  q->cv_pop.wait(lk, [q] { return q->count > 0 || q->finished || q->closed; });
  if (q->closed) return -1;
  if (q->count == 0) return 0;  // finished and drained
  Batch& b = q->ring[q->head];
  std::memcpy(x_out, b.x.data(), b.x.size() * sizeof(float));
  if (q->label_dim > 0 && y_out)
    std::memcpy(y_out, b.y.data(), b.y.size() * sizeof(float));
  std::memcpy(mask_out, b.mask.data(), b.mask.size() * sizeof(float));
  q->head = (q->head + 1) % q->capacity;
  q->count -= 1;
  q->cv_push.notify_one();
  return b.n_real;
}

// Mark closed and wake every blocked producer/consumer. Does NOT free — the
// binding calls this first, waits for its own threads to return from the C
// calls, then calls sfq_destroy. Safe to call repeatedly.
void sfq_close(SfQueue* q) {
  if (!q) return;
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->cv_push.notify_all();
  q->cv_pop.notify_all();
}

void sfq_destroy(SfQueue* q) {
  if (!q) return;
  {
    std::unique_lock<std::mutex> lk(q->mu);
    q->closed = true;
    q->cv_push.notify_all();
    q->cv_pop.notify_all();
    // drain: wait until every thread inside push/pop/finish has left (their
    // waits re-check predicates that now include `closed` and return)
    q->cv_idle.wait(lk, [q] { return q->inflight == 0; });
  }
  delete q;
}

// ---------------------------------------------------------------------------
// Fast numeric CSV loader (MNIST-style dense numeric files)
// ---------------------------------------------------------------------------

// Parses a numeric CSV into a row-major float32 matrix. Returns the matrix
// (malloc'd; free with sf_free), sets *rows_out/*cols_out. nullptr on error.
float* sf_csv_load(const char* path, int64_t* rows_out, int64_t* cols_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = (char*)std::malloc(size + 1);
  if (!buf || std::fread(buf, 1, size, f) != (size_t)size) {
    std::fclose(f);
    std::free(buf);
    return nullptr;
  }
  std::fclose(f);
  buf[size] = '\0';

  std::vector<float> vals;
  vals.reserve(size / 3);
  int64_t cols = 0, rows = 0;
  int64_t cur_cols = 0;
  const char* p = buf;
  const char* end = buf + size;
  while (p < end) {
    char* next = nullptr;
    float v = std::strtof(p, &next);
    if (next == p) {  // no parse progress: skip one char (handles stray text)
      if (*p == '\n') {
        if (cur_cols > 0) {
          if (cols == 0) cols = cur_cols;
          if (cur_cols != cols) { std::free(buf); return nullptr; }
          rows++;
          cur_cols = 0;
        }
      }
      p++;
      continue;
    }
    vals.push_back(v);
    cur_cols++;
    p = next;
    while (p < end && (*p == ',' || *p == ' ' || *p == '\r')) p++;
    if (p < end && *p == '\n') {
      if (cols == 0) cols = cur_cols;
      if (cur_cols != cols) { std::free(buf); return nullptr; }
      rows++;
      cur_cols = 0;
      p++;
    }
  }
  if (cur_cols > 0) {  // last line without newline
    if (cols == 0) cols = cur_cols;
    if (cur_cols != cols) { std::free(buf); return nullptr; }
    rows++;
  }
  std::free(buf);

  float* out = (float*)std::malloc(vals.size() * sizeof(float));
  if (!out) return nullptr;
  std::memcpy(out, vals.data(), vals.size() * sizeof(float));
  *rows_out = rows;
  *cols_out = cols;
  return out;
}

void sf_free(void* p) { std::free(p); }

}  // extern "C"
