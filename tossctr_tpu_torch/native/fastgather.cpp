// fastgather: multi-threaded row gather from mmap'd shard arrays.
//
// The online loader's hot host-side op is "gather N rows by index from a
// (rows, row_bytes) mmap'd array into a contiguous batch buffer"
// (data/dataset.py).  NumPy fancy indexing does this on one
// core; at pod-scale feeding rates (hundreds of thousands of rows/sec
// across several arrays per batch) it becomes the input bottleneck
// (SURVEY.md §7 "Input pipeline throughput").  This library fans the
// row copies out over a small thread pool.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libfastgather.so fastgather.cpp -lpthread
// (driven by native/build.py, which writes the library under build/native/).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// dsts[a][i, :] = srcs[a][idx[i], :] for every array a and i in [0, n):
// the same index set from several arrays (one batch touches
// X_num/X_mask/X_cat/seq/y at once), parallelized across (array,
// row-chunk) pairs to fill the pool evenly.
void gather_rows_multi(const char** srcs, char** dsts, const int64_t* row_bytes,
                       int n_arrays, const int64_t* idx, int64_t n,
                       int n_threads) {
  if (n <= 0 || n_arrays <= 0) return;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> cursor{0};
  const int64_t chunk = 2048;
  const int64_t tasks_per_array = (n + chunk - 1) / chunk;
  const int64_t total_tasks = tasks_per_array * n_arrays;
  auto worker = [&]() {
    for (;;) {
      const int64_t task = cursor.fetch_add(1);
      if (task >= total_tasks) return;
      const int a = static_cast<int>(task % n_arrays);
      const int64_t c = task / n_arrays;
      const int64_t lo = c * chunk;
      const int64_t hi = std::min(n, lo + chunk);
      const char* src = srcs[a];
      char* dst = dsts[a];
      const int64_t rb = row_bytes[a];
      for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(dst + i * rb, src + idx[i] * rb, rb);
      }
    }
  };
  std::vector<std::thread> threads;
  const int nt = std::min<int64_t>(n_threads, total_tasks);
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
