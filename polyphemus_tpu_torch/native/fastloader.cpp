// Batch gather of the packed-shard loader (data/fastloader.py).
//
// The shards are mmapped once on the Python side; this translation unit runs
// the per-batch loop: copy each sample's rows out of its shard into one packed
// batch, widening the tokens from int16 to int32, on a few threads. Plain C
// ABI, called through ctypes (which releases the GIL for the call); no CPython
// API.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 fastloader.cpp -o ...

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather `n` samples. For sample k: source = bases[shard_ids[k]] at row
// row_ids[k]. Token rows are int16[tok_elems], widened to int32 in
// out_tokens; mask rows are uint8[mask_bytes] copied to out_mask.
void poly_gather_batch(const int64_t* shard_ids, const int64_t* row_ids,
                       int64_t n, const uint8_t* const* tok_bases,
                       const uint8_t* const* mask_bases, int64_t tok_elems,
                       int64_t mask_bytes, int32_t* out_tokens,
                       uint8_t* out_mask, int32_t n_threads) {
  const int64_t tok_row_bytes = tok_elems * 2;  // int16 source

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      const uint8_t* tsrc =
          tok_bases[shard_ids[k]] + row_ids[k] * tok_row_bytes;
      const int16_t* t16 = reinterpret_cast<const int16_t*>(tsrc);
      int32_t* tdst = out_tokens + k * tok_elems;
      for (int64_t i = 0; i < tok_elems; ++i) {
        tdst[i] = static_cast<int32_t>(t16[i]);
      }
      const uint8_t* msrc =
          mask_bases[shard_ids[k]] + row_ids[k] * mask_bytes;
      std::memcpy(out_mask + k * mask_bytes, msrc,
                  static_cast<size_t>(mask_bytes));
    }
  };

  if (n_threads <= 1 || n < 2 * n_threads) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
