// Paged-KV page-pool / page-table manager (host runtime, C ABI).
//
// The TPU-native counterpart of the host-side paged-KV bookkeeping the
// reference vendors from FlashInfer (mgemm/include/flashinfer/page.cuh
// paged_kv_t indices/indptr construction happens host-side in Atom's
// serving stack; the reference binds but never drives it).  Device tensors
// stay in JAX; this manages the page free-list and per-sequence page
// tables that feed the Pallas decode-attention kernel's scalar-prefetch
// operands (micromix_tpu/serve/attention.py).
//
// Allocation policy: LIFO free-list (hot pages are reused first, which
// keeps the device-side page arrays dense), all-or-nothing extension (a
// sequence either gets every page it needs or the pool state is
// unchanged), page 0 reserved as the scratch target for inactive slots.
//
// The port's own copy of the JAX package's native/kvpool.cpp (the same
// code), built at first use by micromix_tpu_torch/utils/native.py into
// build/host/ and driven by micromix_tpu_torch/serve/block_manager.py.
//
// Thread-safe: one mutex per pool; the continuous-batching engine admits
// prefills from a host thread while the decode loop runs.

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

struct KvPool {
  int64_t n_pages;
  int64_t page_size;
  int64_t max_pages_per_seq;
  std::vector<int32_t> free_list;               // LIFO stack
  std::vector<std::vector<int32_t>> seq_pages;  // per slot
  std::mutex mu;

  KvPool(int64_t pages, int64_t psize, int64_t seqs, int64_t mps)
      : n_pages(pages), page_size(psize), max_pages_per_seq(mps),
        seq_pages(static_cast<size_t>(seqs)) {
    free_list.reserve(static_cast<size_t>(pages));
    // push descending so pop() hands out low page ids first (page 0 is
    // reserved scratch and never enters the list)
    for (int64_t p = pages - 1; p >= 1; --p)
      free_list.push_back(static_cast<int32_t>(p));
  }
};

}  // namespace

extern "C" {

void* kvpool_create(int64_t n_pages, int64_t page_size, int64_t max_seqs,
                    int64_t max_pages_per_seq) {
  if (n_pages < 2 || page_size < 1 || max_seqs < 1 || max_pages_per_seq < 1)
    return nullptr;
  return new KvPool(n_pages, page_size, max_seqs, max_pages_per_seq);
}

void kvpool_destroy(void* h) { delete static_cast<KvPool*>(h); }

// Grow slot's page list to cover `tokens` tokens.  Returns the new page
// count, or -1 on failure (bad slot, per-seq cap, or pool exhausted — in
// which case nothing was allocated).
int64_t kvpool_ensure(void* h, int64_t slot, int64_t tokens) {
  auto* p = static_cast<KvPool*>(h);
  if (slot < 0 || slot >= static_cast<int64_t>(p->seq_pages.size()))
    return -1;
  int64_t need = (tokens + p->page_size - 1) / p->page_size;
  if (need > p->max_pages_per_seq) return -1;
  std::lock_guard<std::mutex> lock(p->mu);
  auto& pages = p->seq_pages[static_cast<size_t>(slot)];
  int64_t have = static_cast<int64_t>(pages.size());
  if (need <= have) return have;
  if (need - have > static_cast<int64_t>(p->free_list.size())) return -1;
  for (int64_t i = have; i < need; ++i) {
    pages.push_back(p->free_list.back());
    p->free_list.pop_back();
  }
  return need;
}

void kvpool_release(void* h, int64_t slot) {
  auto* p = static_cast<KvPool*>(h);
  if (slot < 0 || slot >= static_cast<int64_t>(p->seq_pages.size())) return;
  std::lock_guard<std::mutex> lock(p->mu);
  auto& pages = p->seq_pages[static_cast<size_t>(slot)];
  for (int32_t pg : pages) p->free_list.push_back(pg);
  pages.clear();
}

int64_t kvpool_free_count(void* h) {
  auto* p = static_cast<KvPool*>(h);
  std::lock_guard<std::mutex> lock(p->mu);
  return static_cast<int64_t>(p->free_list.size());
}

// Write the slot's page-table row (padded with 0 = scratch page) into
// out[max_pages_per_seq].  Returns the number of live pages.
int64_t kvpool_pages(void* h, int64_t slot, int32_t* out) {
  auto* p = static_cast<KvPool*>(h);
  if (slot < 0 || slot >= static_cast<int64_t>(p->seq_pages.size()))
    return -1;
  std::lock_guard<std::mutex> lock(p->mu);
  auto& pages = p->seq_pages[static_cast<size_t>(slot)];
  int64_t i = 0;
  for (; i < static_cast<int64_t>(pages.size()); ++i)
    out[i] = pages[static_cast<size_t>(i)];
  for (int64_t j = i; j < p->max_pages_per_seq; ++j) out[j] = 0;
  return i;
}

}  // extern "C"
