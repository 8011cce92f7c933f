// Native per-cycle negotiation engine: LRU response cache + fusion
// bin-packing (the port's copy of horovod_tpu/cpp/cycle.cc, with the same
// C ABI; reference: horovod/common/response_cache.cc, LRU cache with
// stable cache bits; horovod/common/controller.cc:551-672, FuseResponses
// bin-packing with look-ahead).
//
// The Python layer (runtime/response_cache.py, runtime/fusion.py) defines
// the semantics; this module runs the same algorithms natively when
// HOROVOD_NATIVE_CYCLE is on (the default). Cache params keys and blobs
// cross the ABI as opaque bytes, so the C++ stays schema-free.
//
// Exact-behavior contract with the Python implementations (held by the
// differential tests in tests/test_torch_native_cycle.py):
//   * put() of an existing name refreshes the entry in place and touches
//     LRU order; a new name at capacity evicts the LRU entry first and
//     recycles its bit through a min-heap so bit numbering stays bounded
//     by capacity (reference: response_cache.cc:232+ bit redistribution).
//   * cached() never touches LRU order (announcement timing differs across
//     workers; see the invariant note in runtime/response_cache.py).
//   * fuse(): greedy bin-packing that skips past non-joinable responses
//     (look-ahead) rather than flushing the bin.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <list>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct CacheEntry {
  std::string name;
  std::string params;               // opaque params key
  std::string blob;                 // opaque packed response
  std::list<int64_t>::iterator pos; // position in the LRU list
};

struct Cache {
  int64_t capacity = 0;
  std::unordered_map<std::string, int64_t> name_to_bit;
  std::unordered_map<int64_t, CacheEntry> entries;
  std::list<int64_t> lru; // front = least recently used
  std::priority_queue<int64_t, std::vector<int64_t>, std::greater<int64_t>>
      free_bits;
  int64_t next_bit = 0;

  int64_t alloc_bit() {
    if (!free_bits.empty()) {
      int64_t b = free_bits.top();
      free_bits.pop();
      return b;
    }
    return next_bit++;
  }
};

}  // namespace

extern "C" {

// Bumped whenever a signature below changes: the loader refuses a library
// whose version differs (runtime/native.py ABI_VERSION).
int hvd_cycle_abi_version() { return 1; }

void* hvc_cache_new(int64_t capacity) {
  Cache* c = new Cache();
  c->capacity = capacity;
  return c;
}

void hvc_cache_free(void* h) { delete static_cast<Cache*>(h); }

// 0 = MISS, 1 = HIT, 2 = INVALID (params changed for a known name).
int hvc_cache_cached(void* h, const char* name, const uint8_t* params,
                     int64_t plen) {
  Cache* c = static_cast<Cache*>(h);
  auto it = c->name_to_bit.find(name);
  if (it == c->name_to_bit.end()) return 0;
  auto eit = c->entries.find(it->second);
  if (eit == c->entries.end()) return 0;
  const std::string& key = eit->second.params;
  if (key.size() == static_cast<size_t>(plen) &&
      std::memcmp(key.data(), params, plen) == 0)
    return 1;
  return 2;
}

int64_t hvc_cache_put(void* h, const char* name, const uint8_t* params,
                      int64_t plen, const uint8_t* blob, int64_t blen) {
  Cache* c = static_cast<Cache*>(h);
  if (c->capacity <= 0) return -1;
  std::string sname(name);
  auto it = c->name_to_bit.find(sname);
  if (it != c->name_to_bit.end()) {
    auto eit = c->entries.find(it->second);
    if (eit != c->entries.end()) {
      // refresh in place + touch LRU (move to back)
      CacheEntry& e = eit->second;
      c->lru.erase(e.pos);
      c->lru.push_back(it->second);
      e.pos = std::prev(c->lru.end());
      e.params.assign(reinterpret_cast<const char*>(params), plen);
      e.blob.assign(reinterpret_cast<const char*>(blob), blen);
      return it->second;
    }
  }
  if (static_cast<int64_t>(c->entries.size()) >= c->capacity) {
    int64_t old_bit = c->lru.front();
    c->lru.pop_front();
    auto eit = c->entries.find(old_bit);
    if (eit != c->entries.end()) {
      c->name_to_bit.erase(eit->second.name);
      c->entries.erase(eit);
    }
    c->free_bits.push(old_bit);
  }
  int64_t bit = c->alloc_bit();
  c->lru.push_back(bit);
  CacheEntry e;
  e.name = sname;
  e.params.assign(reinterpret_cast<const char*>(params), plen);
  e.blob.assign(reinterpret_cast<const char*>(blob), blen);
  e.pos = std::prev(c->lru.end());
  c->entries.emplace(bit, std::move(e));
  c->name_to_bit[sname] = bit;
  return bit;
}

int64_t hvc_cache_bit_for_name(void* h, const char* name) {
  Cache* c = static_cast<Cache*>(h);
  auto it = c->name_to_bit.find(name);
  return it == c->name_to_bit.end() ? -1 : it->second;
}

// Returns the blob length for `bit` WITHOUT touching LRU order, or -1.
int64_t hvc_cache_get_len(void* h, int64_t bit) {
  Cache* c = static_cast<Cache*>(h);
  auto it = c->entries.find(bit);
  return it == c->entries.end() ? -1
                                : static_cast<int64_t>(it->second.blob.size());
}

// Copies the blob for `bit` into out (cap bytes) and touches LRU order.
// Returns the blob length, or -1 if absent / cap too small.
int64_t hvc_cache_get(void* h, int64_t bit, uint8_t* out, int64_t cap) {
  Cache* c = static_cast<Cache*>(h);
  auto it = c->entries.find(bit);
  if (it == c->entries.end()) return -1;
  CacheEntry& e = it->second;
  if (static_cast<int64_t>(e.blob.size()) > cap) return -1;
  std::memcpy(out, e.blob.data(), e.blob.size());
  c->lru.erase(e.pos);
  c->lru.push_back(bit);
  e.pos = std::prev(c->lru.end());
  return static_cast<int64_t>(e.blob.size());
}

void hvc_cache_invalidate(void* h, const char* name) {
  Cache* c = static_cast<Cache*>(h);
  auto it = c->name_to_bit.find(name);
  if (it == c->name_to_bit.end()) return;
  int64_t bit = it->second;
  c->name_to_bit.erase(it);
  auto eit = c->entries.find(bit);
  if (eit != c->entries.end()) {
    c->lru.erase(eit->second.pos);
    c->entries.erase(eit);
    c->free_bits.push(bit);
  }
}

int64_t hvc_cache_size(void* h) {
  return static_cast<int64_t>(static_cast<Cache*>(h)->entries.size());
}

// Fusion bin-packing (reference: FuseResponses, controller.cc:551-672).
// Inputs are per-response: is_allreduce flag, join-key id (same id ==
// same dtype + reduction params), payload bytes. Output: sequences of
// [group_len, idx...] in execution order. Returns ints written, or -1 if
// `cap` is too small (caller sizes cap = 2n, which always suffices).
int64_t hvc_fuse(int64_t n, const uint8_t* is_allreduce,
                 const int64_t* key_id, const int64_t* nbytes,
                 int64_t threshold, int32_t* out, int64_t cap) {
  std::vector<int64_t> remaining(n);
  for (int64_t i = 0; i < n; ++i) remaining[i] = i;
  int64_t w = 0;
  std::vector<int64_t> skipped;
  skipped.reserve(n);
  size_t start = 0;  // head cursor into `remaining` (avoids O(n) pops)
  while (start < remaining.size()) {
    int64_t head = remaining[start++];
    if (!is_allreduce[head]) {
      if (w + 2 > cap) return -1;
      out[w++] = 1;
      out[w++] = static_cast<int32_t>(head);
      continue;
    }
    int64_t head_count_pos = w;
    if (w + 2 > cap) return -1;
    out[w++] = 1;
    out[w++] = static_cast<int32_t>(head);
    int64_t acc_bytes = nbytes[head];
    skipped.clear();
    for (size_t j = start; j < remaining.size(); ++j) {
      int64_t cand = remaining[j];
      if (is_allreduce[cand] && key_id[cand] == key_id[head] &&
          acc_bytes + nbytes[cand] <= threshold) {
        if (w + 1 > cap) return -1;
        out[w++] = static_cast<int32_t>(cand);
        out[head_count_pos]++;
        acc_bytes += nbytes[cand];
      } else {
        skipped.push_back(cand);
      }
    }
    remaining.assign(skipped.begin(), skipped.end());
    start = 0;
  }
  return w;
}

}  // extern "C"
