// zstore — native memory-tiered blob store with background prefetch.
//
// Host-side analog of the reference's native data-cache layer: the PMEM
// allocator JNI (zoo/src/main/java/.../pmem/PersistentMemoryAllocator.java:
// 19-44 malloc/free/copy into Optane via memkind) and the tiered FeatureSet
// (zoo/.../feature/FeatureSet.scala DRAMFeatureSet:635 / DiskFeatureSet:556
// "keep 1/n in memory"). The hosts have no Optane, so the tiers here are
// host DRAM (bounded arena, LRU-evicted) over disk spill files, with a
// prefetch thread that stages upcoming shards back into DRAM — the role
// Spark's cached RDD partitions + PMEM played for keeping the training
// loop fed.
//
// C ABI (ctypes-friendly; see data/native_store.py):
//   void*    zstore_create(const char* dir, uint64_t capacity_bytes)
//   int64_t  zstore_put(h, const uint8_t* data, uint64_t len)  -> id | -1
//   int64_t  zstore_size(h, int64_t id)                        -> len | -1
//   int64_t  zstore_get(h, int64_t id, uint8_t* out, uint64_t out_cap)
//   void     zstore_prefetch(h, const int64_t* ids, uint64_t n)
//   uint64_t zstore_resident_bytes(h)
//   uint64_t zstore_count(h)
//   uint64_t zstore_hits(h) / zstore_misses(h)
//   void     zstore_destroy(h)
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread -o libzstore.so zstore.cpp

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <list>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Blob {
  std::vector<uint8_t> data;  // resident copy (empty when spilled)
  std::string path;           // spill file ("" until first spill)
  uint64_t len = 0;
  bool resident = false;
  std::list<int64_t>::iterator lru_it{};  // valid iff resident
};

struct Store {
  std::string dir;
  uint64_t capacity;
  std::mutex mu;
  std::condition_variable cv;
  std::unordered_map<int64_t, Blob> blobs;
  std::list<int64_t> lru;  // front = most recent
  uint64_t resident_bytes = 0;
  int64_t next_id = 0;
  std::atomic<uint64_t> hits{0}, misses{0};
  std::deque<int64_t> prefetch_q;
  bool stopping = false;
  std::thread prefetcher;
};

// mu held. Mark blob most-recently-used.
void Touch(Store* s, int64_t id, Blob& b) {
  if (!b.resident) return;
  s->lru.erase(b.lru_it);
  s->lru.push_front(id);
  b.lru_it = s->lru.begin();
}

// mu held. Spill LRU blobs until under capacity (never evicts `keep`).
bool SpillToCapacity(Store* s, int64_t keep) {
  while (s->resident_bytes > s->capacity && !s->lru.empty()) {
    int64_t victim = s->lru.back();
    if (victim == keep) {
      if (s->lru.size() == 1) break;
      // move keep to front so the true LRU is at the back
      Blob& kb = s->blobs[victim];
      Touch(s, victim, kb);
      continue;
    }
    Blob& b = s->blobs[victim];
    if (b.path.empty()) {
      b.path = s->dir + "/blob-" + std::to_string(victim) + ".bin";
      FILE* f = fopen(b.path.c_str(), "wb");
      if (f == nullptr) return false;
      if (b.len != 0 && fwrite(b.data.data(), 1, b.len, f) != b.len) {
        fclose(f);
        return false;
      }
      fclose(f);
    }
    s->lru.pop_back();
    s->resident_bytes -= b.len;
    b.resident = false;
    b.data.clear();
    b.data.shrink_to_fit();
  }
  return true;
}

// mu held on entry/exit; released during disk IO. Returns false on IO error.
bool LoadResident(Store* s, int64_t id, std::unique_lock<std::mutex>& lk) {
  Blob& b = s->blobs[id];
  if (b.resident) return true;
  std::string path = b.path;
  uint64_t len = b.len;
  lk.unlock();
  std::vector<uint8_t> buf(len);
  int fd = open(path.c_str(), O_RDONLY);
  bool ok = fd >= 0;
  if (ok && len != 0) {
    void* m = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      ok = false;
    } else {
      memcpy(buf.data(), m, len);
      munmap(m, len);
    }
  }
  if (fd >= 0) close(fd);
  lk.lock();
  Blob& b2 = s->blobs[id];  // re-lookup: map may have rehashed
  if (!ok || b2.resident) return ok;
  b2.data = std::move(buf);
  b2.resident = true;
  s->lru.push_front(id);
  b2.lru_it = s->lru.begin();
  s->resident_bytes += b2.len;
  SpillToCapacity(s, id);
  return true;
}

void PrefetchLoop(Store* s) {
  std::unique_lock<std::mutex> lk(s->mu);
  while (true) {
    s->cv.wait(lk, [s] { return s->stopping || !s->prefetch_q.empty(); });
    if (s->stopping) return;
    int64_t id = s->prefetch_q.front();
    s->prefetch_q.pop_front();
    auto it = s->blobs.find(id);
    if (it == s->blobs.end() || it->second.resident) continue;
    LoadResident(s, id, lk);  // drops the lock during IO
  }
}

}  // namespace

extern "C" {

void* zstore_create(const char* dir, uint64_t capacity_bytes) {
  auto* s = new Store();
  s->dir = dir;
  s->capacity = capacity_bytes;
  mkdir(dir, 0755);
  s->prefetcher = std::thread(PrefetchLoop, s);
  return s;
}

int64_t zstore_put(void* h, const uint8_t* data, uint64_t len) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  int64_t id = s->next_id++;
  Blob& b = s->blobs[id];
  b.len = len;
  b.data.assign(data, data + len);
  b.resident = true;
  s->lru.push_front(id);
  b.lru_it = s->lru.begin();
  s->resident_bytes += len;
  if (!SpillToCapacity(s, id)) return -1;
  return id;
}

int64_t zstore_size(void* h, int64_t id) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  auto it = s->blobs.find(id);
  return it == s->blobs.end() ? -1 : static_cast<int64_t>(it->second.len);
}

int64_t zstore_get(void* h, int64_t id, uint8_t* out, uint64_t out_cap) {
  auto* s = static_cast<Store*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  auto it = s->blobs.find(id);
  if (it == s->blobs.end() || it->second.len > out_cap) return -1;
  if (it->second.resident) {
    s->hits.fetch_add(1);
  } else {
    s->misses.fetch_add(1);
    if (!LoadResident(s, id, lk)) return -1;
  }
  Blob& b = s->blobs[id];
  memcpy(out, b.data.data(), b.len);
  Touch(s, id, b);
  return static_cast<int64_t>(b.len);
}

void zstore_prefetch(void* h, const int64_t* ids, uint64_t n) {
  auto* s = static_cast<Store*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    for (uint64_t i = 0; i < n; ++i) s->prefetch_q.push_back(ids[i]);
  }
  s->cv.notify_all();
}

uint64_t zstore_resident_bytes(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->resident_bytes;
}

uint64_t zstore_count(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->blobs.size();
}

uint64_t zstore_hits(void* h) {
  return static_cast<Store*>(h)->hits.load();
}

uint64_t zstore_misses(void* h) {
  return static_cast<Store*>(h)->misses.load();
}

void zstore_destroy(void* h) {
  auto* s = static_cast<Store*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stopping = true;
  }
  s->cv.notify_all();
  if (s->prefetcher.joinable()) s->prefetcher.join();
  for (auto& kv : s->blobs)
    if (!kv.second.path.empty()) unlink(kv.second.path.c_str());
  rmdir(s->dir.c_str());
  delete s;
}

}  // extern "C"
