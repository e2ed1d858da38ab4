// Native transactional KV store engine for semadb_tpu.
//
// Role parity: diskstore/bbolt.go — the reference keeps every shard in one
// bbolt B+tree file with a single writer and many readers. This engine
// provides the same contract as a C++ library: named buckets of ordered
// byte keys, append-only write-ahead log for durability, in-memory ordered
// maps for reads, log compaction, and whole-file snapshots (backups /
// cluster shard shipping). Exposed through a C ABI consumed via ctypes
// (store/native.py); Python's msgpack-snapshot backend remains the
// fallback.
//
// File format:
//   header:  "SDBL1\n"
//   record:  u8 op (1=put, 2=del) | u32 blen | u32 klen | u32 vlen |
//            bucket | key | value   (little-endian, no alignment)
// A record is applied on replay only if fully present (torn tails from a
// crash are ignored, matching WAL semantics).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <string>
#include <unistd.h>
#include <unordered_map>
#include <vector>

extern "C" {

struct Store;

struct Bucket {
  std::map<std::string, std::string> data;
};

struct Store {
  std::string path;            // empty → memory only
  FILE* log = nullptr;         // append handle
  std::unordered_map<std::string, Bucket> buckets;
  std::mutex mu;               // single writer
  uint64_t dirty_ops = 0;      // ops since last compact (compaction hint)
};

static const char MAGIC[6] = {'S', 'D', 'B', 'L', '1', '\n'};

static bool read_exact(FILE* f, void* out, size_t n) {
  return fread(out, 1, n, f) == n;
}

static void append_record(Store* s, uint8_t op, const std::string& bucket,
                          const char* key, uint32_t klen, const char* val,
                          uint32_t vlen) {
  if (!s->log) return;
  uint32_t blen = (uint32_t)bucket.size();
  fwrite(&op, 1, 1, s->log);
  fwrite(&blen, 4, 1, s->log);
  fwrite(&klen, 4, 1, s->log);
  fwrite(&vlen, 4, 1, s->log);
  fwrite(bucket.data(), 1, blen, s->log);
  fwrite(key, 1, klen, s->log);
  if (vlen) fwrite(val, 1, vlen, s->log);
  s->dirty_ops++;
}

static bool replay(Store* s, FILE* f) {
  char magic[6];
  if (!read_exact(f, magic, 6) || memcmp(magic, MAGIC, 6) != 0) return false;
  std::vector<char> buf;
  for (;;) {
    uint8_t op;
    uint32_t blen, klen, vlen;
    if (!read_exact(f, &op, 1)) break;  // clean EOF
    if (!read_exact(f, &blen, 4) || !read_exact(f, &klen, 4) ||
        !read_exact(f, &vlen, 4))
      break;  // torn tail
    buf.resize((size_t)blen + klen + vlen);
    if (!read_exact(f, buf.data(), buf.size())) break;  // torn tail
    std::string bucket(buf.data(), blen);
    std::string key(buf.data() + blen, klen);
    if (op == 1) {
      s->buckets[bucket].data[key] =
          std::string(buf.data() + blen + klen, vlen);
    } else if (op == 2) {
      auto it = s->buckets.find(bucket);
      if (it != s->buckets.end()) it->second.data.erase(key);
    }
  }
  return true;
}

// fsync the directory containing `path` so a just-renamed file survives a
// crash (rename alone only orders the data, not the directory entry).
static void sync_parent_dir(const std::string& path) {
  size_t slash = path.find_last_of('/');
  std::string dir = slash == std::string::npos ? "." : path.substr(0, slash);
  if (dir.empty()) dir = "/";
  int fd = open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (fd >= 0) {
    fsync(fd);
    close(fd);
  }
}

static int write_snapshot(Store* s, const std::string& dest) {
  std::string tmp = dest + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  fwrite(MAGIC, 1, 6, f);
  for (auto& [bname, bucket] : s->buckets) {
    for (auto& [k, v] : bucket.data) {
      uint8_t op = 1;
      uint32_t blen = (uint32_t)bname.size(), klen = (uint32_t)k.size(),
               vlen = (uint32_t)v.size();
      fwrite(&op, 1, 1, f);
      fwrite(&blen, 4, 1, f);
      fwrite(&klen, 4, 1, f);
      fwrite(&vlen, 4, 1, f);
      fwrite(bname.data(), 1, blen, f);
      fwrite(k.data(), 1, klen, f);
      fwrite(v.data(), 1, vlen, f);
    }
  }
  // Durability order: data → disk, then rename, then directory entry →
  // disk. Matches bbolt's fsync-on-commit guarantee for snapshots.
  fflush(f);
  fsync(fileno(f));
  fclose(f);
  if (rename(tmp.c_str(), dest.c_str()) != 0) return -1;
  sync_parent_dir(dest);
  return 0;
}

Store* sdb_open(const char* path) {
  Store* s = new Store();
  s->path = path ? path : "";
  if (!s->path.empty()) {
    FILE* f = fopen(s->path.c_str(), "rb");
    if (f) {
      bool ok = replay(s, f);
      fclose(f);
      if (!ok) {
        delete s;
        return nullptr;  // not our file format
      }
      s->log = fopen(s->path.c_str(), "ab");
    } else {
      s->log = fopen(s->path.c_str(), "wb");
      if (s->log) {
        fwrite(MAGIC, 1, 6, s->log);
        fflush(s->log);
      }
    }
    if (!s->log) {
      delete s;
      return nullptr;
    }
  }
  return s;
}

void sdb_close(Store* s) {
  if (!s) return;
  if (s->log) {
    fflush(s->log);
    fsync(fileno(s->log));
    fclose(s->log);
  }
  delete s;
}

int sdb_put(Store* s, const char* bucket, const char* key, uint32_t klen,
            const char* val, uint32_t vlen) {
  std::lock_guard<std::mutex> g(s->mu);
  std::string b(bucket);
  s->buckets[b].data[std::string(key, klen)] = std::string(val, vlen);
  append_record(s, 1, b, key, klen, val, vlen);
  return 0;
}

int sdb_delete(Store* s, const char* bucket, const char* key, uint32_t klen) {
  std::lock_guard<std::mutex> g(s->mu);
  std::string b(bucket);
  auto it = s->buckets.find(b);
  if (it != s->buckets.end()) it->second.data.erase(std::string(key, klen));
  append_record(s, 2, b, key, klen, nullptr, 0);
  return 0;
}

// Returns value length, or -1 if absent. The value is COPIED into a
// malloc'd buffer under the store mutex (readers never observe a torn
// value from a concurrent writer — the zero-copy variant handed out a
// pointer that the caller dereferenced unlocked, a data race). The caller
// must release it with sdb_free.
int64_t sdb_get(Store* s, const char* bucket, const char* key, uint32_t klen,
                char** out) {
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->buckets.find(bucket);
  if (it == s->buckets.end()) return -1;
  auto kit = it->second.data.find(std::string(key, klen));
  if (kit == it->second.data.end()) return -1;
  const std::string& v = kit->second;
  char* buf = (char*)malloc(v.size() ? v.size() : 1);
  if (!buf) return -1;
  memcpy(buf, v.data(), v.size());
  *out = buf;
  return (int64_t)v.size();
}

void sdb_free(void* p) { free(p); }

// Batched get of nk fixed-length keys (klen bytes each, concatenated in
// keys). All present values are copied into ONE malloc'd buffer (*out,
// released with sdb_free); lens[i] receives value i's length, or -1 when
// key i is absent. Returns total value bytes, or -1 on allocation
// failure. One mutex acquisition + one Python->C crossing for the whole
// batch — the search result backfill path reads tens of thousands of
// point records per request batch (shard.go:350-371 analog), and
// per-key sdb_get calls were measured at ~10us of ctypes overhead each.
int64_t sdb_multi_get(Store* s, const char* bucket, const char* keys,
                      uint32_t klen, uint32_t nk, char** out,
                      int64_t* lens) {
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->buckets.find(bucket);
  if (it == s->buckets.end()) {
    for (uint32_t i = 0; i < nk; i++) lens[i] = -1;
    *out = (char*)malloc(1);
    return *out ? 0 : -1;
  }
  auto& data = it->second.data;
  std::vector<const std::string*> vals(nk, nullptr);
  int64_t total = 0;
  std::string k;
  for (uint32_t i = 0; i < nk; i++) {
    k.assign(keys + (size_t)i * klen, klen);
    auto kit = data.find(k);
    if (kit == data.end()) {
      lens[i] = -1;
      continue;
    }
    vals[i] = &kit->second;
    lens[i] = (int64_t)kit->second.size();
    total += lens[i];
  }
  char* buf = (char*)malloc(total ? (size_t)total : 1);
  if (!buf) return -1;
  char* p = buf;
  for (uint32_t i = 0; i < nk; i++) {
    if (!vals[i]) continue;
    memcpy(p, vals[i]->data(), vals[i]->size());
    p += vals[i]->size();
  }
  *out = buf;
  return total;
}

int sdb_commit(Store* s) {
  std::lock_guard<std::mutex> g(s->mu);
  if (s->log) {
    // bbolt fsyncs on every commit (the reference's durability floor);
    // fflush alone only reaches the OS page cache.
    fflush(s->log);
    fsync(fileno(s->log));
  }
  return 0;
}

int sdb_compact(Store* s) {
  std::lock_guard<std::mutex> g(s->mu);
  if (s->path.empty()) return 0;
  if (s->log) {
    fflush(s->log);
    fclose(s->log);
    s->log = nullptr;
  }
  if (write_snapshot(s, s->path) != 0) return -1;
  s->log = fopen(s->path.c_str(), "ab");
  s->dirty_ops = 0;
  return s->log ? 0 : -1;
}

uint64_t sdb_dirty_ops(Store* s) { return s->dirty_ops; }

int sdb_backup(Store* s, const char* dest) {
  std::lock_guard<std::mutex> g(s->mu);
  return write_snapshot(s, dest);
}

int sdb_delete_bucket(Store* s, const char* bucket) {
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->buckets.find(bucket);
  if (it == s->buckets.end()) return 0;
  // Log tombstones for every key, then drop the bucket
  for (auto& [k, v] : it->second.data) {
    append_record(s, 2, bucket, k.data(), (uint32_t)k.size(), nullptr, 0);
  }
  s->buckets.erase(it);
  return 0;
}

// --- cursors (ordered iteration, safe against concurrent writes) ---
//
// The cursor never holds a live std::map iterator across calls: each
// sdb_cursor_next re-seeks from the last returned key under the store
// mutex and copies the entry into cursor-owned buffers. Concurrent
// puts/deletes (even of the entry the cursor last returned) can therefore
// never invalidate it — the iteration sees a key at most once, in order,
// and tolerates the map changing between steps (the per-step analog of
// bbolt's snapshot isolation; full MVCC is not needed because Python-side
// transactions serialize writers).

struct Cursor {
  Store* store;
  std::string bucket;
  std::string next_from;  // seek lower_bound(next_from) on the next call
  bool exclusive = false; // true once a key has been returned
  std::string cur_k, cur_v;  // cursor-owned copies handed to the caller
};

Cursor* sdb_cursor(Store* s, const char* bucket, const char* start,
                   uint32_t slen) {
  std::lock_guard<std::mutex> g(s->mu);
  auto bit = s->buckets.find(bucket);
  if (bit == s->buckets.end()) return nullptr;
  Cursor* c = new Cursor();
  c->store = s;
  c->bucket = bucket;
  c->next_from = std::string(start, slen);
  return c;
}

// Returned pointers reference cursor-owned memory, valid until the next
// call on the SAME cursor (the caller copies immediately).
int sdb_cursor_next(Cursor* c, const char** key, uint32_t* klen,
                    const char** val, uint32_t* vlen) {
  if (!c) return 0;
  Store* s = c->store;
  std::lock_guard<std::mutex> g(s->mu);
  auto bit = s->buckets.find(c->bucket);
  if (bit == s->buckets.end()) return 0;  // bucket dropped mid-scan
  auto& data = bit->second.data;
  auto it = c->exclusive ? data.upper_bound(c->next_from)
                         : data.lower_bound(c->next_from);
  if (it == data.end()) return 0;
  c->cur_k = it->first;
  c->cur_v = it->second;
  c->next_from = c->cur_k;
  c->exclusive = true;
  *key = c->cur_k.data();
  *klen = (uint32_t)c->cur_k.size();
  *val = c->cur_v.data();
  *vlen = (uint32_t)c->cur_v.size();
  return 1;
}

void sdb_cursor_free(Cursor* c) { delete c; }

uint64_t sdb_bucket_count(Store* s, const char* bucket) {
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->buckets.find(bucket);
  return it == s->buckets.end() ? 0 : it->second.data.size();
}

// Bucket names enumeration: writes up to `max` names separated by '\n' into
// out; returns total byte length required.
uint64_t sdb_bucket_names(Store* s, char* out, uint64_t max) {
  std::lock_guard<std::mutex> g(s->mu);
  std::string all;
  for (auto& [name, _] : s->buckets) {
    all += name;
    all += '\n';
  }
  if (out && max >= all.size()) memcpy(out, all.data(), all.size());
  return all.size();
}

}  // extern "C"
