// lockbox: embedded append-only-log key-value store.
//
// The native storage engine backing the hot/cold database — the slot the
// reference fills with LevelDB (C++) via its KeyValueStore trait
// (beacon_node/store/src/leveldb_store.rs).  Deliberately simpler than an
// LSM tree: beacon-chain storage is append-mostly (blocks/states written
// once, pruned in ranges), so a single log file + in-memory index +
// stop-the-world compaction covers the access pattern.
//
// Format: sequence of records
//   [u8 op] [u32 klen] [u32 vlen] [key bytes] [value bytes]
// op: 1 = put, 2 = delete (vlen == 0).  Little-endian lengths.  On open the
// log is scanned to rebuild the index; a torn tail (partial record from a
// crash) is truncated.  Exposed through a C ABI for ctypes.

#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct Entry {
  uint64_t offset;  // offset of the value bytes in the log
  uint32_t len;
};

struct Lockbox {
  std::string path;
  FILE* log = nullptr;
  std::map<std::string, Entry> index;  // ordered: prefix scans are ranges
  uint64_t log_size = 0;
  uint64_t live_bytes = 0;
  std::mutex mu;
};

bool read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n;
}

// Open read/write honoring seeks.  "ab+" must not be used for the log:
// append mode writes at EOF regardless of fseeko, so after a failed append
// left torn bytes at EOF the next record would land *after* the torn bytes
// and every later record would be silently discarded by scan() on reopen.
FILE* open_rw(const char* path) {
  FILE* f = fopen(path, "rb+");
  if (!f) f = fopen(path, "wb+");
  return f;
}

// Scan the log, rebuilding the index.  Returns the offset of the first
// corrupt/torn record (== file size when the log is clean).
uint64_t scan(Lockbox* box) {
  FILE* f = box->log;
  fseeko(f, 0, SEEK_SET);
  uint64_t off = 0;
  for (;;) {
    uint8_t op;
    uint32_t klen, vlen;
    if (!read_exact(f, &op, 1)) break;
    if (!read_exact(f, &klen, 4) || !read_exact(f, &vlen, 4)) break;
    if (op != 1 && op != 2) break;
    if (klen > (1u << 24) || vlen > (1u << 31)) break;
    std::string key(klen, '\0');
    if (!read_exact(f, key.data(), klen)) break;
    uint64_t voff = off + 9 + klen;
    if (op == 1) {
      if (fseeko(f, vlen, SEEK_CUR) != 0) break;
      auto it = box->index.find(key);
      if (it != box->index.end()) box->live_bytes -= it->second.len;
      box->index[key] = Entry{voff, vlen};
      box->live_bytes += vlen;
    } else {
      auto it = box->index.find(key);
      if (it != box->index.end()) {
        box->live_bytes -= it->second.len;
        box->index.erase(it);
      }
    }
    uint64_t next = voff + (op == 1 ? vlen : 0);
    // Verify we actually reached `next` (fseeko past EOF succeeds silently).
    if ((uint64_t)ftello(f) != next) break;
    off = next;
  }
  return off;
}

int append_record(Lockbox* box, uint8_t op, const char* key, uint32_t klen,
                  const char* val, uint32_t vlen) {
  FILE* f = box->log;
  if (!f) return -1;  // a failed compact may have left the log closed
  if (fseeko(f, box->log_size, SEEK_SET) != 0) return -1;
  if (fwrite(&op, 1, 1, f) != 1) return -1;
  if (fwrite(&klen, 4, 1, f) != 1) return -1;
  if (fwrite(&vlen, 4, 1, f) != 1) return -1;
  if (klen && fwrite(key, 1, klen, f) != klen) return -1;
  if (vlen && fwrite(val, 1, vlen, f) != vlen) return -1;
  box->log_size += 9 + klen + vlen;
  return 0;
}

}  // namespace

extern "C" {

void* lockbox_open(const char* path) {
  auto* box = new Lockbox();
  box->path = path;
  box->log = open_rw(path);
  if (!box->log) {
    delete box;
    return nullptr;
  }
  uint64_t clean = scan(box);
  fseeko(box->log, 0, SEEK_END);
  uint64_t size = ftello(box->log);
  if (clean < size) {
    // torn tail from a crash: truncate to the last clean record
    (void)!ftruncate(fileno(box->log), clean);
  }
  box->log_size = clean;
  return box;
}

void lockbox_close(void* h) {
  auto* box = static_cast<Lockbox*>(h);
  if (box->log) {
    fflush(box->log);
    fclose(box->log);
  }
  delete box;
}

int lockbox_put(void* h, const char* key, uint32_t klen, const char* val,
                uint32_t vlen) {
  auto* box = static_cast<Lockbox*>(h);
  std::lock_guard<std::mutex> g(box->mu);
  uint64_t voff = box->log_size + 9 + klen;
  if (append_record(box, 1, key, klen, val, vlen) != 0) return -1;
  auto it = box->index.find(std::string(key, klen));
  if (it != box->index.end()) box->live_bytes -= it->second.len;
  box->index[std::string(key, klen)] = Entry{voff, vlen};
  box->live_bytes += vlen;
  return 0;
}

// Returns value length, or -1 if absent.  Caller passes a buffer of
// capacity `cap`; if the value is larger, only the length is returned
// (call again with a big enough buffer).
int64_t lockbox_get(void* h, const char* key, uint32_t klen, char* out,
                    uint64_t cap) {
  auto* box = static_cast<Lockbox*>(h);
  std::lock_guard<std::mutex> g(box->mu);
  if (!box->log) return -2;  // failed compact may have left the log closed
  auto it = box->index.find(std::string(key, klen));
  if (it == box->index.end()) return -1;
  if (it->second.len <= cap) {
    fflush(box->log);
    if (fseeko(box->log, it->second.offset, SEEK_SET) != 0) return -2;
    if (!read_exact(box->log, out, it->second.len)) return -2;
  }
  return it->second.len;
}

int lockbox_delete(void* h, const char* key, uint32_t klen) {
  auto* box = static_cast<Lockbox*>(h);
  std::lock_guard<std::mutex> g(box->mu);
  auto it = box->index.find(std::string(key, klen));
  if (it == box->index.end()) return 0;
  if (append_record(box, 2, key, klen, nullptr, 0) != 0) return -1;
  box->live_bytes -= it->second.len;
  box->index.erase(it);
  return 0;
}

uint64_t lockbox_count(void* h) {
  auto* box = static_cast<Lockbox*>(h);
  std::lock_guard<std::mutex> g(box->mu);
  return box->index.size();
}

// Concatenated [u32 klen][key] for every key with the given prefix, in
// sorted order, written into `out` (capacity `cap`).  Returns required size.
uint64_t lockbox_keys(void* h, const char* prefix, uint32_t plen, char* out,
                      uint64_t cap) {
  auto* box = static_cast<Lockbox*>(h);
  std::lock_guard<std::mutex> g(box->mu);
  std::string pfx(prefix, plen);
  uint64_t need = 0;
  auto it = box->index.lower_bound(pfx);
  for (; it != box->index.end(); ++it) {
    if (it->first.compare(0, plen, pfx) != 0) break;
    uint64_t rec = 4 + it->first.size();
    if (need + rec <= cap) {
      uint32_t kl = (uint32_t)it->first.size();
      memcpy(out + need, &kl, 4);
      memcpy(out + need + 4, it->first.data(), kl);
    }
    need += rec;
  }
  return need;
}

int lockbox_flush(void* h) {
  auto* box = static_cast<Lockbox*>(h);
  std::lock_guard<std::mutex> g(box->mu);
  return fflush(box->log) == 0 ? 0 : -1;
}

// Rewrite the log with only live records (stop-the-world compaction —
// the maintenance analog of LevelDB's background compaction).
int lockbox_compact(void* h) {
  auto* box = static_cast<Lockbox*>(h);
  std::lock_guard<std::mutex> g(box->mu);
  if (!box->log) return -1;  // a prior failed compact closed the log
  std::string tmp_path = box->path + ".compact";
  FILE* tmp = fopen(tmp_path.c_str(), "wb");
  if (!tmp) return -1;
  std::map<std::string, Entry> new_index;
  uint64_t off = 0;
  fflush(box->log);
  std::vector<char> buf;
  for (auto& kv : box->index) {
    buf.resize(kv.second.len);
    if (fseeko(box->log, kv.second.offset, SEEK_SET) != 0 ||
        !read_exact(box->log, buf.data(), kv.second.len)) {
      fclose(tmp);
      remove(tmp_path.c_str());
      return -1;
    }
    uint8_t op = 1;
    uint32_t klen = (uint32_t)kv.first.size(), vlen = kv.second.len;
    fwrite(&op, 1, 1, tmp);
    fwrite(&klen, 4, 1, tmp);
    fwrite(&vlen, 4, 1, tmp);
    fwrite(kv.first.data(), 1, klen, tmp);
    fwrite(buf.data(), 1, vlen, tmp);
    new_index[kv.first] = Entry{off + 9 + klen, vlen};
    off += 9 + klen + vlen;
  }
  if (fflush(tmp) != 0) {
    fclose(tmp);
    remove(tmp_path.c_str());
    return -1;
  }
  fclose(tmp);
  fclose(box->log);
  if (rename(tmp_path.c_str(), box->path.c_str()) != 0) {
    box->log = open_rw(box->path.c_str());  // may be NULL; append_record guards
    remove(tmp_path.c_str());
    return -1;
  }
  box->log = open_rw(box->path.c_str());
  if (!box->log) return -1;
  box->index = std::move(new_index);
  box->log_size = off;
  return 0;
}

}  // extern "C"
