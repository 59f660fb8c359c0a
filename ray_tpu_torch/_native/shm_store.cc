// Shared-memory slab arena — the C++ core of the port's object store.
//
// Native equivalent of the reference's plasma store allocator
// (src/ray/object_manager/plasma/: store_runner.h,
// dlmalloc.cc over mmap'd shm, object_lifecycle_manager) re-shaped for the
// ownership design of _private/object_store.py: every worker process
// owns ONE posix-shm arena sized to its store cap; objects are carved out of
// it by a boundary-tag allocator with segregated free-list bins (a compact
// dlmalloc analog), and peers map the whole arena once, then read any object
// at (offset, size) zero-copy — instead of one shm_open+mmap per object.
//
// Concurrency contract: only the OWNING process allocates/frees (single-
// writer ownership, reference reference_count.h:61); a process-local pthread
// mutex serializes its threads. Readers never touch allocator metadata.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x7261795f747075ULL;  // "ray_tpu"
constexpr uint64_t kAlign = 64;  // payload sizes rounded to 64B to bound
                                 // fragmentation; payloads themselves are
                                 // 16-byte aligned (block + 16B header)
constexpr uint64_t kHeaderBytes = 4096;           // arena header page
constexpr uint64_t kBlockHdr = 16;                // size_flags + prev_size
constexpr uint64_t kMinPayload = 64;              // min split remainder
constexpr int kBins = 48;
constexpr uint64_t kUsedBit = 1ULL;

// Block layout (offsets relative to arena base):
//   [size_flags u64][prev_size u64][payload ...]
// size = total block bytes incl. header; LSB of size_flags = in-use.
// Free blocks keep {next_free u64, prev_free u64} at payload start.

struct ArenaHeader {
  uint64_t magic;
  uint64_t arena_size;   // total mapping size
  uint64_t heap_start;   // first block offset
  uint64_t heap_end;
  uint64_t used_bytes;   // payload bytes currently allocated
  uint64_t num_allocs;
  uint64_t bins[kBins];  // free-list heads (0 = empty)
};

struct Handle {
  uint8_t* base;
  uint64_t size;
  std::string name;
  bool owner;
  pthread_mutex_t lock;
};

inline ArenaHeader* hdr(Handle* h) {
  return reinterpret_cast<ArenaHeader*>(h->base);
}
inline uint64_t& size_flags(Handle* h, uint64_t off) {
  return *reinterpret_cast<uint64_t*>(h->base + off);
}
inline uint64_t& prev_size(Handle* h, uint64_t off) {
  return *reinterpret_cast<uint64_t*>(h->base + off + 8);
}
inline uint64_t block_size(Handle* h, uint64_t off) {
  return size_flags(h, off) & ~kUsedBit;
}
inline bool block_used(Handle* h, uint64_t off) {
  return size_flags(h, off) & kUsedBit;
}
inline uint64_t& next_free(Handle* h, uint64_t off) {
  return *reinterpret_cast<uint64_t*>(h->base + off + kBlockHdr);
}
inline uint64_t& prev_free(Handle* h, uint64_t off) {
  return *reinterpret_cast<uint64_t*>(h->base + off + kBlockHdr + 8);
}

int bin_index(uint64_t size) {
  // log2 size classes starting at 128B blocks.
  int b = 0;
  uint64_t s = size >> 7;
  while (s > 1 && b < kBins - 1) {
    s >>= 1;
    ++b;
  }
  return b;
}

void freelist_insert(Handle* h, uint64_t off) {
  ArenaHeader* a = hdr(h);
  int b = bin_index(block_size(h, off));
  next_free(h, off) = a->bins[b];
  prev_free(h, off) = 0;
  if (a->bins[b]) prev_free(h, a->bins[b]) = off;
  a->bins[b] = off;
}

void freelist_remove(Handle* h, uint64_t off) {
  ArenaHeader* a = hdr(h);
  int b = bin_index(block_size(h, off));
  uint64_t nxt = next_free(h, off), prv = prev_free(h, off);
  if (prv) {
    next_free(h, prv) = nxt;
  } else {
    a->bins[b] = nxt;
  }
  if (nxt) prev_free(h, nxt) = prv;
}

uint64_t next_block(Handle* h, uint64_t off) {
  return off + block_size(h, off);
}

}  // namespace

extern "C" {

// Create a new arena of `size` bytes backed by /dev/shm/<name>.
// Returns an opaque handle or nullptr.
void* rtpu_arena_create(const char* name, uint64_t size) {
  if (size < kHeaderBytes + 4 * kMinPayload) return nullptr;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base =
      mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Handle* h = new Handle{static_cast<uint8_t*>(base), size, name, true,
                         PTHREAD_MUTEX_INITIALIZER};
  pthread_mutex_init(&h->lock, nullptr);
  ArenaHeader* a = hdr(h);
  std::memset(a, 0, sizeof(ArenaHeader));
  a->magic = kMagic;
  a->arena_size = size;
  a->heap_start = kHeaderBytes;
  // Keep every block size 8-aligned: an odd heap_end would leave a tail gap
  // whose 'next block' header read lands on unaligned (or out-of-range)
  // bytes during coalescing.
  a->heap_end = size & ~7ULL;
  // one giant free block spans the heap
  uint64_t off = a->heap_start;
  size_flags(h, off) = (a->heap_end - a->heap_start) & ~kUsedBit;
  prev_size(h, off) = 0;
  freelist_insert(h, off);
  return h;
}

// Map an existing arena read-write (readers only read payload bytes).
void* rtpu_arena_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, static_cast<uint64_t>(st.st_size),
                    PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Handle* h = new Handle{static_cast<uint8_t*>(base),
                         static_cast<uint64_t>(st.st_size), name, false,
                         PTHREAD_MUTEX_INITIALIZER};
  pthread_mutex_init(&h->lock, nullptr);
  if (hdr(h)->magic != kMagic) {
    munmap(base, h->size);
    delete h;
    return nullptr;
  }
  return h;
}

// Allocate `size` payload bytes; returns payload offset or 0 on failure
// (0 is inside the header page, never a valid payload offset).
uint64_t rtpu_arena_alloc(void* handle, uint64_t size) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h->owner) return 0;
  uint64_t need = kBlockHdr + ((size + kAlign - 1) & ~(kAlign - 1));
  if (need < kBlockHdr + kMinPayload) need = kBlockHdr + kMinPayload;
  pthread_mutex_lock(&h->lock);
  ArenaHeader* a = hdr(h);
  uint64_t off = 0;
  for (int b = bin_index(need); b < kBins && !off; ++b) {
    // first fit within the bin (bounded scan keeps alloc O(1)-ish)
    uint64_t cur = a->bins[b];
    int scanned = 0;
    while (cur && scanned < 32) {
      if (block_size(h, cur) >= need) {
        off = cur;
        break;
      }
      cur = next_free(h, cur);
      ++scanned;
    }
  }
  if (!off) {
    pthread_mutex_unlock(&h->lock);
    return 0;
  }
  freelist_remove(h, off);
  uint64_t bsize = block_size(h, off);
  if (bsize - need >= kBlockHdr + kMinPayload) {
    // split: tail becomes a new free block
    uint64_t tail = off + need;
    size_flags(h, tail) = (bsize - need) & ~kUsedBit;
    prev_size(h, tail) = need;
    freelist_insert(h, tail);
    uint64_t after = next_block(h, tail);
    if (after < a->heap_end) prev_size(h, after) = bsize - need;
    bsize = need;
  }
  size_flags(h, off) = bsize | kUsedBit;
  a->used_bytes += bsize;
  a->num_allocs += 1;
  pthread_mutex_unlock(&h->lock);
  return off + kBlockHdr;
}

// Free a payload offset returned by rtpu_arena_alloc.
void rtpu_arena_free(void* handle, uint64_t payload_off) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h->owner || payload_off < kHeaderBytes + kBlockHdr) return;
  uint64_t off = payload_off - kBlockHdr;
  pthread_mutex_lock(&h->lock);
  ArenaHeader* a = hdr(h);
  if (!block_used(h, off)) {  // double free — ignore
    pthread_mutex_unlock(&h->lock);
    return;
  }
  uint64_t bsize = block_size(h, off);
  a->used_bytes -= bsize;
  a->num_allocs -= 1;
  size_flags(h, off) = bsize & ~kUsedBit;
  // coalesce forward
  uint64_t nxt = off + bsize;
  if (nxt < a->heap_end && !block_used(h, nxt)) {
    freelist_remove(h, nxt);
    bsize += block_size(h, nxt);
    size_flags(h, off) = bsize & ~kUsedBit;
  }
  // coalesce backward
  if (off > a->heap_start) {
    uint64_t prv = off - prev_size(h, off);
    if (!block_used(h, prv)) {
      freelist_remove(h, prv);
      bsize += block_size(h, prv);
      off = prv;
      size_flags(h, off) = bsize & ~kUsedBit;
    }
  }
  uint64_t after = off + bsize;
  if (after < a->heap_end) prev_size(h, after) = bsize;
  freelist_insert(h, off);
  pthread_mutex_unlock(&h->lock);
}

uint8_t* rtpu_arena_base(void* handle) {
  return static_cast<Handle*>(handle)->base;
}

uint64_t rtpu_arena_size(void* handle) {
  return static_cast<Handle*>(handle)->size;
}

uint64_t rtpu_arena_used(void* handle) {
  return hdr(static_cast<Handle*>(handle))->used_bytes;
}

uint64_t rtpu_arena_num_allocs(void* handle) {
  return hdr(static_cast<Handle*>(handle))->num_allocs;
}

// Detach the mapping (readers and owners); owner additionally unlinks the
// shm name if `unlink` is nonzero.
void rtpu_arena_close(void* handle, int unlink_name) {
  Handle* h = static_cast<Handle*>(handle);
  munmap(h->base, h->size);
  if (h->owner && unlink_name) shm_unlink(h->name.c_str());
  pthread_mutex_destroy(&h->lock);
  delete h;
}

}  // extern "C"
