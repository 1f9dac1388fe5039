// Shared-memory object store — the Plasma analog for the actor runtime.
//
// The port's own copy of `tosem_tpu/native/objstore.cpp`, unchanged in
// behaviour and layout.
//
// Role model: the reference's Plasma store (`src/ray/object_manager/plasma/
// store.cc`, client at `plasma/client.cc`, eviction at `eviction_policy.cc`):
// an mmap'd shared-memory arena holding immutable objects addressed by a
// 20-byte id, shared zero-copy between processes on one host. This
// implementation keeps the same contract (create/seal-on-put, immutable
// objects, per-object refcounts, LRU-evictable) but drops the flatbuffer IPC
// protocol (`plasma/plasma.fbs`): clients attach the segment directly and
// synchronise with one process-shared robust mutex, because the runtime's
// control plane is a single driver process rather than Ray's raylet daemon.
//
// Allocator: boundary-tag first-fit free list with coalescing — the small,
// auditable core of what plasma got from dlmalloc.
//
// Built as a plain C ABI for ctypes (`tosem_tpu_torch/runtime/object_store.py`).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x544f53454d4f5354ULL;  // "TOSEMOST"
constexpr uint32_t kVersion = 2;  // v2: per-pid pin ledger in Slot
constexpr uint32_t kIdLen = 20;
constexpr uint32_t kTableSlots = 1 << 13;  // open-addressed index
constexpr uint64_t kAlign = 64;            // cache-line aligned payloads
constexpr uint32_t kMaxPinners = 12;       // distinct pids per pin ledger

enum SlotState : uint32_t { kEmpty = 0, kUsed = 1, kTombstone = 2,
                            kCreating = 3, kPendingDelete = 4 };

struct Slot {
  uint8_t id[kIdLen];
  uint32_t state;
  uint32_t refcount;
  uint64_t offset;  // payload offset from segment base
  uint64_t size;    // payload size
  uint64_t lru;     // last-touch tick, for eviction
  int64_t creator_pid;  // reserver's pid; orphan detection for kCreating
  // Pin ledger: which processes hold zero-copy mappings (get() without a
  // matching release()). A pinned object (refcount > 0) is skipped by LRU
  // eviction AND refused by delete_if_unpinned (the spill/pressure path),
  // so a mapped-in-place consumer can never have the pages freed out from
  // under it. refcount == sum(pin_count) + anon_pins; entries whose pid is
  // dead are reclaimed lazily under allocation pressure so a SIGKILLed
  // reader cannot wedge eviction forever. A 13th distinct SIMULTANEOUS
  // pinner overflows into anon_pins — still a pin, just not crash-
  // reclaimable; record_pin reclaims dead entries before overflowing,
  // so getting there takes 13+ live pinner processes on ONE object
  // (bounded worker pools never do).
  int64_t pin_pid[kMaxPinners];
  uint32_t pin_count[kMaxPinners];
  uint32_t anon_pins;
};

// getpid() is a real syscall (pathologically slow under some sandboxed
// kernels) — cache it and refresh in fork children via pthread_atfork.
pid_t g_pid = getpid();
void refresh_cached_pid() { g_pid = getpid(); }
struct PidInit {
  PidInit() { pthread_atfork(nullptr, nullptr, refresh_cached_pid); }
} g_pid_init;

void reclaim_dead_pins(Slot* s);

void record_pin(Slot* s, int64_t pid) {
  for (int attempt = 0; attempt < 2; attempt++) {
    int64_t free_i = -1;
    for (uint32_t i = 0; i < kMaxPinners; i++) {
      if (s->pin_count[i] > 0 && s->pin_pid[i] == pid) {
        s->pin_count[i]++;
        return;
      }
      if (s->pin_count[i] == 0 && free_i < 0) free_i = (int64_t)i;
    }
    if (free_i >= 0) {
      s->pin_pid[free_i] = pid;
      s->pin_count[free_i] = 1;
      return;
    }
    // ledger full: entries held by dead processes are reclaimable —
    // evict them before overflowing into the anonymous count
    if (attempt == 0) reclaim_dead_pins(s);
  }
  s->anon_pins++;  // 13+ live pinners: pinned but not crash-reclaimable
}

void drop_pin(Slot* s, int64_t pid) {
  for (uint32_t i = 0; i < kMaxPinners; i++) {
    if (s->pin_count[i] > 0 && s->pin_pid[i] == pid) {
      s->pin_count[i]--;
      if (s->pin_count[i] == 0) s->pin_pid[i] = 0;
      return;
    }
  }
  if (s->anon_pins > 0) s->anon_pins--;
}

// Drop pins whose owning process died (crashed mid-read, SIGKILLed
// worker holding a mapping): each dead entry's count is subtracted from
// refcount so the object becomes evictable/spillable again.
void reclaim_dead_pins(Slot* s) {
  if (s->refcount == 0) return;
  for (uint32_t i = 0; i < kMaxPinners; i++) {
    if (s->pin_count[i] == 0) continue;
    pid_t p = (pid_t)s->pin_pid[i];
    if (p > 0 && kill(p, 0) != 0 && errno == ESRCH) {
      uint32_t c = s->pin_count[i];
      s->refcount = s->refcount > c ? s->refcount - c : 0;
      s->pin_count[i] = 0;
      s->pin_pid[i] = 0;
    }
  }
}

// A kCreating slot whose creator died mid-write is an orphan: nobody can
// seal it, so it is reclaimable (plasma's disconnect-cleanup role).
bool slot_is_orphan(const Slot* s) {
  if (s->state != kCreating) return false;
  return s->creator_pid > 0 && kill((pid_t)s->creator_pid, 0) != 0 &&
         errno == ESRCH;
}

// Block layout in the data region:
//   [BlockHeader][payload ... ][BlockFooter]
// Footer lets free() coalesce with the previous block in O(1).
struct BlockHeader {
  uint64_t size;       // total block size incl. header+footer
  uint64_t free;       // 1 = on free list
  uint64_t next_free;  // offset of next free block (0 = none)
};
struct BlockFooter {
  uint64_t size;
};

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t pad0;
  uint64_t capacity;     // total segment size
  uint64_t data_begin;   // offset of first block
  uint64_t free_head;    // offset of first free block (0 = none)
  uint64_t used_bytes;   // payload bytes currently stored
  uint64_t num_objects;
  uint64_t lru_tick;
  pthread_mutex_t lock;  // process-shared, robust
  Slot table[kTableSlots];
};

struct Handle {
  uint8_t* base;
  uint64_t capacity;
  char name[256];
  int owner;  // created (vs attached) — owner unlinks on destroy
};

inline Header* hdr(Handle* h) { return reinterpret_cast<Header*>(h->base); }
inline BlockHeader* block_at(Handle* h, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(h->base + off);
}
inline BlockFooter* footer_of(Handle* h, uint64_t off) {
  BlockHeader* b = block_at(h, off);
  return reinterpret_cast<BlockFooter*>(h->base + off + b->size -
                                        sizeof(BlockFooter));
}

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

uint64_t id_hash(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t x = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdLen; i++) { x ^= id[i]; x *= 1099511628211ULL; }
  return x;
}

int lock(Header* H) {
  int rc = pthread_mutex_lock(&H->lock);
  if (rc == EOWNERDEAD) {  // a client died holding the lock; recover
    pthread_mutex_consistent(&H->lock);
    return 0;
  }
  return rc;
}
void unlock(Header* H) { pthread_mutex_unlock(&H->lock); }

Slot* find_slot(Handle* h, const uint8_t* id, int for_insert) {
  Header* H = hdr(h);
  uint64_t start = id_hash(id) & (kTableSlots - 1);
  Slot* first_tomb = nullptr;
  for (uint32_t i = 0; i < kTableSlots; i++) {
    Slot* s = &H->table[(start + i) & (kTableSlots - 1)];
    if ((s->state == kUsed || s->state == kCreating ||
         s->state == kPendingDelete) &&
        memcmp(s->id, id, kIdLen) == 0) return s;
    if (s->state == kTombstone && !first_tomb) first_tomb = s;
    if (s->state == kEmpty)
      return for_insert ? (first_tomb ? first_tomb : s) : nullptr;
  }
  return for_insert ? first_tomb : nullptr;
}

// Remove a block from the free list (by offset).
void freelist_remove(Handle* h, uint64_t off) {
  Header* H = hdr(h);
  uint64_t* link = &H->free_head;
  while (*link) {
    BlockHeader* b = block_at(h, *link);
    if (*link == off) { *link = b->next_free; return; }
    link = &b->next_free;
  }
}

void freelist_push(Handle* h, uint64_t off) {
  Header* H = hdr(h);
  BlockHeader* b = block_at(h, off);
  b->free = 1;
  footer_of(h, off)->size = b->size;
  b->next_free = H->free_head;
  H->free_head = off;
}

// First-fit allocate `need` total block bytes; returns block offset or 0.
uint64_t alloc_block(Handle* h, uint64_t need) {
  Header* H = hdr(h);
  uint64_t* link = &H->free_head;
  while (*link) {
    uint64_t off = *link;
    BlockHeader* b = block_at(h, off);
    if (b->size >= need) {
      *link = b->next_free;  // unlink
      uint64_t remain = b->size - need;
      if (remain >= sizeof(BlockHeader) + sizeof(BlockFooter) + kAlign) {
        // split: tail stays free
        b->size = need;
        uint64_t tail_off = off + need;
        BlockHeader* tail = block_at(h, tail_off);
        tail->size = remain;
        freelist_push(h, tail_off);
      }
      b->free = 0;
      footer_of(h, off)->size = b->size;
      return off;
    }
    link = &b->next_free;
  }
  return 0;
}

void free_block(Handle* h, uint64_t off) {
  Header* H = hdr(h);
  BlockHeader* b = block_at(h, off);
  // Coalesce with next neighbour.
  uint64_t next_off = off + b->size;
  if (next_off < H->capacity) {
    BlockHeader* nb = block_at(h, next_off);
    if (nb->free) {
      freelist_remove(h, next_off);
      b->size += nb->size;
    }
  }
  // Coalesce with previous neighbour via its footer.
  if (off > H->data_begin) {
    BlockFooter* pf =
        reinterpret_cast<BlockFooter*>(h->base + off - sizeof(BlockFooter));
    uint64_t prev_off = off - pf->size;
    BlockHeader* pb = block_at(h, prev_off);
    if (pb->free) {
      freelist_remove(h, prev_off);
      pb->size += b->size;
      off = prev_off;
      b = pb;
    }
  }
  freelist_push(h, off);
}

// Complete a deferred delete whose last pin just vanished (the reader
// died instead of releasing): kPendingDelete + refcount 0 frees now.
void finish_pending_delete(Handle* h, Slot* s) {
  Header* H = hdr(h);
  if (s->state != kPendingDelete || s->refcount != 0) return;
  H->used_bytes -= s->size;
  H->num_objects--;
  uint64_t block_off = s->offset - sizeof(BlockHeader);
  s->state = kTombstone;
  free_block(h, block_off);
}

// Evict the least-recently-touched zero-refcount object (plasma
// `eviction_policy.cc` analog, LRU flavour). Caller retries its allocation
// after each eviction; coalescing in free_block grows contiguous space.
// Pinned slots (live zero-copy mappings) are never victims; dead readers'
// pins are reclaimed first so crashes can't wedge eviction.
int evict_lru(Handle* h) {
  Header* H = hdr(h);
  // Orphaned kCreating blocks (creator died mid-write) are reclaimed first:
  // nothing can ever seal them, so they are pure leaks otherwise. The same
  // pass drops pins held by dead processes.
  for (uint32_t i = 0; i < kTableSlots; i++) {
    Slot* s = &H->table[i];
    if (slot_is_orphan(s)) {
      uint64_t block_off = s->offset - sizeof(BlockHeader);
      s->state = kTombstone;  // kCreating was never counted in used_bytes
      free_block(h, block_off);
      return 0;
    }
    if ((s->state == kUsed || s->state == kPendingDelete) &&
        s->refcount > 0) {
      reclaim_dead_pins(s);
      finish_pending_delete(h, s);
      if (s->state == kTombstone) return 0;  // deferred delete completed
    }
  }
  Slot* victim = nullptr;
  for (uint32_t i = 0; i < kTableSlots; i++) {
    Slot* s = &H->table[i];
    if (s->state == kUsed && s->refcount == 0 &&
        (!victim || s->lru < victim->lru))
      victim = s;
  }
  if (!victim) return -1;
  uint64_t block_off = victim->offset - sizeof(BlockHeader);
  H->used_bytes -= victim->size;
  H->num_objects--;
  victim->state = kTombstone;
  free_block(h, block_off);
  return 0;
}

}  // namespace

extern "C" {

// Error codes.
enum {
  OS_OK = 0,
  OS_ERR_EXISTS = -1,
  OS_ERR_NOTFOUND = -2,
  OS_ERR_FULL = -3,
  OS_ERR_SYS = -4,
  OS_ERR_TOOBIG = -5,
  OS_ERR_PINNED = -6,
};

void* objstore_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // fresh segment
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  // The header (index table) needs ~sizeof(Header); guarantee headroom so a
  // tiny capacity can't write past the mapping or underflow the first block.
  uint64_t min_cap = align_up(sizeof(Header), 4096) + (1ULL << 20);
  if (capacity < min_cap) capacity = min_cap;
  capacity = align_up(capacity, 4096);
  if (ftruncate(fd, (off_t)capacity) != 0) { close(fd); shm_unlink(name); return nullptr; }
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) { shm_unlink(name); return nullptr; }

  Handle* h = new Handle();
  h->base = static_cast<uint8_t*>(base);
  h->capacity = capacity;
  strncpy(h->name, name, sizeof(h->name) - 1);
  h->owner = 1;

  Header* H = hdr(h);
  memset(H, 0, sizeof(Header));
  H->magic = kMagic;
  H->version = kVersion;
  H->capacity = capacity;
  H->data_begin = align_up(sizeof(Header), kAlign);
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&H->lock, &attr);
  pthread_mutexattr_destroy(&attr);

  BlockHeader* first = block_at(h, H->data_begin);
  first->size = capacity - H->data_begin;
  freelist_push(h, H->data_begin);
  return h;
}

void* objstore_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                    MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Header* H = static_cast<Header*>(base);
  if (H->magic != kMagic || H->version != kVersion) {
    munmap(base, (size_t)st.st_size);
    return nullptr;
  }
  Handle* h = new Handle();
  h->base = static_cast<uint8_t*>(base);
  h->capacity = (uint64_t)st.st_size;
  strncpy(h->name, name, sizeof(h->name) - 1);
  h->owner = 0;
  return h;
}

int objstore_put(void* vh, const uint8_t* id, const uint8_t* data,
                 uint64_t size) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  uint64_t need = align_up(sizeof(BlockHeader) + size + sizeof(BlockFooter),
                           kAlign);
  if (need > h->capacity - H->data_begin) return OS_ERR_TOOBIG;
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* existing = find_slot(h, id, 0);
  if (existing) { unlock(H); return OS_ERR_EXISTS; }  // objects are immutable
  uint64_t off = alloc_block(h, need);
  while (!off) {
    if (evict_lru(h) != 0) { unlock(H); return OS_ERR_FULL; }
    off = alloc_block(h, need);
  }
  uint64_t payload = off + sizeof(BlockHeader);
  memcpy(h->base + payload, data, size);
  Slot* s = find_slot(h, id, 1);
  if (!s) { free_block(h, off); unlock(H); return OS_ERR_FULL; }
  memcpy(s->id, id, kIdLen);
  s->state = kUsed;
  s->refcount = 0;
  memset(s->pin_pid, 0, sizeof(s->pin_pid));
  memset(s->pin_count, 0, sizeof(s->pin_count));
  s->anon_pins = 0;
  s->offset = payload;
  s->size = size;
  s->lru = ++H->lru_tick;
  H->used_bytes += size;
  H->num_objects++;
  unlock(H);
  return OS_OK;
}

// Returns a pointer into the shared mapping (zero-copy) and bumps refcount;
// pair with objstore_release. Pointer stays valid until refcount drops to 0
// and the object is evicted/deleted. The refcount IS the pin: while held,
// the object is skipped by eviction and refused by delete_if_unpinned, and
// the caller's pid is recorded so a crashed reader's pin is reclaimable.
int objstore_get(void* vh, const uint8_t* id, const uint8_t** out_ptr,
                 uint64_t* out_size) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* s = find_slot(h, id, 0);
  if (!s || s->state != kUsed) { unlock(H); return OS_ERR_NOTFOUND; }
  s->refcount++;
  record_pin(s, (int64_t)g_pid);
  s->lru = ++H->lru_tick;
  *out_ptr = h->base + s->offset;
  *out_size = s->size;
  unlock(H);
  return OS_OK;
}

// Current refcount (pin count) of a sealed object; OS_ERR_NOTFOUND when
// absent. Reclaims dead-process pins first so the answer reflects LIVE
// consumers only (the spill path's pinned-victim check reads this).
int objstore_refcount(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* s = find_slot(h, id, 0);
  if (!s || (s->state != kUsed && s->state != kPendingDelete)) {
    unlock(H);
    return OS_ERR_NOTFOUND;
  }
  reclaim_dead_pins(s);
  finish_pending_delete(h, s);
  int r = s->state == kTombstone ? OS_ERR_NOTFOUND : (int)s->refcount;
  unlock(H);
  return r;
}

// Two-phase write (plasma Create/Seal): reserve space, let the caller write
// the payload directly into the mapping (zero intermediate copies), then
// seal. Unsealed objects are invisible to get() and not evictable.
int objstore_reserve(void* vh, const uint8_t* id, uint64_t size,
                     uint8_t** out_ptr) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  uint64_t need = align_up(sizeof(BlockHeader) + size + sizeof(BlockFooter),
                           kAlign);
  if (need > h->capacity - H->data_begin) return OS_ERR_TOOBIG;
  if (lock(H) != 0) return OS_ERR_SYS;
  if (find_slot(h, id, 0)) { unlock(H); return OS_ERR_EXISTS; }
  uint64_t off = alloc_block(h, need);
  while (!off) {
    if (evict_lru(h) != 0) { unlock(H); return OS_ERR_FULL; }
    off = alloc_block(h, need);
  }
  Slot* s = find_slot(h, id, 1);
  if (!s) { free_block(h, off); unlock(H); return OS_ERR_FULL; }
  memcpy(s->id, id, kIdLen);
  s->state = kCreating;
  s->refcount = 0;
  memset(s->pin_pid, 0, sizeof(s->pin_pid));
  memset(s->pin_count, 0, sizeof(s->pin_count));
  s->anon_pins = 0;
  s->offset = off + sizeof(BlockHeader);
  s->size = size;
  s->lru = ++H->lru_tick;
  s->creator_pid = (int64_t)getpid();
  *out_ptr = h->base + s->offset;
  unlock(H);
  return OS_OK;
}

// 1 = sealed, 0 = mid-write (kCreating), OS_ERR_NOTFOUND = absent.
int objstore_is_sealed(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* s = find_slot(h, id, 0);
  // kPendingDelete reads as sealed: the write DID complete (then the
  // object was deleted under readers) — an idempotent duplicate writer
  // must treat it as "earlier attempt finished", not wait for a seal
  int r = !s ? OS_ERR_NOTFOUND
             : ((s->state == kUsed || s->state == kPendingDelete) ? 1 : 0);
  unlock(H);
  return r;
}

// Reclaim a kCreating slot whose creator is dead; EXISTS if still live.
int objstore_reclaim_orphan(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* s = find_slot(h, id, 0);
  if (!s || s->state != kCreating) { unlock(H); return OS_ERR_NOTFOUND; }
  if (!slot_is_orphan(s)) { unlock(H); return OS_ERR_EXISTS; }
  uint64_t block_off = s->offset - sizeof(BlockHeader);
  s->state = kTombstone;
  free_block(h, block_off);
  unlock(H);
  return OS_OK;
}

int objstore_seal(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* s = find_slot(h, id, 0);
  if (!s || s->state != kCreating) { unlock(H); return OS_ERR_NOTFOUND; }
  s->state = kUsed;
  s->lru = ++H->lru_tick;
  H->used_bytes += s->size;
  H->num_objects++;
  unlock(H);
  return OS_OK;
}

int objstore_abort(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* s = find_slot(h, id, 0);
  if (!s || s->state != kCreating) { unlock(H); return OS_ERR_NOTFOUND; }
  uint64_t block_off = s->offset - sizeof(BlockHeader);
  s->state = kTombstone;
  free_block(h, block_off);
  unlock(H);
  return OS_OK;
}

int objstore_release(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* s = find_slot(h, id, 0);
  if (!s) { unlock(H); return OS_ERR_NOTFOUND; }
  if (s->refcount > 0) {
    s->refcount--;
    drop_pin(s, (int64_t)g_pid);
  }
  if (s->state == kPendingDelete && s->refcount == 0) {
    // last reader gone: perform the deferred delete (plasma semantics —
    // the get() contract promises the zero-copy pointer stays valid
    // until refcount hits 0, so delete-under-readers only marks)
    H->used_bytes -= s->size;
    H->num_objects--;
    uint64_t block_off = s->offset - sizeof(BlockHeader);
    s->state = kTombstone;
    free_block(h, block_off);
  }
  unlock(H);
  return OS_OK;
}

// Delete ONLY when no live consumer pins the object: the eviction-under-
// pressure path (spill, chaos evict). Unlike objstore_delete it never
// defers — a pinned object is simply NOT a victim (OS_ERR_PINNED), so an
// in-place mapping can never observe its pages freed or its id vanish
// into a deferred-delete state that blocks a later re-put. Dead readers'
// pins are reclaimed first.
int objstore_delete_if_unpinned(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* s = find_slot(h, id, 0);
  if (!s || s->state == kCreating) { unlock(H); return OS_ERR_NOTFOUND; }
  reclaim_dead_pins(s);
  finish_pending_delete(h, s);
  if (s->state == kTombstone) { unlock(H); return OS_OK; }
  if (s->refcount > 0) { unlock(H); return OS_ERR_PINNED; }
  if (s->state == kUsed) {
    H->used_bytes -= s->size;
    H->num_objects--;
  }
  uint64_t block_off = s->offset - sizeof(BlockHeader);
  s->state = kTombstone;
  free_block(h, block_off);
  unlock(H);
  return OS_OK;
}

int objstore_contains(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return 0;
  Slot* s = find_slot(h, id, 0);
  int found = s != nullptr && s->state == kUsed;  // unsealed ⇒ not readable
  unlock(H);
  return found;
}

int objstore_delete(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  if (lock(H) != 0) return OS_ERR_SYS;
  Slot* s = find_slot(h, id, 0);
  if (!s) { unlock(H); return OS_ERR_NOTFOUND; }
  if (s->state == kUsed && s->refcount > 0) {
    // readers hold zero-copy views: defer the free to the last release
    s->state = kPendingDelete;
    unlock(H);
    return OS_OK;
  }
  if (s->state == kPendingDelete) {  // double delete: idempotent
    unlock(H);
    return OS_OK;
  }
  if (s->state == kUsed) {  // kCreating was never counted
    H->used_bytes -= s->size;
    H->num_objects--;
  }
  uint64_t block_off = s->offset - sizeof(BlockHeader);
  s->state = kTombstone;
  free_block(h, block_off);
  unlock(H);
  return OS_OK;
}

void objstore_stats(void* vh, uint64_t* used_bytes, uint64_t* num_objects,
                    uint64_t* capacity) {
  Handle* h = static_cast<Handle*>(vh);
  Header* H = hdr(h);
  lock(H);
  *used_bytes = H->used_bytes;
  *num_objects = H->num_objects;
  *capacity = H->capacity;
  unlock(H);
}

void objstore_close(void* vh) {
  Handle* h = static_cast<Handle*>(vh);
  if (h->owner) shm_unlink(h->name);
  munmap(h->base, h->capacity);
  delete h;
}

// Close WITHOUT unmapping: used when live in-place mappings (consumer
// views into the segment) still exist at close time — the pages must
// survive until the process exits or the last view dies. The name is
// still unlinked (owner), so the segment is unreachable for attachers
// and the kernel reclaims the memory when the mapping finally goes.
void objstore_close_keepmap(void* vh) {
  Handle* h = static_cast<Handle*>(vh);
  if (h->owner) shm_unlink(h->name);
  delete h;
}

}  // extern "C"
