// objstore.cc — shared-memory immutable object store (plasma-equivalent).
//
// TPU-native re-design of the reference's per-node object store
// (reference: src/ray/object_manager/plasma/store.h:55, object_store.cc,
// eviction_policy.h). Unlike plasma's socket-server architecture (clients talk
// to the store over a unix socket with fd-passing, plasma/client.h), this store
// is a *single file-backed mmap region shared by all processes on the node*,
// with a process-shared robust mutex in the header. Rationale: on a
// TPU host the heavy data plane (gradients/activations) lives inside XLA
// programs on-device; the host object store serves control payloads, dataset
// blocks and checkpoints, so a lock-based shm design is simpler and has lower
// latency than a socket protocol (no round trip, no fd passing).
//
// Blocking get does NOT use a pthread condvar: process-shared condvars are
// not robust — a client SIGKILLed inside pthread_cond_(timed)wait leaves its
// group reference behind, and the next pthread_cond_broadcast blocks forever
// in the group-switch quiesce (observed as a cluster-wide wedge with the
// broadcaster holding the store mutex). Instead waiters block on a raw
// futex over a seal-sequence counter: seal/delete bump the counter and
// FUTEX_WAKE; the kernel keeps no per-waiter state, so a killed waiter
// simply disappears.
//
// Crash robustness (workers are SIGKILLed by design — ray.kill parity):
//   - robust mutex: owner death => EOWNERDEAD recovery on next lock
//   - futex wait:   waiter death => nothing to clean up
//   - pins:         per-pid pin slots; os_reclaim_pid(pid) drops pins and
//                   aborts unsealed creates of a dead worker
//   - free list:    walks are cycle-bounded so a torn list can never spin
//                   forever while holding the mutex
//
// Features (parity targets):
//   - create/seal/get/contains/delete/acquire/release  (plasma client.h ops)
//   - blocking Get with timeout via futex               (plasma store.h:55 wait)
//   - LRU eviction of sealed, unreferenced objects      (eviction_policy.h)
//   - first-fit free-list allocator with coalescing     (dlmalloc.cc stand-in)
//   - robust-mutex crash recovery (owner dies holding lock)
//
// Exposed as a C ABI consumed from Python via ctypes (no pybind11 in image).

#include <atomic>
#include <cerrno>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <linux/futex.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x7452617954505531ULL;  // "tRayTPU1"
constexpr uint32_t kIdSize = 16;

enum ObjState : int32_t {
  kFree = 0,      // entry slot never used (probe chains END here)
  kCreated = 1,   // allocated, writer filling
  kSealed = 2,    // immutable, readable
  kTomb = 3,      // deleted; keeps probe chains intact (swept by rehash)
};

// Per-pid pin bookkeeping so pins leaked by a SIGKILLed process can be
// reclaimed (os_reclaim_pid). Pins from more than kPinSlots distinct pids
// overflow into an aggregate count that cannot be reclaimed (rare; pins are
// short-lived).
constexpr int kPinSlots = 4;
struct PinSlot {
  int32_t pid;
  int32_t count;
};

struct ObjEntry {
  uint8_t id[kIdSize];
  uint64_t offset;   // payload offset from region base
  uint64_t size;
  int32_t state;
  int32_t refcnt;    // pins against eviction (incl. creator pin pre-seal)
  uint64_t lru_tick;
  int32_t creator_pid;   // pid that os_create'd (abortable while kCreated)
  int32_t overflow_pins;
  PinSlot pins[kPinSlots];
  int32_t delete_pending;  // deleted while pinned: freed at the last unpin
  int32_t pad0;
};

// Free block header, stored inside the heap region itself.
struct FreeBlock {
  uint64_t size;        // total block size incl. nothing (just span)
  uint64_t next;        // offset of next free block, 0 = end
};

struct Header {
  uint64_t magic;
  uint64_t capacity;        // total file size
  uint64_t heap_off;        // where the allocatable heap begins
  uint64_t heap_size;
  uint32_t max_entries;
  uint32_t pad0;
  pthread_mutex_t mutex;
  uint32_t seal_seq;        // bumped on every seal/delete; futex wait target
  uint32_t n_waiters;       // processes blocked in futex_wait on seal_seq
  uint64_t lru_counter;
  uint64_t free_head;       // offset of first free block (0 = none)
  uint64_t bytes_in_use;
  uint64_t num_objects;
  uint64_t evictions;       // stat: count of evicted objects
  uint64_t num_tombs;       // tombstoned entry slots awaiting rehash
  // ObjEntry table follows, then heap.
};

struct Handle {
  int fd;
  uint8_t* base;
  Header* hdr;
  ObjEntry* entries;
  // getpid() cached at create/attach: glibc >= 2.25 makes every getpid() a
  // real syscall, and pin bookkeeping calls it on the get/release hot path
  // (measured ~13us per syscall on virtualized hosts — more than the whole
  // rest of os_get). One Handle per process: attach after fork, never share
  // a handle across fork, or pin accounting keys on the wrong pid.
  int32_t pid;
};

inline ObjEntry* entry_table(Header* h) {
  return reinterpret_cast<ObjEntry*>(reinterpret_cast<uint8_t*>(h) + sizeof(Header));
}

inline uint64_t align8(uint64_t v) { return (v + 7) & ~7ULL; }

void lock(Handle* h) {
  int rc = pthread_mutex_lock(&h->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // A process died holding the lock; state may be torn but entries are
    // updated with care (state flag written last on create), so recover.
    pthread_mutex_consistent(&h->hdr->mutex);
  }
}

void unlock(Handle* h) { pthread_mutex_unlock(&h->hdr->mutex); }

// Raw futex wait/wake on the seal-sequence word (process-shared: no
// FUTEX_PRIVATE flag). FUTEX_WAIT_BITSET takes an *absolute* CLOCK_MONOTONIC
// deadline, matching the deadline os_get already computes.
int futex_wait_abs(uint32_t* addr, uint32_t expected,
                   const struct timespec* deadline) {
  return (int)syscall(SYS_futex, addr, FUTEX_WAIT_BITSET, expected, deadline,
                      nullptr, FUTEX_BITSET_MATCH_ANY);
}

// Absolute CLOCK_MONOTONIC deadline `timeout_ms` from now (the one
// deadline computation every blocking wait entry point shares).
struct timespec abs_deadline(int64_t timeout_ms) {
  struct timespec d;
  clock_gettime(CLOCK_MONOTONIC, &d);
  d.tv_sec += timeout_ms / 1000;
  d.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (d.tv_nsec >= 1000000000L) { d.tv_sec++; d.tv_nsec -= 1000000000L; }
  return d;
}

void futex_wake_all(uint32_t* addr) {
  syscall(SYS_futex, addr, FUTEX_WAKE, INT_MAX, nullptr, nullptr, 0);
}

// Seal/delete notification. The seq bump is unconditional (waiters key
// their re-check on it), but the FUTEX_WAKE syscall is elided when no one
// is registered in n_waiters — on hosts with slow syscalls the wake was
// costing every uncontended seal ~10-20us. Ordering: a waiter increments
// n_waiters (seq_cst) BEFORE loading seal_seq for its futex_wait, so any
// seal that the waiter's load missed must observe n_waiters > 0 and wake.
// A waiter SIGKILLed inside futex_wait leaks its count, which only makes
// wakes unconditional again (never lost) — saturating, self-limiting.
void bump_seal_seq(Handle* h) {
  __atomic_fetch_add(&h->hdr->seal_seq, 1, __ATOMIC_SEQ_CST);
  if (__atomic_load_n(&h->hdr->n_waiters, __ATOMIC_SEQ_CST) != 0)
    futex_wake_all(&h->hdr->seal_seq);
}

// Register/deregister around a futex_wait on seal_seq.
inline void waiter_enter(Handle* h) {
  __atomic_fetch_add(&h->hdr->n_waiters, 1, __ATOMIC_SEQ_CST);
}

inline void waiter_exit(Handle* h) {
  // saturating: never go below zero even if a leaked count was clamped
  uint32_t n = __atomic_load_n(&h->hdr->n_waiters, __ATOMIC_SEQ_CST);
  while (n != 0 && !__atomic_compare_exchange_n(
             &h->hdr->n_waiters, &n, n - 1, false, __ATOMIC_SEQ_CST,
             __ATOMIC_SEQ_CST)) {
  }
}

// Per-pid pin bookkeeping. Caller holds the store mutex.
void pin(ObjEntry* e, int32_t pid) {
  e->refcnt++;
  PinSlot* empty = nullptr;
  for (int i = 0; i < kPinSlots; i++) {
    if (e->pins[i].pid == pid) { e->pins[i].count++; return; }
    if (!empty && e->pins[i].pid == 0) empty = &e->pins[i];
  }
  if (empty) { empty->pid = pid; empty->count = 1; return; }
  e->overflow_pins++;
}

void unpin(ObjEntry* e, int32_t pid) {
  if (e->refcnt > 0) e->refcnt--;
  for (int i = 0; i < kPinSlots; i++) {
    if (e->pins[i].pid == pid) {
      if (--e->pins[i].count <= 0) { e->pins[i].pid = 0; e->pins[i].count = 0; }
      return;
    }
  }
  if (e->overflow_pins > 0) e->overflow_pins--;
}

ObjEntry* find(Handle* h, const uint8_t* id) {
  // Linear-probed open addressing over the entry table, hashed by id
  // prefix. Deleted slots become kTomb (NOT kFree) so probe chains stay
  // intact and an absent-key lookup stops at the first never-used slot
  // instead of scanning all max_entries — absent lookups are the common
  // case (every os_create probes its fresh random id) and a full 64k-slot
  // scan cost ~0.4 ms per create before tombstones.
  Header* hdr = h->hdr;
  uint64_t hash;
  memcpy(&hash, id, 8);
  uint32_t n = hdr->max_entries;
  for (uint32_t i = 0; i < n; i++) {
    ObjEntry* e = &h->entries[(hash + i) % n];
    if (e->state == kFree) return nullptr;
    if (e->state != kTomb && memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return nullptr;
}

ObjEntry* find_slot(Handle* h, const uint8_t* id) {
  // Insertion slot: first tombstone on the probe path if any (reuse keeps
  // chains short), else the terminating free slot; nullptr if the id
  // already exists or the table is full of live entries.
  Header* hdr = h->hdr;
  uint64_t hash;
  memcpy(&hash, id, 8);
  uint32_t n = hdr->max_entries;
  ObjEntry* tomb = nullptr;
  for (uint32_t i = 0; i < n; i++) {
    ObjEntry* e = &h->entries[(hash + i) % n];
    if (e->state == kFree) return tomb ? tomb : e;
    if (e->state == kTomb) {
      if (!tomb) tomb = e;
      continue;
    }
    if (memcmp(e->id, id, kIdSize) == 0) return nullptr;  // exists
  }
  return tomb;  // table has no never-used slots left
}

// Tombstone a live entry slot (caller already dealloc'd its payload).
inline void tombstone(Header* hdr, ObjEntry* e) {
  e->state = kTomb;
  hdr->num_objects--;
  hdr->num_tombs++;
}

// Sweep tombstones by rebuilding the table once they pile up (they
// lengthen every probe chain). O(max_entries) but amortized across the
// >= n/4 deletions that accumulated them. Caller holds the lock and must
// not use ObjEntry pointers obtained before the call.
void maybe_rehash(Handle* h) {
  Header* hdr = h->hdr;
  uint32_t n = hdr->max_entries;
  if (hdr->num_tombs < 64 || hdr->num_tombs < n / 4) return;
  ObjEntry* scratch =
      (ObjEntry*)malloc((size_t)hdr->num_objects * sizeof(ObjEntry));
  if (!scratch && hdr->num_objects > 0) return;  // slow beats failing
  uint64_t live = 0;
  for (uint32_t i = 0; i < n; i++) {
    ObjEntry* e = &h->entries[i];
    if (e->state == kCreated || e->state == kSealed) scratch[live++] = *e;
  }
  memset(h->entries, 0, (size_t)n * sizeof(ObjEntry));
  hdr->num_tombs = 0;
  for (uint64_t j = 0; j < live; j++) {
    ObjEntry* slot = find_slot(h, scratch[j].id);
    *slot = scratch[j];  // table was just cleared: slot is never null
  }
  free(scratch);
}

// First-fit allocation from the free list. Each allocated block carries an
// 8-byte span header (the actual block size, including absorbed remainders
// too small to split off) so dealloc always returns the exact span —
// otherwise absorbed tails would leak permanently. Returns the *payload*
// offset (block + 8) or 0 on failure.
// Upper bound on free-list length: every free block is bordered by
// allocated spans, so a healthy list never exceeds max_entries + 1 nodes.
// A torn list (process died mid-surgery under EOWNERDEAD) could contain a
// cycle; bounding the walk turns "deadlock holding the mutex" into a
// recoverable allocation failure.
inline uint64_t walk_limit(Header* hdr) {
  return (uint64_t)hdr->max_entries + 16;
}

uint64_t alloc(Handle* h, uint64_t size) {
  uint64_t want = align8(size) + 8;
  if (want < sizeof(FreeBlock)) want = sizeof(FreeBlock);
  Header* hdr = h->hdr;
  uint64_t prev = 0, cur = hdr->free_head;
  uint64_t steps = walk_limit(hdr);
  while (cur && steps--) {
    FreeBlock* fb = reinterpret_cast<FreeBlock*>(h->base + cur);
    if (fb->size >= want) {
      uint64_t span = want;
      uint64_t remain = fb->size - want;
      if (remain >= sizeof(FreeBlock) + 64) {
        // split: keep tail as free block
        uint64_t tail_off = cur + want;
        FreeBlock* tail = reinterpret_cast<FreeBlock*>(h->base + tail_off);
        tail->size = remain;
        tail->next = fb->next;
        if (prev) reinterpret_cast<FreeBlock*>(h->base + prev)->next = tail_off;
        else hdr->free_head = tail_off;
      } else {
        span = fb->size;  // absorb remainder
        if (prev) reinterpret_cast<FreeBlock*>(h->base + prev)->next = fb->next;
        else hdr->free_head = fb->next;
      }
      hdr->bytes_in_use += span;
      *reinterpret_cast<uint64_t*>(h->base + cur) = span;
      return cur + 8;
    }
    prev = cur;
    cur = fb->next;
  }
  return 0;
}

// Return an allocated block (by payload offset) to the free list, coalescing
// with neighbours (list kept sorted by offset so coalescing is O(1) at the
// insertion point).
void dealloc(Handle* h, uint64_t payload_off) {
  uint64_t off = payload_off - 8;
  uint64_t size = *reinterpret_cast<uint64_t*>(h->base + off);
  Header* hdr = h->hdr;
  uint64_t prev = 0, cur = hdr->free_head;
  uint64_t steps = walk_limit(hdr);
  while (cur && cur < off) {
    if (!steps--) return;  // torn/cyclic list: leak the block, don't spin
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(h->base + cur)->next;
  }
  if (cur == off) return;  // double-free guard: already on the free list
  hdr->bytes_in_use -= size;
  FreeBlock* nb = reinterpret_cast<FreeBlock*>(h->base + off);
  nb->size = size;
  nb->next = cur;
  if (prev) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(h->base + prev);
    pb->next = off;
    if (prev + pb->size == off) {  // coalesce with prev
      pb->size += nb->size;
      pb->next = nb->next;
      nb = pb;
      off = prev;
    }
  } else {
    hdr->free_head = off;
  }
  if (nb->next && off + nb->size == nb->next) {  // coalesce with next
    FreeBlock* xb = reinterpret_cast<FreeBlock*>(h->base + nb->next);
    nb->size += xb->size;
    nb->next = xb->next;
  }
}

// Evict sealed refcnt==0 objects in LRU order until `need` bytes could fit.
// Caller holds lock. Returns true if anything was evicted.
bool evict_lru(Handle* h, uint64_t need) {
  Header* hdr = h->hdr;
  bool any = false;
  while (true) {
    // Check if a block of `need` is plausible: conservative — try alloc.
    uint64_t off = alloc(h, need);
    if (off) { dealloc(h, off); return true; }
    // find LRU evictable
    ObjEntry* victim = nullptr;
    for (uint32_t i = 0; i < hdr->max_entries; i++) {
      ObjEntry* e = &h->entries[i];
      if (e->state == kSealed && e->refcnt == 0) {
        if (!victim || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (!victim) return any;
    dealloc(h, victim->offset);
    tombstone(hdr, victim);
    hdr->evictions++;
    any = true;
  }
}

}  // namespace

extern "C" {

// Create a new store region backing file at `path` with `capacity` bytes and
// room for `max_entries` objects. Returns handle or nullptr.
void* os_store_create(const char* path, uint64_t capacity, uint32_t max_entries) {
  // the metadata (header + entry table) must FIT with heap to spare —
  // otherwise the memsets below scribble past the mapping (segfault)
  uint64_t meta = align8(sizeof(Header))
      + align8((uint64_t)max_entries * sizeof(ObjEntry));
  if (capacity < meta + (64 << 10)) return nullptr;
  int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)capacity) != 0) { close(fd); return nullptr; }
  uint8_t* base = (uint8_t*)mmap(nullptr, capacity, PROT_READ | PROT_WRITE,
                                 MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  Header* hdr = reinterpret_cast<Header*>(base);
  memset(hdr, 0, sizeof(Header));
  hdr->capacity = capacity;
  hdr->max_entries = max_entries;
  uint64_t table_bytes = align8((uint64_t)max_entries * sizeof(ObjEntry));
  hdr->heap_off = align8(sizeof(Header) + table_bytes);
  hdr->heap_size = capacity - hdr->heap_off;
  memset(entry_table(hdr), 0, table_bytes);

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mutex, &ma);
  hdr->seal_seq = 0;

  // one big free block spanning the heap
  FreeBlock* fb = reinterpret_cast<FreeBlock*>(base + hdr->heap_off);
  fb->size = hdr->heap_size;
  fb->next = 0;
  hdr->free_head = hdr->heap_off;
  hdr->magic = kMagic;  // written last: attachers spin on this

  Handle* h = new Handle{fd, base, hdr, entry_table(hdr), (int32_t)getpid()};
  return h;
}

void* os_store_attach(const char* path) {
  int fd = open(path, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  uint8_t* base = (uint8_t*)mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE,
                                 MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  Header* hdr = reinterpret_cast<Header*>(base);
  if (hdr->magic != kMagic) { munmap(base, st.st_size); close(fd); return nullptr; }
  Handle* h = new Handle{fd, base, hdr, entry_table(hdr), (int32_t)getpid()};
  return h;
}

void os_store_close(void* hv) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  munmap(h->base, h->hdr->capacity);
  close(h->fd);
  delete h;
}

// Refresh the handle's cached pid after a fork: a child inheriting the
// parent's handle must pin under ITS pid, or os_reclaim_pid(parent) would
// strip pins the child still relies on (Python registers this via
// os.register_at_fork, object_store.py).
void os_store_refresh_pid(void* hv) {
  reinterpret_cast<Handle*>(hv)->pid = (int32_t)getpid();
}

// Allocate an object buffer. Returns payload offset (>0), 0 if out of memory
// after eviction, or UINT64_MAX if the id already exists.
uint64_t os_create(void* hv, const uint8_t* id, uint64_t size) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  lock(h);
  if (find(h, id)) { unlock(h); return UINT64_MAX; }
  uint64_t off = alloc(h, size);
  if (!off) {
    evict_lru(h, size);
    off = alloc(h, size);
  }
  if (!off) { unlock(h); return 0; }
  ObjEntry* e = find_slot(h, id);
  if (!e) { dealloc(h, off); unlock(h); return 0; }
  if (e->state == kTomb) h->hdr->num_tombs--;
  memcpy(e->id, id, kIdSize);
  e->offset = off;
  e->size = size;
  e->refcnt = 1;  // creator holds a pin until seal
  e->lru_tick = ++h->hdr->lru_counter;
  e->creator_pid = h->pid;
  e->overflow_pins = 0;
  memset(e->pins, 0, sizeof(e->pins));
  e->delete_pending = 0;
  e->state = kCreated;
  h->hdr->num_objects++;
  // churn workloads (eviction-heavy, no explicit deletes) accumulate
  // tombstones here; sweep before they degrade probes
  maybe_rehash(h);
  unlock(h);
  return off;
}

int os_seal(void* hv, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  lock(h);
  ObjEntry* e = find(h, id);
  if (!e || e->state != kCreated) { unlock(h); return -1; }
  e->state = kSealed;
  e->refcnt -= 1;  // drop creator pin
  e->creator_pid = 0;
  bump_seal_seq(h);
  unlock(h);
  return 0;
}

// Blocking get: waits up to timeout_ms for the object to be sealed.
// On success pins the object (caller must os_release) and fills offset/size.
// Returns 0 ok, -1 timeout, -2 would-block (timeout_ms == 0 and not present).
// Waiting is a raw futex on seal_seq — kill-safe (see file header), and the
// mutex is NEVER held while blocked.
int os_get(void* hv, const uint8_t* id, int64_t timeout_ms,
           uint64_t* offset, uint64_t* size) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  struct timespec deadline = abs_deadline(timeout_ms);
  lock(h);
  while (true) {
    ObjEntry* e = find(h, id);
    if (e && e->state == kSealed) {
      pin(e, h->pid);
      e->lru_tick = ++h->hdr->lru_counter;
      *offset = e->offset;
      *size = e->size;
      unlock(h);
      return 0;
    }
    if (timeout_ms == 0) { unlock(h); return -2; }
    waiter_enter(h);  // BEFORE the seq load — see bump_seal_seq
    uint32_t seq = __atomic_load_n(&h->hdr->seal_seq, __ATOMIC_SEQ_CST);
    unlock(h);
    int rc = futex_wait_abs(&h->hdr->seal_seq, seq, &deadline);
    waiter_exit(h);
    if (rc != 0 && errno == ETIMEDOUT) return -1;
    // 0 (woken), EAGAIN (seq already moved) or EINTR: re-check under lock.
    lock(h);
  }
}

// Stop-aware blocking get — the consumer half of a sealed ring channel
// (ray_tpu_torch/dag/channel.py). Like os_get, but a second `stop_id` aborts
// the wait the INSTANT it seals: one native call both waits for the
// message and watches teardown, so a channel read costs exactly what a
// plain blocking get does (the old transport burned an extra
// os_wait_sealed round-trip per message, measurable under cross-process
// mutex contention). Data wins over a concurrent stop — consumers drain
// what was produced, then observe the close.
// Returns 0 ok (object pinned; caller must os_release), -1 timeout,
// -2 would-block (timeout_ms == 0 and absent), -3 stop sealed and data
// absent.
int os_chan_get(void* hv, const uint8_t* id, const uint8_t* stop_id,
                int64_t timeout_ms, uint64_t* offset, uint64_t* size) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  struct timespec deadline = abs_deadline(timeout_ms);
  lock(h);
  while (true) {
    ObjEntry* e = find(h, id);
    if (e && e->state == kSealed) {
      pin(e, h->pid);
      e->lru_tick = ++h->hdr->lru_counter;
      *offset = e->offset;
      *size = e->size;
      unlock(h);
      return 0;
    }
    ObjEntry* s = find(h, stop_id);
    if (s && s->state == kSealed) { unlock(h); return -3; }
    if (timeout_ms == 0) { unlock(h); return -2; }
    waiter_enter(h);  // BEFORE the seq load — see bump_seal_seq
    uint32_t seq = __atomic_load_n(&h->hdr->seal_seq, __ATOMIC_SEQ_CST);
    unlock(h);
    int rc = futex_wait_abs(&h->hdr->seal_seq, seq, &deadline);
    waiter_exit(h);
    if (rc != 0 && errno == ETIMEDOUT) return -1;
    lock(h);
  }
}

// Multi-object wait: block until at least `min_count` of the `n` ids are
// sealed in the store, or the timeout expires. out[i] is set to 1 once
// id i has been OBSERVED sealed (sticky for the duration of the call —
// a concurrent evict after observation does not unset it; callers that
// then read the object re-enter through os_get and retry on a miss).
// Returns the number of set out[] flags. timeout_ms == 0 is a single
// non-blocking scan. This is the control plane's seal-notification
// primitive: one futex wait services whichever of N results seals first
// (worker-side bulk ray.get / ray.wait), replacing per-ref poll slices.
// Each wake rescans only the not-yet-observed ids, so a call over n ids
// costs O(n) probes per seal event while waiting — fine for the list
// sizes get()/wait() see; callers with huge lists should chunk.
int os_wait_sealed(void* hv, const uint8_t* ids, uint32_t n,
                   uint32_t min_count, int64_t timeout_ms, uint8_t* out) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  struct timespec deadline = abs_deadline(timeout_ms);
  if (min_count > n) min_count = n;
  memset(out, 0, n);
  uint32_t have = 0;
  lock(h);
  while (true) {
    for (uint32_t i = 0; i < n && have < n; i++) {
      if (out[i]) continue;
      ObjEntry* e = find(h, ids + (uint64_t)i * kIdSize);
      if (e && e->state == kSealed) { out[i] = 1; have++; }
    }
    if (have >= min_count || timeout_ms == 0) { unlock(h); return (int)have; }
    waiter_enter(h);
    uint32_t seq = __atomic_load_n(&h->hdr->seal_seq, __ATOMIC_SEQ_CST);
    unlock(h);
    int rc = futex_wait_abs(&h->hdr->seal_seq, seq, &deadline);
    waiter_exit(h);
    if (rc != 0 && errno == ETIMEDOUT) {
      // final rescan: a seal may have slipped between our last scan and
      // the wait (its wake then raced the timeout)
      lock(h);
      for (uint32_t i = 0; i < n; i++) {
        if (out[i]) continue;
        ObjEntry* e = find(h, ids + (uint64_t)i * kIdSize);
        if (e && e->state == kSealed) { out[i] = 1; have++; }
      }
      unlock(h);
      return (int)have;
    }
    lock(h);
  }
}

// Seqlock-style building blocks for chunked multi-waits from Python: read
// the seal sequence, scan in bounded chunks (each a short mutex hold),
// then block until the sequence moves. Any seal/delete wakes the waiter;
// the caller rescans. Lets a partial wait over a huge id list avoid one
// O(n) probe pass under the mutex per seal event.
uint32_t os_seal_seq(void* hv) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  return __atomic_load_n(&h->hdr->seal_seq, __ATOMIC_SEQ_CST);
}

// Block until seal_seq != seq or timeout. 0 = changed, -1 = timeout.
int os_wait_seq(void* hv, uint32_t seq, int64_t timeout_ms) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  struct timespec deadline = abs_deadline(timeout_ms);
  waiter_enter(h);
  while (__atomic_load_n(&h->hdr->seal_seq, __ATOMIC_SEQ_CST) == seq) {
    int rc = futex_wait_abs(&h->hdr->seal_seq, seq, &deadline);
    if (rc != 0 && errno == ETIMEDOUT) { waiter_exit(h); return -1; }
  }
  waiter_exit(h);
  return 0;
}

int os_contains(void* hv, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  lock(h);
  ObjEntry* e = find(h, id);
  int r = (e && e->state == kSealed) ? 1 : 0;
  unlock(h);
  return r;
}

void os_release(void* hv, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  lock(h);
  ObjEntry* e = find(h, id);
  if (e) {
    unpin(e, h->pid);
    if (e->refcnt == 0 && e->delete_pending) {
      // the last pin of an object deleted while pinned (a zero-copy view
      // outlived its channel slot): free it now, not at some eviction
      dealloc(h, e->offset);
      tombstone(h->hdr, e);
      maybe_rehash(h);
      bump_seal_seq(h);
    }
  }
  unlock(h);
}

// Drop all store state owned by a dead process: its unsealed creates are
// aborted and its leaked read pins removed, so objects become evictable
// again. Called by the head when it reaps a worker (reference analog:
// NodeManager worker-death cleanup, raylet/node_manager.h:124). Returns the
// number of entries touched.
int os_reclaim_pid(void* hv, int32_t pid) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  int touched = 0;
  lock(h);
  Header* hdr = h->hdr;
  for (uint32_t i = 0; i < hdr->max_entries; i++) {
    ObjEntry* e = &h->entries[i];
    if (e->state == kCreated && e->creator_pid == pid) {
      dealloc(h, e->offset);
      tombstone(hdr, e);
      touched++;
      continue;
    }
    if (e->state == kSealed) {
      for (int s = 0; s < kPinSlots; s++) {
        if (e->pins[s].pid == pid && e->pins[s].count > 0) {
          e->refcnt -= e->pins[s].count;
          if (e->refcnt < 0) e->refcnt = 0;
          e->pins[s].pid = 0;
          e->pins[s].count = 0;
          touched++;
        }
      }
      if (e->refcnt == 0 && e->delete_pending) {
        dealloc(h, e->offset);
        tombstone(hdr, e);
      }
    }
  }
  maybe_rehash(h);
  // a worker that died mid-create will never seal: wake blocked getters so
  // their timeouts can fire against a now-consistent table
  bump_seal_seq(h);
  unlock(h);
  return touched;
}

// Delete an object (abort an unsealed create or free a sealed object).
// Objects pinned by readers are deleted lazily: marked delete-pending and
// freed when the last pin is released (os_release, os_reclaim_pid), or
// evicted earlier under pressure once unpinned.
int os_delete(void* hv, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  lock(h);
  ObjEntry* e = find(h, id);
  if (!e) { unlock(h); return -1; }
  if (e->refcnt <= (e->state == kCreated ? 1 : 0)) {
    dealloc(h, e->offset);
    tombstone(h->hdr, e);
    maybe_rehash(h);
    // keep the documented contract: every removal wakes waiters so a
    // delete-then-recreate (error overwrite) never strands a blocked get
    bump_seal_seq(h);
  } else {
    // readers still hold it: free it at their last release
    e->lru_tick = 0;
    e->state = kSealed;
    e->delete_pending = 1;
  }
  unlock(h);
  return 0;
}

// Fault in + write-warm the heap with a userspace memset. Call once after
// create, BEFORE any allocation (it scribbles zeros over free heap space —
// only the initial whole-heap FreeBlock may be live, and its header is
// skipped). A plain memset is used instead of MADV_POPULATE_WRITE because
// both pay the same page-zeroing cost on bare metal, but on virtualized
// hosts populate leaves pages in a state where the first real store still
// faults host-side (~3x slower copies measured) while a memset does not.
void os_prefault(void* hv) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  uint8_t* heap = h->base + h->hdr->heap_off;
  uint64_t skip = sizeof(FreeBlock);
  if (h->hdr->heap_size > skip)
    memset(heap + skip, 0, h->hdr->heap_size - skip);
}

uint64_t os_capacity(void* hv) { return reinterpret_cast<Handle*>(hv)->hdr->heap_size; }
uint64_t os_bytes_in_use(void* hv) { return reinterpret_cast<Handle*>(hv)->hdr->bytes_in_use; }
uint64_t os_num_objects(void* hv) { return reinterpret_cast<Handle*>(hv)->hdr->num_objects; }
uint64_t os_evictions(void* hv) { return reinterpret_cast<Handle*>(hv)->hdr->evictions; }

}  // extern "C"
