// Fused DMFB environment step for NVIDIA Hopper (sm_90a): the wide kernel,
// for every configuration that the tile kernel (dmfb_step.cu) does not take:
// more than 16 droplets, or a board whose one chip does not fit in a
// block's shared memory.
//
// Replaces, for those configurations, the Pallas TPU kernel
// `_make_kernel(params).kernel` in marl_dmfb_tpu/ops/dmfb_step_pallas.py:44-219
// (called through `pallas_step_batch`).  It computes what `envs/dmfb.py`
// step_core (:530-600) and the v0 observe (:646-713) compute: the
// sequential health-gated droplet moves, the reward table, the cur-cur and
// past-cur constraint counts, the all-done bonus, electrode wear, episode
// bookkeeping and, with `observe`, the 3-layer int8 field-of-view
// observation with the zoomed goal direction.  Without `observe` it is the
// transition alone (the DMFB v0.1 path, whose observation the caller takes).
// JAX's int8 ids: a cell of layers 0 and 1 holds max(0, max over the
// droplets mapped there of int8(j + 1)), so ids 128-255 show as 0 and ids
// from 256 wrap.
//
// Bound on the H100: bytes.  A chip moves its usage board twice (read and
// written whole), one 32-byte sector of health and of the block mask under
// each droplet, the block mask's fov corner rows, and N rows of
// 3*fov*fov + 2 observation bytes (`ops/dmfb_step.py` `min_bytes`).
//
// Two layouts, chosen by the wrapper from the shape (`wide_group_chips`):
//
// Group layout, wherever a block that holds one chip leaves room for a
// second block on the SM (boards up to 97x97 at 4 droplets, fov 9; every
// board a user runs with more than 16 droplets).  A persistent block of 128
// threads steps groups of C consecutive chips (a (chip, droplet) pair a
// thread, at most 32 chips, two blocks an SM), so that each per-chip array
// of a group is one contiguous span in device memory.  On small boards the
// step is a few chains of dependent loads per chip, so the design removes
// latency from the path of each group:
//  - Inputs staged ahead: a group's pos, goal, dist, actions, draws,
//    counters and block mask arrive by one `cp.async.bulk` each into one of
//    two buffers, completing on the buffer's mbarrier; its usage board by
//    one more on a second mbarrier, since the board leaves the buffer only
//    by the bulk store at the end of its group.  A span arrives as the
//    16-byte words that cover it in device memory (a word that holds one of
//    its bytes lies in the same page), so every span goes by bulk copy
//    whatever its size and offset; it starts at its address's offset mod 16
//    in the buffer.  The health under the droplets, a gather, comes a group
//    ahead by 4-byte `cp.async` into the work area.
//  - A: every thread takes (chip, droplet) pairs: the candidate cell (back
//    to its own cell on a block), the draw, the droplet added to two maps
//    of occupancy (past and new cells, padded by a cell on each side) by
//    shared atomics, and what stages B and C need of the buffer, so that
//    the buffer is free after A.
//  - B: one lane of warp 0 per chip runs the order-dependent move chain:
//    droplet i sees droplets 0..i-1 at their new cells.  The next droplet's
//    map indices are read ahead and the stores are predicated, so only the
//    new map's lookups and updates chain.  Meanwhile warps 1-3 fetch the
//    next group's health, take the block mask's corner [0, fov)^2 as a bit
//    string (32 bits a ballot), give this buffer the group after next
//    (warp 2), and, once the last group's bulk stores have read their
//    spans, request the next group's usage board and zero the rows.
//  - C: every thread takes pairs again: the constraint counts are three
//    3x3 sums of the maps (sq-dist < 4 is |dx| <= 1 and |dy| <= 1: cur-cur,
//    past-cur both ways, less the droplet's own pairs).  With `observe`,
//    one loop over the chip's droplets marks those in the observer's FOV
//    (32 bits of marks at a time), layers 0 and 1 are painted from the
//    marks (each cell raised to the larger int8 id: a max, so any order),
//    layer 2 is the corner's bits OR the observer's walls, written in
//    4-byte words, and the direction is zoomed.  The per-droplet outputs go
//    to device memory, a pair a thread, coalesced; the wear lands on the
//    staged usage board (all of a cell's actuations added at once by the
//    first droplet there); per-chip sums by shared atomics (integers).
//  - D: warp 1 sends the usage board and the rows by bulk stores (the rows
//    staged at their offset mod 16 in device memory, so that all but their
//    first and last few bytes go by one store); rewards with the bonus; one
//    lane a chip sums the team reward in droplet order; the maps cleared
//    where the group wrote them.
//  Four barriers a group.
//
// Chip layout, for boards whose usage board is the cost (98x98 and above
// at 4 droplets, fov 9) and for workspaces beyond shared memory: one block
// of 128 threads per chip, grid-striding over the batch.  Per-droplet
// state, a per-chip occupancy count map of W*L bytes and the observation
// rows being built live in a workspace: dynamic shared memory sized from N,
// the board and the fov at launch, or, where that does not fit, a
// per-block slice of a global scratch buffer that the wrapper allocates
// (one slice a block of the grid, which it reuses chip after chip).
//  1. Every thread takes droplets: it stages their cells, goals and
//     distances, the candidate cell, whether the move succeeds and the
//     usage of both cells.  It zeroes the count map at the two cells, the
//     only ones the moves read.  Meanwhile the block copies the usage
//     board to the output (16-byte words where aligned) and stages the
//     block mask's corner [0, fov)^2 for the observations.
//  2. One thread runs the move chain over the count map.
//  3. Every thread takes droplets again: constraint counts, rewards, dones,
//     the per-droplet outputs and the wear.  Block-wide AND and a shared
//     integer sum give all-done, terminated and the constraint count.
//  4. The bonus is added; the team reward is the mean of the rewards in a
//     fixed order (per-thread strided sums, a warp shuffle tree, the warps
//     in order).
//  5. Observations (`observe`), up to 8 KB of rows at a time, built in the
//     workspace at the alignment (mod 16) of their place in device memory,
//     so that they leave in 16-byte words but for the ends: zeroed in
//     16-byte words; layer 2 a FOV row a thread; then one thread per
//     observer writes the direction and scatters layers 0 and 1.
//
// Interface: plain C, no PyTorch headers (built with nvcc, loaded with
// ctypes).  The launch function returns a cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Threads of a block in either layout.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Chips of a group at most: a lane of warp 0 each for the move chain.
constexpr int kMaxGroup = 32;
// The warps of a group block that issue its bulk stores and the usage
// board's loads (warp 1), and the loads of its other inputs (warp 2); warp
// 0 runs the move chains.
constexpr int kStoreWarp = 1;
constexpr int kLoadWarp = 2;
// A block's largest dynamic shared memory on sm_90 (232,448 bytes).
constexpr int kSmemLimit = 227 * 1024;
// Dynamic shared memory a chip-layout block may take for its workspace:
// kSmemLimit less 1 KB for the kernel's static shared memory.  A workspace
// above it goes to the global scratch buffer.
constexpr int kWideSmemLimit = 227 * 1024 - 1024;
// Observation rows staged in a chip-layout workspace at a time: as many
// whole rows as fit in this many bytes, at least one.
constexpr int kRowBytes = 8192;

struct WideArgs {
  // inputs
  const int32_t* pos;        // (B, N, 2)
  const int32_t* dist;       // (B, N)
  const int32_t* goal;       // (B, N, 2)
  const float* health;       // (B, W, L)
  const float* usage;        // (B, W, L)
  const uint8_t* block;      // (B, W, L) bool
  const int32_t* actions;    // (B, N)
  const float* uniforms;     // (B, N)
  const int32_t* step_count; // (B,)
  const int32_t* cum_constraints;  // (B,)
  // outputs
  int32_t* pos_o;
  int32_t* dist_o;
  float* usage_o;
  int32_t* step_o;
  int32_t* cumc_o;
  float* rew_o;              // (B, N)
  int8_t* obs_o;             // (B, N, 3*fov*fov + 2); unused without observe
  uint8_t* dones_o;          // (B, N) bool
  uint8_t* term_o;           // (B,) bool
  int32_t* cons_o;           // (B,)
  int32_t* succ_o;           // (B,)
  float* team_o;             // (B,)
  uint8_t* scratch;          // chip layout: (slots, workspace) bytes, or null: shared memory
  int B, W, L, N, fov, stall, max_step;
  int group;                 // chips a group (group layout), 0: the chip layout
  float rcp_x, rcp_y;        // float32 1/scale of the direction zoom
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline int take(int& end, int bytes) {
  const int at = end;
  end += round16(bytes);
  return at;
}

// A staged input span: it arrives as the 16-byte words that cover it, which
// take at most 16 bytes more than its bytes rounded up to 16.
__host__ __device__ inline int take_in(int& end, int bytes) { return take(end, bytes + 16); }

// Byte offsets, from the start of dynamic shared memory, of a group block's
// spans: 32 bytes of four mbarriers (each input buffer's usage board and its
// other spans complete apart), two input buffers (the input offsets are
// within a buffer) and the work area.  `M` is the bytes of a map of the
// board padded by a cell on each side, `od` the bytes of one observation
// row, 0 without observations.  `_group_spans` in ops/dmfb_step.py mirrors
// this list.
struct GroupLayout {
  int pos, goal, dist, act, uni, step, cumc, block, usage;
  int in_bytes;  // one input buffer
  int maps, cells, info, move, health, reward, chip, corner, obs;
  int total;
};

__host__ __device__ inline GroupLayout group_layout(int C, int N, int WL, int M, int od) {
  GroupLayout t;
  int e = 0;
  t.pos = take_in(e, C * N * 8);
  t.goal = take_in(e, C * N * 8);
  t.dist = take_in(e, C * N * 4);
  t.act = take_in(e, C * N * 4);
  t.uni = take_in(e, C * N * 4);
  t.step = take_in(e, C * 4);
  t.cumc = take_in(e, C * 4);
  t.block = take_in(e, C * WL);
  t.usage = take_in(e, C * WL * 4);
  t.in_bytes = e;
  e = 32 + 2 * t.in_bytes;
  t.maps = take(e, 2 * C * M);      // droplets on each cell, past and new (uint8)
  t.cells = take(e, C * N * 16);     // the past cell and the candidate, then the new cell (int4)
  t.info = take(e, C * N * 16);      // the goal, the past distance, kAlready | kStalled (int4)
  t.move = take(e, C * N * 16);      // new-map indices of the past and candidate cells, the past cell
  t.health = take(e, C * N * 4);     // the health under each droplet, fetched ahead
  t.reward = take(e, C * N * 4);     // the rewards, the bonus still to add
  t.chip = take(e, C * 16);          // per chip: constraint sum, a droplet not done, step
  t.corner = take(e, C * 4 * ((od + 93) / 96));      // per chip: the corner's fov^2 bits, in words
  t.obs = take(e, (C * N * od + 16) * (od > 0));     // the rows, 16 bytes spare
  t.total = e;
  return t;
}

// Observation rows staged at a time in a chip-layout workspace
// (`wide_rows` in ops/dmfb_step.py).
__host__ __device__ inline int chunk_rows(int N, int od) {
  return min(N, max(1, kRowBytes / od));
}

// Byte offsets of the spans of one chip's workspace in the chip layout, each
// on a 16-byte boundary; `f2` and `rows` are 0 without observations.
// `_wide_spans` in ops/dmfb_step.py mirrors this list.
struct Workspace {
  int count, pos, pos_new, goal, target, dist, dist_new, flags, reward, usage, corner, rows;
  int total;
};

__host__ __device__ inline Workspace workspace(int N, int WL, int f2, int rows) {
  Workspace t;
  int e = 0;
  t.count = take(e, WL);          // droplets on each cell (uint8)
  t.pos = take(e, N * 8);         // the past cells (int2)
  t.pos_new = take(e, N * 8);     // the new cells (int2)
  t.goal = take(e, N * 8);        // the goals (int2)
  t.target = take(e, N * 8);      // the candidate cells (int2)
  t.dist = take(e, N * 4);        // the past distances
  t.dist_new = take(e, N * 4);    // the new distances
  t.flags = take(e, N);           // kMoved | kAlready | kStalled
  t.reward = take(e, N * 4);      // the rewards, the bonus still to add
  t.usage = take(e, N * 8);       // usage at the past and candidate cells
  t.corner = take(e, f2);         // the block mask at [0, fov)^2
  t.rows = take(e, rows);         // staged observation rows, 16 bytes spare
  t.total = e;
  return t;
}

constexpr uint8_t kMoved = 1;    // the draw lets the droplet move
constexpr uint8_t kAlready = 2;  // stall mode and the droplet was at its goal
constexpr uint8_t kStalled = 4;  // its action is STALL

// Direction zoom (envs/dmfb.py _zoom_dir): the JAX package's XLA program
// multiplies by the float32 reciprocal of the scale, and rintf is
// round-half-even like jnp.round.
__device__ __forceinline__ int zoom(int d, int hf, float rcp) {
  if (abs(d) <= hf) return d;
  if (d > 0) return static_cast<int>(rintf(__fmul_rn(static_cast<float>(d - hf), rcp))) + hf;
  return static_cast<int>(rintf(__fmul_rn(static_cast<float>(d + hf), rcp))) - hf;
}

__device__ __forceinline__ bool adjacent(int ax, int ay, int bx, int by) {
  return static_cast<unsigned>(ax - bx + 1) <= 2u && static_cast<unsigned>(ay - by + 1) <= 2u;
}

// The reward of the table for a droplet that went from distance d_old to
// d_new (before constraints, stall and bonus).
__device__ __forceinline__ float table_reward(int d_old, int d_new, uint8_t f) {
  if (d_new == d_old && d_old == 0) return -0.1f;
  if (d_new == d_old && (f & kStalled)) return -0.25f;
  if (d_new < d_old) return -0.1f;
  return -0.4f;
}

// Droplets on the 3x3 cells around (x, y) (|dx| <= 1 and |dy| <= 1: a
// squared distance below 4) in a map padded by a cell on each side, whose
// rows are P bytes apart.
__device__ __forceinline__ int around(const uint8_t* map, int x, int y, int P) {
  const uint8_t* r = map + x * P + y;
  return r[0] + r[1] + r[2] + r[P] + r[P + 1] + r[P + 2] + r[2 * P] + r[2 * P + 1] + r[2 * P + 2];
}

// Raise `o[at]` to `id` where that is larger: JAX's max over int8 ids.
__device__ __forceinline__ void raise_to(int8_t* o, int at, int8_t id) {
  if (id > o[at]) o[at] = id;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int offset16(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// Where the first byte of a span staged at `s` from device address `g` lies.
template <typename T>
__device__ __forceinline__ T* staged(uint8_t* s, const void* g) {
  return reinterpret_cast<T*>(s + offset16(g));
}

__device__ __forceinline__ void bulk_load(void* s, const void* g, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(s)), "l"(g), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* g, const void* s, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(g),
               "r"(smem_addr(s)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's bulk store groups still read shared
// memory.
template <int N>
__device__ __forceinline__ void wait_group_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory become visible to the bulk copies
// (the async proxy) that read it after the next __syncthreads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Bytes dst[0, n) (n <= 128) = bits 0..n-1 of the string (lo, hi): at most
// 3 single bytes up to the first 4-byte boundary, then 4-byte words, each
// spreading 4 bits to its 4 bytes, then at most 3 single bytes (as in
// dmfb_step.cu).
__device__ __forceinline__ void write_bits(int8_t* dst, uint64_t lo, uint64_t hi, int n) {
  const int head = min(n, static_cast<int>((4u - (smem_addr(dst) & 3u)) & 3u));
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k < head) dst[k] = static_cast<int8_t>((lo >> k) & 1u);
  if (head > 0) {  // the string from the first word on
    lo = (lo >> head) | (hi << (64 - head));
    hi >>= head;
  }
  const int words = (n - head) >> 2;
  uint32_t* w = reinterpret_cast<uint32_t*>(dst + head);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k >= words) break;
    const uint32_t nib = static_cast<uint32_t>((k < 16 ? lo >> (4 * k) : hi >> (4 * k - 64)) & 0xfu);
    w[k] = (nib * 0x204081u) & 0x01010101u;  // bit b of nib -> byte b
  }
  const int done = head + 4 * words;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = done + k - head;  // bit of the shifted string
    if (done + k < n)
      dst[done + k] = static_cast<int8_t>((j < 64 ? lo >> j : hi >> (j - 64)) & 1u);
  }
}

// ---------------------------------------------------------------------------
// Group layout
// ---------------------------------------------------------------------------

struct InSpan {
  const void* g;
  int s, bytes;
};

// Request the inputs of group `g` but its usage board into the buffer
// `buf`: each span as the 16-byte words that cover it, completing on the
// mbarrier `bar`.  Run by a whole warp: lane 0 arrives on the mbarrier (one
// arrival) with the bytes to come, lane k issues span k (a thread issues
// bulk copies one at a time).
__device__ __forceinline__ void stage_inputs(const WideArgs& a, const GroupLayout& t, uint8_t* buf,
                                             uint32_t bar, int g, int lane) {
  const int N = a.N, WL = a.W * a.L;
  const int c0 = g * a.group, nc = min(a.group, a.B - c0);
  const size_t cn = static_cast<size_t>(c0) * N, cwl = static_cast<size_t>(c0) * WL;
  const InSpan in[] = {
      {a.pos + cn * 2, t.pos, nc * N * 8},
      {a.goal + cn * 2, t.goal, nc * N * 8},
      {a.dist + cn, t.dist, nc * N * 4},
      {a.actions + cn, t.act, nc * N * 4},
      {a.uniforms + cn, t.uni, nc * N * 4},
      {a.step_count + c0, t.step, nc * 4},
      {a.cum_constraints + c0, t.cumc, nc * 4},
      {a.block + cwl, t.block, nc * WL},
  };
  constexpr int K = sizeof(in) / sizeof(in[0]);
  int tx = 0;  // the bytes are announced before the copies that bring them
#pragma unroll
  for (int k = 0; k < K; ++k) tx += round16(offset16(in[k].g) + in[k].bytes);
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(tx)
                 : "memory");
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane == k) {
      const uint8_t* g0 = static_cast<const uint8_t*>(in[k].g) - offset16(in[k].g);
      bulk_load(buf + in[k].s, g0, round16(offset16(in[k].g) + in[k].bytes), bar);
    }
  }
}

// Request group `g`'s usage board into the buffer `buf`, completing on the
// mbarrier `bar`.  Run by one thread.
__device__ __forceinline__ void stage_usage(const WideArgs& a, const GroupLayout& t, uint8_t* buf,
                                            uint32_t bar, int g) {
  const int WL = a.W * a.L, c0 = g * a.group, nc = min(a.group, a.B - c0);
  const float* src = a.usage + static_cast<size_t>(c0) * WL;
  const int bytes = round16(offset16(src) + nc * WL * 4);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  bulk_load(buf + t.usage, reinterpret_cast<const uint8_t*>(src) - offset16(src), bytes, bar);
}

// Fetch the health under each droplet of group `g`, whose cells are staged
// at `spos`, into `out` by 4-byte async copies; run by `threads` threads
// from `first` on, each of which commits a copy group.
__device__ __forceinline__ void fetch_health(const WideArgs& a, const int* spos, float* out, int g,
                                             int first, int threads) {
  const int N = a.N, WL = a.W * a.L, L = a.L;
  const int c0 = g * a.group, np = min(a.group, a.B - c0) * N;
  const float* health = a.health + static_cast<size_t>(c0) * WL;
  for (int e = threadIdx.x - first; e < np; e += threads) {
    const float* src = health + (e / N) * WL + spos[2 * e] * L + spos[2 * e + 1];
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(out + e)), "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Store `bytes` from shared memory at `s` to device memory at `g`, where
// both have the same offset mod 16: all but the bytes before g's first
// 16-byte boundary and after its last one by one bulk store, issued by lane
// 0 of the calling warp, which commits a bulk group either way; the ends
// byte by byte, a lane each.  Run by a whole warp.
__device__ __forceinline__ void store_staged(uint8_t* g, const uint8_t* s, int bytes, int lane) {
  const int head = min(bytes, (16 - offset16(g)) & 15);
  const int mid = (bytes - head) & ~15, tail = bytes - head - mid;
  if (lane == 0) {
    if (mid > 0) bulk_store(g + head, s + head, mid);
    commit_group();
  }
  if (lane < head) g[lane] = s[lane];
  if (lane >= 16 && lane - 16 < tail) g[head + mid + lane - 16] = s[head + mid + lane - 16];
}

// The group kernel asks for one block an SM at least: shared memory sets
// how many share one, and without the bound ptxas caps the registers low
// enough to spill.
template <bool OBS>
__global__ void __launch_bounds__(kThreads, 1) dmfb_step_group_kernel(const WideArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int N = a.N, W = a.W, L = a.L, WL = W * L, C = a.group;
  const int P = L + 2, M = (W + 2) * P;  // a padded map's row and size
  const int fov = a.fov, hf = fov / 2, f2 = fov * fov, od = OBS ? 3 * f2 + 2 : 0;
  const GroupLayout t = group_layout(C, N, WL, M, od);
  const int ngroups = (a.B + C - 1) / C, G = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // mbarriers: buffer k's inputs at bar0 + 8k, its usage board at bar0 + 16 + 8k
  const uint32_t bar0 = smem_addr(smem);
  uint8_t* const buffers = smem + 32;
  uint8_t* const maps = smem + t.maps;    // chip c: past cells at c * M, new at (C + c) * M
  int4* const cells = reinterpret_cast<int4*>(smem + t.cells);
  int4* const move = reinterpret_cast<int4*>(smem + t.move);
  float* const fetched = reinterpret_cast<float*>(smem + t.health);
  int4* const info = reinterpret_cast<int4*>(smem + t.info);
  float* const reward = reinterpret_cast<float*>(smem + t.reward);
  int* const chip = reinterpret_cast<int*>(smem + t.chip);
  uint32_t* const corner = reinterpret_cast<uint32_t*>(smem + t.corner);
  const int cw = (f2 + 31) / 32;  // words of a chip's corner bits

  if (tid == 0) {
    for (int k = 0; k < 4; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * k) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int w = tid; w < round16(2 * C * M) >> 4; w += kThreads)
    reinterpret_cast<uint4*>(maps)[w] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int k = 0; k < 2; ++k) {  // the first two groups
    const int g = blockIdx.x + k * G;
    if (g >= ngroups) break;
    if (warp == kLoadWarp) stage_inputs(a, t, buffers + k * t.in_bytes, bar0 + 8 * k, g, lane);
    if (tid == kStoreWarp * 32) stage_usage(a, t, buffers + k * t.in_bytes, bar0 + 16 + 8 * k, g);
  }
  wait_parity(bar0, 0);  // the first group's health
  fetch_health(a, staged<const int>(buffers + t.pos, a.pos + static_cast<size_t>(blockIdx.x) * C * N * 2),
               fetched, blockIdx.x, 0, kThreads);

  int it = 0;
  for (int g = blockIdx.x; g < ngroups; g += G, ++it) {
    const int k = it & 1, phase = (it >> 1) & 1;
    uint8_t* const buf = buffers + k * t.in_bytes;
    const int c0 = g * C, nc = min(C, a.B - c0), np = nc * N;
    const size_t cn = static_cast<size_t>(c0) * N, cwl = static_cast<size_t>(c0) * WL;
    const int* spos = staged<const int>(buf + t.pos, a.pos + cn * 2);
    const int* sgoal = staged<const int>(buf + t.goal, a.goal + cn * 2);
    const int* sdist = staged<const int>(buf + t.dist, a.dist + cn);
    const int* sact = staged<const int>(buf + t.act, a.actions + cn);
    const float* suni = staged<const float>(buf + t.uni, a.uniforms + cn);
    const uint8_t* sblock = staged<const uint8_t>(buf + t.block, a.block + cwl);
    float* susage = staged<float>(buf + t.usage, a.usage + cwl);
    int8_t* const obs_dst = a.obs_o + cn * od;
    int8_t* const rows = reinterpret_cast<int8_t*>(smem + t.obs) + offset16(obs_dst);

    // this group's inputs (but its usage board) and the health under its
    // droplets have arrived
    wait_parity(bar0 + 8 * k, phase);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    // A. candidate cells, draws, both occupancy maps; the chip's counters
    int step = 0, cumc = 0;  // for D
    if (tid < nc) {
      step = staged<const int>(buf + t.step, a.step_count + c0)[tid] + 1;
      cumc = staged<const int>(buf + t.cumc, a.cum_constraints + c0)[tid];
      chip[4 * tid] = 0;
      chip[4 * tid + 1] = 0;
      chip[4 * tid + 2] = step;
    }
    for (int e = tid; e < np; e += kThreads) {
      const int c = e / N;
      const int x = spos[2 * e], y = spos[2 * e + 1], act = sact[e], d = sdist[e];
      const bool already = a.stall && d == 0;
      int tx = min(max(x + (act == 1) - (act == 2), 0), W - 1);
      int ty = min(max(y + (act == 4) - (act == 3), 0), L - 1);
      if (sblock[c * WL + tx * L + ty]) {
        tx = x;
        ty = y;
      }
      const int at = c * M + (x + 1) * P + y + 1;  // in the past map; C * M on, the new
      atomicAdd(reinterpret_cast<unsigned*>(maps + (at & ~3)), 1u << (8 * (at & 3)));
      const int at_new = at + C * M;
      atomicAdd(reinterpret_cast<unsigned*>(maps + (at_new & ~3)), 1u << (8 * (at_new & 3)));
      const bool candidate = !already && suni[e] <= fetched[e] && (tx != x || ty != y);
      cells[e] = candidate ? make_int4(x, y, tx, ty) : make_int4(x, y, x, y);
      // a droplet that is no candidate looks up its own cell, which it holds
      move[e] = make_int4(at_new, candidate ? (C + c) * M + (tx + 1) * P + ty + 1 : at_new, x, y);
      info[e] = make_int4(sgoal[2 * e], sgoal[2 * e + 1], d,
                          (already ? kAlready : 0) | (act == 0 ? kStalled : 0));
    }
    __syncthreads();

    // B. the moves, in droplet order, a lane of warp 0 per chip: a
    // candidate moves unless a droplet is on its candidate cell (droplets
    // before it at their new cells, those after at their past ones).  The
    // next droplet's indices are read ahead; only the new map's lookups and
    // updates chain.  Meanwhile the other warps fetch the health under the
    // next group's droplets (its inputs came a group ago) and take the
    // corner's bits; then warp 2 gives this buffer's spans but the usage
    // board (all read by now) the group after next, while warps 1 and 3,
    // once the last group's usage board and rows have left, request the
    // next group's usage board and zero the rows.
    if (tid < nc) {
      const int e1 = (tid + 1) * N;
      int4 m = move[tid * N];
      for (int e = tid * N; e < e1; ++e) {
        const int4 next = move[min(e + 1, e1 - 1)];
        const int on_target = maps[m.y], on_past = maps[m.x];
        if (on_target == 0) {  // the move (predicated stores: the lanes do not part)
          maps[m.y] = 1;
          maps[m.x] = on_past - 1;
        }
        if (on_target != 0 && m.y != m.x) cells[e] = make_int4(m.z, m.w, m.z, m.w);
        m = next;
      }
    } else if (tid >= 32) {
      if (g + G < ngroups) {
        uint8_t* const nbuf = buffers + (k ^ 1) * t.in_bytes;
        wait_parity(bar0 + 8 * (k ^ 1), ((it + 1) >> 1) & 1);
        fetch_health(a, staged<const int>(nbuf + t.pos, a.pos + static_cast<size_t>(g + G) * C * N * 2),
                     fetched, g + G, 32, kThreads - 32);
      }
      if constexpr (OBS) {
        // bit k = r * fov + q of the corner: the block mask at (r, q), 32
        // bits a ballot, a warp a chip
        for (int cc = warp - 1; cc < nc; cc += kWarps - 1)
          for (int m = 0; m < cw; ++m) {
            const int kk = 32 * m + lane, r = kk / fov;
            const bool on = kk < f2 && sblock[cc * WL + r * L + kk - r * fov] != 0;
            const uint32_t bits = __ballot_sync(0xffffffffu, on);
            if (lane == 0) corner[cw * cc + m] = bits;
          }
      }
      if constexpr (OBS) asm volatile("bar.sync 1, %0;" ::"n"(kThreads - 32) : "memory");
      if (warp == kLoadWarp) {
        if (g + 2 * G < ngroups) stage_inputs(a, t, buf, bar0 + 8 * k, g + 2 * G, lane);
      } else {
        if (tid == kStoreWarp * 32) {
          wait_group_read<0>();  // the last group's usage board and rows have left
          if (it >= 1 && g + G < ngroups)
            stage_usage(a, t, buffers + (k ^ 1) * t.in_bytes, bar0 + 16 + 8 * (k ^ 1), g + G);
        }
        if constexpr (OBS) {  // warps 1 and 3
          asm volatile("bar.sync 2, 64;" ::: "memory");
          const int words = (offset16(obs_dst) + np * od + 15) >> 4;
          for (int w = (warp == kStoreWarp ? 0 : 32) + lane; w < words; w += 64)
            reinterpret_cast<uint4*>(smem + t.obs)[w] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    __syncthreads();

    // C. constraints (from the maps: sq-dist < 4 is |dx| <= 1 and |dy| <= 1),
    // observations, rewards, the per-droplet outputs, wear (once the usage
    // board has arrived)
    wait_parity(bar0 + 16 + 8 * k, phase);
    for (int e = tid; e < np; e += kThreads) {
      const int c = e / N, i = e - c * N, base = c * N;
      const int4 me = cells[e];
      const int px = me.x, py = me.y, qx = me.z, qy = me.w;
      const uint8_t* past = maps + c * M;
      const uint8_t* now = maps + (C + c) * M;
      // cur-cur pairs with the others; past-cur pairs both ways, less the
      // droplet's own pair each way
      const int sta = around(now, qx, qy, P) - 1;
      const int dyc = around(now, px, py, P) + around(past, qx, qy, P) - 2 * adjacent(px, py, qx, qy);
      const int ox = qx - hf, oy = qy - hf;
      int8_t* o = rows + e * od;
      if constexpr (OBS) {
        // the droplets in the FOV, 32 at a time: layer 0 their ids, layer 1
        // the goals of the others, clipped into the FOV (a max: any order)
        for (int j0 = 0; j0 < N; j0 += 32) {
          uint32_t seen = 0;
#pragma unroll 4
          for (int j = min(32, N - j0) - 1; j >= 0; --j) {
            const int2 qj = *reinterpret_cast<const int2*>(&cells[base + j0 + j].z);
            const bool in = static_cast<unsigned>(qj.x - ox) < static_cast<unsigned>(fov) &&
                            static_cast<unsigned>(qj.y - oy) < static_cast<unsigned>(fov);
            seen = 2 * seen + in;
          }
          while (seen) {
            const int j = j0 + __ffs(seen) - 1;
            seen &= seen - 1;
            const int4 cj = cells[base + j];
            const int8_t id = static_cast<int8_t>(j + 1);
            raise_to(o, (cj.z - ox) * fov + cj.w - oy, id);
            if (j != i) {
              const int4 ij = info[base + j];
              const int gx = min(max(ij.x - ox, 0), fov - 1);
              const int gy = min(max(ij.y - oy, 0), fov - 1);
              raise_to(o, f2 + gx * fov + gy, id);
            }
          }
        }
      }
      const int4 ie = info[e];
      const int gx = ie.x, gy = ie.y, d_old = ie.z;
      const uint8_t f = static_cast<uint8_t>(ie.w);
      const bool already = f & kAlready;
      const int d = already ? d_old : abs(qx - gx) + abs(qy - gy);
      const float r = already ? 0.f
                              : table_reward(d_old, d, f) - 2.f * static_cast<float>(sta) -
                                    2.f * static_cast<float>(dyc);
      reward[e] = r;
      if (sta + dyc) atomicAdd(chip + 4 * c, sta + dyc);
      if (d != 0) chip[4 * c + 1] = 1;  // every writer writes 1
      const bool within = chip[4 * c + 2] < a.max_step;
      a.pos_o[(cn + e) * 2] = qx;
      a.pos_o[(cn + e) * 2 + 1] = qy;
      a.dist_o[cn + e] = d;
      a.dones_o[cn + e] = d == 0 || !within;
      if (d != 0) {
        const int cell = qx * L + qy;
        int wear = 1;
        bool first = true;
        if (now[(qx + 1) * P + qy + 1] > 1) {  // the first droplet not at its goal adds all
          wear = 0;
          for (int j = 0; j < N; ++j) {
            const int4 cj = cells[base + j], ij = info[base + j];
            const int dj = (ij.w & kAlready) ? ij.z : abs(cj.z - ij.x) + abs(cj.w - ij.y);
            if (dj != 0 && cj.z == qx && cj.w == qy) {
              ++wear;
              first = first && j >= i;
            }
          }
        }
        if (first) susage[c * WL + cell] += static_cast<float>(wear);
      }
      if constexpr (OBS) {
        o[3 * f2] = static_cast<int8_t>(zoom(gx - qx, hf, a.rcp_x));
        o[3 * f2 + 1] = static_cast<int8_t>(zoom(gy - qy, hf, a.rcp_y));
        // layer 2: walls where the FOV leaves the board, and blocks at the
        // ABSOLUTE cell (r, q) (a reference quirk)
        const int q_lo = max(0, -oy), q_hi = min(fov, L - oy);  // columns on the board
        const uint32_t* cb = corner + cw * c;
        if (f2 <= 128) {
          const uint32_t full = (1u << fov) - 1u;
          const uint32_t side = (full & ~((1u << q_hi) - 1u)) | ((1u << q_lo) - 1u);
          uint64_t lo = cb[0] | (cw > 1 ? static_cast<uint64_t>(cb[1]) << 32 : 0);
          uint64_t hi = (cw > 2 ? cb[2] : 0) | (cw > 3 ? static_cast<uint64_t>(cb[3]) << 32 : 0);
          for (int rr = 0; rr < fov; ++rr) {
            const int ax = ox + rr;
            const uint64_t ones = (ax < 0 || ax > W - 1) ? full : side;
            const int at = rr * fov;
            if (at < 64) {
              lo |= ones << at;
              if (at + fov > 64) hi |= ones >> (64 - at);
            } else {
              hi |= ones << (at - 64);
            }
          }
          write_bits(o + 2 * f2, lo, hi, f2);
        } else {
          for (int rr = 0; rr < fov; ++rr) {
            const bool wall_row = ox + rr < 0 || ox + rr > W - 1;
            for (int qq = 0; qq < fov; ++qq) {
              const int bit = rr * fov + qq;
              o[2 * f2 + bit] = wall_row || qq < q_lo || qq >= q_hi || ((cb[bit >> 5] >> (bit & 31)) & 1u);
            }
          }
        }
      }
    }
    fence_proxy_async();  // the usage board and the rows leave by bulk stores
    __syncthreads();

    // D. the usage board and the rows leave (warp 1); rewards with the
    // bonus, the team reward and the per-chip outputs; the maps cleared
    float* const usage_dst = a.usage_o + cwl;
    const bool usage_bulk = offset16(usage_dst) == offset16(susage);
    if (warp == kStoreWarp) {
      if (usage_bulk) {
        store_staged(reinterpret_cast<uint8_t*>(usage_dst), reinterpret_cast<const uint8_t*>(susage),
                     nc * WL * 4, lane);
      }
      if constexpr (OBS) {
        store_staged(reinterpret_cast<uint8_t*>(obs_dst), reinterpret_cast<const uint8_t*>(rows),
                     np * od, lane);
      }
    }
    if (!usage_bulk) {  // an input view whose offset mod 16 differs from the output's
      for (int kk = tid; kk < nc * WL; kk += kThreads) usage_dst[kk] = susage[kk];
    }
    for (int e = tid; e < np; e += kThreads) {
      const int c = e / N;
      const float bonus = chip[4 * c + 1] ? 0.f : (chip[4 * c] == 0 ? 20.f : 10.f);
      a.rew_o[cn + e] = reward[e] + bonus;
      const int4 me = cells[e];
      const int past = c * M + (me.x + 1) * P + me.y + 1;
      maps[past] = 0;
      maps[past + C * M] = 0;
      maps[(C + c) * M + (me.z + 1) * P + me.w + 1] = 0;
    }
    if (tid < nc) {
      const int constraints = chip[4 * tid];
      const bool all_done = chip[4 * tid + 1] == 0;
      const float bonus = all_done ? (constraints == 0 ? 20.f : 10.f) : 0.f;
      float team = 0.f;
      for (int e = tid * N; e < (tid + 1) * N; ++e) team += reward[e] + bonus;
      const int b = c0 + tid;
      cumc += constraints;
      const bool within = step < a.max_step;
      a.step_o[b] = step;
      a.cumc_o[b] = cumc;
      a.cons_o[b] = constraints;
      a.succ_o[b] = within && all_done && cumc == 0;
      a.term_o[b] = !within || all_done;
      a.team_o[b] = team / static_cast<float>(N);
    }
  }
  if (tid == kStoreWarp * 32) wait_group_read<0>();  // shared memory outlives the stores' reads
}

// ---------------------------------------------------------------------------
// Chip layout
// ---------------------------------------------------------------------------

// Copy `n` floats with every thread of the block: 16-byte words where both
// addresses allow, else 4-byte words.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int words = n >> 2;
#pragma unroll 4
    for (int k = threadIdx.x; k < words; k += kThreads)
      reinterpret_cast<float4*>(dst)[k] = __ldg(reinterpret_cast<const float4*>(src) + k);
    done = words << 2;
  }
#pragma unroll 4
  for (int k = done + threadIdx.x; k < n; k += kThreads) dst[k] = __ldg(src + k);
}

template <bool OBS>
__global__ void __launch_bounds__(kThreads) dmfb_step_chip_kernel(const WideArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float warp_sum[kWarps];
  __shared__ int constraint_sum;
  const int N = a.N, W = a.W, L = a.L, WL = W * L, tid = threadIdx.x;
  const int fov = a.fov, hf = fov / 2, f2 = fov * fov, od = 3 * f2 + 2;
  const int R = OBS ? chunk_rows(N, od) : 0;
  const Workspace t = workspace(N, WL, OBS ? f2 : 0, OBS ? R * od + 16 : 0);
  if (tid == 0) constraint_sum = 0;

  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    // the block's slice of the scratch buffer: b % gridDim.x is blockIdx.x,
    // written per chip so that the workspace's pointers are derived per chip
    // and not held in registers across the loop
    uint8_t* ws = a.scratch ? a.scratch + static_cast<size_t>(b % gridDim.x) * t.total : smem;
    uint8_t* count = ws + t.count;
    int2* pos = reinterpret_cast<int2*>(ws + t.pos);
    int2* pos_new = reinterpret_cast<int2*>(ws + t.pos_new);
    int2* goal = reinterpret_cast<int2*>(ws + t.goal);
    int2* target = reinterpret_cast<int2*>(ws + t.target);
    int* dist = reinterpret_cast<int*>(ws + t.dist);
    int* dist_new = reinterpret_cast<int*>(ws + t.dist_new);
    uint8_t* flags = ws + t.flags;
    float* reward = reinterpret_cast<float*>(ws + t.reward);
    float2* usage = reinterpret_cast<float2*>(ws + t.usage);
    uint8_t* corner = ws + t.corner;
    const size_t bn = static_cast<size_t>(b) * N, bwl = static_cast<size_t>(b) * WL;
    const uint8_t* blk = a.block + bwl;

    // 1. stage each droplet, its candidate cell, its draw and the usage of
    // both cells (its new cell is one of them); the block mask's corner
    for (int i = tid; i < N; i += kThreads) {
      const int x = a.pos[(bn + i) * 2], y = a.pos[(bn + i) * 2 + 1];
      const int act = a.actions[bn + i], d = a.dist[bn + i];
      int tx = min(max(x + (act == 1) - (act == 2), 0), W - 1);
      int ty = min(max(y + (act == 4) - (act == 3), 0), L - 1);
      if (blk[tx * L + ty]) {
        tx = x;
        ty = y;
      }
      const bool already = a.stall && d == 0;
      const bool moved = !already && a.uniforms[bn + i] <= __ldg(a.health + bwl + x * L + y);
      pos[i] = make_int2(x, y);
      target[i] = make_int2(tx, ty);
      goal[i] = make_int2(a.goal[(bn + i) * 2], a.goal[(bn + i) * 2 + 1]);
      dist[i] = d;
      flags[i] = (moved ? kMoved : 0) | (already ? kAlready : 0) | (act == 0 ? kStalled : 0);
      usage[i] = make_float2(__ldg(a.usage + bwl + x * L + y), __ldg(a.usage + bwl + tx * L + ty));
      count[x * L + y] = 0;
      count[tx * L + ty] = 0;
    }
    if constexpr (OBS) {
      for (int m = tid; m < f2; m += kThreads) {
        const int r = m / fov;
        corner[m] = blk[r * L + m - r * fov] != 0;
      }
    }
    copy_floats(a.usage_o + bwl, a.usage + bwl, WL);
    __syncthreads();

    // 2. the moves, in droplet order
    if (tid == 0) {
      for (int i = 0; i < N; ++i) count[pos[i].x * L + pos[i].y] += 1;
      for (int i = 0; i < N; ++i) {
        const int2 p = pos[i], c = target[i], g = goal[i];
        const uint8_t f = flags[i];
        int2 q = p;
        // a droplet on the candidate cell, which is not this droplet's own,
        // blocks the move
        if ((f & kMoved) && (c.x != p.x || c.y != p.y) && count[c.x * L + c.y] == 0) {
          count[p.x * L + p.y] -= 1;
          count[c.x * L + c.y] += 1;
          q = c;
        }
        pos_new[i] = q;
        const int d_old = dist[i];
        const int d_new = abs(q.x - g.x) + abs(q.y - g.y);
        const bool already = f & kAlready;
        reward[i] = already ? 0.f : table_reward(d_old, d_new, f);
        dist_new[i] = already ? d_old : d_new;
      }
    }
    __syncthreads();

    // 3. constraints, rewards, dones, wear (the usage board's copy is in
    // place: the barriers above order it before these stores)
    const int step = a.step_count[b] + 1;
    const bool within = step < a.max_step;
    int constraints = 0;
    bool all_done = true, terminated = true;
    for (int i = tid; i < N; i += kThreads) {
      const int2 p = pos[i], q = pos_new[i];
      int sta = 0, dyc = 0;
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        const int2 pj = pos[j], qj = pos_new[j];
        sta += adjacent(q.x, q.y, qj.x, qj.y);
        dyc += adjacent(p.x, p.y, qj.x, qj.y) + adjacent(pj.x, pj.y, q.x, q.y);
      }
      const int d = dist_new[i];
      float r = reward[i] - 2.f * static_cast<float>(sta) - 2.f * static_cast<float>(dyc);
      if (a.stall && dist[i] == 0) r = 0.f;
      reward[i] = r;
      constraints += sta + dyc;
      all_done = all_done && d == 0;
      const bool done = d == 0 || !within;
      terminated = terminated && done;
      a.pos_o[(bn + i) * 2] = q.x;
      a.pos_o[(bn + i) * 2 + 1] = q.y;
      a.dist_o[bn + i] = d;
      a.dones_o[bn + i] = done;
      if (d != 0) {
        const int cell = q.x * L + q.y;
        int wear = 1;
        bool first = true;
        if (count[cell] > 1) {  // the first droplet not at its goal adds all
          wear = 0;
          for (int j = 0; j < N; ++j) {
            const int2 qj = pos_new[j];
            if (dist_new[j] != 0 && qj.x == q.x && qj.y == q.y) {
              ++wear;
              first = first && j >= i;
            }
          }
        }
        const float2 u = usage[i];
        if (first)
          a.usage_o[bwl + cell] = (q.x == p.x && q.y == p.y ? u.x : u.y) + static_cast<float>(wear);
      }
    }
    if (constraints) atomicAdd(&constraint_sum, constraints);
    all_done = __syncthreads_and(all_done);
    terminated = __syncthreads_and(terminated);
    constraints = constraint_sum;

    // 4. the bonus, and the team reward in a fixed order
    const float bonus = all_done ? (constraints == 0 ? 20.f : 10.f) : 0.f;
    float part = 0.f;
    for (int i = tid; i < N; i += kThreads) {
      const float r = reward[i] + bonus;
      a.rew_o[bn + i] = r;
      part += r;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float team = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) team += warp_sum[w];
      const int cumc = a.cum_constraints[b] + constraints;
      a.step_o[b] = step;
      a.cumc_o[b] = cumc;
      a.cons_o[b] = constraints;
      a.succ_o[b] = within && all_done && cumc == 0;
      a.term_o[b] = terminated;
      a.team_o[b] = team / static_cast<float>(N);
      constraint_sum = 0;  // every thread has read it (the barrier above)
    }

    // 5. observations, R rows at a time: staged in the workspace at the
    // alignment (mod 16) of their place in device memory, then copied there
    // in 16-byte words
    if constexpr (OBS) {
      for (int i0 = 0; i0 < N; i0 += R) {
        const int rows = min(R, N - i0), bytes = rows * od;
        int8_t* dst = a.obs_o + (bn + i0) * od;
        const int shift = offset16(dst);
        int8_t* stage = reinterpret_cast<int8_t*>(ws + t.rows) + shift;
        for (int w = tid; w < (shift + bytes + 15) >> 4; w += kThreads)
          reinterpret_cast<uint4*>(ws + t.rows)[w] = make_uint4(0, 0, 0, 0);
        __syncthreads();  // the zeros are written
        // layer 2, a FOV row (observer i, row r) a thread: walls where the
        // FOV leaves the board, and blocks at the ABSOLUTE cell (r, q) (a
        // reference quirk)
        for (int e = tid; e < rows * fov; e += kThreads) {
          const int i = e / fov, r = e - i * fov;
          const int2 c = pos_new[i0 + i];
          const int ax = c.x - hf + r, y0 = c.y - hf;
          const bool wall = ax < 0 || ax >= W;
          int8_t* o = stage + i * od + 2 * f2 + r * fov;
          for (int q = 0; q < fov; ++q)
            o[q] = (wall || y0 + q < 0 || y0 + q >= L) ? 1 : corner[r * fov + q];
        }
        // layers 0 and 1 and the direction, one thread per observer: the
        // droplets in the FOV, and the goals of the others there, clipped
        // into the FOV
        for (int i = tid; i < rows; i += kThreads) {
          int8_t* o = stage + i * od;
          const int2 c = pos_new[i0 + i], g = goal[i0 + i];
          o[3 * f2] = static_cast<int8_t>(zoom(g.x - c.x, hf, a.rcp_x));
          o[3 * f2 + 1] = static_cast<int8_t>(zoom(g.y - c.y, hf, a.rcp_y));
          for (int j = 0; j < N; ++j) {
            const int2 qj = pos_new[j];
            const int rx = qj.x - c.x + hf, ry = qj.y - c.y + hf;
            if (rx < 0 || rx >= fov || ry < 0 || ry >= fov) continue;
            const int8_t id = static_cast<int8_t>(j + 1);
            raise_to(o, rx * fov + ry, id);
            if (j != i0 + i) {
              const int2 gj = goal[j];
              const int gx = min(max(gj.x - c.x + hf, 0), fov - 1);
              const int gy = min(max(gj.y - c.y + hf, 0), fov - 1);
              raise_to(o, f2 + gx * fov + gy, id);
            }
          }
        }
        __syncthreads();
        // bytes up to dst's first 16-byte boundary, 16-byte words, the rest
        const int head = min(bytes, (16 - shift) & 15), words = (bytes - head) >> 4;
        for (int k = tid; k < head; k += kThreads) dst[k] = stage[k];
        for (int w = tid; w < words; w += kThreads)
          reinterpret_cast<uint4*>(dst + head)[w] = reinterpret_cast<const uint4*>(stage + head)[w];
        for (int k = head + (words << 4) + tid; k < bytes; k += kThreads) dst[k] = stage[k];
        __syncthreads();  // the stage is read before the next rows
      }
    }
    __syncthreads();  // the workspace is free for the next chip
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory on a grid of
// as many blocks as fit on the card at once, at most `most`.
template <typename Kernel>
int launch(Kernel kernel, const WideArgs& a, int smem, int most, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<dim3(min(most, per_sm * sms)), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dmfb_step_wide_launch(
    const void* pos, const void* dist, const void* goal, const void* health,
    const void* usage, const void* block, const void* actions,
    const void* uniforms, const void* step_count, const void* cum_constraints,
    void* pos_o, void* dist_o, void* usage_o, void* step_o, void* cumc_o,
    void* rew_o, void* obs_o, void* dones_o, void* term_o, void* cons_o,
    void* succ_o, void* team_o, void* scratch, int slots, int B, int W, int L, int N,
    int fov, int stall, int max_step, int group, int observe, float rcp_x, float rcp_y,
    void* stream) {
  if (B < 1 || N < 1 || W < 1 || L < 1 || fov < 1 || fov > W || fov > L || group < 0 ||
      group > kMaxGroup || (scratch && (slots < 1 || group))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int od = 3 * fov * fov + 2;
  int smem;
  if (group) {  // the wrapper's `group_bytes`
    smem = group_layout(group, N, W * L, (W + 2) * (L + 2), observe ? od : 0).total;
    if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    // `scratch` holds `slots` workspaces where the wrapper found one too
    // large for shared memory (`wide_workspace_bytes`, WIDE_SMEM_LIMIT)
    const int rows = observe ? chunk_rows(N, od) * od + 16 : 0;
    smem = scratch ? 0 : workspace(N, W * L, observe ? fov * fov : 0, rows).total;
    if (smem > kWideSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  }
  WideArgs a;
  a.pos = static_cast<const int32_t*>(pos);
  a.dist = static_cast<const int32_t*>(dist);
  a.goal = static_cast<const int32_t*>(goal);
  a.health = static_cast<const float*>(health);
  a.usage = static_cast<const float*>(usage);
  a.block = static_cast<const uint8_t*>(block);
  a.actions = static_cast<const int32_t*>(actions);
  a.uniforms = static_cast<const float*>(uniforms);
  a.step_count = static_cast<const int32_t*>(step_count);
  a.cum_constraints = static_cast<const int32_t*>(cum_constraints);
  a.pos_o = static_cast<int32_t*>(pos_o);
  a.dist_o = static_cast<int32_t*>(dist_o);
  a.usage_o = static_cast<float*>(usage_o);
  a.step_o = static_cast<int32_t*>(step_o);
  a.cumc_o = static_cast<int32_t*>(cumc_o);
  a.rew_o = static_cast<float*>(rew_o);
  a.obs_o = static_cast<int8_t*>(obs_o);
  a.dones_o = static_cast<uint8_t*>(dones_o);
  a.term_o = static_cast<uint8_t*>(term_o);
  a.cons_o = static_cast<int32_t*>(cons_o);
  a.succ_o = static_cast<int32_t*>(succ_o);
  a.team_o = static_cast<float*>(team_o);
  a.scratch = static_cast<uint8_t*>(scratch);
  a.B = B;
  a.W = W;
  a.L = L;
  a.N = N;
  a.fov = fov;
  a.stall = stall;
  a.max_step = max_step;
  a.group = group;
  a.rcp_x = rcp_x;
  a.rcp_y = rcp_y;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group) {
    const int groups = (B + group - 1) / group;
    return observe ? launch(dmfb_step_group_kernel<true>, a, smem, groups, s)
                   : launch(dmfb_step_group_kernel<false>, a, smem, groups, s);
  }
  // at most one block a chip and, with a scratch buffer, one a slice of it
  const int most = scratch ? min(B, slots) : B;
  return observe ? launch(dmfb_step_chip_kernel<true>, a, smem, most, s)
                 : launch(dmfb_step_chip_kernel<false>, a, smem, most, s);
}
