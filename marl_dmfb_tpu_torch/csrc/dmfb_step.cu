// Fused DMFB environment step (v0 observation) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_kernel(params).kernel` in
// marl_dmfb_tpu/ops/dmfb_step_pallas.py:44-219 (called through
// `pallas_step_batch`, :222-286).  It computes what that kernel computes,
// which is `envs/dmfb.py` step_core + observe: the sequential health-gated
// droplet moves, the reward table, the cur-cur and past-cur constraint
// counts, the all-done bonus, electrode wear, episode bookkeeping, and the
// 3-layer int8 field-of-view observation with the zoomed goal direction.
//
// Modes (the launch's `observe` argument, the kernel's OBS template
// parameter): with it, the whole step above; without it, the transition
// alone, for observations that the kernel does not compute (the DMFB v0.1
// observation, `envs/dmfb_v01.py`, taken by the caller on the new state):
// no observation span in shared memory, no zeroing, no observation stores.
// The OBS=true instantiations are the code of the step with observations
// and nothing else.
//
// Bound on the H100: bytes.  Per chip and step (10x10 board, 4 droplets,
// fov 9) it reads 748 bytes (the usage board, the block mask, one 32-byte
// sector of health under each droplet, positions, goals, actions, draws)
// and writes 1469 (980 observation bytes, the new usage board, small
// per-droplet and per-chip outputs), and does a few thousand integer
// operations: at 3.35 TB/s a batch of 16384 chips cannot take less than
// 10.84 us (`ops/dmfb_step.py` `min_bytes`).
//
// Design.  The work is one short sequential loop per chip plus some 2 KB
// to move, so what a block pays for is latency: the instructions of one
// thread per chip or per droplet, and the issue of the bulk copies (a warp
// issues them one at a time, each far dearer than a store).
//  - A tile is C consecutive chips (the wrapper's `tile_chips`); each
//    per-chip array of a tile is one contiguous span in device memory.
//    Blocks are persistent and alternate between two tile buffers in
//    shared memory, so that while a tile is computed the inputs of the
//    tile after next arrive and the last tile's stores drain.
//  - Stage: each input span whose address and size are multiples of 16
//    bytes arrives by one 1-D bulk copy (`cp.async.bulk`, completion on the
//    buffer's mbarrier), the issues spread over the warps; the others (a
//    short last tile, odd sizes, unaligned views) by plain loads.
//  - Moves: one thread of warp 0 per chip runs the order-dependent move
//    loop, the constraint counts, the rewards and the wear in registers
//    (MAXN is a template bound, so the per-droplet arrays stay in
//    registers), after issuing all N health loads and block lookups, which
//    depend only on each droplet's own start cell and action.  Its small
//    outputs go straight to device memory.  The wear lands on the staged
//    usage board, which leaves as the fresh board (the rollout keeps the
//    old state of chips whose episode has ended, so nothing is updated in
//    place).  Meanwhile one thread of warp 1 per chip flags the chips that
//    have a block at all.
//  - Observations (OBS only): while the usage board leaves by bulk store,
//    one thread per droplet fills the zeroed tile: layers 0 and 1 by scatter, walking
//    the droplets in increasing order so that the highest id wins; layer 2
//    as a bit string of walls and blocks written in 4-byte words; the two
//    direction bytes with `zoom`.  The tile leaves by one bulk store.
// The TPU kernel's batch-minor layout and one-hot lookups were lane tricks
// for the TPU's vector unit and are not carried over.
//
// Interface: plain C, no PyTorch headers (built with nvcc, loaded with
// ctypes).  The launch function returns a cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxDroplets = 16;
constexpr int kMaxTile = 16;  // chips of a tile: one thread of warp 0 each
                              // for the moves, one of warp 1 for the flag
static_assert(kMaxTile <= 32 && kThreads >= 64, "a tile's chips need a lane of two warps");
constexpr int kWarps = kThreads / 32;
constexpr int kStoreLane = 32;  // lane 0 of warp 1, which has no moves to run
// A block's largest dynamic shared memory on sm_90 (232,448 bytes).
constexpr int kSmemLimit = 227 * 1024;

struct StepArgs {
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
  int8_t* obs_o;             // (B, N, 3*fov*fov + 2); unused without OBS
  uint8_t* dones_o;          // (B, N) bool
  uint8_t* term_o;           // (B,) bool
  int32_t* cons_o;           // (B,)
  int32_t* succ_o;           // (B,)
  float* team_o;             // (B,)
  int B, W, L, N, fov, stall, max_step, tile;
  float rcp_x, rcp_y;        // float32 1/scale of the direction zoom
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Byte offsets of the spans of one tile buffer in dynamic shared memory,
// each on a 16-byte boundary.  A block holds two such buffers after the 16
// bytes of its two mbarriers.  `od` is the bytes of one observation row, 0
// without OBS.  `_span_bytes` in ops/dmfb_step.py mirrors this list.
struct Layout {
  int pos, goal, dist, act, uni, step, cumc, block, usage, obs, pos_o, blocked;
  int total;
};

__host__ __device__ inline int take(int& end, int bytes) {
  const int at = end;
  end += round16(bytes);
  return at;
}

__host__ __device__ inline Layout layout(int C, int N, int WL, int od) {
  Layout t;
  int e = 0;
  t.pos = take(e, C * N * 8);
  t.goal = take(e, C * N * 8);
  t.dist = take(e, C * N * 4);
  t.act = take(e, C * N * 4);
  t.uni = take(e, C * N * 4);
  t.step = take(e, C * 4);
  t.cumc = take(e, C * 4);
  t.block = take(e, C * WL);
  t.usage = take(e, C * WL * 4);
  t.obs = take(e, C * N * od);
  t.pos_o = take(e, C * N * 8);  // the new positions, for the observations
  t.blocked = take(e, C);        // per chip: does its block mask hold a block?
  t.total = e;
  return t;
}

__host__ __device__ inline int smem_bytes(int C, int N, int WL, int od) {
  return 16 + 2 * layout(C, N, WL, od).total;
}

// Direction zoom (envs/dmfb.py _zoom_dir): the JAX package's XLA program
// multiplies by the float32 reciprocal of the scale, and rintf is
// round-half-even like jnp.round.
__device__ __forceinline__ int zoom(int d, int hf, float rcp) {
  if (abs(d) <= hf) return d;
  if (d > 0) return static_cast<int>(rintf(__fmul_rn(static_cast<float>(d - hf), rcp))) + hf;
  return static_cast<int>(rintf(__fmul_rn(static_cast<float>(d + hf), rcp))) - hf;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 1-D bulk copy needs a 16-byte aligned address and size (the shared
// side is aligned by the layout).
__device__ __forceinline__ bool bulk_ok(const void* g, int bytes) {
  return bytes > 0 &&
         ((reinterpret_cast<uintptr_t>(g) | static_cast<uintptr_t>(bytes)) & 15) == 0;
}

__device__ __forceinline__ void bulk_load(void* s, const void* g, int bytes,
                                          uint32_t bar) {
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

// Copy `bytes` between global and shared memory with every thread of the
// block: 16-byte words where both addresses allow, else 4-byte words, else
// bytes.  For the spans a bulk copy cannot take, which are rare: out of
// line and not unrolled, because inlined at each of its call sites it
// multiplied the kernel's code.
__device__ __noinline__ void copy_plain(void* dst, const void* src, int bytes) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const uintptr_t both = reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s);
  int done = 0;
  if ((both & 15) == 0) {
    const int n = bytes >> 4;
#pragma unroll 1
    for (int k = threadIdx.x; k < n; k += kThreads)
      reinterpret_cast<uint4*>(d)[k] = reinterpret_cast<const uint4*>(s)[k];
    done = n << 4;
  } else if ((both & 3) == 0) {
    const int n = bytes >> 2;
#pragma unroll 1
    for (int k = threadIdx.x; k < n; k += kThreads)
      reinterpret_cast<uint32_t*>(d)[k] = reinterpret_cast<const uint32_t*>(s)[k];
    done = n << 2;
  }
#pragma unroll 1
  for (int k = done + threadIdx.x; k < bytes; k += kThreads) d[k] = s[k];
}

struct InSpan {
  const void* g;
  int s, bytes;
};

// Request the inputs of tile `tile` into the buffer `buf`.  Span k goes by
// bulk copy where it can, issued by lane 0 of warp k % kWarps; each warp's
// lane 0 arrives on the mbarrier `bar` (initialised for kWarps arrivals)
// with the bytes of its copies.  The block copies the spans a bulk copy
// cannot take.  Called by every thread.
__device__ void stage(const StepArgs& a, const Layout& t, uint8_t* buf,
                      uint32_t bar, int tile) {
  const int N = a.N, WL = a.W * a.L;
  const int c0 = tile * a.tile, nc = min(a.tile, a.B - c0);
  const size_t cn = static_cast<size_t>(c0) * N;
  const size_t cwl = static_cast<size_t>(c0) * WL;
  const InSpan in[] = {
      {a.pos + cn * 2, t.pos, nc * N * 8},
      {a.goal + cn * 2, t.goal, nc * N * 8},
      {a.dist + cn, t.dist, nc * N * 4},
      {a.actions + cn, t.act, nc * N * 4},
      {a.uniforms + cn, t.uni, nc * N * 4},
      {a.step_count + c0, t.step, nc * 4},
      {a.cum_constraints + c0, t.cumc, nc * 4},
      {a.block + cwl, t.block, nc * WL},
      {a.usage + cwl, t.usage, nc * WL * 4},
  };
  constexpr int K = sizeof(in) / sizeof(in[0]);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    int tx = 0;  // the bytes are announced before the copies that bring them
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k % kWarps == warp && bulk_ok(in[k].g, in[k].bytes)) tx += in[k].bytes;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(tx)
                 : "memory");
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k % kWarps == warp && bulk_ok(in[k].g, in[k].bytes))
        bulk_load(buf + in[k].s, in[k].g, in[k].bytes, bar);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (!bulk_ok(in[k].g, in[k].bytes)) copy_plain(buf + in[k].s, in[k].g, in[k].bytes);
}

// Store `bytes` from shared memory at `s` to `g`: one bulk store where the
// span allows, issued by kStoreLane, which commits a group either way (so
// that every tile leaves two groups); plain stores by the block otherwise.
__device__ __forceinline__ void store_span(void* g, const uint8_t* s, int bytes) {
  const bool bulk = bulk_ok(g, bytes);
  if (threadIdx.x == kStoreLane) {
    if (bulk) bulk_store(g, s, bytes);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  if (!bulk) copy_plain(g, s, bytes);
}

// Moves, constraints, rewards, bookkeeping and wear of chip `b`, staged at
// index `c` of the tile in `buf`; run by one thread.
template <int MAXN>
__device__ __forceinline__ void step_chip(const StepArgs& a, const Layout& t,
                                          uint8_t* buf, int c, int b) {
  const int N = a.N, W = a.W, L = a.L, WL = W * L;
  // the staged positions stay the past ones, for the dynamic constraint
  const int* spos = reinterpret_cast<const int*>(buf + t.pos) + c * N * 2;
  const int* sgoal = reinterpret_cast<const int*>(buf + t.goal) + c * N * 2;
  const int* sdist = reinterpret_cast<const int*>(buf + t.dist) + c * N;
  const int* sact = reinterpret_cast<const int*>(buf + t.act) + c * N;
  const float* suni = reinterpret_cast<const float*>(buf + t.uni) + c * N;
  const uint8_t* sblock = buf + t.block + c * WL;
  const float* health = a.health + static_cast<size_t>(b) * WL;

  int px[MAXN], py[MAXN], d[MAXN], act[MAXN], tx[MAXN], ty[MAXN];
  int sta[MAXN], dyc[MAXN];
  float prob[MAXN], rew[MAXN];
  bool done_pre[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    px[i] = py[i] = d[i] = act[i] = 0;
    prob[i] = 0.f;
    if (i < N) {
      px[i] = spos[2 * i];
      py[i] = spos[2 * i + 1];
      d[i] = sdist[i];
      act[i] = sact[i];
      prob[i] = __ldg(health + px[i] * L + py[i]);
    }
    done_pre[i] = d[i] == 0;
    rew[i] = 0.f;
    sta[i] = 0;
    dyc[i] = 0;
    // droplet i's target, back to its cell if a block is there: both
    // depend only on its own start cell and action
    tx[i] = min(max(px[i] + (act[i] == 1) - (act[i] == 2), 0), W - 1);
    ty[i] = min(max(py[i] + (act[i] == 4) - (act[i] == 3), 0), L - 1);
    if (i < N && sblock[tx[i] * L + ty[i]]) {
      tx[i] = px[i];
      ty[i] = py[i];
    }
  }

  // Sequential moves: droplet i sees droplets 0..i-1 at their new cells
  // and i+1..N-1 at their old ones.
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    if (i < N) {
      const int d_old = d[i];
      const bool already = a.stall && d_old == 0;
      const bool moved = !already && suni[i] <= prob[i];
      bool occupied = false;
#pragma unroll
      for (int j = 0; j < MAXN; ++j) {
        if (j < N && j != i && px[j] == tx[i] && py[j] == ty[i]) occupied = true;
      }
      if (moved && !occupied) {
        px[i] = tx[i];
        py[i] = ty[i];
      }
      const int d_new = abs(px[i] - sgoal[2 * i]) + abs(py[i] - sgoal[2 * i + 1]);
      float r;
      if (d_new == d_old && d_old == 0) r = -0.1f;
      else if (d_new == d_old && act[i] == 0) r = -0.25f;
      else if (d_new < d_old) r = -0.1f;
      else r = -0.4f;
      rew[i] = already ? 0.f : r;
      d[i] = already ? d_old : d_new;
    }
  }

  // Constraints: cur-cur pairs count once for each droplet of the pair,
  // ordered past-cur pairs count for both droplets.
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
#pragma unroll
    for (int j = 0; j < MAXN; ++j) {
      if (i < N && j < N && i != j) {
        const int ex = px[i] - px[j], ey = py[i] - py[j];
        if (ex * ex + ey * ey < 4) sta[i] += 1;
        const int fx = spos[2 * i] - px[j], fy = spos[2 * i + 1] - py[j];
        if (fx * fx + fy * fy < 4) {
          dyc[i] += 1;
          dyc[j] += 1;
        }
      }
    }
  }
  int constraints = 0;
  bool all_done = true;
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    if (i < N) {
      constraints += sta[i] + dyc[i];
      all_done = all_done && d[i] == 0;
    }
  }
  const float bonus = all_done ? (constraints == 0 ? 20.f : 10.f) : 0.f;
  const int step = reinterpret_cast<const int*>(buf + t.step)[c] + 1;
  const int cumc = reinterpret_cast<const int*>(buf + t.cumc)[c] + constraints;
  const bool within = step < a.max_step;

  // the chip's outputs go straight to device memory, each a contiguous run
  // beside the runs of the warp's other chips
  const size_t bn = static_cast<size_t>(b) * N;
  int* spos_o = reinterpret_cast<int*>(buf + t.pos_o) + c * N * 2;
  float* usage = reinterpret_cast<float*>(buf + t.usage) + c * WL;
  float team = 0.f;
  bool terminated = true;
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    if (i < N) {
      float r = rew[i] - 2.f * static_cast<float>(sta[i]) - 2.f * static_cast<float>(dyc[i]);
      if (a.stall && done_pre[i]) r = 0.f;
      r += bonus;
      team += r;
      const bool done = d[i] == 0 || !within;
      terminated = terminated && done;
      spos_o[2 * i] = px[i];
      spos_o[2 * i + 1] = py[i];
      a.pos_o[(bn + i) * 2] = px[i];
      a.pos_o[(bn + i) * 2 + 1] = py[i];
      a.dist_o[bn + i] = d[i];
      a.rew_o[bn + i] = r;
      a.dones_o[bn + i] = done;
      // wear: one actuation under each droplet not yet at its goal, all of
      // a cell's actuations added at once (as the plain version's
      // scatter-add, then add)
      if (d[i] != 0) {
        int wear = 0;
        bool first = true;
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
          if (j < N && d[j] != 0 && px[j] == px[i] && py[j] == py[i]) {
            ++wear;
            first = first && j >= i;
          }
        }
        if (first) usage[px[i] * L + py[i]] += static_cast<float>(wear);
      }
    }
  }
  a.step_o[b] = step;
  a.cumc_o[b] = cumc;
  a.cons_o[b] = constraints;
  a.succ_o[b] = within && all_done && cumc == 0;
  a.term_o[b] = terminated;
  a.team_o[b] = team / static_cast<float>(N);
}

// Bytes dst[0, n) (n <= 128) = bits 0..n-1 of the string (lo, hi): at most
// 3 single bytes up to the first 4-byte boundary, then 4-byte words, each
// spreading 4 bits to its 4 bytes, then at most 3 single bytes.
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

// The observations of droplet i of the tile's chip c, into the zeroed
// `o` (3*fov*fov + 2 bytes); run by one thread.
template <int MAXN>
__device__ __forceinline__ void observe_droplet(const StepArgs& a, const Layout& t,
                                                const uint8_t* buf, int c, int i,
                                                int8_t* o) {
  const int N = a.N, W = a.W, L = a.L, fov = a.fov, hf = fov / 2, f2 = fov * fov;
  const int* p = reinterpret_cast<const int*>(buf + t.pos_o) + c * N * 2;
  const int* g = reinterpret_cast<const int*>(buf + t.goal) + c * N * 2;
  const int cx = p[2 * i], cy = p[2 * i + 1], ox = cx - hf, oy = cy - hf;
#pragma unroll
  for (int j = 0; j < MAXN; ++j) {  // increasing ids: the highest wins a cell
    if (j >= N) break;
    const int rx = p[2 * j] - ox, ry = p[2 * j + 1] - oy;
    // layer 0: ids of the droplets in the FOV
    if (rx >= 0 && rx < fov && ry >= 0 && ry < fov) o[rx * fov + ry] = j + 1;
    // layer 1: goals of the visible other droplets, clipped into the FOV
    if (j != i && abs(rx - hf) <= hf && abs(ry - hf) <= hf) {
      const int g1x = min(max(g[2 * j] - ox, 0), fov - 1);
      const int g1y = min(max(g[2 * j + 1] - oy, 0), fov - 1);
      o[f2 + g1x * fov + g1y] = j + 1;
    }
  }
  // layer 2: walls where the FOV leaves the board, and blocks at the
  // ABSOLUTE cell (r, q) (a reference quirk).  Row r is a mask of the bytes
  // that are one.  Up to fov 11 the rows go into one bit string, written as
  // 4-byte words: one instruction per byte is what a byte loop costs, and
  // the instructions of one thread are what this phase pays for.
  int8_t* l2 = o + 2 * f2;
  const uint8_t* brow = buf + t.block + c * (W * L);
  const bool any_block = buf[t.blocked + c];
  const int q_lo = max(0, -oy), q_hi = min(fov, L - oy);  // columns on the board
  if (f2 <= 128) {
    const uint32_t full = (1u << fov) - 1u;
    const uint32_t side = (full & ~((1u << q_hi) - 1u)) | ((1u << q_lo) - 1u);
    uint64_t lo = 0, hi = 0;  // bit r * fov + q: byte (r, q) is one
#pragma unroll
    for (int r = 0; r < 11; ++r) {
      if (r >= fov) break;
      const int ax = ox + r;
      uint32_t ones = (ax < 0 || ax > W - 1) ? full : side;
      if (any_block && ones != full) {
#pragma unroll 1
        for (int q = q_lo; q < q_hi; ++q) ones |= static_cast<uint32_t>(brow[r * L + q] != 0) << q;
      }
      const int at = r * fov;
      if (at < 64) {
        lo |= static_cast<uint64_t>(ones) << at;
        if (at + fov > 64) hi |= static_cast<uint64_t>(ones) >> (64 - at);
      } else {
        hi |= static_cast<uint64_t>(ones) << (at - 64);
      }
    }
    write_bits(l2, lo, hi, f2);
  } else {
#pragma unroll 1
    for (int r = 0; r < fov; ++r) {
      const bool wall_row = ox + r < 0 || ox + r > W - 1;
#pragma unroll 1
      for (int q = 0; q < fov; ++q)
        if (wall_row || q < q_lo || q >= q_hi || (any_block && brow[r * L + q])) l2[r * fov + q] = 1;
    }
  }
  o[3 * f2] = zoom(g[2 * i] - cx, hf, a.rcp_x);
  o[3 * f2 + 1] = zoom(g[2 * i + 1] - cy, hf, a.rcp_y);
}

// Persistent blocks: block x takes tiles x, x + G, x + 2G, ... (G blocks),
// alternating between two buffers, so that the inputs of the tile after
// next and the stores of the last tile are in flight while a tile is
// computed.
template <int MAXN, bool OBS>
__global__ void __launch_bounds__(kThreads) dmfb_step_kernel(const StepArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int N = a.N, WL = a.W * a.L, od = OBS ? 3 * a.fov * a.fov + 2 : 0;
  const Layout t = layout(a.tile, N, WL, od);
  const int ntiles = (a.B + a.tile - 1) / a.tile;
  const int tid = threadIdx.x;
  const uint32_t bar0 = smem_addr(smem);  // the mbarriers of buffers 0, 1
  uint8_t* const buffers = smem + 16;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar0), "n"(kWarps) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar0 + 8), "n"(kWarps)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    if (tile < ntiles) stage(a, t, buffers + k * t.total, bar0 + 8 * k, tile);
  }

  int k = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
    uint8_t* const buf = buffers + (k & 1) * t.total;
    const int c0 = tile * a.tile, nc = min(a.tile, a.B - c0);
    const size_t cn = static_cast<size_t>(c0) * N;
    // the buffer's last stores have read it (the wait that ends the
    // iteration before), so its observations can be zeroed
    if constexpr (OBS) {
      uint4* z = reinterpret_cast<uint4*>(buf + t.obs);
      const int n = round16(nc * N * od) >> 4;
#pragma unroll 1
      for (int e = tid; e < n; e += kThreads) z[e] = make_uint4(0, 0, 0, 0);
    }
    wait_parity(bar0 + 8 * (k & 1), (k >> 1) & 1);
    __syncthreads();

    if (tid < nc) {
      step_chip<MAXN>(a, t, buf, tid, c0 + tid);
    } else if (OBS && tid >= 32 && tid - 32 < nc) {
      // meanwhile: does the chip have a block at all (most boards have none)?
      const int c = tid - 32;
      const uint8_t* blk = buf + t.block + c * WL;
      uint32_t any = 0;
      if (WL % 4 == 0) {
#pragma unroll 4
        for (int w = 0; w < WL / 4; ++w) any |= reinterpret_cast<const uint32_t*>(blk)[w];
      } else {
#pragma unroll 4
        for (int e = 0; e < WL; ++e) any |= blk[e];
      }
      buf[t.blocked + c] = any != 0;
    }
    fence_proxy_async();
    __syncthreads();

    // the new usage board leaves ...
    store_span(a.usage_o + static_cast<size_t>(c0) * WL, buf + t.usage, nc * WL * 4);

    // ... while the block writes the observations, one thread per droplet
    if constexpr (OBS) {
      int8_t* obs = reinterpret_cast<int8_t*>(buf + t.obs);
#pragma unroll 1
      for (int e = tid; e < nc * N; e += kThreads) {
        const int c = e / N;
        observe_droplet<MAXN>(a, t, buf, c, e - c * N, obs + e * od);
      }
      fence_proxy_async();
      __syncthreads();
      store_span(a.obs_o + cn * od, buf + t.obs, nc * N * od);
    }

    // before the buffer takes the tile after next, the usage board has left
    // it (all store groups but the newest, the observations, which the wait
    // that ends the next tile covers; without OBS the usage board is the
    // newest group)
    if (tid == kStoreLane) {
      if constexpr (OBS) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      } else {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    }
    __syncthreads();
    if (tile + 2 * gridDim.x < ntiles)
      stage(a, t, buf, bar0 + 8 * (k & 1), tile + 2 * gridDim.x);
  }
  if (tid == kStoreLane) {  // the shared memory must outlive the bulk stores' reads
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <int MAXN, bool OBS>
int launch(const StepArgs& a, int smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(dmfb_step_kernel<MAXN, OBS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dmfb_step_kernel<MAXN, OBS>, kThreads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = (a.B + a.tile - 1) / a.tile;
  const dim3 grid(min(ntiles, per_sm * sms));
  dmfb_step_kernel<MAXN, OBS><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dmfb_step_launch(
    const void* pos, const void* dist, const void* goal, const void* health,
    const void* usage, const void* block, const void* actions,
    const void* uniforms, const void* step_count, const void* cum_constraints,
    void* pos_o, void* dist_o, void* usage_o, void* step_o, void* cumc_o,
    void* rew_o, void* obs_o, void* dones_o, void* term_o, void* cons_o,
    void* succ_o, void* team_o, int B, int W, int L, int N, int fov,
    int stall, int max_step, int tile, int observe, float rcp_x, float rcp_y,
    void* stream) {
  if (B < 1 || N < 1 || N > kMaxDroplets || fov < 1 || fov > W || fov > L ||
      tile < 1 || tile > kMaxTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(tile, N, W * L, observe ? 3 * fov * fov + 2 : 0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a;
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
  a.B = B;
  a.W = W;
  a.L = L;
  a.N = N;
  a.fov = fov;
  a.stall = stall;
  a.max_step = max_step;
  a.tile = tile;
  a.rcp_x = rcp_x;
  a.rcp_y = rcp_y;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (observe) {
    if (N <= 4) return launch<4, true>(a, smem, s);
    if (N <= 8) return launch<8, true>(a, smem, s);
    return launch<kMaxDroplets, true>(a, smem, s);
  }
  if (N <= 4) return launch<4, false>(a, smem, s);
  if (N <= 8) return launch<8, false>(a, smem, s);
  return launch<kMaxDroplets, false>(a, smem, s);
}
