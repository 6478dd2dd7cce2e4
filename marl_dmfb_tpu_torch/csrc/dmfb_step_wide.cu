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
//
// Bound on the H100: bytes.  A chip moves its usage board twice (read and
// written whole), one 32-byte sector of health and of the block mask under
// each droplet, the block mask's fov corner rows, and N rows of
// 3*fov*fov + 2 observation bytes.  At 200x200 with 4 droplets that is
// 321 KB a chip: 98.34 us for B = 1024 at 3.35 TB/s (`ops/dmfb_step.py`
// `min_bytes`).
//
// Design: one block per chip, grid-striding over the batch: one warp for up
// to 32 droplets on boards of up to 64x64 cells, where a chip's work is a
// few chains of dependent loads and the most chips in flight hide them;
// four warps otherwise (the usage boards of large boards, the O(N^2) scans
// of many droplets).  Per-droplet state, a
// per-chip occupancy count map of W*L bytes and the observation rows being
// built live in a workspace: dynamic shared memory sized from N, the board
// and the fov at launch, or, where that does not fit, a per-block slice of
// a global scratch buffer that the wrapper allocates (one slice a block of
// the grid, which it reuses chip after chip, as it does shared memory).
//  1. Every thread takes droplets: it stages their cells, goals and
//     distances, computes each droplet's candidate cell (back to its own
//     cell on a block), whether its move succeeds (its draw against the
//     health of its own cell) and the usage of both cells: all depend only
//     on the droplet's own inputs.  It zeroes the count map at the two
//     cells, the only ones the moves read.  Meanwhile the block copies the
//     usage board to the output (16-byte words where aligned) and stages
//     the block mask's corner [0, fov)^2 for the observations.
//  2. One thread runs the order-dependent move chain: droplet i sees
//     droplets 0..i-1 at their new cells.  The count map makes each
//     droplet's overlap test one lookup, so the chain is O(N).
//  3. Every thread takes droplets again: constraint counts by a scan of all
//     droplets (sq-dist < 4 is |dx| <= 1 and |dy| <= 1), rewards, dones,
//     the per-droplet outputs, and the wear: the new cell of each droplet
//     not at its goal gets its staged usage + 1 (all of a cell's
//     actuations added at once by the first droplet there, where the count
//     map says a cell holds more than one).  Block-wide AND and a shared
//     integer sum give all-done, terminated and the constraint count,
//     exactly.
//  4. The bonus is added; the team reward is the mean of the rewards in a
//     fixed order (per-thread strided sums, a warp shuffle tree, the warps
//     in order).
//  5. Observations (`observe`), up to 8 KB of rows at a time, built in the
//     workspace at the alignment (mod 16) of their place in device memory,
//     so that they leave in 16-byte words but for the ends: zeroed in
//     16-byte words; layer 2 a FOV row a thread; then one thread per
//     observer writes the direction and scatters layers 0 and 1 over all
//     droplets with JAX's int8 semantics: a cell holds max(0, max over the
//     droplets mapped there of int8(j + 1)), so ids 128-255 show as 0 and
//     ids from 256 wrap.
//
// Interface: plain C, no PyTorch headers (built with nvcc, loaded with
// ctypes).  The launch function returns a cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Threads a chip: one warp for up to 32 droplets on boards of up to
// kNarrowCells cells, where a chip's work is short chains of dependent loads
// and more chips in flight hide them; else four warps, for the usage boards
// of large boards and the O(N^2) scans of many droplets.  Timed at 20
// droplets and B = 4096 (tools/time_dmfb_step.py): one warp is the faster
// up to 64x64 (by 2% there), four from 80x80 (by 4% there).
constexpr int kNarrowCells = 64 * 64;
// Dynamic shared memory a block may take for its workspace: the 227 KB of
// sm_90 less 1 KB for the kernel's static shared memory.  A workspace above
// it goes to the global scratch buffer.
constexpr int kWideSmemLimit = 227 * 1024 - 1024;
// Observation rows staged in the workspace at a time: as many whole rows
// as fit in this many bytes, at least one.
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
  uint8_t* scratch;          // (slots, workspace) bytes, or null: shared memory
  int B, W, L, N, fov, stall, max_step;
  float rcp_x, rcp_y;        // float32 1/scale of the direction zoom
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Observation rows staged at a time (`wide_rows` in ops/dmfb_step.py).
__host__ __device__ inline int chunk_rows(int N, int od) {
  return min(N, max(1, kRowBytes / od));
}

// Byte offsets of the spans of one chip's workspace, each on a 16-byte
// boundary; `f2` and `rows` are 0 without observations.  `_wide_spans` in
// ops/dmfb_step.py mirrors this list.
struct Workspace {
  int count, pos, pos_new, goal, target, dist, dist_new, flags, reward, usage, corner, rows;
  int total;
};

__host__ __device__ inline int take(int& end, int bytes) {
  const int at = end;
  end += round16(bytes);
  return at;
}

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

__device__ __forceinline__ bool adjacent(int2 a, int2 b) {
  return abs(a.x - b.x) <= 1 && abs(a.y - b.y) <= 1;
}

// Copy `n` floats with every thread of the block: 16-byte words where both
// addresses allow, else 4-byte words.
template <int THREADS>
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int words = n >> 2;
#pragma unroll 4
    for (int k = threadIdx.x; k < words; k += THREADS)
      reinterpret_cast<float4*>(dst)[k] = __ldg(reinterpret_cast<const float4*>(src) + k);
    done = words << 2;
  }
#pragma unroll 4
  for (int k = done + threadIdx.x; k < n; k += THREADS) dst[k] = __ldg(src + k);
}

// Raise `o[at]` to `id` where that is larger: JAX's max over int8 ids.
__device__ __forceinline__ void raise_to(int8_t* o, int at, int8_t id) {
  if (id > o[at]) o[at] = id;
}

template <int THREADS, bool OBS>
__global__ void __launch_bounds__(THREADS) dmfb_step_wide_kernel(const WideArgs a) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ __align__(16) uint8_t smem[];
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
    // and not held in registers across the loop (which made ptxas spill)
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
    const int step = a.step_count[b] + 1, cumc_in = a.cum_constraints[b];

    // 1. stage each droplet, its candidate cell, its draw and the usage of
    // both cells (its new cell is one of them); the block mask's corner
    for (int i = tid; i < N; i += THREADS) {
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
      for (int m = tid; m < f2; m += THREADS) {
        const int r = m / fov;
        corner[m] = blk[r * L + m - r * fov] != 0;
      }
    }
    copy_floats<THREADS>(a.usage_o + bwl, a.usage + bwl, WL);
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
        float r;
        if (d_new == d_old && d_old == 0) r = -0.1f;
        else if (d_new == d_old && (f & kStalled)) r = -0.25f;
        else if (d_new < d_old) r = -0.1f;
        else r = -0.4f;
        const bool already = f & kAlready;
        reward[i] = already ? 0.f : r;
        dist_new[i] = already ? d_old : d_new;
      }
    }
    __syncthreads();

    // 3. constraints, rewards, dones, wear (the usage board's copy is in
    // place: the barriers above order it before these stores)
    const bool within = step < a.max_step;
    int constraints = 0;
    bool all_done = true, terminated = true;
    for (int i = tid; i < N; i += THREADS) {
      const int2 p = pos[i], q = pos_new[i];
      int sta = 0, dyc = 0;
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        const int2 pj = pos[j], qj = pos_new[j];
        sta += adjacent(q, qj);
        dyc += adjacent(p, qj) + adjacent(pj, q);
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
    for (int i = tid; i < N; i += THREADS) {
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
      const int cumc = cumc_in + constraints;
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
        const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
        int8_t* stage = reinterpret_cast<int8_t*>(ws + t.rows) + shift;
        for (int w = tid; w < (shift + bytes + 15) >> 4; w += THREADS)
          reinterpret_cast<uint4*>(ws + t.rows)[w] = make_uint4(0, 0, 0, 0);
        __syncthreads();  // the zeros are written
        // layer 2, a FOV row (observer i, row r) a thread: walls where the
        // FOV leaves the board, and blocks at the ABSOLUTE cell (r, q) (a
        // reference quirk)
        for (int e = tid; e < rows * fov; e += THREADS) {
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
        for (int i = tid; i < rows; i += THREADS) {
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
        for (int k = tid; k < head; k += THREADS) dst[k] = stage[k];
        for (int w = tid; w < words; w += THREADS)
          reinterpret_cast<uint4*>(dst + head)[w] = reinterpret_cast<const uint4*>(stage + head)[w];
        for (int k = head + (words << 4) + tid; k < bytes; k += THREADS) dst[k] = stage[k];
        __syncthreads();  // the stage is read before the next rows
      }
    }
    __syncthreads();  // the workspace is free for the next chip
  }
}

// The grid: as many blocks as fit on the card at once, at most one a chip
// and, with a scratch buffer, one a slice of it.
template <int THREADS, bool OBS>
int launch(const WideArgs& a, int smem, int slots, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(dmfb_step_wide_kernel<THREADS, OBS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dmfb_step_wide_kernel<THREADS, OBS>,
                                                      THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(min(min(a.B, per_sm * sms), a.scratch ? slots : a.B));
  dmfb_step_wide_kernel<THREADS, OBS><<<grid, THREADS, smem, s>>>(a);
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
    int fov, int stall, int max_step, int observe, float rcp_x, float rcp_y,
    void* stream) {
  if (B < 1 || N < 1 || W < 1 || L < 1 || fov < 1 || fov > W || fov > L ||
      (scratch && slots < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // `scratch` holds `slots` workspaces where the wrapper found one too large
  // for shared memory (`wide_workspace_bytes`, WIDE_SMEM_LIMIT)
  const int f2 = observe ? fov * fov : 0;
  const int rows = observe ? chunk_rows(N, 3 * fov * fov + 2) * (3 * fov * fov + 2) + 16 : 0;
  const int smem = scratch ? 0 : workspace(N, W * L, f2, rows).total;
  if (smem > kWideSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
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
  a.rcp_x = rcp_x;
  a.rcp_y = rcp_y;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W * L <= kNarrowCells && N <= 32)
    return observe ? launch<32, true>(a, smem, slots, s) : launch<32, false>(a, smem, slots, s);
  return observe ? launch<128, true>(a, smem, slots, s) : launch<128, false>(a, smem, slots, s);
}
