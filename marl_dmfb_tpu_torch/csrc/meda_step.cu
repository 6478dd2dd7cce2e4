// Fused MEDA environment step for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package ran the MEDA step as plain XLA
// code (marl_dmfb_tpu/envs/meda.py step_core + observe), and the port's
// plain PyTorch version of it (envs/meda.py) stays as the CPU path and the
// tests' yardstick.  On the card that version is some 275 small launches a
// step, so a rollout of a few chips waits on the host for each, and one of
// thousands of chips builds masks of (B, N, N, fov, fov) in device memory.
// This kernel computes the same step in one launch, bitwise: the moves
// (the footprint's mean health summed down each column, then across, then
// times float32 1/25, as XLA and the plain version sum it), the rewards,
// the too-close pairs, the all-done bonus, the episode flags, the wear of
// the usage board, and the observation of the new state in the params'
// version (the VERSION template parameter: v0 and v0.1 float32, v0.2
// int8).  Every float operation is an explicit __fadd_rn / __fmul_rn, so
// that no contraction into an FMA changes a bit.
//
// Bound on the H100: bytes.  Per chip and step at 80x80, 10 droplets,
// fov 19, v0.2 it reads and writes the 25,600-byte usage board, writes
// 10,850 observation bytes, reads 25 health cells under each droplet (about
// 1.6 KB in 32-byte sectors) and some 0.5 KB of small state: about 63.5 KB,
// or 77.7 us for 4,096 chips at 3.35 TB/s.  At a batch of 2 (the training
// rollouts) only the launch's latency counts.
//
// Design: one block a chip, so that a chip's droplets share shared memory
// and no block waits on another.
//  - Moves: a thread a droplet reads its state and its 25 health cells and
//    moves it; then, after a barrier, counts its too-close pairs against
//    the new centers in shared memory; then, after another, takes the
//    bonus and the flags and lists itself if it still wears the board.
//    Block-wide counts (droplets not done, too-close pairs, live droplets)
//    are shared-memory atomics on integers, exact in any order.
//  - Wear: all threads stream the usage board, 16 bytes a thread where the
//    board allows, adding to each cell the number of listed droplets whose
//    footprint covers it (one float32 add of an exact count, as the plain
//    version's band product).
//  - Observation: agents are staged a pass at a time in shared memory
//    (as many rows a pass as kStageBytes holds, at least one).  A thread
//    fills one row of one layer: it zeroes the row, then paints each covering
//    footprint in increasing droplet order, so that the highest id wins as
//    in the plain version's max.  The pass leaves by 16-byte stores,
//    staged at the same offset modulo 16 as its place in device memory.
//
// Interface: plain C, no PyTorch headers (built with nvcc, loaded with
// ctypes).  The launch function returns a cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRadius = 2;
constexpr int kFoot = 2 * kRadius + 1;  // 5x5 cells
constexpr int kSqGoal = 16;             // snap when the squared distance < 16
constexpr int kSqPunish = 36;           // a too-close pair when < 36
constexpr int kStall = 8;
// A block's largest dynamic shared memory on sm_90 (232,448 bytes).
constexpr int kSmemLimit = 227 * 1024;
// Observation rows staged a pass: all ten at 80x80-10d fov 19 v0.2.
constexpr int kStageBytes = 24 * 1024;
constexpr float kRcp25 = 1.0f / 25.0f;  // float32 1/25, as XLA divides

struct StepArgs {
  // inputs
  const int32_t* center;       // (B, N, 2) (x, y)
  const int32_t* sq_dist;      // (B, N)
  const int32_t* dest;         // (B, N, 2)
  const uint8_t* status;       // (B, N) bool
  const float* health;         // (B, W, L) [y][x]
  const float* usage;          // (B, W, L)
  const int32_t* step_count;   // (B,)
  const int32_t* fails_count;  // (B,)
  const int32_t* actions;      // (B, N)
  const float* uniforms;       // (B, N)
  // outputs
  int32_t* center_o;
  int32_t* sq_o;
  uint8_t* status_o;
  float* usage_o;
  int32_t* step_o;
  int32_t* fails_o;
  void* obs_o;                 // (B, N, obs_dim): float32 or int8 (v0.2)
  float* rew_o;                // (B, N)
  float* team_o;               // (B,)
  uint8_t* dones_o;            // (B, N) bool
  uint8_t* term_o;             // (B,) bool
  int32_t* cons_o;             // (B,)
  int32_t* succ_o;             // (B,)
  int B, W, L, N, fov, max_step, agents;
  int vec_usage;               // the board moves as float4 (aligned, W*L % 4 == 0)
  float rcp_y, rcp_x;          // the direction's float32 scales (v0.1, v0.2)
};

template <int VERSION>
struct Obs {  // v0 and v0.1: four float32 layers
  using T = float;
  static constexpr int kLayers = 4;
};
template <>
struct Obs<2> {  // v0.2: three int8 layers
  using T = int8_t;
  static constexpr int kLayers = 3;
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Byte offsets of the spans of a block's dynamic shared memory, each on a
// 16-byte boundary: per droplet its new center, its destination, the
// centers of the live droplets (listed in any order), its reward before
// the too-close penalty, its too-close count, its status and its reward;
// then the observation stage of `agents` rows of `row_bytes`, with 16
// bytes spare for its offset.
struct Layout {
  int c, d, live, r, cnt, st, rew, stage;
  int total;
};

__host__ __device__ inline int take(int& end, int bytes) {
  const int at = end;
  end += round16(bytes);
  return at;
}

__host__ __device__ inline Layout layout(int N, int agents, int row_bytes) {
  Layout t;
  int e = 0;
  t.c = take(e, 8 * N);
  t.d = take(e, 8 * N);
  t.live = take(e, 8 * N);
  t.r = take(e, 4 * N);
  t.cnt = take(e, 4 * N);
  t.st = take(e, 4 * N);
  t.rew = take(e, 4 * N);
  t.stage = take(e, agents * row_bytes + 16);
  t.total = e;
  return t;
}

__device__ inline int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// The columns [lo, hi] of row Y (absolute) that a footprint centered on
// (bx, by) covers in a FOV whose column 0 is board column ox; false where
// it misses the row.
__device__ inline bool body_cols(int Y, int bx, int by, int ox, int fov,
                                 int& lo, int& hi) {
  if (abs(Y - by) > kRadius) return false;
  lo = max(0, bx - kRadius - ox);
  hi = min(fov - 1, bx + kRadius - ox);
  return lo <= hi;
}

// The same for a destination's footprint projected onto the FOV's border
// (clamped to [0, fov)), on FOV row r of a FOV at (ox, oy).
__device__ inline bool clip_cols(int r, int bx, int by, int ox, int oy,
                                 int fov, int& lo, int& hi) {
  const int ry = by - oy;
  if (r < clampi(ry - kRadius, 0, fov - 1) || r > clampi(ry + kRadius, 0, fov - 1))
    return false;
  const int rx = bx - ox;
  lo = clampi(rx - kRadius, 0, fov - 1);
  hi = clampi(rx + kRadius, 0, fov - 1);
  return true;
}

// Whether droplet j's body reaches into the FOV at (ox, oy).
__device__ inline bool observed(int2 cj, int ox, int oy, int fov) {
  const int rx = cj.x - ox, ry = cj.y - oy;
  return rx + kRadius >= 0 && rx - kRadius <= fov - 1 && ry + kRadius >= 0 &&
         ry - kRadius <= fov - 1;
}

template <typename T>
__device__ inline void paint(T* row, int lo, int hi, T v) {
  for (int c = lo; c <= hi; ++c) row[c] = v;
}

// Row r of layer `layer` of agent i's observation.  Footprints are painted
// in increasing droplet order, so that the highest id that covers a cell
// is the one left there (the plain version's max over the droplets).
template <int VERSION>
__device__ void fill_row(typename Obs<VERSION>::T* row, int layer, int r,
                         int i, const int2* s_c, const int2* s_d,
                         const StepArgs& a) {
  using T = typename Obs<VERSION>::T;
  const int fov = a.fov, hf = fov / 2, N = a.N;
  const int2 ci = s_c[i];
  const int ox = ci.x - hf, oy = ci.y - hf, Y = oy + r;
  for (int c = 0; c < fov; ++c) row[c] = T(0);
  int lo, hi;
  if (VERSION != 0 && layer == Obs<VERSION>::kLayers - 1) {
    // the walls: rows keyed by center x against the width, columns by
    // center y against the length (the reference's literal formula)
    const int ar = ci.x - hf + r;
    const bool row_bad = ar < 0 || ar > a.W - 1;
    for (int c = 0; c < fov; ++c) {
      const int ac = ci.y - hf + c;
      row[c] = (row_bad || ac < 0 || ac > a.L - 1) ? T(1) : T(0);
    }
    return;
  }
  // which footprints the layer paints
  enum { kOwnBody, kOwnDest, kBodies, kOtherBodies, kOtherDests, kSeenDests };
  int what;
  if (VERSION == 0) {
    what = layer == 0 ? kOwnBody : layer == 1 ? kOwnDest
         : layer == 2 ? kOtherBodies : kOtherDests;
  } else if (VERSION == 1) {
    what = layer == 0 ? kBodies : layer == 1 ? kOwnDest : kSeenDests;
  } else {
    what = layer == 0 ? kBodies : kSeenDests;
  }
  if (what == kOwnBody || what == kOwnDest) {
    const int2 f = what == kOwnBody ? ci : s_d[i];
    if (body_cols(Y, f.x, f.y, ox, fov, lo, hi)) paint(row, lo, hi, T(i + 1));
    return;
  }
  for (int j = 0; j < N; ++j) {
    if (what == kBodies || what == kOtherBodies) {
      if (what == kOtherBodies && j == i) continue;
      const int2 f = s_c[j];
      if (body_cols(Y, f.x, f.y, ox, fov, lo, hi)) paint(row, lo, hi, T(j + 1));
    } else {
      if (j == i || (what == kSeenDests && !observed(s_c[j], ox, oy, fov)))
        continue;
      const int2 f = s_d[j];
      if (clip_cols(r, f.x, f.y, ox, oy, fov, lo, hi)) paint(row, lo, hi, T(j + 1));
    }
  }
}

// The two direction values of agent i's observation.
template <int VERSION>
__device__ void fill_direction(typename Obs<VERSION>::T* out, int2 c, int2 d,
                               const StepArgs& a) {
  const int tx = d.x - c.x, ty = d.y - c.y;
  if (VERSION == 0) {  // to_dest (x, y)
    out[0] = float(tx);
    out[1] = float(ty);
  } else if (VERSION == 1) {  // (y / width, x / length)
    out[0] = __fmul_rn(float(ty), a.rcp_y);
    out[1] = __fmul_rn(float(tx), a.rcp_x);
  } else {  // zoomed to a 30-cell axis, rounded half to even
    out[0] = static_cast<int8_t>(__float2int_rn(__fmul_rn(float(ty), a.rcp_y)));
    out[1] = static_cast<int8_t>(__float2int_rn(__fmul_rn(float(tx), a.rcp_x)));
  }
}

// Live droplets whose footprint covers cell (y, x).
__device__ inline int wear(int y, int x, const int2* live, int n_live) {
  int n = 0;
  for (int k = 0; k < n_live; ++k) {
    const int2 c = live[k];
    n += abs(y - c.y) <= kRadius && abs(x - c.x) <= kRadius;
  }
  return n;
}

template <int VERSION>
__global__ void __launch_bounds__(kThreads)
meda_step_kernel(const StepArgs a) {
  using T = typename Obs<VERSION>::T;
  constexpr int NL = Obs<VERSION>::kLayers;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_notdone, s_nclose, s_nlive;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int N = a.N, W = a.W, L = a.L, fov = a.fov;
  const int f2 = fov * fov, D = NL * f2 + 2;
  const Layout lay = layout(N, a.agents, D * static_cast<int>(sizeof(T)));
  int2* s_c = reinterpret_cast<int2*>(smem + lay.c);
  int2* s_d = reinterpret_cast<int2*>(smem + lay.d);
  int2* s_live = reinterpret_cast<int2*>(smem + lay.live);
  float* s_r = reinterpret_cast<float*>(smem + lay.r);
  int* s_cnt = reinterpret_cast<int*>(smem + lay.cnt);
  int* s_st = reinterpret_cast<int*>(smem + lay.st);
  float* s_rew = reinterpret_cast<float*>(smem + lay.rew);
  if (tid == 0) {
    s_notdone = 0;
    s_nclose = 0;
    s_nlive = 0;
  }
  __syncthreads();

  const size_t bn = static_cast<size_t>(b) * N;
  const size_t WL = static_cast<size_t>(W) * L;
  const float* __restrict__ hb = a.health + b * WL;

  // --- the moves: snap, or move with the footprint's mean health ---
  for (int j = tid; j < N; j += kThreads) {
    const int2 c = reinterpret_cast<const int2*>(a.center)[bn + j];
    const int2 d = reinterpret_cast<const int2*>(a.dest)[bn + j];
    const int sq = a.sq_dist[bn + j];
    const bool done = a.status[bn + j] != 0;
    const int act = a.actions[bn + j];
    const float u = a.uniforms[bn + j];
    float col[kFoot];
#pragma unroll
    for (int cc = 0; cc < kFoot; ++cc) {  // down each column
      const int x = clampi(c.x - kRadius + cc, 0, L - 1);
      float s = hb[clampi(c.y - kRadius, 0, W - 1) * static_cast<size_t>(L) + x];
#pragma unroll
      for (int rr = 1; rr < kFoot; ++rr)
        s = __fadd_rn(s, hb[clampi(c.y - kRadius + rr, 0, W - 1) * static_cast<size_t>(L) + x]);
      col[cc] = s;
    }
    float total = col[0];  // then across
#pragma unroll
    for (int cc = 1; cc < kFoot; ++cc) total = __fadd_rn(total, col[cc]);
    const float prob = __fmul_rn(total, kRcp25);

    const bool snap = !done && sq < kSqGoal;
    const bool moved = !done && !snap && u <= prob;
    int dx = 0, dy = 0;  // N, E, S, W step 3, diagonals 2; others none
    switch (act) {
      case 0: dy = -3; break;
      case 1: dx = 3; break;
      case 2: dy = 3; break;
      case 3: dx = -3; break;
      case 4: dx = 2; dy = -2; break;
      case 5: dx = 2; dy = 2; break;
      case 6: dx = -2; dy = 2; break;
      case 7: dx = -2; dy = -2; break;
      default: break;
    }
    const int2 cand = make_int2(clampi(c.x + dx, kRadius, L - 1 - kRadius),
                                clampi(c.y + dy, kRadius, W - 1 - kRadius));
    const int2 moved_c = snap ? d : (moved ? cand : c);
    const int ex = moved_c.x - d.x, ey = moved_c.y - d.y;
    const int sq_new = ex * ex + ey * ey;
    float r = sq_new < kSqGoal ? 0.0f
            : (sq_new == sq && act == kStall) ? -0.2f
            : sq_new < sq ? -0.08f : -0.4f;
    if (done || snap) r = 0.0f;
    const int2 nc = done ? c : moved_c;
    const bool st = done || snap;
    reinterpret_cast<int2*>(a.center_o)[bn + j] = nc;
    a.sq_o[bn + j] = done ? sq : (snap ? 0 : sq_new);
    a.status_o[bn + j] = st;
    s_c[j] = nc;
    s_d[j] = d;
    s_r[j] = r;
    s_st[j] = st;
    if (!st) atomicAdd(&s_notdone, 1);
  }
  __syncthreads();

  // --- too-close pairs on the new centers ---
  for (int j = tid; j < N; j += kThreads) {
    const int2 cj = s_c[j];
    int cnt = 0;
    for (int k = 0; k < N; ++k) {
      const int2 ck = s_c[k];
      const int ex = cj.x - ck.x, ey = cj.y - ck.y;
      cnt += k != j && ex * ex + ey * ey < kSqPunish;
    }
    s_cnt[j] = cnt;
    if (cnt) atomicAdd(&s_nclose, cnt);
  }
  __syncthreads();

  // --- rewards, flags, the droplets that wear the board ---
  const int step = a.step_count[b] + 1;
  const bool within = step < a.max_step;
  const int n_close = s_nclose;
  const int fails = a.fails_count[b] + n_close;
  const bool all_done = s_notdone == 0;
  const float bonus = all_done ? (fails == 0 ? 6.0f : 3.0f) : 0.0f;
  for (int j = tid; j < N; j += kThreads) {
    const float punish = __fmul_rn(-0.6f, static_cast<float>(s_cnt[j]));
    const float rew = __fadd_rn(__fadd_rn(s_r[j], punish), bonus);
    a.rew_o[bn + j] = rew;
    s_rew[j] = rew;
    const bool st = s_st[j] != 0;
    a.dones_o[bn + j] = st || !within;
    if (!st && within) s_live[atomicAdd(&s_nlive, 1)] = s_c[j];
  }
  if (tid == 0) {
    a.step_o[b] = step;
    a.fails_o[b] = fails;
    a.term_o[b] = all_done || !within;
    a.cons_o[b] = n_close;
    a.succ_o[b] = within && all_done && fails == 0;
  }
  __syncthreads();

  if (tid == 0) {  // the team reward: a float32 mean over the agents
    float sum = s_rew[0];
    for (int j = 1; j < N; ++j) sum = __fadd_rn(sum, s_rew[j]);
    a.team_o[b] = __fdiv_rn(sum, static_cast<float>(N));
  }

  // --- the wear: the new board is the old plus each cell's live count ---
  const int n_live = s_nlive;
  const float* __restrict__ u_in = a.usage + b * WL;
  float* __restrict__ u_out = a.usage_o + b * WL;
  if (a.vec_usage) {
    const int Q = static_cast<int>(WL / 4);
    const float4* __restrict__ in4 = reinterpret_cast<const float4*>(u_in);
    float4* __restrict__ out4 = reinterpret_cast<float4*>(u_out);
    for (int q = tid; q < Q; q += kThreads) {
      float4 v = in4[q];
      int n[4] = {0, 0, 0, 0};
      const int i0 = 4 * q, y = i0 / L, x = i0 - y * L;
      if (x + 3 < L) {  // one row: test each droplet's rows once
        for (int k = 0; k < n_live; ++k) {
          const int2 c = s_live[k];
          if (abs(y - c.y) > kRadius) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) n[e] += abs(x + e - c.x) <= kRadius;
        }
      } else {  // the four cells end one row and start the next
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int wrap = x + e >= L;
          n[e] = wear(y + wrap, x + e - wrap * L, s_live, n_live);
        }
      }
      v.x = __fadd_rn(v.x, static_cast<float>(n[0]));
      v.y = __fadd_rn(v.y, static_cast<float>(n[1]));
      v.z = __fadd_rn(v.z, static_cast<float>(n[2]));
      v.w = __fadd_rn(v.w, static_cast<float>(n[3]));
      out4[q] = v;
    }
  } else {
    for (int i = tid; i < static_cast<int>(WL); i += kThreads) {
      const int y = i / L, x = i - y * L;
      u_out[i] = __fadd_rn(u_in[i], static_cast<float>(wear(y, x, s_live, n_live)));
    }
  }

  // --- the observation of the new state, `agents` agents a pass ---
  T* const obs = static_cast<T*>(a.obs_o);
  const int tasks_per_agent = NL * fov + 1;  // its rows, and its direction
  for (int a0 = 0; a0 < N; a0 += a.agents) {
    const int na = min(a.agents, N - a0);
    unsigned char* dst = reinterpret_cast<unsigned char*>(obs + (bn + a0) * D);
    const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    unsigned char* src = smem + lay.stage + phase;
    T* stage = reinterpret_cast<T*>(src);
    for (int t = tid; t < na * tasks_per_agent; t += kThreads) {
      const int ai = t / tasks_per_agent, rem = t - ai * tasks_per_agent;
      const int i = a0 + ai;
      T* agent = stage + ai * D;
      if (rem == NL * fov) {
        fill_direction<VERSION>(agent + NL * f2, s_c[i], s_d[i], a);
      } else {
        const int layer = rem / fov, r = rem - layer * fov;
        fill_row<VERSION>(agent + layer * f2 + r * fov, layer, r, i, s_c, s_d, a);
      }
    }
    __syncthreads();
    // out by 16-byte stores: the stage sits at the same offset modulo 16
    const int n = na * D * static_cast<int>(sizeof(T));
    const int head = min(n, (16 - phase) & 15);
    const int body = (n - head) / 16;
    for (int k = tid; k < head; k += kThreads) dst[k] = src[k];
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    for (int k = tid; k < body; k += kThreads) d4[k] = s4[k];
    for (int k = head + 16 * body + tid; k < n; k += kThreads) dst[k] = src[k];
    __syncthreads();
  }
}

template <int VERSION>
int launch(const StepArgs& a, int smem, cudaStream_t s) {
  auto kernel = meda_step_kernel<VERSION>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.B, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int meda_step_launch(
    const void* center, const void* sq_dist, const void* dest,
    const void* status, const void* health, const void* usage,
    const void* step_count, const void* fails_count, const void* actions,
    const void* uniforms, void* center_o, void* sq_o, void* status_o,
    void* usage_o, void* step_o, void* fails_o, void* obs_o, void* rew_o,
    void* team_o, void* dones_o, void* term_o, void* cons_o, void* succ_o,
    int B, int W, int L, int N, int fov, int max_step, int version,
    float rcp_y, float rcp_x, void* stream) {
  if (B < 1 || N < 1 || W < kFoot || L < kFoot || fov < 1 || fov % 2 != 1 ||
      version < 0 || version > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (!aligned(center, 8) || !aligned(dest, 8) || !aligned(center_o, 8) ||
      !aligned(obs_o, version == 2 ? 1 : 4)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int n_layers = version == 2 ? 3 : 4;
  const int row_bytes = (n_layers * fov * fov + 2) * (version == 2 ? 1 : 4);
  const int fit = kStageBytes / row_bytes;
  const int agents = fit < 1 ? 1 : (fit > N ? N : fit);
  // past the shared memory: a chip of thousands of droplets, or a fov of
  // hundreds of cells
  const int smem = layout(N, agents, row_bytes).total;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a;
  a.center = static_cast<const int32_t*>(center);
  a.sq_dist = static_cast<const int32_t*>(sq_dist);
  a.dest = static_cast<const int32_t*>(dest);
  a.status = static_cast<const uint8_t*>(status);
  a.health = static_cast<const float*>(health);
  a.usage = static_cast<const float*>(usage);
  a.step_count = static_cast<const int32_t*>(step_count);
  a.fails_count = static_cast<const int32_t*>(fails_count);
  a.actions = static_cast<const int32_t*>(actions);
  a.uniforms = static_cast<const float*>(uniforms);
  a.center_o = static_cast<int32_t*>(center_o);
  a.sq_o = static_cast<int32_t*>(sq_o);
  a.status_o = static_cast<uint8_t*>(status_o);
  a.usage_o = static_cast<float*>(usage_o);
  a.step_o = static_cast<int32_t*>(step_o);
  a.fails_o = static_cast<int32_t*>(fails_o);
  a.obs_o = obs_o;
  a.rew_o = static_cast<float*>(rew_o);
  a.team_o = static_cast<float*>(team_o);
  a.dones_o = static_cast<uint8_t*>(dones_o);
  a.term_o = static_cast<uint8_t*>(term_o);
  a.cons_o = static_cast<int32_t*>(cons_o);
  a.succ_o = static_cast<int32_t*>(succ_o);
  a.B = B;
  a.W = W;
  a.L = L;
  a.N = N;
  a.fov = fov;
  a.max_step = max_step;
  a.agents = agents;
  a.vec_usage = (W * L) % 4 == 0 && aligned(usage, 16) && aligned(usage_o, 16);
  a.rcp_y = rcp_y;
  a.rcp_x = rcp_x;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (version == 0) return launch<0>(a, smem, s);
  if (version == 1) return launch<1>(a, smem, s);
  return launch<2>(a, smem, s);
}
