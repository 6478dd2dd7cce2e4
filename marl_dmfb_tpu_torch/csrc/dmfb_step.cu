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
// Bound on the H100: bytes.  Per chip and step (10x10 board, 4 droplets,
// fov 9) it reads about 0.75 KB (the usage board, the block mask, the
// health cells under the droplets, positions, goals, actions, draws) and
// writes about 1.5 KB (980 observation bytes, the new usage board, small
// per-droplet outputs), and does a few hundred integer operations: at
// 3.35 TB/s a batch of 16384 chips cannot take less than about 11 us.
//
// Design: one warp per chip.  The move/conflict logic is a short sequential
// loop over N <= 16 droplets with data-dependent reverts, so every lane runs
// it redundantly in registers (MAXN is a template bound, so the per-droplet
// arrays stay in registers) with direct board reads; that costs nothing
// extra and needs no broadcast.  Lane 0 then publishes the new positions to
// shared memory, and the 32 lanes stripe the observation bytes and the
// usage board so that consecutive lanes write consecutive addresses.  The
// TPU kernel's batch-minor layout and one-hot lookups were lane tricks for
// the TPU's vector unit and are not carried over.
//
// `usage` is not updated in place: the kernel writes a fresh usage board
// (old value plus wear), because the rollout keeps the old state of chips
// whose episode has ended.
//
// Interface: plain C, no PyTorch headers (built with nvcc, loaded with
// ctypes).  The launch function returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxDroplets = 16;

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
  int8_t* obs_o;             // (B, N, 3*fov*fov + 2)
  uint8_t* dones_o;          // (B, N) bool
  uint8_t* term_o;           // (B,) bool
  int32_t* cons_o;           // (B,)
  int32_t* succ_o;           // (B,)
  float* team_o;             // (B,)
  int B, W, L, N, fov, stall, max_step;
  float rcp_x, rcp_y;        // float32 1/scale of the direction zoom
};

// Direction zoom (envs/dmfb.py _zoom_dir): the JAX package's XLA program
// multiplies by the float32 reciprocal of the scale, and rintf is
// round-half-even like jnp.round.
__device__ __forceinline__ int zoom(int d, int hf, float rcp) {
  if (abs(d) <= hf) return d;
  if (d > 0) return static_cast<int>(rintf(__fmul_rn(static_cast<float>(d - hf), rcp))) + hf;
  return static_cast<int>(rintf(__fmul_rn(static_cast<float>(d + hf), rcp))) - hf;
}

template <int MAXN>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
dmfb_step_kernel(const StepArgs a) {
  __shared__ int s_px[kWarpsPerBlock][MAXN];
  __shared__ int s_py[kWarpsPerBlock][MAXN];
  __shared__ int s_gx[kWarpsPerBlock][MAXN];
  __shared__ int s_gy[kWarpsPerBlock][MAXN];
  __shared__ int s_wear[kWarpsPerBlock][MAXN];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= a.B) return;  // the whole warp leaves together

  const int N = a.N, W = a.W, L = a.L, WL = W * L;
  const int fov = a.fov, hf = fov / 2;
  const size_t bn = static_cast<size_t>(b) * N;
  const float* health = a.health + static_cast<size_t>(b) * WL;
  const uint8_t* block = a.block + static_cast<size_t>(b) * WL;

  int px[MAXN], py[MAXN], gx[MAXN], gy[MAXN], d[MAXN], qx[MAXN], qy[MAXN];
  int sta[MAXN], dyc[MAXN];
  float rew[MAXN];
  bool done_pre[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    if (i < N) {
      px[i] = a.pos[(bn + i) * 2];
      py[i] = a.pos[(bn + i) * 2 + 1];
      gx[i] = a.goal[(bn + i) * 2];
      gy[i] = a.goal[(bn + i) * 2 + 1];
      d[i] = a.dist[bn + i];
    } else {
      px[i] = py[i] = gx[i] = gy[i] = d[i] = 0;
    }
    qx[i] = px[i];  // past positions, for the dynamic constraint
    qy[i] = py[i];
    done_pre[i] = d[i] == 0;
    rew[i] = 0.f;
    sta[i] = 0;
    dyc[i] = 0;
  }

  // Sequential moves: droplet i sees droplets 0..i-1 at their new cells and
  // i+1..N-1 at their old ones.
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    if (i < N) {
      const int d_old = d[i];
      const bool already = a.stall && d_old == 0;
      const int act = a.actions[bn + i];
      const float prob = health[px[i] * L + py[i]];
      const bool moved = !already && a.uniforms[bn + i] <= prob;
      int cx = min(max(px[i] + (act == 1) - (act == 2), 0), W - 1);
      int cy = min(max(py[i] + (act == 4) - (act == 3), 0), L - 1);
      if (block[cx * L + cy]) {
        cx = px[i];
        cy = py[i];
      }
      bool occupied = false;
#pragma unroll
      for (int j = 0; j < MAXN; ++j) {
        if (j < N && j != i && px[j] == cx && py[j] == cy) occupied = true;
      }
      if (occupied) {
        cx = px[i];
        cy = py[i];
      }
      if (moved) {
        px[i] = cx;
        py[i] = cy;
      }
      const int d_new = abs(px[i] - gx[i]) + abs(py[i] - gy[i]);
      float r;
      if (d_new == d_old && d_old == 0) r = -0.1f;
      else if (d_new == d_old && act == 0) r = -0.25f;
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
        const int fx = qx[i] - px[j], fy = qy[i] - py[j];
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
  const int step = a.step_count[b] + 1;
  const int cumc = a.cum_constraints[b] + constraints;
  const bool within = step < a.max_step;

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
      if (lane == i) {  // lane i writes droplet i's outputs
        a.pos_o[(bn + i) * 2] = px[i];
        a.pos_o[(bn + i) * 2 + 1] = py[i];
        a.dist_o[bn + i] = d[i];
        a.rew_o[bn + i] = r;
        a.dones_o[bn + i] = done;
      }
      if (lane == 0) {
        s_px[warp][i] = px[i];
        s_py[warp][i] = py[i];
        s_gx[warp][i] = gx[i];
        s_gy[warp][i] = gy[i];
        s_wear[warp][i] = d[i] != 0;  // droplets not yet at their goal wear
      }
    }
  }
  if (lane == 0) {
    a.step_o[b] = step;
    a.cumc_o[b] = cumc;
    a.cons_o[b] = constraints;
    a.succ_o[b] = within && all_done && cumc == 0;
    a.term_o[b] = terminated;
    a.team_o[b] = team / static_cast<float>(N);
  }
  __syncwarp();

  // New usage board: old value plus one actuation under each droplet that
  // is not yet done.
  const float* usage = a.usage + static_cast<size_t>(b) * WL;
  float* usage_o = a.usage_o + static_cast<size_t>(b) * WL;
  for (int c = lane; c < WL; c += 32) {
    int wear = 0;
    for (int j = 0; j < N; ++j) {
      wear += s_wear[warp][j] && s_px[warp][j] * L + s_py[warp][j] == c;
    }
    usage_o[c] = usage[c] + static_cast<float>(wear);
  }

  // Observations: byte e of the chip's (N, 3*fov*fov + 2) block.
  const int f2 = fov * fov, od = 3 * f2 + 2, total = N * od;
  int8_t* obs = a.obs_o + static_cast<size_t>(b) * total;
  for (int e = lane; e < total; e += 32) {
    const int i = e / od, k = e - i * od;
    const int cx = s_px[warp][i], cy = s_py[warp][i];
    const int ox = cx - hf, oy = cy - hf;
    int v = 0;
    if (k < f2) {
      // layer 0: ids of the droplets in the FOV
      const int ax = ox + k / fov, ay = oy + k % fov;
      for (int j = 0; j < N; ++j) {
        if (s_px[warp][j] == ax && s_py[warp][j] == ay) v = max(v, j + 1);
      }
    } else if (k < 2 * f2) {
      // layer 1: goals of the visible other droplets, clipped into the FOV;
      // the max id wins
      const int r = (k - f2) / fov, c = (k - f2) % fov;
      for (int j = 0; j < N; ++j) {
        if (j != i && abs(s_px[warp][j] - cx) <= hf && abs(s_py[warp][j] - cy) <= hf) {
          const int g1x = min(max(s_gx[warp][j] - ox, 0), fov - 1);
          const int g1y = min(max(s_gy[warp][j] - oy, 0), fov - 1);
          if (g1x == r && g1y == c) v = max(v, j + 1);
        }
      }
    } else if (k < 3 * f2) {
      // layer 2: blocks at the ABSOLUTE cell (r, c) (a reference quirk),
      // overwritten by walls where the FOV leaves the board
      const int r = (k - 2 * f2) / fov, c = (k - 2 * f2) % fov;
      const int ax = ox + r, ay = oy + c;
      v = (ax < 0 || ax > W - 1 || ay < 0 || ay > L - 1) ? 1 : (block[r * L + c] != 0);
    } else if (k == 3 * f2) {
      v = zoom(s_gx[warp][i] - cx, hf, a.rcp_x);
    } else {
      v = zoom(s_gy[warp][i] - cy, hf, a.rcp_y);
    }
    obs[e] = static_cast<int8_t>(v);
  }
}

}  // namespace

extern "C" int dmfb_step_launch(
    const void* pos, const void* dist, const void* goal, const void* health,
    const void* usage, const void* block, const void* actions,
    const void* uniforms, const void* step_count, const void* cum_constraints,
    void* pos_o, void* dist_o, void* usage_o, void* step_o, void* cumc_o,
    void* rew_o, void* obs_o, void* dones_o, void* term_o, void* cons_o,
    void* succ_o, void* team_o, int B, int W, int L, int N, int fov,
    int stall, int max_step, float rcp_x, float rcp_y, void* stream) {
  if (B < 1 || N < 1 || N > kMaxDroplets || fov < 1 || fov > W || fov > L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  a.rcp_x = rcp_x;
  a.rcp_y = rcp_y;

  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 threads(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 4) {
    dmfb_step_kernel<4><<<grid, threads, 0, s>>>(a);
  } else if (N <= 8) {
    dmfb_step_kernel<8><<<grid, threads, 0, s>>>(a);
  } else {
    dmfb_step_kernel<kMaxDroplets><<<grid, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
