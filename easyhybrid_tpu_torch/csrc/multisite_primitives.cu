// The building blocks of the multi-site training kernel (fused_multisite.cu)
// as kernels of their own, for Hopper, sm_90a.
//
// Replaces the Pallas probe kernels of tools/probe_multisite_primitives.py
// (:32) and tools/probe_multisite_primitives2.py (:29), which checked on a
// TPU the primitives its multi-site kernel was built from (reshape between
// sample and (time, site) layouts, exact row select from packed tiles,
// masked row update, the select -> broadcast -> multiply -> reduce over time
// -> accumulate chain). The packed tiles and their reshapes have no
// counterpart here: per-site state is a plain (S,) array read through a site
// index. What this card's kernel does rely on is checked here instead:
//   * eh_prim_site_gather: a per-site value read through the site index and
//     broadcast over the site's time steps (-1 is a padding slot: 0);
//   * eh_prim_site_reduce: a per-site sum over time, in a fixed tree order;
//   * eh_prim_site_update: a masked update that writes the indexed sites and
//     leaves every other site's bits as they were;
//   * eh_prim_site_chain: gather -> multiply -> reduce over time (the same
//     tree) -> accumulate into the site's slot;
//   * eh_prim_block_sum: the sum of per-block partial rows in block order,
//     the same bits on every run.
// The gather and the update must be exact; the sums differ from another
// summation order by rounding only (a count of whole numbers is exact in
// any order). eh_prim_site_reduce also serves the training path: the
// per-site counts of valid targets come from it.
//
// All are bound by bytes: each reads its input once and does one add or
// multiply per element, so what matters is that every load of a warp
// covers whole 128-byte lines. A site's row is n_obs floats, and a thread
// that walked a row alone would put its warp's 32 loads on 32 different
// lines. So a row goes to a group of lanes (a power of two chosen from
// n_obs, 16 lanes for 64 observations), neighbouring lanes read neighbouring
// 16-byte pieces (4-byte ones where n_obs is no multiple of 4 or the base is
// not aligned), neighbouring groups neighbouring rows, and a shuffle tree of
// fixed shape adds the group's partials; one lane stores. A block of 256
// threads takes 256 / lanes sites, which at 8,000 sites x 64 is 500 blocks
// for the card's 132 multiprocessors.

#include "eh_device.cuh"  // eh_group_sum, eh_group_lanes: the lane-group row sum

__global__ void eh_prim_site_gather_kernel(const float* vals, const int* idx, float* out,
                                           int n_slots, int n_obs) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n_slots * n_obs) return;
  const int s = idx[i / n_obs];
  out[i] = s >= 0 ? vals[s] : 0.0f;
}

__global__ void eh_prim_site_reduce_kernel(const float* in, float* out, int n_slots, int n_obs,
                                           int lanes, int vec) {
  const int64_t thread = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = thread / lanes;
  const int64_t row = j < n_slots ? j : n_slots - 1;  // a tail lane repeats the last row
  const float sum = eh_group_sum(in + row * n_obs, n_obs, lanes, (int)(thread % lanes), vec, 1.0f);
  if (j < n_slots && thread % lanes == 0) out[j] = sum;
}

__global__ void eh_prim_site_update_kernel(float* vals, const int* idx, const float* fresh,
                                           int n_slots) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_slots) return;
  const int s = idx[j];
  if (s >= 0) vals[s] = fresh[j];
}

__global__ void eh_prim_site_chain_kernel(const float* vals, const int* idx, const float* x,
                                          float* acc, int n_slots, int n_obs, int lanes, int vec) {
  const int64_t thread = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = thread / lanes;
  const int64_t row = j < n_slots ? j : n_slots - 1;
  const int s = idx[row];
  const float v = s >= 0 ? vals[s] : 0.0f;
  const float sum = eh_group_sum(x + row * n_obs, n_obs, lanes, (int)(thread % lanes), vec, v);
  if (j < n_slots && s >= 0 && thread % lanes == 0) acc[s] += sum;
}

__global__ void eh_prim_block_sum_kernel(const float* partials, float* out, int n_blocks,
                                         int width) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= width) return;
  float acc = 0.0f;
  for (int b = 0; b < n_blocks; ++b) acc += partials[(int64_t)b * width + p];
  out[p] = acc;
}

static int blocks_for(int64_t n) { return (int)((n + 255) / 256); }

// Lanes that share a row of n_obs floats, and whether they read 16 bytes at a
// time: a power of two up to a warp, one load a lane where the row allows.
static int lanes_for(const float* base, int n_obs, int* vec) {
  *vec = n_obs % 4 == 0 && ((uintptr_t)base & 15) == 0;
  return eh_group_lanes(*vec ? n_obs / 4 : n_obs);
}

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int eh_prim_site_gather(const float* vals, const int* idx, float* out, int n_slots,
                                   int n_obs, void* stream) {
  if (n_slots <= 0 || n_obs <= 0) return 0;
  eh_prim_site_gather_kernel<<<blocks_for((int64_t)n_slots * n_obs), 256, 0,
                               (cudaStream_t)stream>>>(vals, idx, out, n_slots, n_obs);
  return (int)cudaGetLastError();
}

extern "C" int eh_prim_site_reduce(const float* in, float* out, int n_slots, int n_obs,
                                   void* stream) {
  if (n_slots <= 0) return 0;
  int vec;
  const int lanes = lanes_for(in, n_obs, &vec);
  eh_prim_site_reduce_kernel<<<blocks_for((int64_t)n_slots * lanes), 256, 0,
                               (cudaStream_t)stream>>>(in, out, n_slots, n_obs, lanes, vec);
  return (int)cudaGetLastError();
}

extern "C" int eh_prim_site_update(float* vals, const int* idx, const float* fresh, int n_slots,
                                   void* stream) {
  if (n_slots <= 0) return 0;
  eh_prim_site_update_kernel<<<blocks_for(n_slots), 256, 0, (cudaStream_t)stream>>>(
      vals, idx, fresh, n_slots);
  return (int)cudaGetLastError();
}

extern "C" int eh_prim_site_chain(const float* vals, const int* idx, const float* x, float* acc,
                                  int n_slots, int n_obs, void* stream) {
  if (n_slots <= 0) return 0;
  int vec;
  const int lanes = lanes_for(x, n_obs, &vec);
  eh_prim_site_chain_kernel<<<blocks_for((int64_t)n_slots * lanes), 256, 0,
                              (cudaStream_t)stream>>>(vals, idx, x, acc, n_slots, n_obs, lanes,
                                                      vec);
  return (int)cudaGetLastError();
}

extern "C" int eh_prim_block_sum(const float* partials, float* out, int n_blocks, int width,
                                 void* stream) {
  if (width <= 0) return 0;
  eh_prim_block_sum_kernel<<<blocks_for(width), 256, 0, (cudaStream_t)stream>>>(
      partials, out, n_blocks, width);
  return (int)cudaGetLastError();
}
