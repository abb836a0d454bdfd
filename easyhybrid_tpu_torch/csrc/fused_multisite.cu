// Fused multi-site training epochs for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel built by make_fused_multisite_epoch in
// easyhybrid_tpu/ops/fused_multisite.py (:249; run_launch at :1112, its
// kernel at :673; pallas_call at :1125). One call of the launcher enqueues
// every optimizer step of n_epochs x n_batches site batches of a
// MultiSiteHybridModel: one MLP shared by all sites over the (site, time)
// samples, and one raw value per site of every global parameter. Each step:
//   1. the batch's sites come through the site index site_index[e][b][j]
//      (-1 marks a padding slot: no data, no gradient);
//   2. per sample: static or no input norm, the MLP forward, sigmoid bound
//      scaling, the site's globals as lower + span * sigmoid(raw[s]), the
//      mechanistic model in its kernel form with its partials;
//   3. the masked loss and its cotangent with the batch-wide scale computed
//      by the caller (mse and nseLoss: scale * diff^2; mae: scale * |diff|);
//   4. the hand-written backward; the per-site gradient is the sum over the
//      site's samples, the shared gradient the sum over all of them;
//   5. the optax adam or sgd update of the shared parameters and of every
//      site's globals, in the batch or not (a site outside it has a zero
//      gradient, which still decays adam's moments), unless the batch holds
//      no valid target: then nothing changes.
//
// Design: two kernels per step, enqueued back to back on one stream, so the
// host never waits between steps.
//   * eh_ms_grad_kernel, a grid over chunks of the batch's sites. A block
//     owns whole sites, one thread per sample, in tiles of tile_rows samples
//     whose residuals live in shared memory (eh_device.cuh). A site's samples
//     are summed by one thread in time order into gsite (only this block
//     touches that site, so no atomics); the shared gradient is summed over
//     the block's tiles in shared memory and written, with the block's loss,
//     as one row of `partials`.
//   * eh_ms_update_kernel, one thread per shared parameter and per (global,
//     site): sums the rows of `partials` in block order and updates. No
//     float atomicAdd anywhere: the same inputs give the same bits.
//
// What bounds it on an H100: at the bench shape (8,000 sites x 64
// observations a step, MLP [16, 16]) a step reads 20 bytes a sample and does
// about 2,000 flops a sample, so operations bound it, not bytes; the layer
// products run on the float32 pipes with the weights broadcast from shared
// memory. Tensor-core tiles (wgmma) are for a later change.
//
// Built without --use_fast_math, as fused_forward.cu.

#include "eh_device.cuh"

// Mirrored field by field by _Args in easyhybrid_tpu_torch/ops/fused_multisite.py;
// eh_fused_multisite_args_size() lets the wrapper check the two agree.
struct EhFusedMultisiteArgs {
  const float* x;                        // (n_slots, n_obs, dims[0]) row-major
  const float* forcing[EH_MAX_FORCING];  // (n_slots, n_obs) each
  const float* y[EH_MAX_TARGETS];        // (n_slots, n_obs) each, 0 where masked
  const float* mask[EH_MAX_TARGETS];     // (n_slots, n_obs) each, 0 or 1
  const int* site_index;                 // (n_epochs, n_batches, batch), -1 padding
  const float* scale;                    // (n_epochs, n_batches, n_targets) loss scales
  const float* valid;                    // (n_epochs, n_batches) 1 if any target is valid
  const float* tcount;                   // (n_epochs, n_batches) step count after the step
  float* params;                         // n_shared shared, then n_globals x n_sites; in place
  float* m;                              // first moments, like params, in place
  float* v;                              // second moments, like params, in place
  const float* bn;                       // static norm mean, var (2 dims[0])
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* gsite;                          // (n_globals, n_sites) scratch, zero between steps
  float* partials;                       // (n_blocks, n_shared + 1) scratch
  float* epoch_loss;                     // (n_epochs) sum of valid batch losses, zero on entry
  int n_obs;
  int n_epochs;
  int n_batches;
  int batch;
  int n_sites;
  int sites_per_block;
  int n_blocks;
  int n_layers;
  int dims[EH_MAX_LAYERS + 1];
  int acts[EH_MAX_LAYERS];
  int norm_mode;                         // 0 none, 1 static
  float norm_eps;
  int n_shared;
  int p_off_w[EH_MAX_LAYERS];
  int p_off_b[EH_MAX_LAYERS];
  int n_globals;
  int n_fixed;
  int scale_nn_outputs;
  int form;
  int n_args;
  int arg_src[EH_MAX_ARGS];
  int arg_idx[EH_MAX_ARGS];
  float arg_const[EH_MAX_ARGS];
  int n_targets;
  int target_out[EH_MAX_TARGETS];
  int loss_kind;                         // 0 squared (mse, nseLoss), 1 absolute (mae)
  int opt;                               // 0 sgd, 1 adam
  float lr;
  float b1;
  float b2;
  float one_minus_b1;
  float one_minus_b2;
  float eps;
  int tile_rows;
  int res_floats;
  int r_off_xhat;
  int r_off_d0;
  int r_off_g;
  int r_off_h[EH_MAX_LAYERS];
  int r_off_d[EH_MAX_LAYERS];
};
// Shared parameters: [norm scale, norm bias] (dims[0] each, with a norm);
// per layer W (dout x din, row-major) at p_off_w[l], b (dout) at p_off_b[l].
// Global g of site s: params[n_shared + g * n_sites + s].

enum { LOSS_SQUARED = 0, LOSS_ABSOLUTE };

template <int W>
__global__ void __launch_bounds__(128)
eh_ms_grad_kernel(const __grid_constant__ EhFusedMultisiteArgs a, int step) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;  // == a.tile_rows
  const int ld = nth + 1;      // row stride of the residual tile
  const int F = a.dims[0];
  const int L = a.n_layers;
  const int P = a.dims[L];
  const int G = a.n_globals;
  const int K = a.n_fixed;
  const int T = a.n_targets;
  const int NP = a.n_shared;
  const int N = a.n_obs;
  const int S = a.n_sites;
  const int n_consts = 2 * P + 2 * G + K;

  float* Pm = sm;             // shared parameters
  float* Gr = Pm + NP;        // their gradient, summed over this block's tiles
  float* C = Gr + NP;         // constants
  float* BM = C + n_consts;   // norm mean
  float* BR = BM + F;         // rsqrt(var + eps)
  float* SCL = BR + F;        // loss scale per target
  float* RED = SCL + T;       // per-thread loss partials
  float* RES = RED + nth;     // residual tile

  for (int i = tid; i < NP; i += nth) {
    Pm[i] = a.params[i];
    Gr[i] = 0.0f;
  }
  for (int i = tid; i < n_consts; i += nth) C[i] = a.consts[i];
  for (int k = tid; k < F; k += nth) {
    BM[k] = a.norm_mode != NORM_NONE ? a.bn[k] : 0.0f;
    BR[k] = a.norm_mode != NORM_NONE ? rsqrtf(a.bn[F + k] + a.norm_eps) : 1.0f;
  }
  for (int j = tid; j < T; j += nth) SCL[j] = a.scale[(int64_t)step * T + j];
  __syncthreads();

  const float* nlo = C;
  const float* nspan = C + P;
  const float* glo = C + 2 * P;
  const float* gspan = C + 2 * P + G;
  const float* fixed = C + 2 * P + 2 * G;
  const int* idx = a.site_index + (int64_t)step * a.batch;
  const int j0 = blockIdx.x * a.sites_per_block;
  const int j1 = min(j0 + a.sites_per_block, a.batch);
  const int total = (j1 - j0) * N;  // this block's samples

  float loss_part = 0.0f;
  for (int q0 = 0; q0 < total; q0 += nth) {
    const int q = q0 + tid;
    const int rows_here = min(nth, total - q0);
    if (q < total) {
      const int s = idx[j0 + q / N];
      const bool live = s >= 0;
      const int64_t row = live ? (int64_t)s * N + q % N : 0;
      float* res = RES + tid;
      float h[W];
#pragma unroll
      for (int k = 0; k < W; ++k) h[k] = (k < F && live) ? a.x[row * F + k] : 0.0f;
      if (a.norm_mode != NORM_NONE) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (k < F) {
            const float xh = (h[k] - BM[k]) * BR[k];
            res[(a.r_off_xhat + k) * ld] = xh;
            h[k] = xh * Pm[k] + Pm[F + k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (k < F) res[(a.r_off_h[0] + k) * ld] = h[k];

      ehe_mlp_forward<W>(a, Pm, h, res, ld);

      // bound scaling of the neural outputs
      float dsc[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        dsc[j] = 1.0f;
        if (j < P && a.scale_nn_outputs) {
          const float sg = ehe_sigmoid(h[j]);
          dsc[j] = nspan[j] * (sg * (1.0f - sg));
          h[j] = nlo[j] + nspan[j] * sg;
        }
      }

      float av[EH_MAX_ARGS];
#pragma unroll
      for (int i = 0; i < EH_MAX_ARGS; ++i) {
        float val = 0.0f;
        if (i < a.n_args) {
          const int id = a.arg_idx[i];
          switch (a.arg_src[i]) {
            case SRC_FORCING: {
              const float* col = a.forcing[0];
#pragma unroll
              for (int f = 1; f < EH_MAX_FORCING; ++f) col = (f == id) ? a.forcing[f] : col;
              val = live ? col[row] : 0.0f;
              break;
            }
            case SRC_NEURAL: val = ehe_pick<W>(h, id); break;
            case SRC_SCALAR:
              if (id < G) {  // this site's global
                const float raw = live ? a.params[NP + (int64_t)id * S + s] : 0.0f;
                val = glo[id] + gspan[id] * ehe_sigmoid(raw);
              } else {
                val = fixed[id - G];
              }
              break;
            default: val = a.arg_const[i]; break;
          }
        }
        av[i] = val;
      }
      float out[EH_MAX_OUT];
      float pd[EH_MAX_OUT][EH_MAX_ARGS];
      ehe_form(a.form, av, out, pd);

      // masked loss and its cotangent; the mask selects, so a NaN target
      // that the caller did not zero cannot reach the sums
      float cot[EH_MAX_TARGETS];
      float term = 0.0f;
#pragma unroll
      for (int j = 0; j < EH_MAX_TARGETS; ++j) {
        cot[j] = 0.0f;
        if (j < T) {
          const bool on = live && a.mask[j][row] > 0.0f;
          const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
          const float diff = on ? pred - a.y[j][row] : 0.0f;
          const float sc = SCL[j];
          if (a.loss_kind == LOSS_ABSOLUTE) {
            term += sc * fabsf(diff);
            cot[j] = sc * (diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f));
          } else {
            term += sc * diff * diff;
            cot[j] = (2.0f * sc) * diff;
          }
        }
      }
      loss_part += term;

      // cotangents of the neural outputs and of the site's scaled globals
      float dn[W];
      float gg[EH_MAX_SCALARS];
#pragma unroll
      for (int j = 0; j < W; ++j) dn[j] = 0.0f;
#pragma unroll
      for (int j = 0; j < EH_MAX_SCALARS; ++j) gg[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < EH_MAX_ARGS; ++i) {
        if (i < a.n_args) {
          const int src = a.arg_src[i];
          const int id = a.arg_idx[i];
          if (src == SRC_NEURAL || (src == SRC_SCALAR && id < G)) {
            float c = 0.0f;
#pragma unroll
            for (int j = 0; j < EH_MAX_TARGETS; ++j) {
              if (j < T) {
                float part = 0.0f;
#pragma unroll
                for (int o = 0; o < EH_MAX_OUT; ++o)
                  part = (o == a.target_out[j]) ? pd[o][i] : part;
                c += cot[j] * part;
              }
            }
            if (src == SRC_NEURAL) {
#pragma unroll
              for (int j = 0; j < W; ++j) dn[j] += (j == id) ? c : 0.0f;
            } else {
#pragma unroll
              for (int j = 0; j < EH_MAX_SCALARS; ++j) gg[j] += (j == id) ? c : 0.0f;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < EH_MAX_SCALARS; ++j)
        if (j < G) res[(a.r_off_g + j) * ld] = gg[j];

      float D[W];
#pragma unroll
      for (int j = 0; j < W; ++j) D[j] = (j < P) ? dn[j] * dsc[j] : 0.0f;
      ehe_mlp_backward<W>(a, Pm, D, res, ld);
    }
    __syncthreads();

    // one thread per shared parameter sums the tile's rows
    for (int p = tid; p < NP; p += nth) Gr[p] += ehe_param_tile_sum(a, RES, ld, p, rows_here);
    // one thread per site of the tile sums the site's rows, in time order
    const int jf = q0 / N;
    const int jl = (q0 + rows_here - 1) / N;
    for (int jj = jf + tid; jj <= jl; jj += nth) {
      const int s = idx[j0 + jj];
      if (s >= 0) {
        const int r_lo = max(jj * N, q0) - q0;
        const int r_hi = min((jj + 1) * N, q0 + rows_here) - q0;
        for (int g = 0; g < G; ++g) {
          const float* u = RES + (a.r_off_g + g) * ld;
          float acc = 0.0f;
          for (int r2 = r_lo; r2 < r_hi; ++r2) acc += u[r2];
          a.gsite[(int64_t)g * S + s] += acc;
        }
      }
    }
    __syncthreads();
  }

  RED[tid] = loss_part;
  __syncthreads();
  float* part = a.partials + (int64_t)blockIdx.x * (NP + 1);
  for (int p = tid; p < NP; p += nth) part[p] = Gr[p];
  if (tid == 0) {
    float bl = 0.0f;
    for (int r2 = 0; r2 < nth; ++r2) bl += RED[r2];
    part[NP] = bl;
  }
}

__global__ void __launch_bounds__(256)
eh_ms_update_kernel(const __grid_constant__ EhFusedMultisiteArgs a, int step) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int NP = a.n_shared;
  const int S = a.n_sites;
  const int G = a.n_globals;
  const bool valid = a.valid[step] > 0.0f;
  const float tc = fmaxf(a.tcount[step], 1.0f);
  const float bc1 = 1.0f - powf(a.b1, tc);
  const float bc2 = 1.0f - powf(a.b2, tc);

  if (gid <= NP) {  // a shared parameter's gradient, or (gid == NP) the batch loss
    float g = 0.0f;
    for (int b = 0; b < a.n_blocks; ++b) g += a.partials[(int64_t)b * (NP + 1) + gid];
    if (valid) {
      if (gid == NP) {
        a.epoch_loss[step / a.n_batches] += g;
      } else {
        ehe_update(a, &a.params[gid], &a.m[gid], &a.v[gid], g, bc1, bc2);
      }
    }
  }
  if (gid < (int64_t)G * S) {  // global gid / S of site gid % S
    float g = a.gsite[gid];
    a.gsite[gid] = 0.0f;
    if (valid) {
      const int gi = (int)(gid / S);
      const int P = a.dims[a.n_layers];
      const float span = a.consts[2 * P + G + gi];
      const int64_t i = NP + gid;
      const float sg = ehe_sigmoid(a.params[i]);
      g = g * (span * (sg * (1.0f - sg)));
      ehe_update(a, &a.params[i], &a.m[i], &a.v[i], g, bc1, bc2);
    }
  }
}

extern "C" int eh_fused_multisite_args_size(void) {
  return (int)sizeof(EhFusedMultisiteArgs);
}

// Shared-memory floats of a gradient block; ops/fused_multisite.py::_smem_floats
// computes the same.
static size_t ehm_smem_floats(const EhFusedMultisiteArgs* a) {
  const int F = a->dims[0];
  const int P = a->dims[a->n_layers];
  const int G = a->n_globals, K = a->n_fixed, T = a->n_targets;
  return (size_t)2 * a->n_shared + (2 * P + 2 * G + K) + 2 * F + T + a->tile_rows +
         (size_t)a->res_floats * (a->tile_rows + 1);
}

template <int W>
static int ehm_launch(const EhFusedMultisiteArgs* args, size_t smem, cudaStream_t s) {
  // allow the full 227 KB once per width, not per launch: the call may wait
  // for the device
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        eh_ms_grad_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, EH_MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int64_t n_site_values = (int64_t)args->n_globals * args->n_sites;
  const int64_t n_update = n_site_values > args->n_shared + 1 ? n_site_values : args->n_shared + 1;
  const int update_blocks = (int)((n_update + 255) / 256);
  const int steps = args->n_epochs * args->n_batches;
  for (int step = 0; step < steps; ++step) {
    eh_ms_grad_kernel<W><<<args->n_blocks, args->tile_rows, smem, s>>>(*args, step);
    eh_ms_update_kernel<<<update_blocks, 256, 0, s>>>(*args, step);
  }
  return (int)cudaGetLastError();
}

// Enqueue every step of the call on `stream`; returns cudaGetLastError() (0
// on success). The caller checks shapes, devices and the envelope first.
extern "C" int eh_fused_multisite(const EhFusedMultisiteArgs* args, int width, void* stream) {
  if (args->n_epochs <= 0 || args->n_batches <= 0) return 0;
  const size_t smem = ehm_smem_floats(args) * sizeof(float);
  const int tr = args->tile_rows;
  if (smem > EH_MAX_SMEM_BYTES || args->n_layers < 1 || args->n_layers > EH_MAX_LAYERS ||
      args->n_args > EH_MAX_ARGS || args->n_targets < 1 || args->n_targets > EH_MAX_TARGETS ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS || args->n_obs < 1 ||
      args->sites_per_block < 1 ||
      (int64_t)args->n_blocks * args->sites_per_block < args->batch ||
      (tr != 32 && tr != 64 && tr != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 16: return ehm_launch<16>(args, smem, s);
    case 32: return ehm_launch<32>(args, smem, s);
    case 64: return ehm_launch<64>(args, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
