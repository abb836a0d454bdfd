// Fused training epochs for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel built by make_fused_epoch in
// easyhybrid_tpu/ops/fused_epoch.py (run_kernel_epoch at :2128, its kernel at
// :2269 with kernel_body at :1268; pallas_call at :2662). One launch runs
// n_epochs x n_batches SGD steps of a SingleNN MLP hybrid. Each step:
//   1. gathers the batch's rows through the permutation index perm[e][i*B + r];
//   2. input norm: trainable BatchNorm (batch mean and biased variance, two
//      passes over the batch's rows, padding rows included, then the EMA of
//      the running statistics), static (the carried statistics) or none;
//   3. the MLP forward, saving each layer's input and activation derivative;
//      sigmoid bound scaling of the neural outputs; the scaled globals;
//   4. the mechanistic model in its kernel form, with its partials;
//   5. the masked mse and its cotangent, n = max(sum(mask), 1) per target,
//      agg sum or mean;
//   6. the hand-written backward through the form's partials, the bound
//      scaling and the MLP, including the norm's affine scale and bias;
//   7. the batch-validity gate: an all-masked batch changes nothing;
//   8. the optax adam or sgd update.
// Parameters, moments, the step counter and the BatchNorm statistics are read
// into shared memory once, stay there across every step of the launch, and
// are written back once at the end, with the last epoch's mean batch loss.
//
// Design: one thread block per model, one batch row per thread. The batch is
// cut into tiles of tile_rows rows (128, 64 or 32: the most that fits); a
// tile's residuals (layer inputs, activation derivatives overwritten by the
// cotangents, per-row global cotangents) live in dynamic shared memory,
// feature-major so that neighbouring threads touch neighbouring words, with
// a row stride of tile_rows + 1 so that the threads summing different
// features read different banks. After a tile's backward, one thread per
// parameter sums the tile's rows into a shared-memory gradient accumulator,
// in row order (deterministic). The update is one thread per parameter.
// Layer widths are fixed at compile time (16, 32 or 64) so the per-row
// vectors stay in registers.
//
// What bounds it on an H100: each SGD step needs the previous update, so the
// chain of steps is latency-bound. At the quick-start widths ([16, 16],
// batch 512) a row costs about 24 bytes of device memory (two predictors,
// one forcing, target, mask and index) and ~2,000 flops per step; one block
// on one of 132 SMs keeps the card mostly idle for one model. Today nothing
// is done about that beyond keeping the host out of the chain (one launch
// per eval block). Later: a grid axis over population members (one block
// per member), and tensor-core tiles for wide layers.
//
// Built without --use_fast_math, as fused_forward.cu.

#include "eh_device.cuh"

// Mirrored field by field by _Args in easyhybrid_tpu_torch/ops/fused_epoch.py;
// eh_fused_epoch_args_size() lets the wrapper check the two agree.
struct EhFusedEpochArgs {
  const float* x;                        // (n_rows, dims[0]) row-major
  const float* forcing[EH_MAX_FORCING];  // (n_rows,) each
  const float* y[EH_MAX_TARGETS];        // (n_rows,) each, 0 where masked
  const float* mask[EH_MAX_TARGETS];     // (n_rows,) each, 0 or 1
  const int* perm;                       // (n_epochs, n_rows) row index
  float* params;                         // packed parameters, in place
  float* m;                              // first moments, in place
  float* v;                              // second moments, in place
  float* bn;                             // running mean, var (2 dims[0]), in place
  int* t;                                // step counter (1), in place
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* loss;                           // (1) last epoch's mean batch loss
  int64_t n_rows;
  int n_epochs;
  int n_batches;
  int batch;
  int n_layers;
  int dims[EH_MAX_LAYERS + 1];
  int acts[EH_MAX_LAYERS];
  int norm_mode;                         // 0 none, 1 static, 2 trainable
  float norm_eps;
  float momentum;
  float one_minus_momentum;
  int n_params;
  int p_off_w[EH_MAX_LAYERS];
  int p_off_b[EH_MAX_LAYERS];
  int p_off_g;
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
  float agg_scale;
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
// Packed parameters: [norm scale, norm bias] (dims[0] each, with a norm);
// per layer W (dout x din, row-major) at p_off_w[l], b (dout) at p_off_b[l];
// raw globals at p_off_g. Residual tile: see eh_device.cuh.

template <int W>
__global__ void __launch_bounds__(128)
eh_fused_epoch_kernel(const __grid_constant__ EhFusedEpochArgs a) {
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
  const int NP = a.n_params;
  const int B = a.batch;
  const int n_consts = 2 * P + 2 * G + K;

  float* Pm = sm;               // parameters
  float* Mm = Pm + NP;          // first moments
  float* Vm = Mm + NP;          // second moments
  float* Gr = Vm + NP;          // gradient accumulator
  float* BN = Gr + NP;          // running mean, var
  float* C = BN + 2 * F;        // constants
  float* SC = C + n_consts;     // scaled globals, then fixed values
  float* DG = SC + G + K;       // d scaled global / d raw
  float* BM = DG + G;           // batch (or running) mean
  float* BR = BM + F;           // rsqrt(var + eps)
  float* BV = BR + F;           // batch variance
  float* NT = BV + F;           // max(sum(mask), 1) per target
  float* MISC = NT + T;         // [0] batch valid
  float* RED = MISC + 4;        // per-thread partials
  float* RES = RED + nth;       // residual tile, also the pre-pass scratch

  for (int i = tid; i < NP; i += nth) {
    Pm[i] = a.params[i];
    Mm[i] = a.m[i];
    Vm[i] = a.v[i];
  }
  for (int i = tid; i < 2 * F; i += nth) BN[i] = a.norm_mode != NORM_NONE ? a.bn[i] : 0.0f;
  for (int i = tid; i < n_consts; i += nth) C[i] = a.consts[i];
  for (int i = tid; i < K; i += nth) SC[G + i] = a.consts[2 * P + 2 * G + i];
  __syncthreads();

  const float* nlo = C;
  const float* nspan = C + P;
  const float* glo = C + 2 * P;
  const float* gspan = C + 2 * P + G;
  float t = (float)a.t[0];   // every thread carries the same step count
  float last_loss = 0.0f;    // thread 0 only

  for (int e = 0; e < a.n_epochs; ++e) {
    float epoch_loss = 0.0f;  // thread 0 only
    for (int ib = 0; ib < a.n_batches; ++ib) {
      const int* idx = a.perm + (int64_t)e * a.n_rows + (int64_t)ib * B;

      // ---- pre-pass: mask counts and the norm's batch mean ----------------
      {
        float cnt[EH_MAX_TARGETS];
        float xs[W];
#pragma unroll
        for (int j = 0; j < EH_MAX_TARGETS; ++j) cnt[j] = 0.0f;
#pragma unroll
        for (int k = 0; k < W; ++k) xs[k] = 0.0f;
        for (int r = tid; r < B; r += nth) {
          const int64_t row = idx[r];
#pragma unroll
          for (int j = 0; j < EH_MAX_TARGETS; ++j)
            if (j < T) cnt[j] += a.mask[j][row];
          if (a.norm_mode == NORM_TRAIN) {
#pragma unroll
            for (int k = 0; k < W; ++k)
              if (k < F) xs[k] += a.x[row * F + k];
          }
        }
#pragma unroll
        for (int j = 0; j < EH_MAX_TARGETS; ++j)
          if (j < T) RES[j * ld + tid] = cnt[j];
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < F) RES[(T + k) * ld + tid] = xs[k];
      }
      __syncthreads();
      for (int j = tid; j < T + F; j += nth) {
        if (j < T) {
          const float s = ehe_column_sum(RES, j, nth, ld);
          RED[j] = s;  // the raw count, for the validity flag below
          NT[j] = fmaxf(s, 1.0f);
        } else if (a.norm_mode == NORM_TRAIN) {
          BM[j - T] = ehe_column_sum(RES, j, nth, ld) / (float)B;
        }
      }
      __syncthreads();
      if (tid == 0) {
        float total = 0.0f;
        for (int j = 0; j < T; ++j) total += RED[j];
        MISC[0] = total > 0.0f ? 1.0f : 0.0f;
      }
      if (a.norm_mode == NORM_TRAIN) {
        // second pass: the biased variance around the batch mean
        float vs[W];
#pragma unroll
        for (int k = 0; k < W; ++k) vs[k] = 0.0f;
        for (int r = tid; r < B; r += nth) {
          const int64_t row = idx[r];
#pragma unroll
          for (int k = 0; k < W; ++k) {
            if (k < F) {
              const float dv = a.x[row * F + k] - BM[k];
              vs[k] += dv * dv;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < F) RES[k * ld + tid] = vs[k];
        __syncthreads();
        for (int k = tid; k < F; k += nth) {
          BV[k] = ehe_column_sum(RES, k, nth, ld) / (float)B;
          BR[k] = rsqrtf(BV[k] + a.norm_eps);
        }
      } else if (a.norm_mode == NORM_STATIC) {
        for (int k = tid; k < F; k += nth) {
          BM[k] = BN[k];
          BR[k] = rsqrtf(BN[F + k] + a.norm_eps);
        }
      }
      for (int i = tid; i < NP; i += nth) Gr[i] = 0.0f;
      if (tid < G) {
        const float s = ehe_sigmoid(Pm[a.p_off_g + tid]);
        SC[tid] = glo[tid] + gspan[tid] * s;
        DG[tid] = gspan[tid] * (s * (1.0f - s));
      }
      __syncthreads();

      // ---- tiles: forward, loss, backward per row; gradient sums ----------
      float loss_part = 0.0f;
      for (int t0 = 0; t0 < B; t0 += nth) {
        const int r = t0 + tid;
        const int rows_here = min(nth, B - t0);
        if (r < B) {
          const int64_t row = idx[r];
          float* res = RES + tid;
          float h[W];
#pragma unroll
          for (int k = 0; k < W; ++k) h[k] = (k < F) ? a.x[row * F + k] : 0.0f;
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
              const float s = ehe_sigmoid(h[j]);
              dsc[j] = nspan[j] * (s * (1.0f - s));
              h[j] = nlo[j] + nspan[j] * s;
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
                  val = col[row];
                  break;
                }
                case SRC_NEURAL: val = ehe_pick<W>(h, id); break;
                case SRC_SCALAR: val = SC[id]; break;
                default: val = a.arg_const[i]; break;
              }
            }
            av[i] = val;
          }
          float out[EH_MAX_OUT];
          float pd[EH_MAX_OUT][EH_MAX_ARGS];
          ehe_form(a.form, av, out, pd);

          // masked mse and its cotangent
          float cot[EH_MAX_TARGETS];
          float term = 0.0f;
#pragma unroll
          for (int j = 0; j < EH_MAX_TARGETS; ++j) {
            cot[j] = 0.0f;
            if (j < T) {
              const float mk = a.mask[j][row];
              const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
              const float diff = (pred - a.y[j][row]) * mk;
              const float scale = a.agg_scale / NT[j];
              term += scale * diff * diff;
              cot[j] = (2.0f * a.agg_scale / NT[j]) * diff;
            }
          }
          loss_part += term;

          // cotangents of the neural outputs and the scaled globals
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

          // backward through the MLP
          float D[W];
#pragma unroll
          for (int j = 0; j < W; ++j) D[j] = (j < P) ? dn[j] * dsc[j] : 0.0f;
          ehe_mlp_backward<W>(a, Pm, D, res, ld);
        }
        __syncthreads();

        // one thread per parameter sums the tile's rows
        for (int p = tid; p < NP; p += nth) {
          float s;
          if (p >= a.p_off_g) {
            const float* u = RES + (a.r_off_g + (p - a.p_off_g)) * ld;
            s = 0.0f;
            for (int r2 = 0; r2 < rows_here; ++r2) s += u[r2];
          } else {
            s = ehe_param_tile_sum(a, RES, ld, p, rows_here);
          }
          Gr[p] += s;
        }
        __syncthreads();
      }

      // ---- batch loss, validity gate and the update -------------------------
      RED[tid] = loss_part;
      __syncthreads();
      const float valid = MISC[0];
      const float t_new = t + valid;
      if (tid == 0 && valid > 0.0f) {
        float bl = 0.0f;
        for (int r2 = 0; r2 < nth; ++r2) bl += RED[r2];
        epoch_loss += bl;
      }
      if (valid > 0.0f) {
        const float tc = fmaxf(t_new, 1.0f);
        const float bc1 = 1.0f - powf(a.b1, tc);
        const float bc2 = 1.0f - powf(a.b2, tc);
        for (int p = tid; p < NP; p += nth) {
          float g = Gr[p];
          if (p >= a.p_off_g) g = g * DG[p - a.p_off_g];
          ehe_update(a, &Pm[p], &Mm[p], &Vm[p], g, bc1, bc2);
        }
        if (a.norm_mode == NORM_TRAIN) {
          for (int k = tid; k < F; k += nth) {
            BN[k] = a.one_minus_momentum * BN[k] + a.momentum * BM[k];
            BN[F + k] = a.one_minus_momentum * BN[F + k] + a.momentum * BV[k];
          }
        }
      }
      t = t_new;
      __syncthreads();
    }
    last_loss = epoch_loss / (float)a.n_batches;
  }

  for (int i = tid; i < NP; i += nth) {
    a.params[i] = Pm[i];
    a.m[i] = Mm[i];
    a.v[i] = Vm[i];
  }
  if (a.norm_mode != NORM_NONE)
    for (int i = tid; i < 2 * F; i += nth) a.bn[i] = BN[i];
  if (tid == 0) {
    a.t[0] = (int)lrintf(t);
    a.loss[0] = last_loss;
  }
}

extern "C" int eh_fused_epoch_args_size(void) {
  return (int)sizeof(EhFusedEpochArgs);
}

// Shared-memory floats of one launch; ops/fused_epoch.py::_smem_floats
// computes the same.
static size_t ehe_smem_floats(const EhFusedEpochArgs* a) {
  const int F = a->dims[0];
  const int P = a->dims[a->n_layers];
  const int G = a->n_globals, K = a->n_fixed, T = a->n_targets;
  const int res = a->res_floats > F + T ? a->res_floats : F + T;
  return (size_t)4 * a->n_params + 2 * F + (2 * P + 2 * G + K) + 2 * G + K + 3 * F + T + 4 +
         a->tile_rows + (size_t)res * (a->tile_rows + 1);
}

template <int W>
static int ehe_launch(const EhFusedEpochArgs* args, size_t smem, cudaStream_t s) {
  // allow the full 227 KB once per width: setting the attribute at every
  // launch would cost a host call that may wait for the device
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        eh_fused_epoch_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, EH_MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  eh_fused_epoch_kernel<W><<<1, args->tile_rows, smem, s>>>(*args);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes, devices and the envelope before it gets here.
extern "C" int eh_fused_epoch(const EhFusedEpochArgs* args, int width, void* stream) {
  if (args->n_epochs <= 0 || args->n_batches <= 0) return 0;
  const size_t smem = ehe_smem_floats(args) * sizeof(float);
  const int tr = args->tile_rows;
  if (smem > EH_MAX_SMEM_BYTES || args->n_layers < 1 || args->n_layers > EH_MAX_LAYERS ||
      args->n_args > EH_MAX_ARGS || args->n_targets < 1 || args->n_targets > EH_MAX_TARGETS ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS ||
      (tr != 32 && tr != 64 && tr != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 16: return ehe_launch<16>(args, smem, s);
    case 32: return ehe_launch<32>(args, smem, s);
    case 64: return ehe_launch<64>(args, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
