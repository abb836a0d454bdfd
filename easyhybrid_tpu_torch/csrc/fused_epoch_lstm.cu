// Fused training epochs of the LSTM sequence hybrid for Hopper, sm_90a.
//
// Replaces the LSTM body of the Pallas TPU kernel built by make_fused_epoch in
// easyhybrid_tpu/ops/fused_epoch.py (kernel_body_lstm at :1700, chosen at
// :2479; pallas_call at :2662). One launch runs n_epochs x n_batches
// optimizer steps of a SingleNN hybrid whose network is an LSTM over windows
// of n_steps time steps with a Dense head. Each step:
//   1. gathers the batch's windows through the index perm[e][i*B + r];
//   2. the loss scale of every target over the whole (n_out_steps x B)
//      window: agg / max(sum(mask), 1) for mse and mae, agg / max(SST, 1e-12)
//      of the masked target about its masked mean for nseLoss; the batch is
//      valid when any mask is set;
//   3. per window: the static input norm with its trained scale and bias (or
//      none), then the recurrence z = wi x_t + wh h + b, gates i f g o,
//      c = f c + i g, h = o tanh(c) from h = c = 0, saving (x_t, h_t, c_t);
//   4. at the trailing n_out_steps steps: the head, sigmoid bound scaling,
//      the mechanistic model in its kernel form with its partials, the masked
//      loss term and its cotangent, the head's output cotangent;
//   5. backward through time, the gates recomputed from the checkpoints:
//      dh = dh_next + head^T D_t, dc += dh o (1 - tanh(c)^2), the four gate
//      cotangents dz, dh_next = wh^T dz, dc *= f; with a norm the cotangent
//      wi^T dz of the normed input feeds the norm's scale and bias;
//   6. gradients summed over the batch's windows and time steps in a fixed
//      order; an all-masked batch changes nothing; optax adam or sgd.
// Parameters and the step counter are read into shared memory once, stay
// there across every step of the launch and are written back once, with the
// last epoch's mean batch loss. The moments stay in device memory (each is
// touched once a step, by the update), which leaves shared memory to the
// parameters, the gradients and the windows' checkpoints.
//
// Design: kernel 2's (fused_epoch.cu). One block of 512 threads per model.
// The batch is cut into tiles of tile_rows windows (128, 64, 32, 16 or 8:
// the most whose checkpoints fit in 227 KB), and a window of a tile is walked
// through its time steps, the serial chain of the recurrence, by
// 512 / tile_rows threads (its lanes) that share out the hidden units: a lane
// computes its units' gates from the whole previous h, which every lane holds
// in registers (hidden size fixed at compile time: 8, 16, 32 or 64), with the
// weights read from shared memory as broadcasts, and the lanes meet at a
// barrier after each step. The tile's checkpoints and cotangents live in
// dynamic shared memory, feature-major with a row stride of tile_rows + 1
// (see eh_device.cuh). After each backward time step all 512 threads, one per
// parameter, sum that step's products over the tile's windows in window order
// into a shared-memory gradient accumulator: no atomics, the same bits on
// every run. (With one thread per window and 128 threads the same kernel took
// six times as long: two warps hide no latency.)
//
// What bounds it on an H100: operations, and before that latency. A window
// of LSTM(16) over 10 steps costs this kernel about 92,000 flops a step (the
// forward, the two backward products and, a quarter of it and no part of the
// function's bound, the recomputed gates), 45 times a quick-start MLP row,
// but it is 10 dependent cell evaluations forward and 10 backward, and
// each optimizer step needs the one before it. One block on one of 132 SMs
// leaves the card mostly idle. Nothing is done about that here beyond keeping
// the host out of the chain (one launch per eval block). Later: a gradient
// kernel over window tiles on many blocks with an update kernel behind it, as
// fused_multisite.cu, and the cell's products on tensor cores.
//
// Built without --use_fast_math, as fused_forward.cu.

#include "eh_device.cuh"

#define EH_LSTM_MAX_OUT 8
#define EH_LSTM_THREADS 512
#define EH_LSTM_SST_EPS 1e-12f

// Mirrored field by field by _Args in
// easyhybrid_tpu_torch/ops/fused_epoch_lstm.py; eh_fused_lstm_args_size()
// lets the wrapper check the two agree.
struct EhFusedLstmArgs {
  const float* x;                        // (n_rows, n_steps, n_features) row-major
  const float* forcing[EH_MAX_FORCING];  // (n_rows, n_steps) each
  const float* y[EH_MAX_TARGETS];        // (n_rows, n_out_steps) each, 0 where masked
  const float* mask[EH_MAX_TARGETS];     // (n_rows, n_out_steps) each, 0 or 1
  const int* perm;                       // (n_epochs, n_rows) window index
  float* params;                         // packed parameters, in place
  float* m;                              // first moments, in place
  float* v;                              // second moments, in place
  const float* bn;                       // the norm's mean, var (2 n_features)
  int* t;                                // step counter (1), in place
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* loss;                           // (1) last epoch's mean batch loss
  int64_t n_rows;
  int n_epochs;
  int n_batches;
  int batch;
  int n_steps;                           // input window T
  int n_out_steps;                       // output window: the trailing steps
  int n_features;
  int hidden;
  int n_out;                             // head outputs (neural parameters)
  int head_act;
  int norm_mode;                         // 0 none, 1 static
  float norm_eps;
  int n_params;
  int p_off_wi;                          // (4 hidden, n_features)
  int p_off_wh;                          // (4 hidden, hidden)
  int p_off_b;                           // (4 hidden)
  int p_off_hw;                          // (n_out, hidden)
  int p_off_hb;                          // (n_out)
  int p_off_g;                           // raw globals
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
  int loss_kind;                         // 0 squared, 1 absolute differences
  int loss_nse;                          // scale by the target's SST
  int opt;                               // 0 sgd, 1 adam
  float lr;
  float b1;
  float b2;
  float one_minus_b1;
  float one_minus_b2;
  float eps;
  int tile_rows;
  int res_floats;
};
// Packed parameters: [norm scale, norm bias] (n_features each, with a norm),
// then wi, wh, b, the head's W and b, the raw globals.

// Offsets, in tile columns, of what a window keeps in the residual tile.
struct EhLstmTile {
  int x, xhat, h, c, dz, dh, dc, hd, gg, gs, gb, total;
};

__host__ __device__ inline EhLstmTile ehl_tile(const EhFusedLstmArgs& a) {
  const int F = a.n_features, H = a.hidden, T = a.n_steps;
  const bool norm = a.norm_mode != NORM_NONE;
  EhLstmTile o;
  o.x = 0;                                  // the cell's input, per step
  o.xhat = norm ? T * F : 0;                // the normalised input, per step
  o.h = T * F * (norm ? 2 : 1);             // h after each step
  o.c = o.h + T * H;                        // c after each step
  o.dz = o.c + T * H;                       // one step's gate cotangents (4H)
  o.dh = o.dz + 4 * H;                      // dh carried to the step before
  o.dc = o.dh + H;                          // dc carried to the step before
  o.hd = o.dc + H;                          // head cotangents of the trailing steps
  o.gg = o.hd + a.n_out_steps * a.n_out;    // cotangents of the scaled globals
  o.gs = o.gg + a.n_globals;                // the window's norm scale gradient
  o.gb = o.gs + (norm ? F : 0);             // and norm bias gradient
  o.total = o.gb + (norm ? F : 0);
  return o;
}

// Pre-activations of the four gates of hidden unit j: x is the window's
// input column at this step (stride ld), hp the previous h.
template <int HT>
__device__ __forceinline__ void ehl_gates(const EhFusedLstmArgs& a, const float* Pm, int j,
                                          const float* x, int ld, const float (&hp)[HT],
                                          float* zi, float* zf, float* zg, float* zo) {
  const int F = a.n_features, H = a.hidden;
  const float* b = Pm + a.p_off_b;
  const float* wi_i = Pm + a.p_off_wi + j * F;
  const float* wi_f = wi_i + H * F;
  const float* wi_g = wi_f + H * F;
  const float* wi_o = wi_g + H * F;
  float si = b[j], sf = b[H + j], sg = b[2 * H + j], so = b[3 * H + j];
  for (int k = 0; k < F; ++k) {
    const float xv = x[k * ld];
    si = fmaf(wi_i[k], xv, si);
    sf = fmaf(wi_f[k], xv, sf);
    sg = fmaf(wi_g[k], xv, sg);
    so = fmaf(wi_o[k], xv, so);
  }
  const float* wh_i = Pm + a.p_off_wh + j * H;
  const float* wh_f = wh_i + H * H;
  const float* wh_g = wh_f + H * H;
  const float* wh_o = wh_g + H * H;
#pragma unroll
  for (int k = 0; k < HT; ++k) {
    if (k < H) {
      const float hk = hp[k];
      si = fmaf(wh_i[k], hk, si);
      sf = fmaf(wh_f[k], hk, sf);
      sg = fmaf(wh_g[k], hk, sg);
      so = fmaf(wh_o[k], hk, so);
    }
  }
  *zi = si;
  *zf = sf;
  *zg = sg;
  *zo = so;
}

template <int HT>
__global__ void __launch_bounds__(EH_LSTM_THREADS)
eh_fused_lstm_kernel(const __grid_constant__ EhFusedLstmArgs a) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int TR = a.tile_rows;
  const int ld = TR + 1;  // row stride of the residual tile
  // tid = s * TR + r: lane s of window r. A lane owns hidden units s, s + S, ...
  // With tiles of 32 windows or more a warp holds one lane of 32 windows, so
  // its weight reads are broadcasts and its tile reads fall in 32 banks.
  const int S = nth / TR;
  const int s = tid / TR;
  const int r = tid % TR;
  const int F = a.n_features;
  const int H = a.hidden;
  const int P = a.n_out;
  const int G = a.n_globals;
  const int K = a.n_fixed;
  const int NT = a.n_targets;
  const int NP = a.n_params;
  const int B = a.batch;
  const int T = a.n_steps;
  const int TO = a.n_out_steps;
  const bool norm = a.norm_mode != NORM_NONE;
  const int n_consts = 2 * P + 2 * G + K;
  const int p_base = norm ? 2 * F : 0;  // the first parameter after the norm's
  const EhLstmTile o = ehl_tile(a);

  float* Pm = sm;               // parameters
  float* Gr = Pm + NP;          // gradient accumulator
  float* BN = Gr + NP;          // the norm's mean, var
  float* C = BN + 2 * F;        // constants
  float* SC = C + n_consts;     // scaled globals, then fixed values
  float* DG = SC + G + K;       // d scaled global / d raw
  float* BM = DG + G;           // the norm's mean
  float* BR = BM + F;           // rsqrt(var + eps)
  float* SCL = BR + F;          // loss scale per target
  float* MISC = SCL + NT;       // [0] batch valid, [1] count, [2] mean
  float* RED = MISC + 4;        // two per-thread partials
  float* RES = RED + 2 * nth;   // residual tile

  for (int i = tid; i < NP; i += nth) Pm[i] = a.params[i];
  for (int i = tid; i < 2 * F; i += nth) BN[i] = norm ? a.bn[i] : 0.0f;
  for (int i = tid; i < n_consts; i += nth) C[i] = a.consts[i];
  for (int i = tid; i < K; i += nth) SC[G + i] = a.consts[2 * P + 2 * G + i];
  __syncthreads();
  for (int k = tid; k < F; k += nth) {
    BM[k] = BN[k];
    BR[k] = rsqrtf(BN[F + k] + a.norm_eps);
  }

  const float* nlo = C;
  const float* nspan = C + P;
  const float* glo = C + 2 * P;
  const float* gspan = C + 2 * P + G;
  const float* wi = Pm + a.p_off_wi;
  const float* wh = Pm + a.p_off_wh;
  const float* hw = Pm + a.p_off_hw;
  const float* hb = Pm + a.p_off_hb;
  float t_count = (float)a.t[0];  // every thread carries the same step count
  float last_loss = 0.0f;         // thread 0 only

  for (int e = 0; e < a.n_epochs; ++e) {
    float epoch_loss = 0.0f;  // thread 0 only
    for (int ib = 0; ib < a.n_batches; ++ib) {
      const int* idx = a.perm + (int64_t)e * a.n_rows + (int64_t)ib * B;

      // ---- loss scales over the whole (TO x B) window, batch validity ------
      float total = 0.0f;  // thread 0 only
      for (int j = 0; j < NT; ++j) {
        float cnt = 0.0f, ys = 0.0f;
        for (int i = tid; i < B * TO; i += nth) {
          const int64_t at = (int64_t)idx[i / TO] * TO + i % TO;
          cnt += a.mask[j][at];
          ys += a.y[j][at];
        }
        RED[tid] = cnt;
        RED[nth + tid] = ys;
        __syncthreads();
        if (tid == 0) {
          float c = 0.0f, ysum = 0.0f;
          for (int i = 0; i < nth; ++i) {
            c += RED[i];
            ysum += RED[nth + i];
          }
          const float n = fmaxf(c, 1.0f);
          total += c;
          MISC[2] = ysum / n;
          SCL[j] = a.agg_scale / n;
        }
        __syncthreads();
        if (a.loss_nse) {
          const float mu = MISC[2];
          float d2 = 0.0f;
          for (int i = tid; i < B * TO; i += nth) {
            const int64_t at = (int64_t)idx[i / TO] * TO + i % TO;
            const float d = (a.y[j][at] - mu) * a.mask[j][at];
            d2 += d * d;
          }
          RED[tid] = d2;
          __syncthreads();
          if (tid == 0) {
            float sst = 0.0f;
            for (int i = 0; i < nth; ++i) sst += RED[i];
            SCL[j] = a.agg_scale / fmaxf(sst, EH_LSTM_SST_EPS);
          }
          __syncthreads();
        }
      }
      if (tid == 0) MISC[0] = total > 0.0f ? 1.0f : 0.0f;
      for (int i = tid; i < NP; i += nth) Gr[i] = 0.0f;
      if (tid < G) {
        const float sg = ehe_sigmoid(Pm[a.p_off_g + tid]);
        SC[tid] = glo[tid] + gspan[tid] * sg;
        DG[tid] = gspan[tid] * (sg * (1.0f - sg));
      }
      __syncthreads();

      // ---- tiles of windows ----------------------------------------------------
      float loss_part = 0.0f;  // lane 0 of each window only
      for (int t0 = 0; t0 < B; t0 += TR) {
        const int rows_here = min(TR, B - t0);
        const bool active = r < rows_here;
        const int64_t row = active ? idx[t0 + r] : 0;
        float* res = RES + r;  // this window's column of the tile

        // ---- the cell's input at every step, the lanes sharing the (t, k) pairs ----
        if (active) {
          for (int q = s; q < T * F; q += S) {
            const int k = q % F;
            float xv = a.x[row * T * F + q];
            if (norm) {
              const float xh = (xv - BM[k]) * BR[k];
              res[(o.xhat + q) * ld] = xh;
              xv = xh * Pm[k] + Pm[F + k];
            }
            res[(o.x + q) * ld] = xv;
          }
        }
        __syncthreads();

        // ---- forward: the recurrence, the head at the trailing steps -------------
        float hp[HT];  // h before the step, whole, in every lane of the window
        float gacc[EH_MAX_SCALARS];
#pragma unroll
        for (int k = 0; k < HT; ++k) hp[k] = 0.0f;
#pragma unroll
        for (int j = 0; j < EH_MAX_SCALARS; ++j) gacc[j] = 0.0f;
        for (int t = 0; t < T; ++t) {
          if (active) {
            const float* xt = res + (o.x + t * F) * ld;
            for (int j = s; j < H; j += S) {
              float zi, zf, zg, zo;
              ehl_gates<HT>(a, Pm, j, xt, ld, hp, &zi, &zf, &zg, &zo);
              const float ig = ehe_sigmoid(zi);
              const float fg = ehe_sigmoid(zf);
              const float gg = tanhf(zg);
              const float og = ehe_sigmoid(zo);
              const float c_prev = t > 0 ? res[(o.c + (t - 1) * H + j) * ld] : 0.0f;
              const float c_new = fg * c_prev + ig * gg;
              res[(o.c + t * H + j) * ld] = c_new;
              res[(o.h + t * H + j) * ld] = og * tanhf(c_new);
            }
          }
          __syncthreads();  // the window's lanes have written all of h_t
          if (!active) continue;
#pragma unroll
          for (int k = 0; k < HT; ++k) hp[k] = k < H ? res[(o.h + t * H + k) * ld] : 0.0f;

          if (s != 0 || t < T - TO) continue;
          const int tt = t - (T - TO);
          float nv[EH_LSTM_MAX_OUT];    // the scaled neural outputs
          float dsc[EH_LSTM_MAX_OUT];   // d scaled / d head output
          float dact[EH_LSTM_MAX_OUT];  // d head output / d pre-activation
#pragma unroll
          for (int q = 0; q < EH_LSTM_MAX_OUT; ++q) {
            nv[q] = 0.0f;
            dsc[q] = 1.0f;
            dact[q] = 0.0f;
            if (q < P) {
              float z = hb[q];
#pragma unroll
              for (int k = 0; k < HT; ++k)
                if (k < H) z = fmaf(hw[q * H + k], hp[k], z);
              float d;
              float out = ehe_act(a.head_act, z, &d);
              dact[q] = d;
              if (a.scale_nn_outputs) {
                const float sg = ehe_sigmoid(out);
                dsc[q] = nspan[q] * (sg * (1.0f - sg));
                out = nlo[q] + nspan[q] * sg;
              }
              nv[q] = out;
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
                  val = col[row * T + t];
                  break;
                }
                case SRC_NEURAL: val = ehe_pick<EH_LSTM_MAX_OUT>(nv, id); break;
                case SRC_SCALAR: val = SC[id]; break;
                default: val = a.arg_const[i]; break;
              }
            }
            av[i] = val;
          }
          float out[EH_MAX_OUT];
          float pd[EH_MAX_OUT][EH_MAX_ARGS];
          ehe_form(a.form, av, out, pd);

          // the masked loss term and its cotangent
          float cot[EH_MAX_TARGETS];
          float term = 0.0f;
#pragma unroll
          for (int j = 0; j < EH_MAX_TARGETS; ++j) {
            cot[j] = 0.0f;
            if (j < NT) {
              const int64_t at = row * TO + tt;
              const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
              const float diff = (pred - a.y[j][at]) * a.mask[j][at];
              if (a.loss_kind == 0) {
                term += SCL[j] * diff * diff;
                cot[j] = (2.0f * SCL[j]) * diff;
              } else {
                term += SCL[j] * fabsf(diff);
                cot[j] = SCL[j] * (float)((diff > 0.0f) - (diff < 0.0f));
              }
            }
          }
          loss_part += term;

          // cotangents of the neural outputs and the scaled globals
          float dn[EH_LSTM_MAX_OUT];
#pragma unroll
          for (int q = 0; q < EH_LSTM_MAX_OUT; ++q) dn[q] = 0.0f;
#pragma unroll
          for (int i = 0; i < EH_MAX_ARGS; ++i) {
            if (i < a.n_args) {
              const int src = a.arg_src[i];
              const int id = a.arg_idx[i];
              if (src == SRC_NEURAL || (src == SRC_SCALAR && id < G)) {
                float c = 0.0f;
#pragma unroll
                for (int j = 0; j < EH_MAX_TARGETS; ++j) {
                  if (j < NT) {
                    float part = 0.0f;
#pragma unroll
                    for (int q = 0; q < EH_MAX_OUT; ++q)
                      part = (q == a.target_out[j]) ? pd[q][i] : part;
                    c += cot[j] * part;
                  }
                }
                if (src == SRC_NEURAL) {
#pragma unroll
                  for (int q = 0; q < EH_LSTM_MAX_OUT; ++q) dn[q] += (q == id) ? c : 0.0f;
                } else {
#pragma unroll
                  for (int j = 0; j < EH_MAX_SCALARS; ++j) gacc[j] += (j == id) ? c : 0.0f;
                }
              }
            }
          }
#pragma unroll
          for (int q = 0; q < EH_LSTM_MAX_OUT; ++q)
            if (q < P) res[(o.hd + tt * P + q) * ld] = (dn[q] * dsc[q]) * dact[q];
        }
        if (active) {
          if (s == 0) {
#pragma unroll
            for (int j = 0; j < EH_MAX_SCALARS; ++j)
              if (j < G) res[(o.gg + j) * ld] = gacc[j];
          }
          for (int k = s; k < H; k += S) {  // a lane carries dh and dc of its own units
            res[(o.dh + k) * ld] = 0.0f;
            res[(o.dc + k) * ld] = 0.0f;
          }
          if (norm) {
            for (int k = s; k < F; k += S) {
              res[(o.gs + k) * ld] = 0.0f;
              res[(o.gb + k) * ld] = 0.0f;
            }
          }
        }
        __syncthreads();  // the head cotangents are written

        // ---- backward through time ----------------------------------------------
        for (int t = T - 1; t >= 0; --t) {
          const bool trailing = t >= T - TO;
          const int tt = t - (T - TO);
          if (active) {
#pragma unroll
            for (int k = 0; k < HT; ++k)
              hp[k] = (k < H && t > 0) ? res[(o.h + (t - 1) * H + k) * ld] : 0.0f;
            const float* xt = res + (o.x + t * F) * ld;
            for (int j = s; j < H; j += S) {
              float dh = res[(o.dh + j) * ld];
              if (trailing) {  // the head's seed: dh += head_w^T D_t
                for (int q = 0; q < P; ++q) dh = fmaf(hw[q * H + j], res[(o.hd + tt * P + q) * ld], dh);
              }
              float zi, zf, zg, zo;
              ehl_gates<HT>(a, Pm, j, xt, ld, hp, &zi, &zf, &zg, &zo);
              const float ig = ehe_sigmoid(zi);
              const float fg = ehe_sigmoid(zf);
              const float gg = tanhf(zg);
              const float og = ehe_sigmoid(zo);
              const float c_prev = t > 0 ? res[(o.c + (t - 1) * H + j) * ld] : 0.0f;
              const float tanh_c = tanhf(res[(o.c + t * H + j) * ld]);
              const float dc = res[(o.dc + j) * ld] + dh * og * (1.0f - tanh_c * tanh_c);
              res[(o.dz + j) * ld] = (dc * gg) * ig * (1.0f - ig);
              res[(o.dz + H + j) * ld] = (dc * c_prev) * fg * (1.0f - fg);
              res[(o.dz + 2 * H + j) * ld] = (dc * ig) * (1.0f - gg * gg);
              res[(o.dz + 3 * H + j) * ld] = (dh * tanh_c) * og * (1.0f - og);
              res[(o.dc + j) * ld] = dc * fg;
            }
          }
          __syncthreads();  // the window's lanes have written all of dz

          if (active) {
            for (int k = s; k < H; k += S) {  // dh of the step before: wh^T dz
              float acc = 0.0f;
              for (int jj = 0; jj < 4 * H; ++jj) acc = fmaf(wh[jj * H + k], res[(o.dz + jj) * ld], acc);
              res[(o.dh + k) * ld] = acc;
            }
            if (norm) {  // the normed input's cotangent wi^T dz
              for (int k = s; k < F; k += S) {
                float acc = 0.0f;
                for (int jj = 0; jj < 4 * H; ++jj) acc = fmaf(wi[jj * F + k], res[(o.dz + jj) * ld], acc);
                res[(o.gs + k) * ld] += acc * res[(o.xhat + t * F + k) * ld];
                res[(o.gb + k) * ld] += acc;
              }
            }
          }

          // one thread per parameter sums this step's products over the windows
          for (int p = p_base + tid; p < a.p_off_g; p += nth) {
            const float* u = nullptr;   // summed alone, or times v
            const float* vv = nullptr;
            if (p < a.p_off_wh) {
              const int q = p - a.p_off_wi;
              u = RES + (o.dz + q / F) * ld;
              vv = RES + (o.x + t * F + q % F) * ld;
            } else if (p < a.p_off_b) {
              if (t == 0) continue;  // h before the first step is zero
              const int q = p - a.p_off_wh;
              u = RES + (o.dz + q / H) * ld;
              vv = RES + (o.h + (t - 1) * H + q % H) * ld;
            } else if (p < a.p_off_hw) {
              u = RES + (o.dz + (p - a.p_off_b)) * ld;
            } else if (!trailing) {
              continue;
            } else if (p < a.p_off_hb) {
              const int q = p - a.p_off_hw;
              u = RES + (o.hd + tt * P + q / H) * ld;
              vv = RES + (o.h + t * H + q % H) * ld;
            } else {
              u = RES + (o.hd + tt * P + (p - a.p_off_hb)) * ld;
            }
            float sum = 0.0f;
            if (vv != nullptr) {
              for (int r2 = 0; r2 < rows_here; ++r2) sum = fmaf(u[r2], vv[r2], sum);
            } else {
              for (int r2 = 0; r2 < rows_here; ++r2) sum += u[r2];
            }
            Gr[p] += sum;
          }
          __syncthreads();
        }

        // the norm's scale and bias and the globals: one sum per window tile
        for (int p = tid; p < NP; p += nth) {
          const float* u;
          if (p < p_base) {
            u = RES + ((p < F ? o.gs + p : o.gb + (p - F))) * ld;
          } else if (p >= a.p_off_g) {
            u = RES + (o.gg + (p - a.p_off_g)) * ld;
          } else {
            continue;
          }
          float sum = 0.0f;
          for (int r2 = 0; r2 < rows_here; ++r2) sum += u[r2];
          Gr[p] += sum;
        }
        __syncthreads();
      }

      // ---- batch loss, validity gate and the update ------------------------------
      RED[tid] = loss_part;
      __syncthreads();
      const float valid = MISC[0];
      const float t_new = t_count + valid;
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
          ehe_update(a, &Pm[p], &a.m[p], &a.v[p], g, bc1, bc2);
        }
      }
      t_count = t_new;
      __syncthreads();
    }
    last_loss = epoch_loss / (float)a.n_batches;
  }

  for (int i = tid; i < NP; i += nth) a.params[i] = Pm[i];
  if (tid == 0) {
    a.t[0] = (int)lrintf(t_count);
    a.loss[0] = last_loss;
  }
}

extern "C" int eh_fused_lstm_args_size(void) {
  return (int)sizeof(EhFusedLstmArgs);
}

// Shared-memory floats of one launch; ops/fused_epoch_lstm.py's
// _Sizes.smem_bytes computes the same.
static size_t ehl_smem_floats(const EhFusedLstmArgs* a) {
  const int F = a->n_features, P = a->n_out;
  const int G = a->n_globals, K = a->n_fixed, T = a->n_targets;
  return (size_t)2 * a->n_params + 2 * F + (2 * P + 2 * G + K) + (G + K) + G + 2 * F + T + 4 +
         2 * EH_LSTM_THREADS + (size_t)a->res_floats * (a->tile_rows + 1);
}

template <int HT>
static int ehl_launch(const EhFusedLstmArgs* args, size_t smem, cudaStream_t s) {
  // allow the full 227 KB once per hidden size, as fused_epoch.cu
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        eh_fused_lstm_kernel<HT>, cudaFuncAttributeMaxDynamicSharedMemorySize, EH_MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  eh_fused_lstm_kernel<HT><<<1, EH_LSTM_THREADS, smem, s>>>(*args);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes, devices and the envelope before it gets here.
extern "C" int eh_fused_lstm(const EhFusedLstmArgs* args, int width, void* stream) {
  if (args->n_epochs <= 0 || args->n_batches <= 0) return 0;
  const size_t smem = ehl_smem_floats(args) * sizeof(float);
  const int tr = args->tile_rows;
  if (smem > EH_MAX_SMEM_BYTES || args->res_floats != ehl_tile(*args).total ||
      args->hidden < 1 || args->hidden > width || args->n_features < 1 ||
      args->n_features > EH_MAX_WIDTH || args->n_out < 1 || args->n_out > EH_LSTM_MAX_OUT ||
      args->n_out_steps < 1 || args->n_out_steps > args->n_steps ||
      args->n_args > EH_MAX_ARGS || args->n_targets < 1 || args->n_targets > EH_MAX_TARGETS ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS ||
      (tr != 8 && tr != 16 && tr != 32 && tr != 64 && tr != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 8: return ehl_launch<8>(args, smem, s);
    case 16: return ehl_launch<16>(args, smem, s);
    case 32: return ehl_launch<32>(args, smem, s);
    case 64: return ehl_launch<64>(args, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
