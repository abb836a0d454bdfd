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
//      by the caller (eh_device.cuh, ehe_loss_row: mse and nseLoss scale *
//      diff^2, mae scale * |diff|, a traced elementwise loss scale * l(yh, y));
//      rmse (one target) as the JAX kernel defers it: the raw sum of diff^2
//      and the gradient of the raw cotangent 2 diff, summed across blocks, then
//      scaled in the update by (1 / n) / (2 max(r, 1e-30)), r = sqrt(sse / n);
//   4. the hand-written backward; the per-site gradient is the sum over the
//      site's samples, the shared gradient the sum over all of them;
//   5. the update of the shared parameters and of every site's globals by
//      any of the optax rules of the JAX kernel (eh_device.cuh, ehe_update),
//      in the batch or not (a site outside it has a zero gradient, which
//      still decays adam's moments), unless the batch holds no valid target:
//      then nothing changes.
//
// What bounds it on an H100: at the bench shape (8,000 sites x 64
// observations a step, MLP [16, 16]) a step reads 20 bytes a sample and does
// about 1,800 flops a sample, so operations bound it, not bytes: ~0.014 ms of
// float32 FMA over the card. What a step costs in practice is the instruction
// stream of a row (its layer products, activations, form and backward) and of
// the gradient sums, spread over the 132 multiprocessors.
//
// Design: two kernels per step, enqueued back to back on one stream, so the
// host never waits between steps. No float atomics anywhere, and every sum
// has a fixed order: the same inputs give the same bits.
//   * eh_ms_grad_kernel, a grid over the batch's sites cut by
//     ops/fused_multisite.py::multisite_geometry. A block owns whole sites and
//     walks them in tiles of one row a thread: several whole sites a tile, or
//     a site longer than a tile in several. Rows run kernel 2's row code
//     (eh_device.cuh: layers at their own size, 16-byte broadcast weight
//     loads from the padded parameter layout, branch-free sigmoids), with
//     their residuals in a tile in shared memory. A tile's rows (predictors,
//     forcing, targets, masks) and its sites' raw globals are staged in
//     shared memory by cp.async, the next tile's copies in flight while the
//     current tile's sums run.
//   * Per tile, the shared gradient is taken by warps over 4 x 4 units with
//     the fixed folding tree (eh_device.cuh), added into the block's partial
//     row in tile order; each site's gradient by a group of lanes with a
//     fixed shuffle tree (the lane-group sum of multisite_primitives.cu's
//     site_reduce), written once per site (a site longer than a tile is
//     summed over its tiles in order first). The block writes one partial
//     row: its shared gradient and its loss.
//   * eh_ms_update_kernel: a warp per shared parameter (and one for the
//     loss) sums the blocks' partial rows, its lanes in a fixed stride and
//     then a fixed shuffle tree, and updates; a thread per (global, site)
//     updates that site's value. Its sum no longer caps the grid. Under
//     lamb it runs twice: first each block writes its part of every leaf's
//     norms (a per-site global's values over all sites are one leaf, as
//     optax sees the stacked leaf), then every block adds those parts in
//     block order, a warp a leaf, and updates.
//
// The member axis (population training: a seed ensemble of one model,
// replacing the JAX kernel under jax.vmap in
// easyhybrid_tpu/training/population.py:241-287): one call trains n_members
// models side by side, the gradient kernel on the grid (site blocks,
// n_members) and the update kernel on (update blocks, n_members), the member
// blockIdx.y. Member k's parameters, slots, static norm statistics, step
// counts (tcount), per-site gradient, partial rows, lamb parts and epoch
// losses are the k-th rows of their arrays; its site index, loss scales and validity flags sit
// step_stride steps further on (0 where the members share one set). The
// data, the bounds and the constants are the model's, one set for every
// member. The members share nothing and never wait on one another, so a
// member's bits are those of a call of it alone; the loop below still
// enqueues two kernels a step (three under lamb) for all of them.
//
// Built with -DEHM_STAMPS, thread 0 of block 0 adds the clock64() cycles it
// spends in each stage of a step to a.stamps when the kernel ends: 0 waiting
// for the tile's staged rows (with the block's start), 1 forward to loss,
// 2 backward, 3 starting the next tile's copies, 4 the shared gradient's
// units, 5 the per-site sums, 6 the block's end (loss, partial row), 7 the
// whole kernel.
//
// Built without --use_fast_math, as fused_forward.cu.

#include "eh_device.cuh"

// Threads a gradient block may have (one row each).
#define EHM_MAX_THREADS 256

// Mirrored field by field by _Args in easyhybrid_tpu_torch/ops/fused_multisite.py;
// eh_fused_multisite_args_size() lets the wrapper check the two agree.
struct EhFusedMultisiteArgs {
  const float* x;                        // (n_slots, n_obs, dims[0]) row-major
  const float* forcing[EH_MAX_FORCING];  // (n_slots, n_obs) each
  const float* y[EH_MAX_TARGETS];        // (n_slots, n_obs) each, 0 where masked
  const float* mask[EH_MAX_TARGETS];     // (n_slots, n_obs) each, 0 or 1
  const int* site_index;                 // (n_epochs, n_batches, batch), -1 padding
  const float* scale;                    // (n_epochs, n_batches, n_targets) loss scales (rmse: 1 / n)
  const float* valid;                    // (n_epochs, n_batches) 1 if any target is valid
  const float* tcount;                   // (n_members, n_epochs, n_batches) step count after the step
  float* params;                         // a member's n_shared shared, then n_globals x n_sites; in place
  float* m;                              // first moments, like params, in place
  float* v;                              // second moments, like params, in place
  float* u;                              // amsgrad's third slot, like params (else unused)
  const float* bn;                       // static norm mean, var (2 dims[0]) a member
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* gsite;                          // (n_members, n_globals, n_sites) scratch, zero between steps
  float* partials;                       // (n_members, n_blocks, n_shared + 1) scratch
  float* lamb_parts;                     // lamb: (n_members, update blocks, 2 n_leaves) scratch, else unused
  float* epoch_loss;                     // (n_members, n_epochs) sum of valid batch losses, zero on entry
  long long* stamps;                     // (EHM_N_STAMPS) cycles per stage, or null
  int n_obs;
  int n_epochs;
  int n_batches;
  int batch;
  int n_sites;
  int threads;                           // a tile's rows, one a thread
  int tile_sites;                        // sites a tile holds (1 when a site takes several)
  int site_tiles;                        // tiles a site takes (1 unless n_obs > threads)
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
  int p_off_g;                           // == n_shared: the globals are per site, not in a unit
  int n_padded;                          // shared parameters with weight rows padded to 4
  int pp_off_w[EH_MAX_LAYERS];           // the padded layout's offsets
  int pp_off_b[EH_MAX_LAYERS];
  int pp_off_g;
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
  int loss_kind;                         // LOSS_* (eh_device.cuh): squared, absolute, rmse, traced
  EhOptimizer optimizer;                 // the rule and its hyperparameters
  int n_forcing;
  int res_floats;                        // floats a row keeps in the tile
  int r_off_xhat;
  int r_off_d0;
  int r_off_g;
  int r_off_h[EH_MAX_LAYERS];
  int r_off_d[EH_MAX_LAYERS];
  int r_off_out;                         // the network's outputs, then their cotangents
  int r_off_dsc;                         // the bound scaling's derivative
  int r_off_one;                         // a feature that is 1 on every row
  int n_unit_table;                      // gradient units described once a block
  const int* halt;                       // the halt word (eh_halted), or null
  int n_members;                         // models trained side by side (1: train())
  int64_t step_stride;                   // steps between two members' site_index, scale, valid (0: shared)
};
// Shared parameters: [norm scale, norm bias] (dims[0] each, with a norm);
// per layer W (dout x din, row-major) at p_off_w[l], b (dout) at p_off_b[l].
// Global g of site s: params[n_shared + g * n_sites + s]. In shared memory the
// shared parameters use the padded layout (eh_device.cuh, ehe_padded_index).
// Residual tile: word (off + k) * threads + r for feature k of row r.

#define EHM_N_STAMPS 8
#ifdef EHM_STAMPS
#define EHM_STAMP(k)                                 \
  do {                                               \
    if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) { \
      const long long now = clock64();               \
      stamp_acc[k] += now - stamp_last;              \
      stamp_last = now;                              \
    }                                                \
  } while (0)
#else
#define EHM_STAMP(k)
#endif

// Two blocks a multiprocessor, what multisite_geometry aims at: the bound
// gives ptxas a budget of 128 registers a thread, where on its own it chose
// 80 at width 16 and spilled (4% slower a step on an NVIDIA H100 80GB HBM3
// at 700 W).
template <int W>
__global__ void __launch_bounds__(EHM_MAX_THREADS, 2)
eh_ms_grad_kernel(const __grid_constant__ EhFusedMultisiteArgs a, int step) {
  if (eh_halted(a.halt)) return;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;  // == a.threads
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nth >> 5;
  const int ld = nth;  // row stride of the residual tile and of a stage
  const int F = a.dims[0];
  const int L = a.n_layers;
  const int P = a.dims[L];
  const int G = a.n_globals;
  const int K = a.n_fixed;
  const int T = a.n_targets;
  const int NF = a.n_forcing;
  const int NP = a.n_shared;
  const int N = a.n_obs;
  const int S = a.n_sites;
  const int n_consts = 2 * P + 2 * G + K;
  const int cols = F + NF + 2 * T;             // a stage's columns
  // member k's state and scratch: the k-th rows of their arrays; its per-step rows
  const int64_t member = blockIdx.y;           // a population's member, 0 for train()
  const float* const params = a.params + member * (NP + (int64_t)G * S);
  float* const gsite = a.gsite + member * (int64_t)G * S;
  const float* const bn = a.bn + member * 2 * F;
  const int64_t srow = member * a.step_stride + step;
  const int stage_floats = cols * ld + a.tile_sites * G;  // the rows, then the sites' raw globals

  float* Pm = sm;                 // shared parameters, padded layout
  float* Gr = Pm + a.n_padded;    // their gradient, summed over this block's tiles
  float* C = Gr + NP;             // constants
  float* BM = C + n_consts;       // norm mean
  float* BR = BM + F;             // rsqrt(var + eps)
  float* SCL = BR + F;            // loss scale per target
  float* XL = SCL + T;            // loss partials, one a warp
  float* GS = XL + nw;            // a long site's sums over its tiles so far
  int* UT = reinterpret_cast<int*>(GS + G);  // the first units, 8 ints each
  float* RES = reinterpret_cast<float*>(UT + 8 * a.n_unit_table);  // residual tile
  float* ST = RES + a.res_floats * ld;       // the two stages
#ifdef EHM_STAMPS
  long long stamp_acc[EHM_N_STAMPS] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long stamp_first = clock64();
  long long stamp_last = stamp_first;
#endif

  const int* idx = a.site_index + srow * a.batch;
  const int j0 = blockIdx.x * a.sites_per_block;
  const int n_mine = min(a.sites_per_block, a.batch - j0);  // this block's sites, at least 1
  const int chunks = a.site_tiles;
  const int n_tiles = chunks > 1 ? n_mine * chunks : (n_mine + a.tile_sites - 1) / a.tile_sites;

  // Tile k: ns sites from the block's site fs, observations [t0, t0 + nobs)
  // of each; its row r is site fs + r / nobs, observation t0 + r % nobs.
  struct Tile {
    int fs, ns, t0, nobs;
  };
  auto tile_of = [&](int k) {
    Tile t;
    if (chunks > 1) {
      t.fs = k / chunks;
      t.ns = 1;
      t.t0 = (k - t.fs * chunks) * nth;
      t.nobs = min(nth, N - t.t0);
    } else {
      t.fs = k * a.tile_sites;
      t.ns = min(a.tile_sites, n_mine - t.fs);
      t.t0 = 0;
      t.nobs = N;
    }
    return t;
  };
  // Start the copies of tile k's rows (zeros for a padding slot) and of its
  // sites' raw globals, each loaded once a site, into stage k & 1.
  auto stage_tile = [&](int k) {
    const Tile t = tile_of(k);
    float* dst = ST + (k & 1) * stage_floats;
    if (tid < t.ns * t.nobs) {
      const int i = tid / t.nobs;
      const int s = idx[j0 + t.fs + i];
      if (s >= 0) {
        const int64_t row = (int64_t)s * N + t.t0 + (tid - i * t.nobs);
        for (int c = 0; c < F; ++c) ehe_cp_async4(dst + c * ld + tid, a.x + row * F + c);
        for (int f = 0; f < NF; ++f) ehe_cp_async4(dst + (F + f) * ld + tid, a.forcing[f] + row);
        for (int j = 0; j < T; ++j) {
          ehe_cp_async4(dst + (F + NF + j) * ld + tid, a.y[j] + row);
          ehe_cp_async4(dst + (F + NF + T + j) * ld + tid, a.mask[j] + row);
        }
      } else {
        for (int c = 0; c < cols; ++c) dst[c * ld + tid] = 0.0f;
      }
    }
    // site i's global g at i * G + g; a tile may hold more of them than it
    // has threads (G above the observations a site)
    for (int q = tid; q < t.ns * G; q += nth) {
      const int i = q / G;
      const int s = idx[j0 + t.fs + i];
      float* d = dst + cols * ld + q;
      if (s >= 0) {
        ehe_cp_async4(d, params + NP + (int64_t)(q - i * G) * S + s);
      } else {
        *d = 0.0f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  stage_tile(0);
  for (int i = tid; i < a.n_padded; i += nth) Pm[i] = 0.0f;
  for (int i = tid; i < n_consts; i += nth) C[i] = a.consts[i];
  for (int k = tid; k < F; k += nth) {
    BM[k] = a.norm_mode != NORM_NONE ? bn[k] : 0.0f;
    BR[k] = a.norm_mode != NORM_NONE ? rsqrtf(bn[F + k] + a.norm_eps) : 1.0f;
  }
  for (int j = tid; j < T; j += nth) SCL[j] = a.scale[srow * T + j];
  for (int u = tid; u < a.n_unit_table; u += nth) ehe_unit_describe(a, UT, u);
  RES[a.r_off_one * ld + tid] = 1.0f;
  __syncthreads();
  for (int i = tid; i < NP; i += nth) Pm[ehe_padded_index(a, i)] = params[i];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  EHM_STAMP(0);

  const float* nlo = C;
  const float* nspan = C + P;
  const float* glo = C + 2 * P;
  const float* gspan = C + 2 * P + G;
  const float* fixed = C + 2 * P + 2 * G;
  const int n_units = ehe_n_units(a, false);  // the shared parameters' units
  float loss_part = 0.0f;

  for (int k = 0; k < n_tiles; ++k) {
    const Tile t = tile_of(k);
    const int rows = t.ns * t.nobs;
    const float* st = ST + (k & 1) * stage_floats;  // this tile's staged rows, landed
    if (tid < rows) {
      float* res = RES + tid;
      float h[1][W];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        float x = 0.0f;
        if (c < F) {
          x = st[c * ld + tid];
          if (a.norm_mode != NORM_NONE) {
            const float xh = (x - BM[c]) * BR[c];
            res[(a.r_off_xhat + c) * ld] = xh;
            x = xh * Pm[c] + Pm[F + c];
          }
          res[(a.r_off_h[0] + c) * ld] = x;
        }
        h[0][c] = x;
      }

      ehe_row_forward<W, 1, true>(a, Pm, h, res, ld, 0);

      // The row's small vectors (the network's P outputs, the G globals'
      // cotangents) live in the row's column of the tile, walked by loops of
      // their own length. Bound scaling of the neural outputs: the scaled
      // value in place, its derivative beside it.
      float* outv = res + a.r_off_out * ld;
      float* dscv = res + a.r_off_dsc * ld;
      for (int j = 0; j < P; ++j) {
        float y = outv[j * ld];
        float ds = 1.0f;
        if (a.scale_nn_outputs) {
          const float sg = ehe_sigmoid_nb(y);
          ds = nspan[j] * (sg * (1.0f - sg));
          y = nlo[j] + nspan[j] * sg;
        }
        outv[j * ld] = y;
        dscv[j * ld] = ds;
      }

      const float* raw = st + cols * ld + (tid / t.nobs) * G;  // the row's site's raw globals
      float av[EH_MAX_ARGS];
#pragma unroll
      for (int i = 0; i < EH_MAX_ARGS; ++i) {
        float val = 0.0f;
        if (i < a.n_args) {
          const int id = a.arg_idx[i];
          switch (a.arg_src[i]) {
            case SRC_FORCING: val = st[(F + id) * ld + tid]; break;
            case SRC_NEURAL: val = outv[id * ld]; break;
            case SRC_SCALAR:
              val = id < G ? glo[id] + gspan[id] * ehe_sigmoid_nb(raw[id]) : fixed[id - G];
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
      // that the caller did not zero cannot reach the sums. rmse: the raw
      // squared loss, scaled in the update
      float cot[EH_MAX_TARGETS];
      float term = 0.0f;
#pragma unroll
      for (int j = 0; j < EH_MAX_TARGETS; ++j) {
        cot[j] = 0.0f;
        if (j < T) {
          const bool on = st[(F + NF + T + j) * ld + tid] > 0.0f;
          const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
          const float yv = st[(F + NF + j) * ld + tid];
          const float diff = on ? pred - yv : 0.0f;
          EhLossCoef c = {};
          c.c0 = a.loss_kind == LOSS_RMSE ? 1.0f : SCL[j];
          c.c1 = 2.0f * c.c0;
          term += ehe_loss_row<false>(a.loss_kind == LOSS_RMSE ? LOSS_SQUARED : a.loss_kind, c,
                               on ? pred : 0.0f, on ? yv : 0.0f, on ? 1.0f : 0.0f, diff, cot[j]);
        }
      }
      loss_part += term;
      EHM_STAMP(1);

      // cotangents of the neural outputs (gathered where the outputs were)
      // and of the site's scaled globals
      for (int j = 0; j < P; ++j) outv[j * ld] = 0.0f;
      for (int j = 0; j < G; ++j) res[(a.r_off_g + j) * ld] = 0.0f;
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
            float* slot = src == SRC_NEURAL ? outv + id * ld : res + (a.r_off_g + id) * ld;
            *slot += c;
          }
        }
      }
      // the last layer's pre-activation cotangent, then backward through the MLP
      {
        float* zd = res + a.r_off_d[L - 1] * ld;
        for (int j = 0; j < P; ++j) zd[j * ld] = (outv[j * ld] * dscv[j * ld]) * zd[j * ld];
      }
      ehe_row_backward<W>(a, Pm, res, ld);
      EHM_STAMP(2);
    }
    // the next tile's copies go out here, to land while this tile's sums run
    if (k + 1 < n_tiles) stage_tile(k + 1);
    EHM_STAMP(3);
    __syncthreads();

    // the shared gradient: a warp per unit of 4 x 4 parameters, its lanes
    // splitting the tile's rows; added into the block's row in tile order
    for (int u = warp; u < n_units; u += nw) {
      const EheUnit un = ehe_unit_at(a, UT, u);
      const float total = ehe_unit_sum(un, RES, ld, rows, lane);
      const int p = ehe_unit_param(un, lane);
      if (p >= 0) Gr[p] = k == 0 ? total : Gr[p] + total;
    }
    EHM_STAMP(4);
    // each site's gradient: a group of lanes per (site, global) over the
    // site's rows of the tile; written once a site
    {
      const int lanes = eh_group_lanes(t.nobs);
      const int per_warp = 32 / lanes;
      const int pairs = t.ns * G;
      const int gl = lane & (lanes - 1);
      for (int q0 = warp * per_warp; q0 < pairs; q0 += nw * per_warp) {
        const int q = q0 + lane / lanes;
        const bool on = q < pairs;
        const int i = on ? q / G : 0;
        const int g = on ? q - i * G : 0;
        const float sum = eh_group_sum(RES + (a.r_off_g + g) * ld + i * t.nobs, on ? t.nobs : 0,
                                       lanes, gl, false, 1.0f);
        if (on && gl == 0) {
          const int s = idx[j0 + t.fs + i];
          if (chunks == 1) {
            if (s >= 0) gsite[(int64_t)g * S + s] = sum;
          } else {  // a site over several tiles: its chunks in order
            const int c = k - (k / chunks) * chunks;
            const float acc = c == 0 ? sum : GS[g] + sum;
            GS[g] = acc;
            if (c == chunks - 1 && s >= 0) gsite[(int64_t)g * S + s] = acc;
          }
        }
      }
    }
    EHM_STAMP(5);
    if (k + 1 < n_tiles) {  // the next tile's rows have landed; this tile's are free
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      EHM_STAMP(0);
    }
  }

  {
    const float v = ehe_warp_sum(loss_part);
    if (lane == 0) XL[warp] = v;
  }
  __syncthreads();
  float* part = a.partials + (member * a.n_blocks + blockIdx.x) * (NP + 1);
  for (int p = tid; p < NP; p += nth) part[p] = Gr[p];
  if (tid == 0) {
    float bl = 0.0f;
    for (int w = 0; w < nw; ++w) bl += XL[w];
    part[NP] = bl;
  }
  EHM_STAMP(6);
#ifdef EHM_STAMPS
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && a.stamps != nullptr) {
    stamp_acc[EHM_N_STAMPS - 1] = clock64() - stamp_first;
    for (int k = 0; k < EHM_N_STAMPS; ++k) a.stamps[k] += stamp_acc[k];
  }
#endif
}

// Warps of the update kernel's first blocks: one per shared parameter, and
// one for the batch loss.
__host__ __device__ __forceinline__ int ehm_shared_blocks(int n_shared) {
  return (n_shared + 1 + 7) / 8;
}

// Pass 1 updates; pass 0 (lamb only, before pass 1) writes this block's part
// of every leaf's squared norms of the parameters and of the update
// directions into its row of lamb_parts.
__global__ void __launch_bounds__(256)
eh_ms_update_kernel(const __grid_constant__ EhFusedMultisiteArgs a, int step, int pass) {
  if (eh_halted(a.halt)) return;
  const EhOptimizer& o = a.optimizer;
  const int NP = a.n_shared;
  const int S = a.n_sites;
  const int G = a.n_globals;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nl = o.n_leaves;
  // member k's state and scratch: the k-th rows of their arrays; its per-step rows
  const int64_t member = blockIdx.y;  // a population's member, 0 for train()
  const int64_t n_params = NP + (int64_t)G * S;
  float* const params = a.params + member * n_params;
  float* const mom1 = a.m + member * n_params;
  float* const mom2 = a.v + member * n_params;
  float* const mom3 = a.u != nullptr ? a.u + member * n_params : nullptr;
  const float* const partials = a.partials + member * a.n_blocks * (NP + 1);
  float* const gsite = a.gsite + member * (int64_t)G * S;
  float* const lamb_parts =
      a.lamb_parts != nullptr ? a.lamb_parts + member * gridDim.x * nl * 2 : nullptr;
  const int64_t srow = member * a.step_stride + step;
  const bool valid = a.valid[srow] > 0.0f;
  if (pass == 0 && !valid) return;  // the member's whole grid row alike
  const EhOptStep st =
      ehe_opt_step(o, fmaxf(a.tcount[member * a.n_epochs * a.n_batches + step], 1.0f));
  const int shared_blocks = ehm_shared_blocks(NP);

  // rmse: the batch's raw sse (the blocks' loss column, summed as the loss
  // warp sums it), its value r and the gradient's factor, in every block
  __shared__ float rmse[2];
  const bool is_rmse = a.loss_kind == LOSS_RMSE;
  if (is_rmse) {
    if (warp == 0) {
      float sse = 0.0f;
      const float* col = partials + NP;
#pragma unroll 8
      for (int b = lane; b < a.n_blocks; b += 32) sse += col[(int64_t)b * (NP + 1)];
      sse = ehe_warp_sum(sse);
      if (lane == 0) {
        const float inv_n = a.scale[srow * a.n_targets];
        const float r = sqrtf(ehe_max_nan(sse * inv_n, 0.0f));
        rmse[0] = r;  // the batch loss: agg r, agg being 1 with one target
        rmse[1] = inv_n / (2.0f * ehe_max_nan(r, 1e-30f));
      }
    }
    __syncthreads();
  }

  __shared__ float tr[EH_MAX_LEAVES];
  if (pass == 1 && valid && o.rule == OPT_LAMB) {
    // the leaves of this block's elements: its shared parameters or sites' globals
    int64_t first, last;
    if ((int)blockIdx.x < shared_blocks) {
      first = (int64_t)blockIdx.x * 8;
      last = min(first + 7, (int64_t)NP - 1);
    } else {
      first = NP + (int64_t)(blockIdx.x - shared_blocks) * blockDim.x;
      last = min(first + blockDim.x - 1, (int64_t)NP + (int64_t)G * S - 1);
    }
    ehe_leaf_trust_ratios(lamb_parts, gridDim.x, nl, first <= last ? ehe_leaf_of(o, first) : 0,
                          first <= last ? ehe_leaf_of(o, last) : -1, tr);
  }

  // this thread's element (packed index i, gradient g), or none
  int64_t i = -1;
  float g = 0.0f;
  if ((int)blockIdx.x < shared_blocks) {
    // a shared parameter's gradient, or (p == NP) the batch loss: the lanes
    // add the blocks' partial rows lane, lane + 32, ..., then a shuffle tree
    const int p = blockIdx.x * 8 + warp;
    if (p <= NP) {
      const float* col = partials + p;
#pragma unroll 8
      for (int b = lane; b < a.n_blocks; b += 32) g += col[(int64_t)b * (NP + 1)];
      g = ehe_warp_sum(g);
      if (is_rmse && p < NP) g = rmse[1] * g;
      if (lane == 0) {
        if (p < NP) {
          i = p;
        } else if (pass == 1 && valid) {
          a.epoch_loss[member * a.n_epochs + step / a.n_batches] += is_rmse ? rmse[0] : g;
        }
      }
    }
  } else {
    const int64_t gid = (int64_t)(blockIdx.x - shared_blocks) * blockDim.x + threadIdx.x;
    if (gid < (int64_t)G * S) {  // global gid / S of site gid % S
      g = gsite[gid];
      if (is_rmse) g = rmse[1] * g;
      if (pass == 1) gsite[gid] = 0.0f;
      if (valid) {
        const int gi = (int)(gid / S);
        const int P = a.dims[a.n_layers];
        const float span = a.consts[2 * P + G + gi];
        i = NP + gid;
        const float sg = ehe_sigmoid(params[i]);
        g = g * (span * (sg * (1.0f - sg)));
      }
    }
  }

  if (pass == 0) {
    float pv = 0.0f, d = 0.0f;
    if (i >= 0) {
      pv = params[i];
      float mm = mom1[i], vv = mom2[i];
      d = ehe_lamb_direction(o, st, pv, g, mm, vv);
    }
    ehe_block_leaf_sums(pv * pv, d * d, i >= 0 ? ehe_leaf_of(o, i) : -1, nl,
                        lamb_parts + (int64_t)blockIdx.x * nl * 2);
    return;
  }
  if (i >= 0 && valid)
    ehe_update(o, st, params + i, mom1 + i, mom2 + i, mom3 != nullptr ? mom3 + i : nullptr, g,
               o.rule == OPT_LAMB ? tr[ehe_leaf_of(o, i)] : 1.0f);
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
  const int cols = F + a->n_forcing + 2 * T;
  return (size_t)a->n_padded + a->n_shared + (2 * P + 2 * G + K) + 2 * F + T + a->threads / 32 +
         G + 8 * a->n_unit_table + (size_t)a->res_floats * a->threads +
         2 * ((size_t)cols * a->threads + (size_t)a->tile_sites * G);
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
  const int update_blocks = ehm_shared_blocks(args->n_shared) + (int)((n_site_values + 255) / 256);
  const int steps = args->n_epochs * args->n_batches;
  const bool lamb = args->optimizer.rule == OPT_LAMB;
  const dim3 grad_grid(args->n_blocks, args->n_members);  // a row of site blocks a member
  const dim3 update_grid(update_blocks, args->n_members);
  for (int step = 0; step < steps; ++step) {
    eh_ms_grad_kernel<W><<<grad_grid, args->threads, smem, s>>>(*args, step);
    if (lamb) eh_ms_update_kernel<<<update_grid, 256, 0, s>>>(*args, step, 0);
    eh_ms_update_kernel<<<update_grid, 256, 0, s>>>(*args, step, 1);
  }
  return (int)cudaGetLastError();
}

// Enqueue every step of the call on `stream`; returns cudaGetLastError() (0
// on success). The caller checks shapes, devices and the envelope first.
extern "C" int eh_fused_multisite(const EhFusedMultisiteArgs* args, int width, void* stream) {
  if (args->n_epochs <= 0 || args->n_batches <= 0) return 0;
  const size_t smem = ehm_smem_floats(args) * sizeof(float);
  const int th = args->threads, N = args->n_obs;
  const int64_t spb = args->sites_per_block;
  const bool tiles_ok = args->site_tiles == 1
                            ? args->tile_sites >= 1 && (int64_t)args->tile_sites * N <= th
                            : args->tile_sites == 1 && (int64_t)args->site_tiles * th >= N &&
                                  (int64_t)(args->site_tiles - 1) * th < N;
  if (smem > EH_MAX_SMEM_BYTES || args->n_layers < 1 || args->n_layers > EH_MAX_LAYERS ||
      args->n_args > EH_MAX_ARGS || !eh_form_built(args->form) || args->n_targets < 1 ||
      args->n_targets > EH_MAX_TARGETS || !eh_loss_built(args->loss_kind) ||
      (args->loss_kind != LOSS_SQUARED && args->loss_kind != LOSS_ABSOLUTE &&
       args->loss_kind != LOSS_TRACED && (args->loss_kind != LOSS_RMSE || args->n_targets != 1)) ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS || args->n_forcing > EH_MAX_FORCING ||
      N < 1 || th < 32 || th > EHM_MAX_THREADS || th % 32 != 0 || !tiles_ok || spb < 1 ||
      args->n_blocks * spb < args->batch || (args->n_blocks - 1) * spb >= args->batch ||
      args->n_padded % 4 != 0 || args->n_unit_table < 0 || args->p_off_g != args->n_shared ||
      args->optimizer.n_leaves < 1 || args->optimizer.n_leaves > EH_MAX_LEAVES ||
      args->n_members < 1 || args->n_members > 65535 || args->step_stride < 0) {
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
