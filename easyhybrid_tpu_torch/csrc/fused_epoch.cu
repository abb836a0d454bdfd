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
//   8. the update by any of the optax rules of the JAX kernel (eh_device.cuh,
//      ehe_update; lamb's per-leaf norms first, in a pass of their own).
// Parameters, moments, the step counter and the BatchNorm statistics are read
// into shared memory once, stay there across every step of the launch, and
// are written back once at the end, with the last epoch's mean batch loss.
//
// What bounds it on an H100: every step needs the previous step's update, so
// a launch is a chain of n_epochs x n_batches dependent steps, and a step of
// a [16, 16] network on 512 rows is ~1 MFLOP and 12 KB of rows: nothing for
// the card's arithmetic or memory rate, everything for latency. A step costs
// what its longest dependent path costs: device-memory round trips, block
// and cluster barriers, sums taken by one thread, and one thread's own
// instruction stream, which on this card is paced as much by instruction
// fetch (taken branches, straight-line code that is skipped) as by
// arithmetic.
//
// What the design does about it:
//   * The whole batch in flight: one row per thread, blocks of up to 256 rows
//     while a thread-block cluster of up to 8 blocks has room (two warps a
//     scheduler on two multiprocessors ran the main shape faster than four on
//     one), then up to 512 threads a block. Only a batch beyond that, or a
//     model whose state leaves little shared memory, walks tiles serially.
//   * Rows gathered once, ahead of the chain: a step's rows (predictors,
//     forcing, targets, masks) are staged in shared memory by cp.async
//     through the index, and step s + 1's rows are in flight while step s
//     computes, across epoch boundaries too; every pass over a batch (mean,
//     variance, forward) reads the stage.
//   * Every sum is a tree of fixed shape: warp shuffles, then per-warp
//     partials added by a warp in warp order, then (in a cluster) the blocks'
//     partials read through distributed shared memory in rank order. Every
//     block ends with the same bits and two runs give the same bits; there
//     are no float atomics. The parameter gradients are cut into units of
//     4 x 4 (cotangent feature x input feature); a warp takes a unit, its
//     lanes split the rows, and one folding shuffle tree of 16 shuffles
//     leaves all 16 sums. The units are described once a launch.
//   * Layers at their own size: a row's products loop over the layer's own
//     outputs, four at a time; weights sit in shared memory with rows padded
//     to 4 floats and are read as one 16-byte broadcast load per four
//     products; the activation is chosen by one branch per four outputs, and
//     its sigmoid carries no branch, so the four interleave. Only the
//     layer's input vector is unrolled to the kernel's width (it lives in
//     registers); the row's small vectors (outputs, cotangents of the
//     globals) live in the row's column of the tile and are walked by loops
//     of their own length, which costs less in instruction fetch than code
//     unrolled to the width and predicated off.
//   * Every block of a cluster keeps the whole state and applies the same
//     update from the same gradient bits, so nothing is sent back.
//   * What does not depend on the parameters leaves the critical barriers: a
//     step's mask counts and batch mean are taken at the end of the step
//     before and exchanged with its gradient, and what the optimizer rule
//     takes from the step count (bias corrections, radam's rectification) is
//     computed then too, by the warp with the fewest units.
//   * Lamb's trust ratio needs the norms of a leaf's parameters and update
//     directions: a warp takes a leaf, its lanes in a fixed stride and then a
//     shuffle tree, so every block of a cluster gets the same bits from the
//     same gradient; the directions are computed again in the update rather
//     than kept, so the state needs no more shared memory.
// Per step, with a trainable norm: an exchange barrier (the cluster's, or the
// block's without a cluster) for the variance, one for the gradient, the loss
// and the next step's counts and mean; and 3 block barriers (after the
// variance, between the rows' pass and the gradient units, after the
// update). Without a trainable norm the variance barrier goes and the one
// after the update is an exchange barrier, so that no block overwrites
// partials another still reads.
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
  float* u;                              // amsgrad's third slot, in place (else unused)
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
  EhOptimizer optimizer;                 // the rule and its hyperparameters
  int tile_rows;                         // threads of a block: rows it takes at once
  int res_floats;
  int r_off_xhat;
  int r_off_d0;
  int r_off_g;
  int r_off_h[EH_MAX_LAYERS];
  int r_off_d[EH_MAX_LAYERS];
  int r_off_out;                         // the network's outputs, then their cotangents
  int r_off_dsc;                         // the bound scaling's derivative
  int r_off_one;                         // a feature that is 1 on every row
  int n_forcing;
  int n_padded;                          // parameters with weight rows padded to 4
  int pp_off_w[EH_MAX_LAYERS];           // the padded layout's offsets
  int pp_off_b[EH_MAX_LAYERS];
  int pp_off_g;
  int block_rows;                        // rows of a batch one block owns
  int stages;                            // 2: rows staged and prefetched; 0: read in place
  int cluster;                           // blocks over a batch's rows
  int moments_shared;                    // 1: m, v in shared memory; 2: u too; 0: in device memory
  int n_unit_table;                      // gradient units described once a launch (the first ones)
  long long* stamps;                     // (EHE_N_STAMPS) cycles per stage, or null
};
// Packed parameters: [norm scale, norm bias] (dims[0] each, with a norm);
// per layer W (dout x din, row-major) at p_off_w[l], b (dout) at p_off_b[l];
// raw globals at p_off_g. In shared memory the parameters (not the moments)
// use the padded layout: the same order, every W row padded with zeros to a
// multiple of 4 floats and every W starting on a 16-byte boundary. The
// optimizer's slots follow the parameters: m and v, and with moments_shared 2
// amsgrad's u and a pad of the same size (the shared-memory formula counts
// slots in pairs). Where the state would leave no room for 32 residual rows
// the slots stay in device memory (one block only: each element is then one
// thread's alone).
// Residual tile: word (off + k) * tile_rows + r for feature k of row r.

// Built with -DEHE_STAMPS, thread 0 of block 0 adds the clock64() cycles it
// spends in each stage of a step to a.stamps when the kernel ends: 0 the wait
// for the step's staged rows, 1 counts and mean, 2 starting the next step's
// copies, 3 variance (0 to 3: gather and statistics), 4 forward to loss,
// 5 backward, 6 gradient sum, 7 update, 8 the whole kernel. Built with
// -DEHE_CHAIN_ONLY, the rows' arithmetic is left out: barriers, exchanges,
// staging and the update remain.
#define EHE_N_STAMPS 9
#ifdef EHE_STAMPS
#define EHE_STAMP(k)                      \
  do {                                    \
    if (tid == 0 && rank == 0) {          \
      const long long now = clock64();    \
      stamp_acc[k] += now - stamp_last;   \
      stamp_last = now;                   \
    }                                     \
  } while (0)
#else
#define EHE_STAMP(k)
#endif

// Threads a block may have: the registers of 512 threads (128 each) hold a
// row of width 32; a row of width 64 takes 256.
#define EHE_MAX_THREADS(W) ((W) == 64 ? 256 : 512)

template <int W>
__global__ void __launch_bounds__(EHE_MAX_THREADS(W))
eh_fused_epoch_kernel(const __grid_constant__ EhFusedEpochArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster;
  const int rank = blockIdx.x;  // the grid is one cluster
  const int tid = threadIdx.x;
  const int nth = blockDim.x;  // == a.tile_rows
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
  const int NP = a.n_params;
  const int B = a.batch;
  const int n_consts = 2 * P + 2 * G + K;
  const int NS = T + F;             // counts, then the predictors' sums
  const int cols = F + NF + 2 * T;  // a stage's columns
  const bool staged = a.stages > 0;

  const EhOptimizer& o = a.optimizer;
  float* Pm = sm;                 // parameters, padded layout
  // the optimizer's slots: beside the parameters, or in device memory where
  // the state would leave no room for 32 rows (each element is one thread's
  // alone)
  float* Mm = a.moments_shared ? Pm + a.n_padded : a.m;
  float* Vm = a.moments_shared ? Mm + NP : a.v;
  float* Um = a.moments_shared == 2 ? Vm + NP : a.u;
  float* Gr = Pm + a.n_padded + 2 * a.moments_shared * NP;  // this block's gradient partial
  float* XL = Gr + NP;            // this block's loss partials, one a warp
  float* XS1 = XL + nw;           // count and mean partials, NS a warp
  float* XS2 = XS1 + nw * NS;     // variance partials, F a warp
  float* BN = XS2 + nw * F;       // running mean, var
  float* Cc = BN + 2 * F;         // constants
  float* SC = Cc + n_consts;      // scaled globals, then fixed values
  float* DG = SC + G + K;         // d scaled global / d raw
  float* BM = DG + G;             // batch (or running) mean
  float* BR = BM + F;             // rsqrt(var + eps)
  float* NT = BR + F;             // max(sum(mask), 1) per target
  float* MISC = NT + T;           // [0..1] batch valid, [2..7] the rule's step numbers: two steps'
  int* UT = reinterpret_cast<int*>(MISC + 8);  // the first units, 8 ints each
  float* RES = MISC + 8 + 8 * a.n_unit_table;  // residual tile
  float* ST = RES + a.res_floats * ld;  // the stages

  for (int i = tid; i < a.n_padded; i += nth) Pm[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < NP; i += nth) {
    Pm[ehe_padded_index(a, i)] = a.params[i];
    if (a.moments_shared) {
      Mm[i] = a.m[i];
      Vm[i] = a.v[i];
    }
    if (a.moments_shared == 2) Um[i] = a.u[i];
  }
  for (int i = tid; i < 2 * F; i += nth) BN[i] = a.norm_mode != NORM_NONE ? a.bn[i] : 0.0f;
  for (int i = tid; i < n_consts; i += nth) Cc[i] = a.consts[i];
  for (int i = tid; i < K; i += nth) SC[G + i] = a.consts[2 * P + 2 * G + i];
  RES[a.r_off_one * ld + tid] = 1.0f;
  for (int u = tid; u < a.n_unit_table; u += nth) ehe_unit_describe(a, UT, u);
  __syncthreads();
  if (tid == nth - 1)  // the first step's numbers
    ehe_opt_step_store(ehe_opt_step(o, (float)a.t[0] + 1.0f), MISC + 2);
  if (a.norm_mode == NORM_STATIC) {
    for (int k = tid; k < F; k += nth) {
      BM[k] = BN[k];
      BR[k] = rsqrtf(BN[F + k] + a.norm_eps);
    }
  }

  const float* nlo = Cc;
  const float* nspan = Cc + P;
  const float* glo = Cc + 2 * P;
  const float* gspan = Cc + 2 * P + G;
  const int row0 = rank * a.block_rows;  // this block's rows of a batch
  const int mine = max(0, min(a.block_rows, B - row0));
  const int n_units = ehe_n_units(a);
  const int pp_first = tid < NP ? ehe_padded_index(a, tid) : 0;  // of the thread's first parameter
  const int n_steps = a.n_epochs * a.n_batches;
  float t = (float)a.t[0];   // every thread carries the same step count
  float last_loss = 0.0f;    // warp 0 only
  float epoch_loss = 0.0f;   // warp 0 only
#ifdef EHE_STAMPS
  long long stamp_acc[EHE_N_STAMPS] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  const long long stamp_first = clock64();
  long long stamp_last = stamp_first;
#endif

  // Start the copies of step `step`'s row `row` into its stage.
  auto stage_row = [&](int step, int64_t row) {
    float* dst = ST + (step & 1) * cols * ld + tid;
    for (int k = 0; k < F; ++k) ehe_cp_async4(dst + k * ld, a.x + row * F + k);
    for (int f = 0; f < NF; ++f) ehe_cp_async4(dst + (F + f) * ld, a.forcing[f] + row);
    for (int j = 0; j < T; ++j) {
      ehe_cp_async4(dst + (F + NF + j) * ld, a.y[j] + row);
      ehe_cp_async4(dst + (F + NF + T + j) * ld, a.mask[j] + row);
    }
  };
  auto step_index = [&](int step) {
    const int e = step / a.n_batches;
    return a.perm + (int64_t)e * a.n_rows + (int64_t)(step - e * a.n_batches) * B + row0;
  };
  // The sum over every block's and warp's partial i of `width`, taken by a
  // whole warp: lane e adds entries e, e + 32, ... of the blocks' partials in
  // rank and warp order, then a shuffle tree; the same bits in every lane of
  // every block.
  auto exchanged = [&](float* part, int width, int i) {
    float s = 0.0f;
    for (int e = lane; e < C * nw; e += 32) {
      const int rk = e / nw;
      const float* p = C > 1 ? cluster.map_shared_rank(part, rk) : part;
      s += p[(e - rk * nw) * width + i];
    }
    return ehe_warp_sum(s);
  };
  auto exchange_barrier = [&]() {
    if (C > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  // A step's mask counts and, for the trainable norm, its predictors' sums:
  // every warp's partials. They depend on the rows alone, not on the
  // parameters, so step s + 1's are taken at the end of step s, off the chain.
  auto stat_partials = [&](int step) {
    const int* idx = step_index(step);
    const float* st = ST + (step & 1) * cols * ld;
    const int n = a.norm_mode == NORM_TRAIN ? NS : T;
    for (int i = 0; i < n; ++i) {  // target i's mask, then predictor i - T
      float v = 0.0f;
      for (int r = tid; r < mine; r += nth) {
        if (staged) {
          v += st[(i < T ? F + NF + T + i : i - T) * ld + r];
        } else {
          const int64_t row = idx[r];
          v += i < T ? a.mask[i][row] : a.x[row * F + (i - T)];
        }
      }
      v = ehe_warp_sum(v);
      if (lane == 0) XS1[warp * NS + i] = v;
    }
  };
  // After an exchange barrier: step `step`'s counts, batch mean and validity
  // (MISC[step & 1]) from the partials, a warp per sum.
  auto stat_sums = [&](int step) {
    for (int i = warp; i < NS; i += nw) {
      if (i < T) {
        const float v = exchanged(XS1, NS, i);
        if (lane == 0) NT[i] = fmaxf(v, 1.0f);
      } else if (a.norm_mode == NORM_TRAIN) {
        const float v = exchanged(XS1, NS, i);
        if (lane == 0) BM[i - T] = v / (float)B;
      }
    }
    if (warp == nw - 1) {  // validity: any target counted
      float total = 0.0f;
      for (int j = 0; j < T; ++j) total += exchanged(XS1, NS, j);
      if (lane == 0) MISC[step & 1] = total > 0.0f ? 1.0f : 0.0f;
    }
  };

  if (staged && tid < mine) {
    stage_row(0, step_index(0)[tid]);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  stat_partials(0);
  exchange_barrier();
  stat_sums(0);
  exchange_barrier();

  for (int s = 0; s < n_steps; ++s) {
    const int* idx = step_index(s);
    const float* st = ST + (s & 1) * cols * ld;  // this step's staged rows, landed
    const float valid = MISC[s & 1];
    int64_t next_row = -1;
    if (staged && s + 1 < n_steps && tid < mine) next_row = step_index(s + 1)[tid];
    if (tid < G) {
      const float sg = ehe_sigmoid_nb(Pm[a.pp_off_g + tid]);
      SC[tid] = glo[tid] + gspan[tid] * sg;
      DG[tid] = gspan[tid] * (sg * (1.0f - sg));
    }
    if (a.norm_mode == NORM_TRAIN) {
      // second pass: the biased variance around the batch mean
      for (int k = 0; k < F; ++k) {
        const float mean = BM[k];
        float v = 0.0f;
        for (int r = tid; r < mine; r += nth) {
          const float dv = (staged ? st[k * ld + r] : a.x[(int64_t)idx[r] * F + k]) - mean;
          v += dv * dv;
        }
        v = ehe_warp_sum(v);
        if (lane == 0) XS2[warp * F + k] = v;
      }
      exchange_barrier();
      for (int k = warp; k < F; k += nw) {
        const float v = exchanged(XS2, F, k) / (float)B;
        if (lane == 0) {
          BR[k] = rsqrtf(v + a.norm_eps);
          if (valid > 0.0f) {  // the running statistics' EMA, gated like the update
            BN[k] = a.one_minus_momentum * BN[k] + a.momentum * BM[k];
            BN[F + k] = a.one_minus_momentum * BN[F + k] + a.momentum * v;
          }
        }
      }
    }
    __syncthreads();
    EHE_STAMP(3);
    // the next step's copies go out here, off the chain of barriers and sums
    // above: scattered 4-byte copies keep the load-store unit busy for ~1.3
    // cycles each, which the rows' arithmetic hides
    if (next_row >= 0) {
      stage_row(s + 1, next_row);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    EHE_STAMP(2);

    // ---- tiles: forward, loss, backward per row; gradient sums ---------------
    float loss_part = 0.0f;
    if (mine == 0)
      for (int p = tid; p < NP; p += nth) Gr[p] = 0.0f;
    for (int t0 = 0; t0 < mine; t0 += nth) {
      const int r = t0 + tid;
      const int rows_here = min(nth, mine - t0);
#ifndef EHE_CHAIN_ONLY
      if (r < mine) {
        const int64_t row = staged ? 0 : idx[r];
        float* res = RES + tid;
        float h[1][W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float x = 0.0f;
          if (k < F) {
            x = staged ? st[k * ld + r] : a.x[row * F + k];
            if (a.norm_mode != NORM_NONE) {
              const float xh = (x - BM[k]) * BR[k];
              res[(a.r_off_xhat + k) * ld] = xh;
              x = xh * Pm[k] + Pm[F + k];
            }
            res[(a.r_off_h[0] + k) * ld] = x;
          }
          h[0][k] = x;
        }

        ehe_row_forward<W, 1, true>(a, Pm, h, res, ld, 0);

        // From here on the row's small vectors (the network's P outputs, the
        // G globals' cotangents) live in the row's column of the tile and are
        // walked by loops of their own length: code unrolled to the kernel's
        // width for them costs more in instruction fetch than it saves.
        // Bound scaling of the neural outputs: the scaled value in place, its
        // derivative beside it.
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

        float av[EH_MAX_ARGS];
#pragma unroll
        for (int i = 0; i < EH_MAX_ARGS; ++i) {
          float val = 0.0f;
          if (i < a.n_args) {
            const int id = a.arg_idx[i];
            switch (a.arg_src[i]) {
              case SRC_FORCING: val = staged ? st[(F + id) * ld + r] : a.forcing[id][row]; break;
              case SRC_NEURAL: val = outv[id * ld]; break;
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
            const float mk = staged ? st[(F + NF + T + j) * ld + r] : a.mask[j][row];
            const float yv = staged ? st[(F + NF + j) * ld + r] : a.y[j][row];
            const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
            const float diff = (pred - yv) * mk;
            const float scale = a.agg_scale / NT[j];
            term += scale * diff * diff;
            cot[j] = (2.0f * a.agg_scale / NT[j]) * diff;
          }
        }
        loss_part += term;
        EHE_STAMP(4);

        // cotangents of the neural outputs (gathered where the outputs were)
        // and of the scaled globals
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
        EHE_STAMP(5);
      }
#endif
      __syncthreads();

      // a warp per unit of 4 x 4 parameters; its lanes split the tile's rows
      for (int u = warp; u < n_units; u += nw) {
        const EheUnit un = ehe_unit_at(a, UT, u);
#ifndef EHE_CHAIN_ONLY
        const float total = ehe_unit_sum(un, RES, ld, rows_here, lane);
#else
        const float total = ehe_unit_sum<false>(un, RES, ld, rows_here, lane);
#endif
        const int p = ehe_unit_param(un, lane);
        if (p >= 0) Gr[p] = t0 == 0 ? total : Gr[p] + total;
      }
      if (t0 + nth < mine) __syncthreads();  // the next tile overwrites the residuals
      EHE_STAMP(6);
    }

    // ---- the next step's counts and mean; batch loss, validity gate, update ----
    if (s + 1 < n_steps) {
      if (staged) asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // its rows have landed
      EHE_STAMP(0);
      stat_partials(s + 1);
      EHE_STAMP(1);
    }
    if (tid == nth - 1) {
      // the rule's numbers for the next step if its batch is valid (they are
      // not read if it is not), off that step's chain and in the warp that
      // has the fewest units: the step count after this step, plus one, is
      // never below the clamp at 1
      ehe_opt_step_store(ehe_opt_step(o, t + valid + 1.0f), MISC + 2 + 3 * ((s + 1) & 1));
    }
    {
      const float v = ehe_warp_sum(loss_part);
      if (lane == 0) XL[warp] = v;
    }
    exchange_barrier();
    if (s + 1 < n_steps) stat_sums(s + 1);
    if (warp == 0 && valid > 0.0f) epoch_loss += exchanged(XL, 1, 0);
    if (valid > 0.0f) {
      const EhOptStep st = ehe_opt_step_at(MISC + 2 + 3 * (s & 1));
      // parameter p's gradient: the blocks' partials in rank order
      auto grad = [&](int p) {
        float g = 0.0f;
        for (int rk = 0; rk < C; ++rk) g += (C > 1 ? cluster.map_shared_rank(Gr, rk) : Gr)[p];
        if (p >= a.p_off_g) g = g * DG[p - a.p_off_g];
        return g;
      };
      // lamb: each leaf's trust ratio, a warp a leaf, into the residual tile
      // (free until the next step's rows)
      float* TR = RES;
      if (o.rule == OPT_LAMB) {
        for (int l = warp; l < o.n_leaves; l += nw) {
          float ps = 0.0f, ds = 0.0f;
          for (int p = (int)ehe_leaf_start(o, l) + lane; p < o.leaf_end[l]; p += 32) {
            const float pv = Pm[ehe_padded_index(a, p)];
            float mm = Mm[p], vv = Vm[p], w = 0.0f;
            const float d = ehe_direction(o, st, pv, grad(p), mm, vv, w);
            ps += pv * pv;
            ds += d * d;
          }
          ps = ehe_warp_sum(ps);
          ds = ehe_warp_sum(ds);
          if (lane == 0) TR[l] = ehe_trust_ratio(ps, ds);
        }
        __syncthreads();
      }
      for (int p = tid; p < NP; p += nth) {
        const int pp = p == tid ? pp_first : ehe_padded_index(a, p);
        ehe_update(o, st, &Pm[pp], &Mm[p], &Vm[p], &Um[p], grad(p),
                   o.rule == OPT_LAMB ? TR[ehe_leaf_of(o, p)] : 1.0f);
      }
    }
    t += valid;
    // A cluster's blocks must all have read this step's partials before any
    // writes the next step's. With a trainable norm the next step's variance
    // barrier sees to that (the partials it guards are written after it), and
    // the block's own barrier is enough here.
    if (a.norm_mode == NORM_TRAIN) {
      __syncthreads();
    } else {
      exchange_barrier();
    }
    EHE_STAMP(7);
    if (s % a.n_batches == a.n_batches - 1) {
      last_loss = epoch_loss / (float)a.n_batches;
      epoch_loss = 0.0f;
    }
  }

  if (rank == 0) {
    for (int i = tid; i < NP; i += nth) {
      a.params[i] = Pm[ehe_padded_index(a, i)];
      if (a.moments_shared) {
        a.m[i] = Mm[i];
        a.v[i] = Vm[i];
      }
      if (a.moments_shared == 2) a.u[i] = Um[i];
    }
    if (a.norm_mode != NORM_NONE)
      for (int i = tid; i < 2 * F; i += nth) a.bn[i] = BN[i];
    if (tid == 0) {
      a.t[0] = (int)lrintf(t);
      a.loss[0] = last_loss;
#ifdef EHE_STAMPS
      if (a.stamps != nullptr) {
        stamp_acc[EHE_N_STAMPS - 1] = clock64() - stamp_first;
        for (int k = 0; k < EHE_N_STAMPS; ++k) a.stamps[k] = stamp_acc[k];
      }
#endif
    }
  }
  if (C > 1) cluster.sync();  // no block leaves while another may read its partials
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
  const int NW = a->tile_rows / 32;
  const int COLS = F + a->n_forcing + 2 * T;
  return (size_t)a->n_padded + (1 + 2 * a->moments_shared) * a->n_params + NW * (1 + T + 2 * F) + 2 * F +
         (2 * P + 2 * G + K) + 2 * G + K + 2 * F + T + 8 + 8 * a->n_unit_table +
         (size_t)a->tile_rows * (a->res_floats + a->stages * COLS);
}

template <int W>
static int ehe_launch(const EhFusedEpochArgs* args, size_t smem, cudaStream_t s) {
  if (args->tile_rows > EHE_MAX_THREADS(W)) return (int)cudaErrorInvalidValue;
  // allow the full 227 KB once per width: setting the attribute at every
  // launch would cost a host call that may wait for the device
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        eh_fused_epoch_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, EH_MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  return (int)eh_launch_cluster(eh_fused_epoch_kernel<W>, *args, args->cluster, args->tile_rows,
                                smem, s);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes, devices and the envelope before it gets here.
extern "C" int eh_fused_epoch(const EhFusedEpochArgs* args, int width, void* stream) {
  if (args->n_epochs <= 0 || args->n_batches <= 0) return 0;
  const size_t smem = ehe_smem_floats(args) * sizeof(float);
  const int tr = args->tile_rows;
  const int c = args->cluster;
  if (smem > EH_MAX_SMEM_BYTES || args->n_layers < 1 || args->n_layers > EH_MAX_LAYERS ||
      args->n_args > EH_MAX_ARGS || args->n_targets < 1 || args->n_targets > EH_MAX_TARGETS ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS || args->n_forcing > EH_MAX_FORCING ||
      tr < 32 || tr % 32 != 0 || (c != 1 && c != 2 && c != 4 && c != 8) ||
      (int64_t)args->block_rows * c < args->batch || args->n_padded % 4 != 0 ||
      args->n_unit_table < 0 ||
      args->moments_shared < 0 || args->moments_shared > 2 ||
      (args->moments_shared == 0 && c != 1) ||
      (args->optimizer.rule == OPT_AMSGRAD && args->moments_shared == 1) ||
      args->optimizer.n_leaves < 1 || args->optimizer.n_leaves > EH_MAX_LEAVES ||
      (args->stages != 0 && (args->stages != 2 || tr < args->block_rows))) {
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
