// Fused training epochs of the LSTM sequence hybrid for Hopper, sm_90a: the
// cluster-split form of kernel 4, for the LSTMs whose state does not fit one
// block (hidden sizes past 64, 64 features at hidden size 64, and the windows
// whose checkpoints outgrow the one-block form).
//
// Replaces, for those models, the LSTM body of the Pallas TPU kernel built by
// make_fused_epoch in easyhybrid_tpu/ops/fused_epoch.py (kernel_body_lstm at
// :1700, chosen at :2479; pallas_call at :2662), which takes an LSTM of any
// hidden size and feature count over windows of up to 32 steps. It computes
// what fused_epoch_lstm.cu computes (same arguments but the launch geometry,
// same packed layout, same plain version: ops/fused_epoch_lstm.py's
// fused_lstm_reference): one launch runs n_epochs x n_batches optimizer steps
// of a SingleNN hybrid whose network is an LSTM over windows of n_steps time
// steps with a Dense head, each step the loss scales over the batch's
// (n_out_steps x B) window, the static input norm or none, the recurrence,
// the head, bound scaling and kernel form at the trailing steps, the masked
// loss (every loss of the JAX kernel, the two-pass ones too) and its
// cotangent, the backward through time, the batch-validity gate and the
// update by any optax rule of the JAX kernel (eh_device.cuh, ehe_update).
//
// How the work is split: one thread-block cluster of `cluster` blocks. Block
// r owns hidden units [r U, (r + 1) U), U = `units`: the four gate rows of
// those units in wi, wh and b, kept transposed in its shared memory
// ((F + H + 1) columns x 4U rows), their gradients beside them, and the
// head's weights of those units. Every block keeps a copy of what all need:
// the whole head, the norm's scale and bias, the globals. A batch's windows
// are walked in tiles of `windows` windows, every block on the same tile:
//   * forward, each time step: every block computes its units' gates for the
//     tile from the cell's input and the whole previous h, writes its units'
//     gates, c and h to the device workspace (the checkpoints, T B 6H floats,
//     which L2 holds at the main shapes), and stores its slice of h_t into
//     every block's input buffer for the next step through distributed shared
//     memory (double-buffered by step parity); one cluster barrier a step;
//   * the head at the trailing steps is computed by every block alike from
//     the whole h in the workspace, so every block gets the same predictions,
//     loss terms and head cotangents with no exchange. The two-pass losses
//     (rmse, pearsonLoss, kgeLoss, pbkgeLoss) keep every prediction of the
//     batch in the workspace after all tiles' forward, take the batch's
//     moments there (every block the same sums in the same order) and
//     ehe_stat_loss's g and partials, then run the backward;
//   * backward, each time step: a block forms its units' gate cotangents dz,
//     its part of wh^T dz for every unit, and stores each unit's part into the
//     owner's receive buffer, in a slot of its own rank; after one cluster
//     barrier each block sums its units' parts in rank order, so two runs
//     give the same bits. The gradients of a block's own rows need no
//     exchange: the outer product of dz and (x, h_{t-1}, 1) is summed into
//     them step by step, a thread a 4 x 4 unit of (row, column);
//   * update: each block updates its own rows and its own head columns (the
//     latter written into every block), block 0 the norm's scale and bias,
//     the head's bias and the globals (written into every block); the norm's
//     gradient is the blocks' partials of wi^T dz x xhat, read by block 0 in
//     rank order. Lamb's per-leaf norms are each block's part of a leaf,
//     added over the blocks in rank order by every block.
// Per optimizer step: T cluster barriers forward and T backward for each tile,
// one or two (lamb) before the update and one after it. No float atomics.
//
// What bounds it on an H100: the products. A step is 6 T 4H (F + H) B flops
// (forward, the cotangent of h and the weight gradients), 2.4 ms an epoch of
// 25 steps of 128 windows at H = 256, T = 32, F = 2 at 67 TFLOP/s; the form
// runs them as plain FMA on one cluster of at most 16 SMs, between barriers:
// far from that bound, simple and right first. Tensor cores (wgmma), TMA and
// a grid wider than one cluster are later work.
//
// Built without --use_fast_math, as fused_forward.cu.

#include <cstddef>

#include "eh_device.cuh"

#define EHS_MAX_OUT 8
#define EHS_MAX_CLUSTER 16
#define EHS_MAX_HIDDEN 256
#define EHS_MAX_STEPS 32
#define EHS_MAX_THREADS 512
#define EHS_SST_EPS 1e-12f
// global loads a thread issues before it uses the first (the tile's rows)
#define EHS_ILP 8
// the next step's inputs a thread loads ahead of the step's products
#define EHS_XPF 4

// Built with -DEHS_STAMPS, thread 0 of block 0 adds the clock64() cycles it
// spends in each stage to ehs_stamps, read by eh_fused_lstm_split_stamps():
// 0 a step's start (the loss scales), 1 the forward's products, 2 its cells,
// the h exchange and the next input, 3 its cluster barrier, 4 the two-pass
// losses' predictions and moments, 5 a tile's head and its sums, 6 the
// backward's gate cotangents and rows, 7 its products (wh^T dz, wi^T dz), 8
// the weight gradients, 9 the norm's gradient, 10 its cluster barrier, 11 the
// update and its barriers; 12 the whole kernel. ops/fused_lstm_split.py's
// STAGES names them.
#define EHS_N_STAMPS 13
#ifdef EHS_STAMPS
__device__ long long ehs_stamps[EHS_N_STAMPS];
extern "C" int eh_fused_lstm_split_stamps(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, ehs_stamps, sizeof(ehs_stamps));
}
#define EHS_STAMP(k)                      \
  do {                                    \
    if (tid == 0 && rank == 0) {          \
      const long long now = clock64();    \
      stamp_acc[k] += now - stamp_last;   \
      stamp_last = now;                   \
    }                                     \
  } while (0)
#else
#define EHS_STAMP(k)
#endif

// Mirrored field by field by _SplitArgs in
// easyhybrid_tpu_torch/ops/fused_lstm_split.py; eh_fused_lstm_split_args_size()
// lets the wrapper check the two agree. The fields up to `halt` are
// fused_epoch_lstm.cu's EhFusedLstmArgs'.
struct EhLstmSplitArgs {
  const float* x;                        // (n_rows, n_steps, n_features) row-major
  const float* forcing[EH_MAX_FORCING];  // (n_rows, n_steps) each
  const float* y[EH_MAX_TARGETS];        // (n_rows, n_out_steps) each, 0 where masked
  const float* mask[EH_MAX_TARGETS];     // (n_rows, n_out_steps) each, 0 or 1
  const int* perm;                       // (n_epochs, n_rows) window index
  float* params;                         // packed parameters, in place
  float* m;                              // first moments, in place
  float* v;                              // second moments, in place
  float* u;                              // amsgrad's third slot, in place (else unused)
  const float* bn;                       // the norm's mean, var (2 n_features)
  int* t;                                // step counter, in place
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* loss;                           // last epoch's mean batch loss
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
  int loss_kind;                         // LOSS_* (eh_device.cuh)
  int loss_nse;                          // scale by the target's SST
  int loss_sum;                          // a traced loss summed: scale agg, not agg / n
  EhOptimizer optimizer;                 // the rule and its hyperparameters
  const int* halt;                       // the halt word (eh_halted), or null
  int threads;                           // of a block, whole warps
  int cluster;                           // blocks of the cluster
  int units;                             // hidden units a block owns: ceil(hidden / cluster)
  int windows;                           // windows of a tile, a multiple of 4
  int tiles;                             // tiles of a batch
  float* work;                           // device workspace, ehs_work_floats of it
  int64_t work_floats;
};

__host__ __device__ inline int ehs_up4(int n) {
  return (n + 3) & ~3;
}

// Shared-memory layout, in floats from the start; the last is the total.
// ops/fused_lstm_split.py's split_smem_floats computes the same total.
struct EhsSmem {
  int w, gw, hw, ns, hb, gl, sc, dg, bm, br, cc, gh, gs, gn, misc, red, lb, xh, recv, z, zt, dcc,
      dxn, rows, total;
};

__host__ __device__ inline EhsSmem ehs_smem(const EhLstmSplitArgs& a) {
  const int F = a.n_features, H = a.hidden, P = a.n_out, G = a.n_globals, K = a.n_fixed;
  const int U = a.units, R = 4 * U, NC = F + H + 1, LDW = R | 1, TW = a.windows;
  const int LDV = ehs_up4(NC + F);
  EhsSmem s;
  s.w = 0;                              // own gate rows, transposed: column c, row r at c LDW + r
  s.gw = s.w + NC * LDW;                // their gradients, the same layout
  s.hw = s.gw + NC * LDW;               // the whole head's weights (P, H)
  s.ns = s.hw + P * H;                  // the norm's scale, bias
  s.hb = s.ns + 2 * F;                  // the head's bias
  s.gl = s.hb + P;                      // the raw globals
  s.sc = s.gl + G;                      // scaled globals, then fixed values
  s.dg = s.sc + G + K;                  // d scaled global / d raw
  s.bm = s.dg + G;                      // the norm's mean
  s.br = s.bm + F;                      // rsqrt(var + eps)
  s.cc = s.br + F;                      // constants
  s.gh = s.cc + 2 * P + 2 * G + K;      // the gradient of the own head columns (P, U)
  s.gs = s.gh + P * U;                  // the head bias's and the globals' gradients
  s.gn = s.gs + P + G;                  // this block's part of the norm's gradient
  s.misc = s.gn + 2 * F;                // loss scales and coefficients: 12 a target, 8 more
  s.red = s.misc + 12 * EH_MAX_TARGETS + 8;     // a block sum's warp partials
  s.lb = s.red + 32;                    // lamb: this block's leaf parts, then the ratios
  s.xh = ehs_up4(s.lb + 3 * EH_MAX_LEAVES);
  // the tile: the cell's input and h (two step parities, (F + H) x TW each), or
  // the backward's (x, h_{t-1}, 1, xhat) rows of the tile's windows (TW x LDV)
  const int xh_floats = 2 * (F + H) * TW > LDV * TW ? 2 * (F + H) * TW : LDV * TW;
  s.recv = s.xh + ehs_up4(xh_floats);   // dh parts: (parity, rank, window, unit)
  s.z = s.recv + ehs_up4(2 * a.cluster * TW * U);  // pre-activations / dz: (window, row)
  s.zt = s.z + ehs_up4(TW * R);         // dz again, (row, window)
  s.dcc = s.zt + ehs_up4(TW * R);       // c forward, dc backward: (window, unit)
  s.dxn = s.dcc + ehs_up4(TW * U);      // this block's wi^T dz of a step: (window, feature)
  s.rows = s.dxn + ehs_up4(TW * F);     // the tile's window indexes (ints)
  s.total = s.rows + TW;
  return s;
}

// Device workspace, in floats: the checkpoints h, c (B T H each) and the gates
// (B T 4H); then per block the tile's head cotangents (TW TO P), global
// cotangents (TW TO G), loss terms (TW TO) and, the two-pass losses, the
// batch's predictions (NT B TO).
__host__ __device__ inline int64_t ehs_block_work(const EhLstmSplitArgs& a) {
  const int64_t pairs = (int64_t)a.windows * a.n_out_steps;
  return pairs * (a.n_out + a.n_globals + 1) +
         (int64_t)a.n_targets * a.batch * a.n_out_steps;
}
__host__ __device__ inline int64_t ehs_work_floats(const EhLstmSplitArgs& a) {
  return (int64_t)a.batch * a.n_steps * 6 * a.hidden + (int64_t)a.cluster * ehs_block_work(a);
}

// The cell's input feature k of a window's step, with the static norm's trained
// scale and bias where there is one; xhat its normalised value.
__device__ __forceinline__ float ehs_input(float xv, int k, bool norm, const float* BM,
                                           const float* BR, const float* NS, int F, float* xhat) {
  if (!norm) {
    *xhat = 0.0f;
    return xv;
  }
  const float xh = (xv - BM[k]) * BR[k];
  *xhat = xh;
  return fmaf(xh, NS[k], NS[F + k]);
}

template <bool TWO_PASS>
__global__ void __launch_bounds__(EHS_MAX_THREADS)
eh_lstm_split_kernel(const __grid_constant__ EhLstmSplitArgs a) {
  if (eh_halted(a.halt)) return;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nth >> 5;
  const int F = a.n_features;
  const int H = a.hidden;
  const int P = a.n_out;
  const int G = a.n_globals;
  const int K = a.n_fixed;
  const int NT = a.n_targets;
  const int B = a.batch;
  const int T = a.n_steps;
  const int TO = a.n_out_steps;
  const int LK = a.loss_kind;
  const int U = a.units;
  const int R = 4 * U;
  const int NC = F + H + 1;
  const int LDW = R | 1;
  const int TW = a.windows;
  const int TW4 = TW / 4;
  const int LDV = ehs_up4(NC + F);
  const int FH = F + H;
  const int j0 = rank * U;
  const int nu = max(0, min(U, H - j0));  // the units this block owns
  const bool norm = a.norm_mode != NORM_NONE;
  const bool loss_sst = a.loss_nse || ehe_loss_is_stat(LK);
  const EhOptimizer& opt = a.optimizer;
  const int n_steps = a.n_epochs * a.n_batches;

  const EhsSmem L = ehs_smem(a);
  float* W = sm + L.w;
  float* GW = sm + L.gw;
  float* HW = sm + L.hw;
  float* NS = sm + L.ns;
  float* HB = sm + L.hb;
  float* GL = sm + L.gl;
  float* SC = sm + L.sc;
  float* DG = sm + L.dg;
  float* BM = sm + L.bm;
  float* BR = sm + L.br;
  float* Cc = sm + L.cc;
  float* GH = sm + L.gh;
  float* GS = sm + L.gs;
  float* GN = sm + L.gn;
  float* SCL = sm + L.misc;                  // the targets' loss scales
  float* TN = SCL + EH_MAX_TARGETS;          // max(sum(mask), 1)
  float* TMU = TN + EH_MAX_TARGETS;          // the targets' mean
  float* TSS = TMU + EH_MAX_TARGETS;         // their SST
  float* LC = TSS + EH_MAX_TARGETS;          // the two-pass coefficients, 8 a target
  float* MISC = LC + 8 * EH_MAX_TARGETS;     // 0 valid, 1 the batch's loss, 2 the epoch's
  float* RED = sm + L.red;
  float* LB = sm + L.lb;                     // lamb: 2 a leaf, then the ratios
  float* TR = LB + 2 * EH_MAX_LEAVES;
  float* XH = sm + L.xh;
  float* VB = XH;                            // the backward's rows alias the inputs
  float* RECV = sm + L.recv;
  float* Z = sm + L.z;
  float* ZT = sm + L.zt;
  float* DCC = sm + L.dcc;
  float* DXN = sm + L.dxn;
  int* ROWS = reinterpret_cast<int*>(sm + L.rows);

  // the workspace
  float* HS = a.work;                                        // h (B, T, H)
  float* CS = HS + (int64_t)B * T * H;                       // c (B, T, H)
  float* GT = CS + (int64_t)B * T * H;                       // gates (B, T, 4H)
  float* mine = GT + (int64_t)B * T * 4 * H + (int64_t)rank * ehs_block_work(a);
  float* HDS = mine;                                         // (TW, TO, P)
  float* GCS = HDS + (int64_t)TW * TO * P;                   // (TW, TO, G)
  float* LTS = GCS + (int64_t)TW * TO * G;                   // (TW, TO)
  float* PRS = LTS + (int64_t)TW * TO;                       // (NT, B, TO)

  // ---- the state into shared memory ----
  for (int e = tid; e < NC * LDW; e += nth) {
    const int c = e / LDW, r = e - c * LDW;
    const int g = r / max(U, 1), u = r - g * U;
    float val = 0.0f;
    if (r < R && u < nu) {
      const int row = g * H + j0 + u;
      val = c < F ? a.params[a.p_off_wi + row * F + c]
            : c < FH ? a.params[a.p_off_wh + row * H + (c - F)]
                     : a.params[a.p_off_b + row];
    }
    W[e] = val;
  }
  for (int i = tid; i < P * H; i += nth) HW[i] = a.params[a.p_off_hw + i];
  for (int i = tid; i < 2 * F; i += nth) NS[i] = norm ? a.params[i] : 0.0f;
  for (int i = tid; i < P; i += nth) HB[i] = a.params[a.p_off_hb + i];
  for (int i = tid; i < G; i += nth) GL[i] = a.params[a.p_off_g + i];
  for (int i = tid; i < 2 * P + 2 * G + K; i += nth) Cc[i] = a.consts[i];
  for (int i = tid; i < K; i += nth) SC[G + i] = a.consts[2 * P + 2 * G + i];
  for (int k = tid; k < F; k += nth) {
    BM[k] = norm ? a.bn[k] : 0.0f;
    BR[k] = norm ? rsqrtf(a.bn[F + k] + a.norm_eps) : 0.0f;
  }
  __syncthreads();
  const float* nlo = Cc;
  const float* nspan = Cc + P;
  const float* glo = Cc + 2 * P;
  const float* gspan = Cc + 2 * P + G;
  auto scale_globals = [&]() {
    for (int i = tid; i < G; i += nth) {
      const float sg = ehe_sigmoid(GL[i]);
      SC[i] = glo[i] + gspan[i] * sg;
      DG[i] = gspan[i] * (sg * (1.0f - sg));
    }
  };
  scale_globals();
  float t = (float)a.t[0];
  float last_loss = 0.0f;  // block 0's thread 0
#ifdef EHS_STAMPS
  long long stamp_acc[EHS_N_STAMPS] = {};
  const long long stamp_first = clock64();
  long long stamp_last = stamp_first;
#endif

  // The sum of v over the block's threads, the same bits in every thread (and
  // in every block that sums the same values).
  auto block_sum = [&](float v) {
    v = ehe_warp_sum(v);
    __syncthreads();  // the partials of the sum before are read
    if (lane == 0) RED[warp] = v;
    __syncthreads();
    float s = 0.0f;
    for (int i = 0; i < nw; ++i) s += RED[i];
    return s;
  };

  // One (window, trailing step) pair's head, kernel form and partials: the
  // window's row, its place i in the batch, the trailing step tt.
  float av[EH_MAX_ARGS];
  float fout[EH_MAX_OUT];
  float pd[EH_MAX_OUT][EH_MAX_ARGS];
  float dsc[EHS_MAX_OUT], dact[EHS_MAX_OUT];
  auto head = [&](int64_t row, int64_t i, int tt) {
    const int t_in = T - TO + tt;
    const float* hv = HS + (i * T + t_in) * H;
    float zz[EHS_MAX_OUT];
#pragma unroll
    for (int q = 0; q < EHS_MAX_OUT; ++q) zz[q] = q < P ? HB[q] : 0.0f;
    for (int k = 0; k < H; ++k) {
      const float hk = hv[k];
#pragma unroll
      for (int q = 0; q < EHS_MAX_OUT; ++q)
        if (q < P) zz[q] = fmaf(HW[q * H + k], hk, zz[q]);
    }
    float nv[EHS_MAX_OUT];
#pragma unroll
    for (int q = 0; q < EHS_MAX_OUT; ++q) {
      nv[q] = 0.0f;
      dsc[q] = 1.0f;
      dact[q] = 0.0f;
      if (q < P) {
        float d;
        float out = ehe_act(a.head_act, zz[q], &d);
        dact[q] = d;
        if (a.scale_nn_outputs) {
          const float sg = ehe_sigmoid(out);
          dsc[q] = nspan[q] * (sg * (1.0f - sg));
          out = nlo[q] + nspan[q] * sg;
        }
        nv[q] = out;
      }
    }
#pragma unroll
    for (int k = 0; k < EH_MAX_ARGS; ++k) {
      float val = 0.0f;
      if (k < a.n_args) {
        const int id = a.arg_idx[k];
        switch (a.arg_src[k]) {
          case SRC_FORCING: {
            const float* col = a.forcing[0];
#pragma unroll
            for (int f = 1; f < EH_MAX_FORCING; ++f) col = (f == id) ? a.forcing[f] : col;
            val = col[row * T + t_in];
            break;
          }
          case SRC_NEURAL: val = ehe_pick<EHS_MAX_OUT>(nv, id); break;
          case SRC_SCALAR: val = SC[id]; break;
          default: val = a.arg_const[k]; break;
        }
      }
      av[k] = val;
    }
    ehe_form(a.form, av, fout, pd);
  };

  for (int s = 0; s < n_steps; ++s) {
    const int e_ix = s / a.n_batches;
    const int* idx = a.perm + (int64_t)e_ix * a.n_rows + (int64_t)(s - e_ix * a.n_batches) * B;

    // ---- the loss scales and the batch's validity, every block alike ----
    float total = 0.0f;
    for (int j = 0; j < NT; ++j) {
      float c = 0.0f, ys = 0.0f;
      for (int i = tid; i < B * TO; i += nth) {
        const int64_t at = (int64_t)idx[i / TO] * TO + i % TO;
        c += a.mask[j][at];
        ys += a.y[j][at];
      }
      c = block_sum(c);
      ys = block_sum(ys);
      const float n = fmaxf(c, 1.0f);
      const float mu = ys / n;
      float sst = 0.0f;
      if (loss_sst) {
        float d2 = 0.0f;
        for (int i = tid; i < B * TO; i += nth) {
          const int64_t at = (int64_t)idx[i / TO] * TO + i % TO;
          const float d = (a.y[j][at] - mu) * a.mask[j][at];
          d2 += d * d;
        }
        sst = block_sum(d2);
      }
      total += c;
      if (tid == 0) {
        SCL[j] = a.loss_nse ? a.agg_scale / fmaxf(sst, EHS_SST_EPS)
                 : a.loss_sum ? a.agg_scale
                              : a.agg_scale / n;
        TN[j] = n;
        TMU[j] = mu;
        TSS[j] = sst;
      }
    }
    const bool valid = total > 0.0f;
    // the step's gradients from zero
    for (int i = tid; i < NC * LDW; i += nth) GW[i] = 0.0f;
    for (int i = tid; i < P * U; i += nth) GH[i] = 0.0f;
    for (int i = tid; i < P + G; i += nth) GS[i] = 0.0f;
    for (int i = tid; i < 2 * F; i += nth) GN[i] = 0.0f;
    if (tid == 0) MISC[1] = 0.0f;
    __syncthreads();
    EHS_STAMP(0);

    // ---- forward over every tile: the checkpoints into the workspace ----
    for (int tile = 0; tile < a.tiles; ++tile) {
      const int t0 = tile * TW;
      for (int w = tid; w < TW; w += nth) ROWS[w] = t0 + w < B ? idx[t0 + w] : -1;
      __syncthreads();
      // the cell's input of step tt into the inputs of parity par
      // the raw input feature e = w F + k of step tt (0 past the batch)
      auto raw_x = [&](int tt, int e) {
        const int w = e / F, k = e - w * F;
        const int row = ROWS[w];
        return row >= 0 ? a.x[((int64_t)row * T + tt) * F + k] : 0.0f;
      };
      // ... into the inputs of parity par, normed
      auto put_x = [&](int par, int e, float xv) {
        const int w = e / F, k = e - w * F;
        float xhat;
        XH[par * FH * TW + k * TW + w] = ROWS[w] >= 0 ? ehs_input(xv, k, norm, BM, BR, NS, F, &xhat)
                                                      : 0.0f;
      };
      for (int e = tid; e < F * TW; e += nth) put_x(0, e, raw_x(0, e));
      __syncthreads();
      for (int tt = 0; tt < T; ++tt) {
        const int par = tt & 1;
        const float* xp = XH + par * FH * TW;
        // the next step's inputs, loaded now and stored after the cells
        float xpf[EHS_XPF];
#pragma unroll
        for (int i = 0; i < EHS_XPF; ++i) {
          const int e = tid + i * nth;
          xpf[i] = tt + 1 < T && e < F * TW ? raw_x(tt + 1, e) : 0.0f;
        }
        // pre-activations of the block's gate rows, a thread a row and 4 windows
        for (int e = tid; e < R * TW4; e += nth) {
          const int r = e % R, wq = e / R;
          const float b = W[FH * LDW + r];
          float z0 = b, z1 = b, z2 = b, z3 = b;
          const int cend = tt > 0 ? FH : F;  // h before the first step is 0
#pragma unroll 4
          for (int c = 0; c < cend; ++c) {
            const float wv = W[c * LDW + r];
            const float4 xv = *reinterpret_cast<const float4*>(xp + c * TW + 4 * wq);
            z0 = fmaf(wv, xv.x, z0);
            z1 = fmaf(wv, xv.y, z1);
            z2 = fmaf(wv, xv.z, z2);
            z3 = fmaf(wv, xv.w, z3);
          }
          Z[(4 * wq) * R + r] = z0;
          Z[(4 * wq + 1) * R + r] = z1;
          Z[(4 * wq + 2) * R + r] = z2;
          Z[(4 * wq + 3) * R + r] = z3;
        }
        __syncthreads();
        EHS_STAMP(1);
        // the cell of each owned unit and window; h_t into every block's inputs
        for (int e = tid; e < nu * TW; e += nth) {
          const int u = e % nu, w = e / nu;
          const int j = j0 + u;
          const float* zr = Z + w * R;
          const float ig = ehe_sigmoid_nb(zr[u]);
          const float fg = ehe_sigmoid_nb(zr[U + u]);
          const float gg = tanhf(zr[2 * U + u]);
          const float og = ehe_sigmoid_nb(zr[3 * U + u]);
          const float c_prev = tt > 0 ? DCC[w * U + u] : 0.0f;
          const float c_new = fg * c_prev + ig * gg;
          const float h = og * tanhf(c_new);
          DCC[w * U + u] = c_new;
          const int64_t i = t0 + w;
          if (i < B) {
            const int64_t at = i * T + tt;
            HS[at * H + j] = h;
            CS[at * H + j] = c_new;
            float* gt = GT + at * 4 * H + j;
            gt[0] = ig;
            gt[H] = fg;
            gt[2 * H] = gg;
            gt[3 * H] = og;
          }
          if (tt + 1 < T) {
            const int off = (par ^ 1) * FH * TW + (F + j) * TW + w;
            for (int rk = 0; rk < C; ++rk)
              (C > 1 ? cluster.map_shared_rank(XH, rk) : XH)[off] = h;
          }
        }
        if (tt + 1 < T) {
#pragma unroll
          for (int i = 0; i < EHS_XPF; ++i) {
            const int e = tid + i * nth;
            if (e < F * TW) put_x(par ^ 1, e, xpf[i]);
          }
          for (int e = tid + EHS_XPF * nth; e < F * TW; e += nth) put_x(par ^ 1, e, raw_x(tt + 1, e));
        }
        EHS_STAMP(2);
        // every block's slice of h_t is in place (and the workspace is seen)
        if (C > 1) {
          cluster.sync();
        } else {
          __syncthreads();
        }
        EHS_STAMP(3);
      }
    }

    // ---- the two-pass losses: the batch's predictions and moments ----
    if constexpr (TWO_PASS) {
      for (int e = tid; e < B * TO; e += nth) {
        const int i = e / TO, tt = e - i * TO;
        head(idx[i], i, tt);
        for (int j = 0; j < NT; ++j) PRS[(int64_t)j * B * TO + e] = ehe_pick<EH_MAX_OUT>(fout, a.target_out[j]);
      }
      __syncthreads();
      for (int j = 0; j < NT; ++j) {
        const float* pr = PRS + (int64_t)j * B * TO;
        float s1 = 0.0f;
        for (int e = tid; e < B * TO; e += nth) {
          const int64_t at = (int64_t)idx[e / TO] * TO + e % TO;
          const float mk = a.mask[j][at];
          const float d = (pr[e] - a.y[j][at]) * mk;
          s1 += LK == LOSS_RMSE ? d * d : pr[e] * mk;
        }
        s1 = block_sum(s1);
        const float nj = TN[j];
        float c[8] = {a.agg_scale, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (LK == LOSS_RMSE) {
          const float r = sqrtf(s1 / nj);
          c[1] = a.agg_scale / (nj * ehe_max_nan(r, 1e-30f));
          c[7] = a.agg_scale * r;
        } else {
          const float mh = s1 / nj;
          const float my = TMU[j];
          float shh = 0.0f, chy = 0.0f;
          for (int e = tid; e < B * TO; e += nth) {
            const int64_t at = (int64_t)idx[e / TO] * TO + e % TO;
            const float mk = a.mask[j][at];
            const float dh = (pr[e] * mk - mh) * mk;
            const float dy = (a.y[j][at] - my) * mk;
            shh += dh * dh;
            chy += dh * dy;
          }
          shh = block_sum(shh);
          chy = block_sum(chy);
          float d[3];
          const float g = ehe_stat_loss(LK, mh, shh, chy, TSS[j], my, nj, d);
          c[3] = mh;
          c[4] = d[0];
          c[5] = 2.0f * d[1];
          c[6] = d[2];
          c[7] = a.agg_scale * g;
        }
        if (tid == 0)
          for (int k = 0; k < 8; ++k) LC[8 * j + k] = c[k];
      }
      __syncthreads();
      EHS_STAMP(4);
    }

    // ---- backward, tile by tile ----
    for (int tile = 0; tile < a.tiles; ++tile) {
      const int t0 = tile * TW;
      for (int w = tid; w < TW; w += nth) ROWS[w] = t0 + w < B ? idx[t0 + w] : -1;
      __syncthreads();
      // the head at the trailing steps, a thread a (window, step) pair: the
      // loss term, the head cotangents and the globals' cotangents
      for (int e = tid; e < TW * TO; e += nth) {
        const int w = e / TO, tt = e - w * TO;
        const int row = ROWS[w];
        float term = 0.0f;
        float hdv[EHS_MAX_OUT];
        float gacc[EH_MAX_SCALARS];
#pragma unroll
        for (int q = 0; q < EHS_MAX_OUT; ++q) hdv[q] = 0.0f;
#pragma unroll
        for (int q = 0; q < EH_MAX_SCALARS; ++q) gacc[q] = 0.0f;
        if (row >= 0) {
          head(row, t0 + w, tt);
          float cot[EH_MAX_TARGETS];
#pragma unroll
          for (int j = 0; j < EH_MAX_TARGETS; ++j) {
            cot[j] = 0.0f;
            if (j < NT) {
              const int64_t at = (int64_t)row * TO + tt;
              const float pred = ehe_pick<EH_MAX_OUT>(fout, a.target_out[j]);
              const float yv = a.y[j][at];
              const float mk = a.mask[j][at];
              const float diff = (pred - yv) * mk;
              EhLossCoef c = {};
              if constexpr (TWO_PASS) {
                const float* lc = LC + 8 * j;
                c.c0 = lc[0];
                c.c1 = lc[1];
                c.n = TN[j];
                c.mu_h = lc[3];
                c.mu_y = TMU[j];
                c.k_mu = lc[4];
                c.k_h = lc[5];
                c.k_c = lc[6];
              } else {
                c.c0 = SCL[j];
                c.c1 = 2.0f * SCL[j];
              }
              term += ehe_loss_row<TWO_PASS>(LK, c, pred, yv, mk, diff, cot[j]);
            }
          }
          float dn[EHS_MAX_OUT];
#pragma unroll
          for (int q = 0; q < EHS_MAX_OUT; ++q) dn[q] = 0.0f;
#pragma unroll
          for (int k = 0; k < EH_MAX_ARGS; ++k) {
            if (k < a.n_args) {
              const int src = a.arg_src[k];
              const int id = a.arg_idx[k];
              if (src == SRC_NEURAL || (src == SRC_SCALAR && id < G)) {
                float c = 0.0f;
#pragma unroll
                for (int j = 0; j < EH_MAX_TARGETS; ++j) {
                  if (j < NT) {
                    float part = 0.0f;
#pragma unroll
                    for (int oo = 0; oo < EH_MAX_OUT; ++oo)
                      part = (oo == a.target_out[j]) ? pd[oo][k] : part;
                    c += cot[j] * part;
                  }
                }
                if (src == SRC_NEURAL) {
#pragma unroll
                  for (int q = 0; q < EHS_MAX_OUT; ++q) dn[q] += (q == id) ? c : 0.0f;
                } else {
#pragma unroll
                  for (int q = 0; q < EH_MAX_SCALARS; ++q) gacc[q] += (q == id) ? c : 0.0f;
                }
              }
            }
          }
#pragma unroll
          for (int q = 0; q < EHS_MAX_OUT; ++q) hdv[q] = (dn[q] * dsc[q]) * dact[q];
        }
        for (int q = 0; q < P; ++q) HDS[e * P + q] = ehe_pick<EHS_MAX_OUT>(hdv, q);
        for (int q = 0; q < G; ++q) GCS[e * G + q] = ehe_pick<EH_MAX_SCALARS>(gacc, q);
        LTS[e] = term;
      }
      __syncthreads();
      // the tile's sums over its pairs, in pair order: the head bias, the
      // globals and the loss alike in every block; the own head columns
      for (int e = tid; e < P + G + 1; e += nth) {
        float v = 0.0f;
        if (e < P) {
          for (int pq = 0; pq < TW * TO; ++pq) v += HDS[pq * P + e];
          GS[e] += v;
        } else if (e < P + G) {
          for (int pq = 0; pq < TW * TO; ++pq) v += GCS[pq * G + e - P];
          GS[e] += v;
        } else {
          for (int pq = 0; pq < TW * TO; ++pq) v += LTS[pq];
          MISC[1] += v;  // the batch's loss
        }
      }
      for (int e = tid; e < P * nu; e += nth) {
        const int q = e / nu, u = e - q * nu;
        float v = 0.0f;
        for (int pq = 0; pq < TW * TO; ++pq) {
          const int64_t i = t0 + pq / TO;
          if (i >= B) break;
          v = fmaf(HDS[pq * P + q], HS[(i * T + T - TO + pq % TO) * H + j0 + u], v);
        }
        GH[q * U + u] += v;
      }

      EHS_STAMP(5);
      // backward through time
      for (int tt = T - 1; tt >= 0; --tt) {
        const int par = tt & 1;
        // the gate cotangents of the owned units, from the kept gates
        for (int e = tid; e < U * TW; e += nth) {
          const int u = e % U, w = e / U;
          const int64_t i = t0 + w;
          float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (u < nu && i < B) {
            const int j = j0 + u;
            float dh = 0.0f;
            if (tt < T - 1) {
              const float* rv = RECV + (par ^ 1) * C * TW * U + w * U + u;
              for (int rk = 0; rk < C; ++rk) dh += rv[rk * TW * U];
            }
            if (tt >= T - TO) {  // the head's seed
              const float* hd = HDS + (w * TO + tt - (T - TO)) * P;
              for (int q = 0; q < P; ++q) dh = fmaf(HW[q * H + j], hd[q], dh);
            }
            const int64_t at = i * T + tt;
            const float* gt = GT + at * 4 * H + j;
            const float ig = gt[0], fg = gt[H], gg = gt[2 * H], og = gt[3 * H];
            const float c_prev = tt > 0 ? CS[(at - 1) * H + j] : 0.0f;
            const float tanh_c = tanhf(CS[at * H + j]);
            const float dc = (tt < T - 1 ? DCC[w * U + u] : 0.0f) + dh * og * (1.0f - tanh_c * tanh_c);
            dz[0] = (dc * gg) * ig * (1.0f - ig);
            dz[1] = (dc * c_prev) * fg * (1.0f - fg);
            dz[2] = (dc * ig) * (1.0f - gg * gg);
            dz[3] = (dh * tanh_c) * og * (1.0f - og);
            DCC[w * U + u] = dc * fg;
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            Z[w * R + g * U + u] = dz[g];
            ZT[(g * U + u) * TW + w] = dz[g];
          }
        }
        // the tile's (x_t, h_{t-1}, 1, xhat_t) rows, EHS_ILP loads issued at once:
        // column c of window w is x (c < F), h_{t-1}, a 1 (c = F + H), xhat
        for (int base = tid; base < TW * LDV; base += EHS_ILP * nth) {
          float v[EHS_ILP];
#pragma unroll
          for (int i = 0; i < EHS_ILP; ++i) {
            const int e = base + i * nth;
            const int w = e / LDV, c = e - w * LDV;
            const int row = e < TW * LDV ? ROWS[w] : -1;
            const float* src = nullptr;
            if (row >= 0) {
              if (c < F || (norm && c >= NC && c < NC + F)) {
                src = a.x + ((int64_t)row * T + tt) * F + (c < F ? c : c - NC);
              } else if (c >= F && c < FH && tt > 0) {
                src = HS + ((int64_t)(t0 + w) * T + tt - 1) * H + (c - F);
              }
            }
            v[i] = src != nullptr ? *src : (row >= 0 && c == FH ? 1.0f : 0.0f);
          }
#pragma unroll
          for (int i = 0; i < EHS_ILP; ++i) {
            const int e = base + i * nth;
            if (e >= TW * LDV) break;
            const int w = e / LDV, c = e - w * LDV;
            float val = v[i];
            if (ROWS[w] >= 0 && (c < F || (c >= NC && c < NC + F))) {
              float xhat;
              val = ehs_input(val, c < F ? c : c - NC, norm, BM, BR, NS, F, &xhat);
              if (c >= NC) val = xhat;
            }
            VB[e] = val;
          }
        }
        __syncthreads();
        EHS_STAMP(6);
        // dh of the step before: this block's part of wh^T dz for every unit,
        // into the owner's receive buffer, in this block's slot; with a norm,
        // its part of wi^T dz, the normed input's cotangent, for every feature
        {
          const int c0 = norm ? 0 : F;           // the first column: wi's with a norm
          const int c1 = tt > 0 ? FH : F;        // past the last: no dh before step 0
          for (int e = tid; e < (c1 - c0) * TW4; e += nth) {
            const int c = c0 + e % (c1 - c0), wq = e / (c1 - c0);
            const float* wr = W + c * LDW;
            const float* dz = ZT + 4 * wq;
            float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
#pragma unroll 4
            for (int r = 0; r < R; ++r) {
              const float wv = wr[r];
              const float4 d = *reinterpret_cast<const float4*>(dz + r * TW);
              d0 = fmaf(wv, d.x, d0);
              d1 = fmaf(wv, d.y, d1);
              d2 = fmaf(wv, d.z, d2);
              d3 = fmaf(wv, d.w, d3);
            }
            if (c < F) {
              float* dx = DXN + 4 * wq * F + c;
              dx[0] = d0;
              dx[F] = d1;
              dx[2 * F] = d2;
              dx[3 * F] = d3;
              continue;
            }
            const int k = c - F, owner = k / U;
            float* dst = (C > 1 ? cluster.map_shared_rank(RECV, owner) : RECV) + par * C * TW * U +
                         (rank * TW + 4 * wq) * U + (k - owner * U);
            dst[0] = d0;
            dst[U] = d1;
            dst[2 * U] = d2;
            dst[3 * U] = d3;
          }
        }
        EHS_STAMP(7);
        // the own rows' gradients: a thread a 4 x 4 unit of (row, column)
        {
          const int RB = R / 4, NCB = (NC + 3) / 4;
          for (int e = tid; e < RB * NCB; e += nth) {
            const int cb = e % NCB, rb = e / NCB;
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
            for (int w = 0; w < TW; ++w) {
              const float4 d = *reinterpret_cast<const float4*>(Z + w * R + 4 * rb);
              const float4 v = *reinterpret_cast<const float4*>(VB + w * LDV + 4 * cb);
              const float dd[4] = {d.x, d.y, d.z, d.w};
              const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(dd[i], vv[k], acc[i][k]);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int c = 4 * cb + k;
              if (c < NC) {
#pragma unroll
                for (int i = 0; i < 4; ++i) GW[c * LDW + 4 * rb + i] += acc[i][k];
              }
            }
          }
        }
        EHS_STAMP(8);
        // the norm's scale and bias: this block's part of wi^T dz, times xhat,
        // summed over the tile's windows in order
        if (norm) {
          __syncthreads();  // DXN is written
          for (int k = tid; k < F; k += nth) {
            float gsc = 0.0f, gbi = 0.0f;
            for (int w = 0; w < TW; ++w) {
              const float d = DXN[w * F + k];
              gsc = fmaf(d, VB[w * LDV + NC + k], gsc);
              gbi += d;
            }
            GN[k] += gsc;
            GN[F + k] += gbi;
          }
        }
        EHS_STAMP(9);
        // the dh parts are in place; the tile's rows and dz may be overwritten
        if (C > 1) {
          cluster.sync();
        } else {
          __syncthreads();
        }
        EHS_STAMP(10);
      }
    }

    // ---- the update of the block's own parameters ----
    if constexpr (TWO_PASS) {  // the batch's terms, once
      if (tid == 0)
        for (int j = 0; j < NT; ++j) MISC[1] += LC[8 * j + 7];
    }
    if (valid) {
      const EhOptStep st = ehe_opt_step(opt, t + 1.0f);
      // owned element e: its packed index, its place in shared memory, its
      // gradient, and whether the other blocks keep a copy of it
      const int n_rows_own = 4 * nu * NC, n_head_own = P * nu;
      const int n_own = n_rows_own + n_head_own + (rank == 0 ? 2 * (norm ? F : 0) + P + G : 0);
      auto element = [&](int e, int& p, float*& slot, float& grad, bool& shared) {
        shared = false;
        if (e < n_rows_own) {
          const int ri = e / NC, c = e - ri * NC;
          const int g = ri / nu, u = ri - g * nu;
          const int r = g * U + u, row = g * H + j0 + u;
          p = c < F ? a.p_off_wi + row * F + c
              : c < FH ? a.p_off_wh + row * H + (c - F)
                       : a.p_off_b + row;
          slot = W + c * LDW + r;
          grad = GW[c * LDW + r];
          return;
        }
        e -= n_rows_own;
        shared = true;
        if (e < n_head_own) {
          const int q = e / nu, u = e - q * nu;
          p = a.p_off_hw + q * H + j0 + u;
          slot = HW + q * H + j0 + u;
          grad = GH[q * U + u];
          return;
        }
        e -= n_head_own;
        if (norm && e < 2 * F) {
          p = e;
          slot = NS + e;
          float g = 0.0f;
          for (int rk = 0; rk < C; ++rk) g += (C > 1 ? cluster.map_shared_rank(GN, rk) : GN)[e];
          grad = g;
          return;
        }
        e -= norm ? 2 * F : 0;
        if (e < P) {
          p = a.p_off_hb + e;
          slot = HB + e;
          grad = GS[e];
          return;
        }
        e -= P;
        p = a.p_off_g + e;
        slot = GL + e;
        grad = GS[P + e] * DG[e];
      };
      if (opt.rule == OPT_LAMB) {
        // this block's part of every leaf's norms, then the blocks' parts in rank order
        for (int l = 0; l < opt.n_leaves; ++l) {
          const int64_t lo = ehe_leaf_start(opt, l), hi = opt.leaf_end[l];
          float ps = 0.0f, ds = 0.0f;
          for (int e = tid; e < n_own; e += nth) {
            int p;
            float* slot;
            float g;
            bool shared;
            element(e, p, slot, g, shared);
            if (p < lo || p >= hi) continue;
            float mm = a.m[p], vv = a.v[p];
            const float d = ehe_lamb_direction(opt, st, *slot, g, mm, vv);
            ps += *slot * *slot;
            ds += d * d;
          }
          ps = block_sum(ps);
          ds = block_sum(ds);
          if (tid == 0) {
            LB[2 * l] = ps;
            LB[2 * l + 1] = ds;
          }
        }
        if (C > 1) {
          cluster.sync();
        } else {
          __syncthreads();
        }
        for (int l = tid; l < opt.n_leaves; l += nth) {
          float ps = 0.0f, ds = 0.0f;
          for (int rk = 0; rk < C; ++rk) {
            const float* part = C > 1 ? cluster.map_shared_rank(LB, rk) : LB;
            ps += part[2 * l];
            ds += part[2 * l + 1];
          }
          TR[l] = ehe_trust_ratio(ps, ds);
        }
        __syncthreads();
      }
      for (int e = tid; e < n_own; e += nth) {
        int p;
        float* slot;
        float g;
        bool shared;
        element(e, p, slot, g, shared);
        ehe_update(opt, st, slot, &a.m[p], &a.v[p], &a.u[p], g,
                   opt.rule == OPT_LAMB ? TR[ehe_leaf_of(opt, p)] : 1.0f);
        if (shared && C > 1) {
          const int off = (int)(slot - sm);
          const float np = *slot;
          for (int rk = 0; rk < C; ++rk)
            if (rk != rank) cluster.map_shared_rank(sm, rk)[off] = np;
        }
      }
    }
    t += valid ? 1.0f : 0.0f;
    // every block's copies are updated, every partial read
    if (C > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    scale_globals();
    if (rank == 0 && tid == 0) {
      if (s % a.n_batches == 0) MISC[2] = 0.0f;
      if (valid) MISC[2] += MISC[1];
      if (s % a.n_batches == a.n_batches - 1) last_loss = MISC[2] / (float)a.n_batches;
    }
    __syncthreads();
    EHS_STAMP(11);
  }

  // ---- the parameters back: each block its own, block 0 the shared ones ----
  for (int e = tid; e < 4 * nu * NC; e += nth) {
    const int ri = e / NC, c = e - ri * NC;
    const int g = ri / nu, u = ri - g * nu;
    const int row = g * H + j0 + u;
    const int p = c < F ? a.p_off_wi + row * F + c
                  : c < FH ? a.p_off_wh + row * H + (c - F)
                           : a.p_off_b + row;
    a.params[p] = W[c * LDW + g * U + u];
  }
  for (int e = tid; e < P * nu; e += nth) {
    const int q = e / nu, u = e - q * nu;
    a.params[a.p_off_hw + q * H + j0 + u] = HW[q * H + j0 + u];
  }
  if (rank == 0) {
    for (int i = tid; i < (norm ? 2 * F : 0); i += nth) a.params[i] = NS[i];
    for (int i = tid; i < P; i += nth) a.params[a.p_off_hb + i] = HB[i];
    for (int i = tid; i < G; i += nth) a.params[a.p_off_g + i] = GL[i];
    if (tid == 0) {
      a.t[0] = (int)lrintf(t);
      a.loss[0] = last_loss;
#ifdef EHS_STAMPS
      stamp_acc[EHS_N_STAMPS - 1] = clock64() - stamp_first;
      for (int k = 0; k < EHS_N_STAMPS; ++k) ehs_stamps[k] = stamp_acc[k];
#endif
    }
  }
  if (C > 1) cluster.sync();  // no block leaves while another may read its memory
}

extern "C" int eh_fused_lstm_split_args_size(void) {
  return (int)sizeof(EhLstmSplitArgs);
}

// Shared-memory floats of one launch; ops/fused_lstm_split.py's
// split_smem_floats computes the same.
static size_t ehs_smem_floats(const EhLstmSplitArgs* a) {
  return (size_t)ehs_smem(*a).total;
}

template <bool TWO_PASS>
static int ehs_launch(const EhLstmSplitArgs* args, size_t smem, cudaStream_t s) {
  static bool allowed = false;  // the full 227 KB, once per build
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(eh_lstm_split_kernel<TWO_PASS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 EH_MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  return (int)eh_launch_cluster(eh_lstm_split_kernel<TWO_PASS>, *args, args->cluster,
                                args->threads, smem, s);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes, devices and the envelope before it gets here.
extern "C" int eh_fused_lstm_split(const EhLstmSplitArgs* args, void* stream) {
  if (args->n_epochs <= 0 || args->n_batches <= 0) return 0;
  const size_t smem = ehs_smem_floats(args) * sizeof(float);
  const int c = args->cluster;
  if (smem > EH_MAX_SMEM_BYTES || args->hidden < 1 || args->hidden > EHS_MAX_HIDDEN ||
      args->n_features < 1 || args->n_features > EH_MAX_WIDTH || args->n_out < 1 ||
      args->n_out > EHS_MAX_OUT || args->n_steps < 1 || args->n_steps > EHS_MAX_STEPS ||
      args->n_out_steps < 1 || args->n_out_steps > args->n_steps ||
      args->n_args > EH_MAX_ARGS || !eh_form_built(args->form) || args->n_targets < 1 ||
      args->n_targets > EH_MAX_TARGETS || !eh_loss_built(args->loss_kind) ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS ||
      (c != 1 && c != 2 && c != 4 && c != 8 && c != EHS_MAX_CLUSTER) ||
      args->units < 1 || (int64_t)args->units * c < args->hidden ||
      (int64_t)(args->units - 1) * c >= args->hidden || args->threads < 32 ||
      args->threads > EHS_MAX_THREADS || args->threads % 32 != 0 || args->windows < 4 ||
      args->windows % 4 != 0 || (int64_t)args->tiles * args->windows < args->batch ||
      (int64_t)(args->tiles - 1) * args->windows >= args->batch || args->work == nullptr ||
      args->work_floats < ehs_work_floats(*args) || args->optimizer.n_leaves < 1 ||
      args->optimizer.n_leaves > EH_MAX_LEAVES) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool two_pass = args->loss_kind == LOSS_RMSE || ehe_loss_is_stat(args->loss_kind);
  return two_pass ? ehs_launch<true>(args, smem, s) : ehs_launch<false>(args, smem, s);
}
