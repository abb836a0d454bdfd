// Fused training epochs of the LSTM sequence hybrid for Hopper, sm_90a.
//
// Replaces the LSTM body of the Pallas TPU kernel built by make_fused_epoch in
// easyhybrid_tpu/ops/fused_epoch.py (kernel_body_lstm at :1700, chosen at
// :2479; pallas_call at :2662). One launch runs n_epochs x n_batches
// optimizer steps of a SingleNN hybrid whose network is an LSTM over windows
// of n_steps time steps with a Dense head. Each step:
//   1. gathers the batch's windows through the index perm[e][i*B + r];
//   2. the loss scale of every target over the whole (n_out_steps x B)
//      window: agg / max(sum(mask), 1) for mse, mae and a traced elementwise
//      loss by mean, agg for one by sum, agg / max(SST, 1e-12) of the masked
//      target about its masked mean for nseLoss; the batch is valid when any
//      mask is set;
//   3. per window: the static input norm with its trained scale and bias (or
//      none), then the recurrence z = wi x_t + wh h + b, gates i f g o,
//      c = f c + i g, h = o tanh(c) from h = c = 0, saving (x_t, h_t, c_t);
//   4. at the trailing n_out_steps steps: the head, sigmoid bound scaling,
//      the mechanistic model in its kernel form with its partials, the masked
//      loss term and its cotangent, the head's output cotangent. rmse and the
//      statistic losses (pearsonLoss, kgeLoss, pbkgeLoss) are the JAX body's
//      two-pass losses (:1921-2047): their cotangents need the moments of the
//      predictions over the whole (n_out_steps x B) window first, so a head
//      pass of their own keeps each trailing step's predictions, the batch's
//      moments are exchanged (rmse's squared differences; the masked
//      predictions' sum, then their centred squares and products with the
//      centred targets), g and its partials are taken (ehe_stat_loss), and the
//      head pass of step 4 turns them into cotangents;
//   5. backward through time, from the gates the forward kept:
//      dh = dh_next + head^T D_t, dc += dh o (1 - tanh(c)^2), the four gate
//      cotangents dz, dh_next = wh^T dz, dc *= f; with a norm the cotangent
//      wi^T dz of the normed input feeds the norm's scale and bias;
//   6. gradients summed over the batch's windows and time steps in a fixed
//      order; an all-masked batch changes nothing; the update by any of the
//      optax rules of the JAX kernel (eh_device.cuh, ehe_update).
//
// The member axis (population training, replacing the JAX kernel under
// jax.vmap in easyhybrid_tpu/training/population.py:215 and :355): one launch
// trains n_members models side by side, a thread-block cluster each (the grid
// (cluster, n_members), the member blockIdx.y), as kernel 2's member axis
// does (fused_epoch.cu). Member k's parameters (the norm's trained scale and
// bias among them), slots, statistics, step count and loss are the k-th rows
// of the state arrays; its row index sits perm_stride further on (0 where the
// members share one); its data is where its row index points (a fold's
// windows follow the folds before it); its optimizer numbers are row k of
// member_opt, or the shared struct's where that is null. The members share
// nothing and never wait on one another: each cluster runs the one-model code
// on its own numbers, so a member's bits are those of a launch of it alone.
//
// What bounds it on an H100: latency. A window of LSTM(16) over 10 steps is
// 10 dependent cell evaluations forward and 10 backward, each optimizer step
// needs the one before it, and a step is ~90,000 flops a window: the card's
// arithmetic and memory rates are far away, the chain is everything.
//
// What the design does about it:
//   * The whole batch in flight: a thread-block cluster of up to 8 blocks
//     (16 where the card allows a non-portable cluster) shares a batch's
//     windows, each block holding its windows at once; only a batch beyond
//     that walks tiles of windows.
//   * A window's recurrence inside one warp: a window has min(32, width)
//     lanes, a lane one hidden unit (two at width 64). A lane computes its
//     unit's four gates from the whole previous h, written by the window's
//     lanes beside the checkpoints and read back after __syncwarp; backward,
//     each lane's share of wh^T dz is summed over the window's lanes by a
//     folding shuffle tree (ehe_fold) that leaves each lane the sums of its
//     own units. No block barrier sits inside the time loop. Up to width 16
//     a lane keeps its recurrent weights in registers for the step; wider, it
//     reads them from shared memory, where wi and wh are kept transposed so
//     that a window's lanes read consecutive words. The gates are kept, not
//     recomputed: the forward writes a step's four gate activations into
//     the words that will hold the step's gate cotangents, and the backward
//     reads them there before it overwrites them, so keeping them costs no
//     shared memory and spares the backward 4 (F + H) products a unit and
//     step.
//   * Gradient sums out of the time loop: every step's gate cotangents stay
//     beside the checkpoints, and one pass after the backward sums them, as
//     kernel 2's units: a warp takes 4 x 4 parameters (cotangent feature x
//     input feature), its lanes split the tile's (window, step) pairs, and a
//     folding tree of 16 shuffles leaves the 16 sums. Then the blocks'
//     partials are read through distributed shared memory in rank order by
//     the block that owns the parameter (each block updates a slice of the
//     parameters, with the moments in device memory, which no other block
//     touches) and written into every block. Every sum has a fixed shape:
//     no float atomics, the same bits on every run.
//   * What does not depend on the parameters leaves the chain: the loss
//     scales' counts, means and SSTs of step s + 1 are taken during step s
//     over the whole batch by every block alike (the same order, so the same
//     bits), warp-wide partials summed by each warp itself; what the
//     optimizer rule takes from the step count is taken a step ahead.
//   * The two-pass losses are a build of their own (TWO_PASS), so that the
//     other losses keep the code, registers and time they had. Where the
//     blocks hold their windows at once (one tile) the forward runs once: the
//     head pass keeps the trailing steps' predictions in shared memory, each
//     exchange is a cluster barrier and a sum of every block's warp partials
//     in rank and warp order (kernel 2's), and the cotangent pass recomputes
//     the head beside the kept checkpoints. A block that walks tiles takes
//     the moments first, in passes of their own that run the tiles' forward
//     again (once for rmse, twice for the statistic losses), since the
//     checkpoints of one tile are all a block keeps. Built with
//     -DEHL_RECOMPUTE_PASSES, the one-tile case takes those passes too, to
//     measure the two layouts against each other.
//   * Lamb's trust ratio needs per-leaf norms, and a leaf can straddle the
//     blocks' slices: each block sums its slice's part of every leaf (a warp
//     a leaf), and after a cluster barrier each block adds the blocks' parts
//     in rank order through distributed shared memory, so all get the same
//     bits.
// Per step: two cluster barriers (the gradient partials; the updated
// slices, written by their owners into every block) and one block barrier
// after the backward; rmse one more cluster barrier and a block barrier, the
// statistic losses two more and a block barrier. The epoch's loss is summed
// per block and read across the cluster once an epoch.
//
// Built without --use_fast_math, as fused_forward.cu.

#include <cstddef>

#include "eh_device.cuh"

#define EH_LSTM_MAX_OUT 8
#define EH_LSTM_MAX_CLUSTER 16
#define EH_LSTM_SST_EPS 1e-12f
// threads a block may have: 255 registers a thread hold a lane's recurrent
// weights (width 16) or its share of wh^T dz (width 64) without spilling
#define EHL_MAX_THREADS 256
// loss-scale elements a thread prefetches a step ahead
#define EHL_PREFETCH 2

// Built with -DEHL_STAMPS, thread 0 of block 0 adds the clock64() cycles it
// spends in each stage of a step to ehl_stamps, read by
// eh_fused_lstm_stamps(), in the order of a step: 0 its start (the loss
// scales from the partials, the next steps' loads, the recurrent weights), 1
// input gather, 8 the recurrence, 2 head and loss, 3 backward through time, 4
// gradient sums, 9 the next step's counts and Adam's corrections, 5 the
// gradient exchange (its barrier), 10 the next step's SSTs and the epoch's
// loss, 6 update, 7 the parameter exchange, 11 the two-pass losses' moments
// exchange (its barriers, g and the coefficients); 12 the whole kernel. Built
// with -DEHL_CHAIN_ONLY, the windows' products are left out: barriers,
// shuffles, loss scales, the checkpoints' traffic and the update remain.
#define EHL_N_STAMPS 13
#ifdef EHL_STAMPS
__device__ long long ehl_stamps[EHL_N_STAMPS];
extern "C" int eh_fused_lstm_stamps(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, ehl_stamps, sizeof(ehl_stamps));
}
#define EHL_STAMP(k)                      \
  do {                                    \
    if (tid == 0 && rank == 0) {          \
      const long long now = clock64();    \
      stamp_acc[k] += now - stamp_last;   \
      stamp_last = now;                   \
    }                                     \
  } while (0)
#else
#define EHL_STAMP(k)
#endif

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
  float* u;                              // amsgrad's third slot, in place (else unused)
  const float* bn;                       // the norm's mean, var (2 n_features)
  int* t;                                // step counter (n_members), in place
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* loss;                           // (n_members) last epoch's mean batch loss
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
  int loss_kind;                         // LOSS_* (eh_device.cuh): squared, absolute, traced
  int loss_nse;                          // scale by the target's SST
  int loss_sum;                          // a traced loss summed: scale agg, not agg / n
  EhOptimizer optimizer;                 // the rule and its hyperparameters
  const int* halt;                       // the halt word (eh_halted), or null
  int threads;                           // of a block: windows x lanes, in whole warps
  int lanes;                             // lanes a window: min(32, width)
  int windows;                           // windows a block holds at once
  int cluster;                           // blocks over a batch's windows
  int tiles;                             // tiles of windows a block walks a step
  int stages;                            // 0: the windows are read in place
  int res_floats;                        // features of a (window, step) pair
  int n_members;                         // models trained side by side, a cluster each (1: train())
  int64_t perm_stride;                   // ints between two members' row indexes (0: one shared)
  const float* member_opt;               // (n_members, EHL_OPT_SCALARS) optimizer numbers, or null
};
// A member's optimizer numbers: EhOptimizer's floats from lr to rect_den, in
// its order (kernel 2's EHE_OPT_* layout); the rule, sgd's Nesterov flag and
// lamb's leaves stay the shared struct's. Each block copies the struct into
// shared memory with its member's numbers in place.
constexpr int EHL_OPT_WORDS = sizeof(EhOptimizer) / sizeof(float);
constexpr int EHL_OPT_FIRST = offsetof(EhOptimizer, lr) / sizeof(float);
constexpr int EHL_OPT_SCALARS =
    (offsetof(EhOptimizer, rect_den) - offsetof(EhOptimizer, lr)) / sizeof(float) + 1;
// Packed parameters: [norm scale, norm bias] (n_features each, with a norm),
// then wi, wh, b, the head's W and b, the raw globals. In shared memory wi and
// wh are transposed, (n_features, 4 hidden) and (hidden, 4 hidden).

// The tile's pair arrays: feature f of the pair (window w, step t) is word
// f * ld + t * windows + w. Offsets, in features. Beside them, the trailing
// steps' head cotangents (feature f of (w, t - T + T_out) at f * ldh +
// (t - T + T_out) * windows + w) and the globals' cotangents, summed over the
// trailing steps a lane of the window takes (feature f of (w, lane l) at
// f * ldg + l * windows + w).
struct EhLstmTile {
  int x, xhat, dxn, h, c, dz, one, total;
};

__host__ __device__ inline EhLstmTile ehl_tile(const EhFusedLstmArgs& a) {
  const int F = a.n_features, H = a.hidden;
  const bool norm = a.norm_mode != NORM_NONE;
  EhLstmTile o;
  o.x = 0;                          // the cell's input
  o.one = F;                        // 1, beside it: the gate biases' input
  o.xhat = F + 1;                   // the normalised input (with a norm)
  o.dxn = o.xhat + (norm ? F : 0);  // its cotangent wi^T dz (with a norm)
  o.h = o.dxn + (norm ? F : 0);     // h over T + 1 steps: step t holds h_{t-1}, step 0 zeros
  o.c = o.h + H;                    // c_t
  o.dz = o.c + H;                   // the four gate cotangents of step t
  o.total = o.dz + 4 * H;
  return o;
}

// Words between two features of an array of `cols` columns: odd, so that a
// window's lanes, one feature each, write different banks.
__host__ __device__ inline int ehl_ld(int cols) {
  return cols | 1;
}

// Packed parameter p's place in shared memory: wi and wh transposed.
__device__ __forceinline__ int ehl_pos(const EhFusedLstmArgs& a, int p) {
  if (p < a.p_off_wi || p >= a.p_off_b) return p;
  const int H4 = 4 * a.hidden;
  if (p < a.p_off_wh) {
    const int q = p - a.p_off_wi;
    const int jj = q / a.n_features;
    return a.p_off_wi + (q - jj * a.n_features) * H4 + jj;
  }
  const int q = p - a.p_off_wh;
  const int jj = q / a.hidden;
  return a.p_off_wh + (q - jj * a.hidden) * H4 + jj;
}

// A unit of the gradient sum: the sums over npairs pairs of u_i * v_k for nj
// features u (the first at word ubase of the pair arrays, ustride apart) and
// nk features v (from vbase, vstride apart), written to packed parameters
// pbase + i * pstride + k, but for k == bcol (the 1 beside the cell's input),
// written to the bias bbase + i.
struct EhlUnit {
  int ubase, ustride, nj, vbase, vstride, nk, pbase, pstride, npairs, bcol, bbase;
};

__device__ __forceinline__ int ehl_n_units(const EhFusedLstmArgs& a) {
  const int F = a.n_features, H = a.hidden;
  const int kF = (F + 3) >> 2, kH = (H + 3) >> 2;
  int n = H * (((F + 4) >> 2) + kH) + ((a.n_out + 3) >> 2) * (kH + 1) + ((a.n_globals + 3) >> 2);
  if (a.norm_mode != NORM_NONE) n += F + kF;
  return n;
}

// Unit u: per block of four gate rows the blocks of wi with the bias beside
// it, then of wh; per block of four head outputs the head's weight blocks and
// bias;
// the norm's scale (one feature a unit) and bias; the globals. ld, ldh and
// ldg are the strides of the pair arrays, the head's and the globals';
// `lanes` is the window's lanes that take trailing steps.
__device__ __forceinline__ EhlUnit ehl_unit(const EhFusedLstmArgs& a, const EhLstmTile& o, int u,
                                            int windows, int lanes, int ld, int ldh, int ldg) {
  const int F = a.n_features, H = a.hidden, P = a.n_out;
  const int T = a.n_steps, TO = a.n_out_steps;
  const int kF = (F + 3) >> 2, kH = (H + 3) >> 2;
  const int hd = o.total * ld;   // the head cotangents' first word
  const int gg = hd + P * ldh;   // the globals'
  const int kF1 = (F + 4) >> 2;  // blocks of the cell's input and the 1 beside it
  EhlUnit x;
  x.nk = 1;
  x.pstride = 1;
  x.vbase = o.one * ld;
  x.vstride = ld;
  x.ustride = ld;
  x.npairs = T * windows;
  x.bcol = 4;
  x.bbase = 0;
  const int per = kF1 + kH;
  if (u < H * per) {
    const int jb = u / per;
    const int kb = u - jb * per;
    x.ubase = (o.dz + 4 * jb) * ld;
    x.nj = 4;
    if (kb < kF1) {
      x.vbase = (o.x + 4 * kb) * ld;
      x.nk = min(4, F + 1 - 4 * kb);
      x.pbase = a.p_off_wi + 4 * jb * F + 4 * kb;
      x.pstride = F;
      x.bcol = F - 4 * kb;
      x.bbase = a.p_off_b + 4 * jb;
    } else {
      const int kk = kb - kF1;
      x.vbase = (o.h + 4 * kk) * ld;  // step t of h holds h_{t-1}
      x.nk = min(4, H - 4 * kk);
      x.pbase = a.p_off_wh + 4 * jb * H + 4 * kk;
      x.pstride = H;
    }
    return x;
  }
  u -= H * per;
  const int nq = (P + 3) >> 2;
  if (u < nq * (kH + 1)) {
    const int qb = u / (kH + 1);
    const int kb = u - qb * (kH + 1);
    x.ubase = hd + 4 * qb * ldh;
    x.ustride = ldh;
    x.nj = min(4, P - 4 * qb);
    x.npairs = TO * windows;
    if (kb < kH) {
      x.vbase = (o.h + 4 * kb) * ld + (T - TO + 1) * windows;  // h_t of the trailing step t
      x.nk = min(4, H - 4 * kb);
      x.pbase = a.p_off_hw + 4 * qb * H + 4 * kb;
      x.pstride = H;
    } else {
      x.pbase = a.p_off_hb + 4 * qb;
    }
    return x;
  }
  u -= nq * (kH + 1);
  if (a.norm_mode != NORM_NONE) {
    if (u < F) {
      x.ubase = (o.dxn + u) * ld;
      x.nj = 1;
      x.vbase = (o.xhat + u) * ld;
      x.pbase = u;
      return x;
    }
    u -= F;
    if (u < kF) {
      x.ubase = (o.dxn + 4 * u) * ld;
      x.nj = min(4, F - 4 * u);
      x.pbase = F + 4 * u;
      return x;
    }
    u -= kF;
  }
  x.ubase = gg + 4 * u * ldg;
  x.ustride = ldg;
  x.nj = min(4, a.n_globals - 4 * u);
  x.npairs = min(lanes, TO) * windows;
  x.pbase = a.p_off_g + 4 * u;
  return x;
}

// The folding tree over a window's lanes: levels HALF, HALF / 2, ... at lane
// bits BIT, BIT / 2, ..., 1.
template <int HALF, int BIT, int N>
__device__ __forceinline__ void ehl_fold(float (&v)[N], int lane) {
  ehe_fold<HALF>(v, (lane & BIT) != 0, BIT);
  if constexpr (BIT > 1) ehl_fold<HALF / 2, BIT / 2>(v, lane);
}

// Pre-activations z[g][u] of the four gates g of the lane's units u (unit
// q U + u, clamped to the last for lanes past the hidden size): xc is the
// pair's column of the cell's input (stride ld), hp the previous h; the
// recurrent weights from registers (wr, br) or shared memory.
template <int HT, int U, bool WR>
__device__ __forceinline__ void ehl_gates(const EhFusedLstmArgs& a, const float* Pm, const float* xc,
                                          int ld, int q, const float (&hp)[HT],
                                          const float (&wr)[4][WR ? HT : 1], const float (&br)[4],
                                          float (&z)[4][U]) {
  const int F = a.n_features, H = a.hidden, H4 = 4 * H;
  const float* wiT = Pm + a.p_off_wi;
  const float* whT = Pm + a.p_off_wh;
  const float* b = Pm + a.p_off_b;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = min(q * U + u, H - 1);
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g][u] = WR ? br[g] : b[g * H + j];
#ifndef EHL_CHAIN_ONLY
    for (int k = 0; k < F; ++k) {
      const float xv = xc[k * ld];
      const float* w = wiT + k * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g][u] = fmaf(w[g * H], xv, z[g][u]);
    }
#pragma unroll
    for (int k = 0; k < HT; ++k) {
      if (k < H) {
        const float hk = hp[k];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          z[g][u] = fmaf(WR ? wr[g][WR ? k : 0] : whT[k * H4 + g * H + j], hk, z[g][u]);
      }
    }
#else
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g][u] += xc[0] + hp[0];
#endif
  }
}

template <int HT, bool TWO_PASS>
__global__ void __launch_bounds__(EHL_MAX_THREADS)
eh_fused_lstm_kernel(const __grid_constant__ EhFusedLstmArgs a) {
  if (eh_halted(a.halt)) return;
  constexpr int L = HT < 32 ? HT : 32;  // lanes a window
  constexpr int U = HT / L;             // hidden units a lane
  constexpr int WPW = 32 / L;           // windows a warp
  constexpr bool WR = HT <= 16;         // the recurrent weights in registers
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster;
  const int rank = (int)cluster.block_rank();  // in the member's cluster
  const int64_t member = blockIdx.y;            // a population's member, 0 for train()
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nth >> 5;
  const int TW = a.windows;
  const int q = lane % L;  // the lane's place in its window
  // its window in the tile; the lanes of a warp past the tile's last window
  // repeat that window's work (the same values to the same words) and add
  // nothing to the loss
  const int wl = min(warp * WPW + lane / L, TW - 1);
  const bool ghost = warp * WPW + lane / L >= TW;
  const int F = a.n_features;
  const int H = a.hidden;
  const int H4 = 4 * H;
  const int P = a.n_out;
  const int G = a.n_globals;
  const int K = a.n_fixed;
  const int NT = a.n_targets;
  const int NP = a.n_params;
  const int B = a.batch;
  const int T = a.n_steps;
  const int TO = a.n_out_steps;
  const int LK = a.loss_kind;
  const int ld = ehl_ld((T + 1) * TW);     // the pair arrays' stride
  const int ldh = ehl_ld(TO * TW);         // the head cotangents' (and the kept predictions')
  const int ldg = ehl_ld(min(L, TO) * TW);  // the globals' cotangents
  const bool norm = a.norm_mode != NORM_NONE;
  const int n_consts = 2 * P + 2 * G + K;
  const EhLstmTile o = ehl_tile(a);
  // nseLoss and the statistic losses: the targets' SST about their mean
  const bool loss_sst = a.loss_nse || ehe_loss_is_stat(LK);
#ifdef EHL_RECOMPUTE_PASSES
  constexpr bool inline_moments = false;
#else
  // the blocks hold their windows at once: the moments between the head's
  // two passes over the one forward
  const bool inline_moments = TWO_PASS && a.tiles == 1;
#endif

  // member k's state: the k-th rows of the state arrays, its row index
  // perm_stride ints on; the offsets are taken where they are used, so that
  // no member pointer stays in a register across the step (a train() launch
  // keeps the registers of the kernel before the member axis)

  float* Pm = sm;                  // parameters, wi and wh transposed
  float* Gr = Pm + NP;             // this block's gradient partial, packed order
  float* BN = Gr + NP;             // the norm's mean, var
  float* Cc = BN + 2 * F;          // constants
  float* SC = Cc + n_consts;       // scaled globals, then fixed values
  float* DG = SC + G + K;          // d scaled global / d raw
  float* BM = DG + G;              // the norm's mean
  float* BR = BM + F;              // rsqrt(var + eps)
  float* MISC = BR + F;            // the rule's step numbers, two steps'; the member
  float* XS1 = MISC + 8;           // counts and target sums, 2 NT a warp, two steps'
  float* XS2 = XS1 + 4 * nw * NT;  // SSTs, NT a warp, two steps'
  float* XL = XS2 + 2 * nw * NT;   // loss, one a warp
  float* BL = XL + nw;             // the block's loss over the epoch, two epochs'
  float* OS = BL + 2;              // the optimizer struct, the member's numbers in it
  float* PA = OS + EHL_OPT_WORDS;  // the tile's pair arrays
  float* HD = PA + o.total * ld;   // the head cotangents
  float* GG = HD + P * ldh;        // the globals' cotangents
  // the two-pass losses (TWO_PASS only; ehl_smem_floats counts them there)
  float* PR = GG + G * ldg;        // the trailing steps' predictions, a target each
  float* XM1 = PR + NT * ldh;      // rmse's squared differences or the predictions' sums, NT a warp
  float* XM2 = XM1 + nw * NT;      // their centred squares and products, 2 NT a warp
  float* LC = XM2 + 2 * nw * NT;   // each target's coefficients of the step, 8 a target

  {
    // the rule and its numbers: the shared struct's, a member's numbers in place
    const int* src = reinterpret_cast<const int*>(&a.optimizer);
    const float* row = a.member_opt != nullptr ? a.member_opt + member * EHL_OPT_SCALARS : nullptr;
    int* dst = reinterpret_cast<int*>(OS);
    for (int i = tid; i < EHL_OPT_WORDS; i += nth) {
      const bool swept =
          row != nullptr && i >= EHL_OPT_FIRST && i < EHL_OPT_FIRST + EHL_OPT_SCALARS;
      dst[i] = swept ? __float_as_int(row[i - EHL_OPT_FIRST]) : src[i];
    }
  }
  for (int i = tid; i < NP; i += nth) Pm[ehl_pos(a, i)] = a.params[member * NP + i];
  for (int i = tid; i < 2 * F; i += nth) BN[i] = norm ? a.bn[member * 2 * F + i] : 0.0f;
  for (int i = tid; i < n_consts; i += nth) Cc[i] = a.consts[i];
  for (int i = tid; i < K; i += nth) SC[G + i] = a.consts[2 * P + 2 * G + i];
  for (int i = tid; i < ld; i += nth) PA[o.one * ld + i] = 1.0f;
  __syncthreads();
  const EhOptimizer& opt = *reinterpret_cast<const EhOptimizer*>(OS);
  for (int k = tid; k < F; k += nth) {
    BM[k] = BN[k];
    BR[k] = rsqrtf(BN[F + k] + a.norm_eps);
  }
  const float* nlo = Cc;
  const float* nspan = Cc + P;
  const float* glo = Cc + 2 * P;
  const float* gspan = Cc + 2 * P + G;
  if (tid < G) {
    const float sg = ehe_sigmoid(Pm[a.p_off_g + tid]);
    SC[tid] = glo[tid] + gspan[tid] * sg;
    DG[tid] = gspan[tid] * (sg * (1.0f - sg));
  }
  const int n_steps = a.n_epochs * a.n_batches;
  const int bw = (B + C - 1) / C;  // windows of a batch a block owns
  const int row0 = rank * bw;
  const int mine = max(0, min(bw, B - row0));
  const int slice = (NP + C - 1) / C;  // parameters a block updates
  const int lo = rank * slice;
  const int hi = min(NP, lo + slice);
  const int n_units = ehl_n_units(a);
  float t = (float)a.t[member];  // every thread carries the same step count
  float last_loss = 0.0f;   // thread 0 of block 0 only
  if (tid == nth - 1) ehe_opt_step_store(ehe_opt_step(opt, t + 1.0f), MISC);  // the first step's
  // the member, read from shared memory where a step uses it: a register
  // that held it (or a pointer offset by it) across the step would cost a
  // train() launch time
  int* const MEMBER = reinterpret_cast<int*>(MISC + 6);
  if (tid == 0) MEMBER[0] = (int)member;
  __syncthreads();
#ifdef EHL_STAMPS
  long long stamp_acc[EHL_N_STAMPS] = {};
  const long long stamp_first = clock64();
  long long stamp_last = stamp_first;
#endif

  auto step_index = [&](int step) {
    const int e = step / a.n_batches;
    return a.perm + MEMBER[0] * a.perm_stride + (int64_t)e * a.n_rows +
           (int64_t)(step - e * a.n_batches) * B;
  };
  auto exchange_barrier = [&]() {
    if (C > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  // The sum of the block's warp partials part[w * width + i], the same bits
  // in every lane of every warp.
  auto warps_sum = [&](const float* part, int width, int i) {
    float v = 0.0f;
    for (int e = lane; e < nw; e += 32) v += part[e * width + i];
    return ehe_warp_sum(v);
  };
  // The loss scales depend on the batch alone: every block takes them over
  // the whole batch, a step ahead, a thread's first EHL_PREFETCH elements
  // (i = tid + k nth of the (B x T_out) window) loaded at the start of the
  // step before from indices loaded a step before that. First pass: every
  // warp's counts and target sums of step `step`.
  float pm[EHL_PREFETCH][EH_MAX_TARGETS], py[EHL_PREFETCH][EH_MAX_TARGETS];
  int pidx[EHL_PREFETCH];  // the windows of the next step's prefetched elements
  auto prefetch_index = [&](int step) {
#pragma unroll
    for (int k = 0; k < EHL_PREFETCH; ++k) {
      const int i = tid + k * nth;
      pidx[k] = step < n_steps && i < B * TO ? step_index(step)[i / TO] : 0;
    }
  };
  auto prefetch_targets = [&](int step) {
#pragma unroll
    for (int k = 0; k < EHL_PREFETCH; ++k) {
      const int i = tid + k * nth;
      const bool in = step < n_steps && i < B * TO;
      const int64_t at = (int64_t)pidx[k] * TO + i % TO;
#pragma unroll
      for (int j = 0; j < EH_MAX_TARGETS; ++j) {
        pm[k][j] = in && j < NT ? a.mask[j][at] : 0.0f;
        py[k][j] = in && j < NT ? a.y[j][at] : 0.0f;
      }
    }
  };
  auto scale_counts = [&](int step) {
    const int* idx = step_index(step);
    float* xs = XS1 + (step & 1) * 2 * nw * NT;
    for (int j = 0; j < NT; ++j) {
      float c = 0.0f, ys = 0.0f;
#pragma unroll
      for (int k = 0; k < EHL_PREFETCH; ++k) {
        c += ehe_pick<EH_MAX_TARGETS>(pm[k], j);
        ys += ehe_pick<EH_MAX_TARGETS>(py[k], j);
      }
      for (int i = tid + EHL_PREFETCH * nth; i < B * TO; i += nth) {
        const int64_t at = (int64_t)idx[i / TO] * TO + i % TO;
        c += a.mask[j][at];
        ys += a.y[j][at];
      }
      c = ehe_warp_sum(c);
      ys = ehe_warp_sum(ys);
      if (lane == 0) {
        xs[warp * 2 * NT + j] = c;
        xs[warp * 2 * NT + NT + j] = ys;
      }
    }
  };
  // Second pass, nseLoss and the statistic losses only, once the first is
  // visible: every warp's SST of the masked targets about their masked mean.
  auto scale_ssts = [&](int step) {
    const int* idx = step_index(step);
    const float* xs = XS1 + (step & 1) * 2 * nw * NT;
    float* xd = XS2 + (step & 1) * nw * NT;
    for (int j = 0; j < NT; ++j) {
      const float mu = warps_sum(xs, 2 * NT, NT + j) / fmaxf(warps_sum(xs, 2 * NT, j), 1.0f);
      float d2 = 0.0f;
#pragma unroll
      for (int k = 0; k < EHL_PREFETCH; ++k) {
        const float d = (ehe_pick<EH_MAX_TARGETS>(py[k], j) - mu) * ehe_pick<EH_MAX_TARGETS>(pm[k], j);
        d2 += d * d;
      }
      for (int i = tid + EHL_PREFETCH * nth; i < B * TO; i += nth) {
        const int64_t at = (int64_t)idx[i / TO] * TO + i % TO;
        const float d = (a.y[j][at] - mu) * a.mask[j][at];
        d2 += d * d;
      }
      d2 = ehe_warp_sum(d2);
      if (lane == 0) xd[warp * NT + j] = d2;
    }
  };

  prefetch_index(0);
  prefetch_targets(0);
  prefetch_index(1);
  scale_counts(0);
  __syncthreads();
  if (loss_sst) {
    scale_ssts(0);
    __syncthreads();
  }

  for (int s = 0; s < n_steps; ++s) {
    const int* idx = step_index(s) + row0;
    // the step's loss scales and validity, taken by each warp from the
    // partials; the two-pass losses' n = max(sum(mask), 1), the targets' mean
    // and their SST Syy
    float scl[EH_MAX_TARGETS];
    float tn[EH_MAX_TARGETS], tmu[EH_MAX_TARGETS], tss[EH_MAX_TARGETS];
    float valid = 0.0f;
    {
      const float* xs = XS1 + (s & 1) * 2 * nw * NT;
      const float* xd = XS2 + (s & 1) * nw * NT;
      float total = 0.0f;
#pragma unroll
      for (int j = 0; j < EH_MAX_TARGETS; ++j) {
        scl[j] = tn[j] = tmu[j] = tss[j] = 0.0f;
        if (j < NT) {
          const float c = warps_sum(xs, 2 * NT, j);
          total += c;
          scl[j] = a.loss_nse ? a.agg_scale / fmaxf(warps_sum(xd, NT, j), EH_LSTM_SST_EPS)
                   : a.loss_sum ? a.agg_scale
                                : a.agg_scale / fmaxf(c, 1.0f);
          if constexpr (TWO_PASS) {
            tn[j] = fmaxf(c, 1.0f);
            tmu[j] = warps_sum(xs, 2 * NT, NT + j) / tn[j];
            tss[j] = loss_sst ? warps_sum(xd, NT, j) : 0.0f;
          }
        }
      }
      valid = total > 0.0f ? 1.0f : 0.0f;
    }
    prefetch_targets(s + 1);  // consumed at the end of the step
    prefetch_index(s + 2);
    // the lane's recurrent weights and biases for the step
    float wr[4][WR ? HT : 1];
    float br[4];
    {
      const int j = min(q, H - 1);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        br[g] = Pm[a.p_off_b + g * H + j];
#pragma unroll
        for (int k = 0; k < (WR ? HT : 1); ++k)
          wr[g][k] = (WR && k < H) ? Pm[a.p_off_wh + k * H4 + g * H + j] : 0.0f;
      }
    }
    EHL_STAMP(0);

    // ---- rmse and the statistic losses: the moments of the predictions ----
    // The lane's sums over tile t0's kept predictions: second false, rmse's
    // (pred - y)^2 m, or the masked predictions pred m, into acc[j]; second
    // true, dh^2 into acc[2 j] and dh dy into acc[2 j + 1], with dh = (pred m
    // - mu_h) m and dy = (y - mu_y) m.
    float acc[2 * EH_MAX_TARGETS];
    float mu_h[EH_MAX_TARGETS];
#pragma unroll
    for (int i = 0; i < 2 * EH_MAX_TARGETS; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < EH_MAX_TARGETS; ++j) mu_h[j] = 0.0f;
    auto moment_sums = [&](int t0, bool second) {
      const int w = t0 + wl;
      if (w >= mine || ghost) return;
      const int64_t row = idx[w];
      for (int tt = q; tt < TO; tt += L) {
#pragma unroll
        for (int j = 0; j < EH_MAX_TARGETS; ++j) {
          if (j < NT) {
            const int64_t at = row * TO + tt;
            const float pred = PR[j * ldh + tt * TW + wl];
            const float yv = a.y[j][at];
            const float mk = a.mask[j][at];
            if (!second) {
              const float d = (pred - yv) * mk;
              acc[j] += LK == LOSS_RMSE ? d * d : pred * mk;
            } else {
              const float dh = (pred * mk - mu_h[j]) * mk;
              const float dy = (yv - tmu[j]) * mk;
              acc[2 * j] += dh * dh;
              acc[2 * j + 1] += dh * dy;
            }
          }
        }
      }
    };
    // The sum over every block's and warp's partial i of `width`, taken by a
    // whole warp: lane e adds entries e, e + 32, ... of the blocks' partials
    // in rank and warp order, then a shuffle tree; the same bits in every
    // lane of every block (kernel 2's).
    auto exchanged = [&](float* part, int width, int i) {
      float v = 0.0f;
      for (int e = lane; e < C * nw; e += 32) {
        const int rk = e / nw;
        const float* p = C > 1 ? cluster.map_shared_rank(part, rk) : part;
        v += p[(e - rk * nw) * width + i];
      }
      return ehe_warp_sum(v);
    };
    // After a moments pass, in every block, windows or not: every warp's
    // partials of the lanes' sums, the exchange barrier, then the batch's
    // sums. Pass 0: rmse's coefficients, or every warp's mu_h; pass 1: g and
    // its partials. The coefficients go to LC (8 a target: c0, c1, -, mu_h,
    // d g / d mu_h, 2 d g / d Shh, d g / d C, the batch's loss term).
    auto moments_exchange = [&](int pass) {
      const int n = pass == 0 ? NT : 2 * NT;
      float* part = pass == 0 ? XM1 : XM2;
      for (int i = 0; i < n; ++i) {
        const float v = ehe_warp_sum(ehe_pick<2 * EH_MAX_TARGETS>(acc, i));
        if (lane == 0) part[warp * n + i] = v;
      }
      exchange_barrier();
      if (pass == 0 && LK != LOSS_RMSE) {
#pragma unroll
        for (int j = 0; j < EH_MAX_TARGETS; ++j) {
          mu_h[j] = j < NT ? exchanged(XM1, NT, j) / tn[j] : 0.0f;
          acc[2 * j] = acc[2 * j + 1] = 0.0f;
        }
        EHL_STAMP(11);
        return;
      }
      for (int j = warp; j < NT; j += nw) {
        const float nj = ehe_pick<EH_MAX_TARGETS>(tn, j);
        float c[8] = {a.agg_scale, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (pass == 0) {  // rmse
          const float r = sqrtf(exchanged(XM1, NT, j) / nj);
          c[1] = a.agg_scale / (nj * ehe_max_nan(r, 1e-30f));
          c[7] = a.agg_scale * r;
        } else {
          const float shh = exchanged(XM2, 2 * NT, 2 * j);
          const float chy = exchanged(XM2, 2 * NT, 2 * j + 1);
          const float mh = ehe_pick<EH_MAX_TARGETS>(mu_h, j);
          float d[3];
          const float g = ehe_stat_loss(LK, mh, shh, chy, ehe_pick<EH_MAX_TARGETS>(tss, j),
                                        ehe_pick<EH_MAX_TARGETS>(tmu, j), nj, d);
          c[3] = mh;
          c[4] = d[0];
          c[5] = 2.0f * d[1];
          c[6] = d[2];
          c[7] = a.agg_scale * g;
        }
        if (lane == 0)
          for (int i = 0; i < 8; ++i) LC[8 * j + i] = c[i];
      }
      __syncthreads();  // the coefficients are written
      EHL_STAMP(11);
    };

    // ---- the step's passes over the block's tiles of windows: the two-pass
    // losses' moments first (pass 0 the predictions' sums, pass 1 the
    // statistic losses' centred sums), then the step itself (pass 2). Where a
    // block holds its windows at once (inline_moments) the forward and the
    // predictions of pass 0 stay for the passes after it; else each pass runs
    // each tile's forward again. The other losses run pass 2 alone. ----------
    float loss_part = 0.0f;
    for (int pass = TWO_PASS ? 0 : 2; pass < 3; ++pass) {
      if (TWO_PASS && pass == 1 && LK == LOSS_RMSE) continue;
      if (pass == 2 && mine == 0)
        for (int p = tid; p < NP; p += nth) Gr[p] = 0.0f;
      for (int t0 = 0; t0 < mine; t0 += TW) {
        const int w = t0 + wl;  // the window of the block's share
        const bool active = w < mine;
        const int64_t row = active ? idx[w] : 0;
        if (!inline_moments || pass == 0) {  // a pass that keeps no forward of the pass before
          // ---- the cell's input at every step, normed; h before the first step ----
          for (int i = q; i < T * F; i += L) {
            const int tt = i / F;
            const int k = i - tt * F;
            const int p = tt * TW + wl;
            float xv = active ? a.x[row * T * F + i] : 0.0f;
            if (norm) {
              const float xh = active ? (xv - BM[k]) * BR[k] : 0.0f;
              PA[(o.xhat + k) * ld + p] = xh;
              xv = active ? xh * Pm[k] + Pm[F + k] : 0.0f;
            }
            PA[(o.x + k) * ld + p] = xv;
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (q * U + u < H) PA[(o.h + q * U + u) * ld + wl] = 0.0f;
          __syncwarp();
          EHL_STAMP(1);

          float hp[HT];  // h before the step, whole, in every lane of the window
#pragma unroll
          for (int k = 0; k < HT; ++k) hp[k] = 0.0f;
          float cc[U];
#pragma unroll
          for (int u = 0; u < U; ++u) cc[u] = 0.0f;
          for (int tt = 0; tt < T; ++tt) {
            const int p = tt * TW + wl;
            float z[4][U];
            ehl_gates<HT, U, WR>(a, Pm, PA + o.x * ld + p, ld, q, hp, wr, br, z);
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int j = q * U + u;
              const float ig = ehe_sigmoid_nb(z[0][u]);
              const float fg = ehe_sigmoid_nb(z[1][u]);
              const float gg = tanhf(z[2][u]);
              const float og = ehe_sigmoid_nb(z[3][u]);
              const float c_new = fg * cc[u] + ig * gg;
              cc[u] = c_new;
              if (j < H) {
                PA[(o.c + j) * ld + p] = c_new;
                PA[(o.h + j) * ld + p + TW] = og * tanhf(c_new);
                PA[(o.dz + j) * ld + p] = ig;  // kept for the backward
                PA[(o.dz + H + j) * ld + p] = fg;
                PA[(o.dz + 2 * H + j) * ld + p] = gg;
                PA[(o.dz + 3 * H + j) * ld + p] = og;
              }
            }
            __syncwarp();  // the window's lanes have written all of h_t
#pragma unroll
            for (int k = 0; k < HT; ++k) hp[k] = k < H ? PA[(o.h + k) * ld + p + TW] : 0.0f;
          }
          EHL_STAMP(8);
        }

        // ---- the head at the trailing steps: a lane per (window, step) pair ----
        float gacc[EH_MAX_SCALARS];  // the globals' cotangents over the lane's steps
#pragma unroll
        for (int j = 0; j < EH_MAX_SCALARS; ++j) gacc[j] = 0.0f;
        for (int tt = q; tt < TO; tt += L) {
          const int pt = tt * TW + wl;
          if constexpr (TWO_PASS) {  // the moments' passes (inline, pass 1 keeps pass 0's)
            if (pass < 2 && (ghost || (inline_moments && pass == 1))) continue;
          }
          float hdv[EH_LSTM_MAX_OUT];
#pragma unroll
          for (int qq = 0; qq < EH_LSTM_MAX_OUT; ++qq) hdv[qq] = 0.0f;
#ifndef EHL_CHAIN_ONLY
          if (active) {
            const int t_in = T - TO + tt;
            const float* hcol = PA + o.h * ld + (t_in + 1) * TW + wl;
            const float* hw = Pm + a.p_off_hw;
            float nv[EH_LSTM_MAX_OUT];    // the scaled neural outputs
            float dsc[EH_LSTM_MAX_OUT];   // d scaled / d head output
            float dact[EH_LSTM_MAX_OUT];  // d head output / d pre-activation
#pragma unroll
            for (int qq = 0; qq < EH_LSTM_MAX_OUT; ++qq) {
              nv[qq] = 0.0f;
              dsc[qq] = 1.0f;
              dact[qq] = 0.0f;
              if (qq < P) {
                float zz = Pm[a.p_off_hb + qq];
                for (int k = 0; k < H; ++k) zz = fmaf(hw[qq * H + k], hcol[k * ld], zz);
                float d;
                float out = ehe_act(a.head_act, zz, &d);
                dact[qq] = d;
                if (a.scale_nn_outputs) {
                  const float sg = ehe_sigmoid(out);
                  dsc[qq] = nspan[qq] * (sg * (1.0f - sg));
                  out = nlo[qq] + nspan[qq] * sg;
                }
                nv[qq] = out;
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
                    val = col[row * T + t_in];
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
            if constexpr (TWO_PASS) {
              if (pass < 2) {  // each target's prediction, into PR
#pragma unroll
                for (int j = 0; j < EH_MAX_TARGETS; ++j)
                  if (j < NT) PR[j * ldh + pt] = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
                continue;
              }
            }

            // the masked loss term and its cotangent
            float cot[EH_MAX_TARGETS];
            float term = 0.0f;
#pragma unroll
            for (int j = 0; j < EH_MAX_TARGETS; ++j) {
              cot[j] = 0.0f;
              if (j < NT) {
                const int64_t at = row * TO + tt;
                const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
                const float yv = a.y[j][at];
                const float mk = a.mask[j][at];
                const float diff = (pred - yv) * mk;
                EhLossCoef c = {};
                if constexpr (TWO_PASS) {  // the step's, in LC
                  const float* lc = LC + 8 * j;
                  c.c0 = lc[0];
                  c.c1 = lc[1];
                  c.n = tn[j];
                  c.mu_h = lc[3];
                  c.mu_y = tmu[j];
                  c.k_mu = lc[4];
                  c.k_h = lc[5];
                  c.k_c = lc[6];
                } else {
                  c.c0 = scl[j];
                  c.c1 = 2.0f * scl[j];
                }
                term += ehe_loss_row<TWO_PASS>(LK, c, pred, yv, mk, diff, cot[j]);
              }
            }
            if (!ghost) loss_part += term;

            // cotangents of the neural outputs and the scaled globals
            float dn[EH_LSTM_MAX_OUT];
#pragma unroll
            for (int qq = 0; qq < EH_LSTM_MAX_OUT; ++qq) dn[qq] = 0.0f;
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
                      for (int oo = 0; oo < EH_MAX_OUT; ++oo)
                        part = (oo == a.target_out[j]) ? pd[oo][i] : part;
                      c += cot[j] * part;
                    }
                  }
                  if (src == SRC_NEURAL) {
#pragma unroll
                    for (int qq = 0; qq < EH_LSTM_MAX_OUT; ++qq) dn[qq] += (qq == id) ? c : 0.0f;
                  } else {
#pragma unroll
                    for (int j = 0; j < EH_MAX_SCALARS; ++j) gacc[j] += (j == id) ? c : 0.0f;
                  }
                }
              }
            }
#pragma unroll
            for (int qq = 0; qq < EH_LSTM_MAX_OUT; ++qq) hdv[qq] = (dn[qq] * dsc[qq]) * dact[qq];
          }
#endif
          if constexpr (TWO_PASS) {
            if (pass < 2) continue;
          }
          for (int qq = 0; qq < P; ++qq) HD[qq * ldh + pt] = ehe_pick<EH_LSTM_MAX_OUT>(hdv, qq);
        }
        if constexpr (TWO_PASS) {
          if (pass < 2) {
            moment_sums(t0, pass == 1);
            EHL_STAMP(2);
            continue;
          }
        }
        if (q < TO)
          for (int j = 0; j < G; ++j) GG[j * ldg + q * TW + wl] = ehe_pick<EH_MAX_SCALARS>(gacc, j);
        __syncwarp();  // the head cotangents are written
        EHL_STAMP(2);

        // ---- backward through time, from the kept gates and cell states ------------
        float dhc[U];  // dh carried to the step before, the lane's units
        float dcc[U];  // dc carried to the step before
#pragma unroll
        for (int u = 0; u < U; ++u) {
          dhc[u] = 0.0f;
          dcc[u] = 0.0f;
        }
        for (int tt = T - 1; tt >= 0; --tt) {
          const int p = tt * TW + wl;
          const bool trailing = tt >= T - TO;
          float dz[4][U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int j = q * U + u;
            const int jc = min(j, H - 1);
            float dh = dhc[u];
            if (trailing) {  // the head's seed: dh += head_w^T D_t
              const int pt = (tt - (T - TO)) * TW + wl;
              for (int qq = 0; qq < P; ++qq)
                dh = fmaf(Pm[a.p_off_hw + qq * H + jc], HD[qq * ldh + pt], dh);
            }
            const bool own = j < H;
            const float ig = own ? PA[(o.dz + jc) * ld + p] : 0.0f;
            const float fg = own ? PA[(o.dz + H + jc) * ld + p] : 0.0f;
            const float gg = own ? PA[(o.dz + 2 * H + jc) * ld + p] : 0.0f;
            const float og = own ? PA[(o.dz + 3 * H + jc) * ld + p] : 0.0f;
            const float c_prev = tt > 0 ? PA[(o.c + jc) * ld + p - TW] : 0.0f;
            const float tanh_c = tanhf(PA[(o.c + jc) * ld + p]);
            const float dc = dcc[u] + dh * og * (1.0f - tanh_c * tanh_c);
            dz[0][u] = own ? (dc * gg) * ig * (1.0f - ig) : 0.0f;
            dz[1][u] = own ? (dc * c_prev) * fg * (1.0f - fg) : 0.0f;
            dz[2][u] = own ? (dc * ig) * (1.0f - gg * gg) : 0.0f;
            dz[3][u] = own ? (dh * tanh_c) * og * (1.0f - og) : 0.0f;
            dcc[u] = dc * fg;
            if (own && !ghost) {  // over the kept gates, which a ghost lane may still read
#pragma unroll
              for (int g = 0; g < 4; ++g) PA[(o.dz + g * H + j) * ld + p] = dz[g][u];
            }
          }
          // dh of the step before, wh^T dz: each lane's share, folded over the
          // window's lanes so that each keeps the sums of its own units
          float v[HT];
#pragma unroll
          for (int k = 0; k < HT; ++k) {
            float acc = 0.0f;
#ifndef EHL_CHAIN_ONLY
            if (k < H) {
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const int j = min(q * U + u, H - 1);
#pragma unroll
                for (int g = 0; g < 4; ++g)
                  acc = fmaf(WR ? wr[g][WR ? k : 0] : Pm[a.p_off_wh + k * H4 + g * H + j],
                             dz[g][u], acc);
              }
            }
#endif
            v[k] = acc;
          }
          ehl_fold<HT / 2, L / 2>(v, lane);
#pragma unroll
          for (int u = 0; u < U; ++u) dhc[u] = v[u];
          if (norm) {  // the normed input's cotangent wi^T dz, summed over the window's lanes
            for (int k = 0; k < F; ++k) {
              float acc = 0.0f;
#ifndef EHL_CHAIN_ONLY
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const int j = min(q * U + u, H - 1);
#pragma unroll
                for (int g = 0; g < 4; ++g)
                  acc = fmaf(Pm[a.p_off_wi + k * H4 + g * H + j], dz[g][u], acc);
              }
#endif
#pragma unroll
              for (int bit = L / 2; bit >= 1; bit >>= 1)
                acc += __shfl_xor_sync(0xffffffffu, acc, bit);
              if (q == k % L && !ghost) PA[(o.dxn + k) * ld + p] = acc;
            }
          }
        }
        __syncthreads();  // every window's cotangents are written
        EHL_STAMP(3);

        // ---- gradient sums: a warp per unit of 4 x 4 parameters, its lanes
        // splitting the tile's (window, step) pairs ------------------------------
        for (int un_i = warp; un_i < n_units; un_i += nw) {
          const EhlUnit un = ehl_unit(a, o, un_i, TW, L, ld, ldh, ldg);
          const float* Uf = PA + un.ubase;
          const float* Vf = PA + un.vbase;
          const int u1 = min(1, un.nj - 1) * un.ustride, u2 = min(2, un.nj - 1) * un.ustride,
                    u3 = min(3, un.nj - 1) * un.ustride;
          const int v1 = min(1, un.nk - 1) * un.vstride, v2 = min(2, un.nk - 1) * un.vstride,
                    v3 = min(3, un.nk - 1) * un.vstride;
          float acc[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
#ifndef EHL_CHAIN_ONLY
#pragma unroll 2
          for (int r2 = lane; r2 < un.npairs; r2 += 32) {
            const float uu[4] = {Uf[r2], Uf[u1 + r2], Uf[u2 + r2], Uf[u3 + r2]};
            const float vv[4] = {Vf[r2], Vf[v1 + r2], Vf[v2 + r2], Vf[v3 + r2]};
#pragma unroll
            for (int i = 0; i < 16; ++i) acc[i] = fmaf(uu[i >> 2], vv[i & 3], acc[i]);
          }
#endif
          ehe_fold<8>(acc, (lane & 16) != 0, 16);
          ehe_fold<4>(acc, (lane & 8) != 0, 8);
          ehe_fold<2>(acc, (lane & 4) != 0, 4);
          ehe_fold<1>(acc, (lane & 2) != 0, 2);
          const float total = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
          const int ia = (lane >> 3) & 3;  // this lane's sum is u_ia * v_ib
          const int ib = (lane >> 1) & 3;
          if ((lane & 1) == 0 && ia < un.nj && ib < un.nk) {
            const int pp = ib == un.bcol ? un.bbase + ia : un.pbase + ia * un.pstride + ib;
            Gr[pp] = t0 == 0 ? total : Gr[pp] + total;
          }
        }
        if (t0 + TW < mine) __syncthreads();  // the next tile overwrites the pair arrays
        EHL_STAMP(4);
      }
      if constexpr (TWO_PASS) {
        if (pass < 2) moments_exchange(pass);
      }
    }

    // ---- the next step's loss scales and Adam's corrections; the exchange ----
    if (s + 1 < n_steps) scale_counts(s + 1);
    if (tid == nth - 1) {
      // the rule's numbers for the next step if its batch is valid (they are
      // not read if it is not): the step count after this step, plus one, is
      // never below the clamp at 1
      ehe_opt_step_store(ehe_opt_step(opt, t + valid + 1.0f), MISC + 3 * ((s + 1) & 1));
    }
    {
      const float v = ehe_warp_sum(loss_part);
      if (lane == 0) XL[warp] = v;
    }
    EHL_STAMP(9);
    exchange_barrier();
    EHL_STAMP(5);
    if (s + 1 < n_steps && loss_sst) scale_ssts(s + 1);
    const int e_par = (s / a.n_batches) & 1;
    if (warp == 0) {  // the block's loss over the epoch: its warps in order
      float v = warps_sum(XL, 1, 0);
      if constexpr (TWO_PASS) {  // the batch's terms, taken once, by the first block
        if (rank == 0)
          for (int j = 0; j < NT; ++j) v += LC[8 * j + 7];
      }
      if (lane == 0) {
        if (s % a.n_batches == 0) BL[e_par] = 0.0f;
        if (valid > 0.0f) BL[e_par] += v;
      }
    }
    EHL_STAMP(10);
    if (valid > 0.0f) {
      // this block's slice: the blocks' partials in rank order, the update,
      // and the new values (with the scaled globals) written to every block
      const EhOptStep st = ehe_opt_step_at(MISC + 3 * (s & 1));
      const int64_t mo = (int64_t)MEMBER[0] * NP;  // the member's rows of m, v and u
      auto grad = [&](int p) {
        float g = 0.0f;
        for (int rk = 0; rk < C; ++rk) g += (C > 1 ? cluster.map_shared_rank(Gr, rk) : Gr)[p];
        const int gi = p - a.p_off_g;
        if (gi >= 0) g = g * DG[gi];
        return g;
      };
      // lamb: this slice's part of every leaf's norms (a warp a leaf) after
      // the ones column of the pair arrays, free until the next step's tile;
      // then every block adds the blocks' parts in rank order
      float* LB = PA + (o.one + 1) * ld;
      if (opt.rule == OPT_LAMB) {
        for (int l = warp; l < opt.n_leaves; l += nw) {
          float ps = 0.0f, ds = 0.0f;
          const int end = min(hi, opt.leaf_end[l]);
          for (int p = max(lo, (int)ehe_leaf_start(opt, l)) + lane; p < end; p += 32) {
            const float pv = Pm[ehl_pos(a, p)];
            float mm = a.m[mo + p], vv = a.v[mo + p];
            const float d = ehe_lamb_direction(opt, st, pv, grad(p), mm, vv);
            ps += pv * pv;
            ds += d * d;
          }
          ps = ehe_warp_sum(ps);
          ds = ehe_warp_sum(ds);
          if (lane == 0) {
            LB[2 * l] = ps;
            LB[2 * l + 1] = ds;
          }
        }
        exchange_barrier();
      }
      auto trust_ratio = [&](int l) {
        float ps = 0.0f, ds = 0.0f;
        for (int rk = 0; rk < C; ++rk) {
          const float* part = C > 1 ? cluster.map_shared_rank(LB, rk) : LB;
          ps += part[2 * l];
          ds += part[2 * l + 1];
        }
        return ehe_trust_ratio(ps, ds);
      };
      for (int p = lo + tid; p < hi; p += nth) {
        const int pp = ehl_pos(a, p);
        const int gi = p - a.p_off_g;
        ehe_update(opt, st, &Pm[pp], &a.m[mo + p], &a.v[mo + p], &a.u[mo + p], grad(p),
                   opt.rule == OPT_LAMB ? trust_ratio(ehe_leaf_of(opt, p)) : 1.0f);
        const float np = Pm[pp];
        float sc = 0.0f, dg = 0.0f;
        if (gi >= 0) {
          const float sg = ehe_sigmoid(np);
          sc = glo[gi] + gspan[gi] * sg;
          dg = gspan[gi] * (sg * (1.0f - sg));
          SC[gi] = sc;
          DG[gi] = dg;
        }
        for (int rk = 0; rk < C; ++rk) {
          if (rk == rank) continue;
          cluster.map_shared_rank(Pm, rk)[pp] = np;
          if (gi >= 0) {
            cluster.map_shared_rank(SC, rk)[gi] = sc;
            cluster.map_shared_rank(DG, rk)[gi] = dg;
          }
        }
      }
    }
    t += valid;
    EHL_STAMP(6);
    exchange_barrier();  // every slice is updated everywhere and every partial read
    EHL_STAMP(7);
    if (s % a.n_batches == a.n_batches - 1 && rank == 0 && warp == 0) {
      // the last epoch's mean batch loss: the blocks' sums in rank order
      const float v = lane < C ? (C > 1 ? cluster.map_shared_rank(BL, lane) : BL)[e_par] : 0.0f;
      last_loss = ehe_warp_sum(v) / (float)a.n_batches;
    }
  }

  if (rank == 0) {
    for (int i = tid; i < NP; i += nth) a.params[member * NP + i] = Pm[ehl_pos(a, i)];
    if (tid == 0) {
      a.t[member] = (int)lrintf(t);
      a.loss[member] = last_loss;
#ifdef EHL_STAMPS
      if (member == 0) {
        stamp_acc[EHL_N_STAMPS - 1] = clock64() - stamp_first;
        for (int k = 0; k < EHL_N_STAMPS; ++k) ehl_stamps[k] = stamp_acc[k];
      }
#endif
    }
  }
  if (C > 1) cluster.sync();  // no block leaves while another may read its slice
}

extern "C" int eh_fused_lstm_args_size(void) {
  return (int)sizeof(EhFusedLstmArgs);
}

// rmse and the statistic losses: the build that exchanges the predictions'
// moments inside a step (TWO_PASS)
static bool ehl_two_pass(int kind) {
  return kind == LOSS_RMSE || ehe_loss_is_stat(kind);
}

// Shared-memory floats of one launch (EHL_OPT_WORDS: the optimizer struct);
// ops/fused_epoch_lstm.py's _Sizes.smem_floats computes the same.
static size_t ehl_smem_floats(const EhFusedLstmArgs* a) {
  const int F = a->n_features, P = a->n_out;
  const int G = a->n_globals, K = a->n_fixed, T = a->n_targets;
  const int nw = a->threads / 32;
  const int W = a->windows, TO = a->n_out_steps;
  const int TP = ehl_two_pass(a->loss_kind) ? 1 : 0;
  return (size_t)2 * a->n_params + 2 * F + (2 * P + 2 * G + K) + (G + K) + G + 2 * F + 10 +
         (size_t)nw * (6 * T + 1) + EHL_OPT_WORDS +
         (size_t)a->res_floats * ehl_ld((a->n_steps + 1) * W) + (size_t)P * ehl_ld(TO * W) +
         (size_t)G * ehl_ld(min(a->lanes, TO) * W) +
         (size_t)TP * (T * ehl_ld(TO * W) + nw * 3 * T + 8 * T);
}

template <int HT, bool TWO_PASS>
static int ehl_launch(const EhFusedLstmArgs* args, size_t smem, cudaStream_t s) {
  if (args->threads > EHL_MAX_THREADS || args->lanes != (HT < 32 ? HT : 32))
    return (int)cudaErrorInvalidValue;
  // allow the full 227 KB once per build, as fused_epoch.cu
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(eh_fused_lstm_kernel<HT, TWO_PASS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 EH_MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  return (int)eh_launch_cluster(eh_fused_lstm_kernel<HT, TWO_PASS>, *args, args->cluster,
                                args->threads, smem, s, args->n_members);
}

template <int HT>
static int ehl_launch_build(const EhFusedLstmArgs* args, size_t smem, cudaStream_t s) {
  return ehl_two_pass(args->loss_kind) ? ehl_launch<HT, true>(args, smem, s)
                                       : ehl_launch<HT, false>(args, smem, s);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes, devices and the envelope before it gets here.
extern "C" int eh_fused_lstm(const EhFusedLstmArgs* args, int width, void* stream) {
  if (args->n_epochs <= 0 || args->n_batches <= 0) return 0;
  const size_t smem = ehl_smem_floats(args) * sizeof(float);
  const int c = args->cluster;
  const int64_t block_windows = (args->batch + c - 1) / c;
  if (smem > EH_MAX_SMEM_BYTES || args->res_floats != ehl_tile(*args).total ||
      args->hidden < 1 || args->hidden > width || args->n_features < 1 ||
      args->n_features > EH_MAX_WIDTH || args->n_out < 1 || args->n_out > EH_LSTM_MAX_OUT ||
      args->n_out_steps < 1 || args->n_out_steps > args->n_steps ||
      args->n_args > EH_MAX_ARGS || !eh_form_built(args->form) || args->n_targets < 1 ||
      args->n_targets > EH_MAX_TARGETS || !eh_loss_built(args->loss_kind) ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS || args->windows < 1 ||
      args->threads != (args->windows * args->lanes + 31) / 32 * 32 ||
      (c != 1 && c != 2 && c != 4 && c != 8 && c != EH_LSTM_MAX_CLUSTER) ||
      (int64_t)args->tiles * args->windows < block_windows ||
      (int64_t)(args->tiles - 1) * args->windows >= block_windows || args->stages != 0 ||
      args->optimizer.n_leaves < 1 || args->optimizer.n_leaves > EH_MAX_LEAVES ||
      args->n_members < 1 || args->n_members > 65535 || args->perm_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->optimizer.rule == OPT_LAMB) {
    // lamb's per-leaf parts go after the ones column of the pair arrays, into
    // the head's and the globals' cotangents: room for two floats a leaf
    const EhLstmTile o = ehl_tile(*args);
    const int W = args->windows;
    const int64_t room = (int64_t)(o.total - o.one - 1) * ehl_ld((args->n_steps + 1) * W) +
                         (int64_t)args->n_out * ehl_ld(args->n_out_steps * W) +
                         (int64_t)args->n_globals * ehl_ld(min(args->lanes, args->n_out_steps) * W);
    if (room < 2 * args->optimizer.n_leaves) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 8: return ehl_launch_build<8>(args, smem, s);
    case 16: return ehl_launch_build<16>(args, smem, s);
    case 32: return ehl_launch_build<32>(args, smem, s);
    case 64: return ehl_launch_build<64>(args, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
