// K1 folded_attention: softmax(q k^T * scale) v on heads folded into the
// channel dim, q [B, Sq, H*DH], k/v [B, Sk, H*DH], bf16 in and out.
//
// Replaces (anyv2v_tpu/ops/):
//   pallas_packed_flash.py  _packed_whole_pipe_kernel (L0 spatial self),
//                           _wide_kv_kernel (L1/L2 self, L2 cross),
//                           _wide_t_kernel (L0/L1 cross, sk = 157),
//                           _packed_whole_kernel, _packed_kernel (Sk past 4096)
//   pallas_short_attention.py _short_kernel (mid-block self, S = 64; the
//                           image-latent temporal encoder, S = 16 or 128;
//                           ConsistI2V mid cross, 20 heads of 64)
// The TPU needed five bodies to fit 64 narrow heads (dh 5/10/20 padded to
// 8/16/32) into 128-lane MXU tiles. Here the head width DH (stored: 8, 16,
// 32, 64; the scale comes from the true width) is a template parameter, and
// two bodies, each a kernel symbol of its own so that a profile tells them
// apart, take the classes (ops/folded_attention.py folded_plan):
//  - folded_attention_kernel: the Hopper body below, for the long key axes
//    (the spatial self-attentions);
//  - folded_attention_short_kernel: the earlier body, mma.sync on K/V tiles
//    from a cp.async ring, for Sq <= 32 (the image-latent encoder at 16
//    frames, seine-tiny's short calls), where a 64-row wgmma would waste
//    three quarters of itself, and for Sk <= 192 wherever its grid has a
//    block per SM (the cross-attentions over 157 keys, the mid block, the
//    128-frame image-latent encoder): there an item of the Hopper body is
//    one to three key stages, and its fixed costs (the Q wait, the dummy
//    first P.V, the staging and the store) made it 11-55 % slower than this
//    body (scripts/torch_k1_classes.py times both over a sweep of Sk at each
//    head width).
//
// What bounds it on the H100 (80GB HBM3, 700 W): at DH = 8 the softmax's
// exponentials, not bytes or products. L0 self of one edit step is 48 rows x
// 64 heads x 4096 x 4096 = 5.2e10 scores, one ex2 each, and the
// special-function unit retires 16 a clock per SM; the products take a tenth
// of that. scripts/torch_sfu_probe.py measured the instructions around each
// exponential: ex2.approx.f16x2 and .bf16x2 compile to two MUFU.EX2 each (16
// results a clock per SM, no gain over f32); the bf16 pack (F2FP) runs on
// another pipe at 62 a clock, fmax at 60, fma at 116-147, and the fp32
// inner loop (fma, ex2, pack) keeps 15.6-15.7 exponentials a clock: the
// unit itself is the floor, reached only if every sub-partition always has
// an exponential to issue. The mma.sync body did not: scripts/torch_attention_stamps.py
// put its warps' cycles at L0 self in the exponentials 26 %, P.V 23 %
// (mma.sync and ldmatrix chains), the max tree 15 %, Q.K^T 12 %, the copies
// 4 %: latency-bound at 2.24x its exp2 floor. In the Hopper body each
// consumer warp runs one chain a step (the wgmma issue and the scores' wait,
// the max tree, the exponentials, the pack); more warps a sub-partition keep
// the special-function unit busier: three consumer warpgroups (layout WG3)
// take L0 self at the forward's 48 rows 11 % under two (PERF.md section 6),
// the unit 61-64 % busy by the stamps' count. Tried and slower (PERF.md):
// two warpgroups each keeping the next step's scores and the last step's
// P.V in flight under a step's softmax (two score, P and P.V buffers by step
// parity), and two units a step. A wgmma accumulator that any other
// instruction writes while a product is in flight makes ptxas serialise the
// loop's wgmmas (C7515), and the compiler itself moves zero-initialisations
// and branches of operand selects there. A quarter of the exponentials on the
// FMA pipe lengthened the chain (1.1x), and 128-key stages, the row sums by
// fp32 adds and a correction skipped where no maximum grew were slower.
//
// Design of the Hopper body (ops/folded_attention.py folded_plan sizes it;
// the entry refuses a plan that does not match this file's layout):
//  - Persistent blocks (one per SM) walk items of (batch row, head group,
//    64 rows or one 64-row tile a consumer warpgroup), query tile fastest,
//    so the blocks in flight share K/V in L2. The producer (a warp, or in
//    WG3 a warpgroup of which one thread issues TMA) fills a ring of 2 Q
//    tiles and a ring of 4 stages of 64 keys with separate full and empty
//    mbarriers for K and V; the consumers poll the full barriers.
//  - Two (WARP2) or three (WG3, head width 8 where its 192-row items fill
//    the card) consumer warpgroups share each stage. An item is U units a
//    warpgroup, a unit being (64 query rows, one head): with a tile a
//    warpgroup each takes its 64 rows of every head of the group, with one
//    tile the warpgroups split the heads. Each unit keeps its output, row
//    sums and row maxima in registers across the key loop (DH/2 + 6 a
//    thread), so U is 4 at DH 8 and 16, 2 at 32, 1 at 64: at most 166
//    registers a thread, under WARP2's 168 and within WG3's 160.
//  - A stage's units run as steps. A step issues its unit's Q.K^T and the
//    previous step's P.V as two commit groups of wgmma, waits for the
//    scores only, and runs the softmax while that P.V runs; no product is
//    in flight from one step to the next.
//    At DH 16 and up the warpgroups take turns to issue (named barriers),
//    so that one's softmax runs while another waits for its scores, instead
//    of all waiting at once; at DH 8 they issue freely.
//    A unit's offsets are recomputed with selects and shifts: runtime
//    divisions there cost a third of the kernel's time.
//  - Tiles land by one 4-D TMA box each ([B, S, C] seen as [B, C/8, S, 8]:
//    8-channel column chunks of 16-byte rows, [chunk][row][8]), which is
//    wgmma's unswizzled layout. Q.K^T is an SS wgmma per 16 channels; at DH
//    8 its second 8 channels are a zero chunk (the descriptor's leading
//    offset points there), written once per block. P.V is an RS wgmma with
//    P from registers, and the row sums come from the same bf16 P against
//    a chunk of ones (the n16 product's second 8 columns at DH 8, an n8
//    product elsewhere). Keys past Sk are TMA's zero fill, masked to -inf.
//  - Online softmax in the exp2 domain: the row maxima on raw scores, the
//    scale folded into one fma before ex2.approx. The maxima move lazily:
//    each thread takes the maxima of its own scores of its two rows, the
//    warp votes, and only where one passes its row's maximum by more than
//    8 in the exp2 domain do the quad's shuffles, the new maxima and the
//    correction of the unit's output and sums run (most stages after the
//    first few skip them); P is then at most 2^8, which bf16 and the fp32
//    sums hold. That is done at DH 8 and 16 only, where the step's chain
//    bounds the body: a row's largest P is then rarely exactly 1, and its
//    bf16 rounding moves the output (at DH 64 it took a case past 1.5x the
//    plain version's error against fp32). At DH 32 and 64 the maxima move
//    at every stage, exactly (a vote with no margin was 2-3 % slower).
//  - Output: normalised; WARP2 stages it as bf16 per unit ([chunk][64
//    rows][8]) and writes it by a TMA store (rows past Sq are clipped) while
//    the next item computes; WG3 stores each thread's two rows from the
//    registers (its consumers may have no bulk-group wait, below).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ================= the Hopper body =================

constexpr int BK = 64;              // keys per K/V stage (128 measured slower)
constexpr int MAX_STAGES = 4;       // of the Q ring and of the K/V ring
constexpr int BARRIER_BYTES = 256, ALIGN = 128;
constexpr uint32_t ONES2 = 0x3F803F80u;   // two bf16 1.0
// At DH 8 and 16 a row's maximum moves only where a score of the warp's
// rows passes it by more than LAZY_LOG2 in the exp2 domain, so P is at most
// 2^LAZY_LOG2; wider heads move it at every stage.
constexpr float LAZY_LOG2 = 8.f;

// The block's layouts (ops/folded_attention.py LAYOUTS):
//  - WARP2: two consumer warpgroups and a producer warp (ptxas gives each
//    thread 168 registers), the output staged and written by TMA stores;
//  - WG3: three consumer warpgroups and a producer warpgroup, which gives its
//    registers up (setmaxnreg 24) so that the consumers hold 160, the output
//    stored from the registers. ptxas compiles the code past a
//    setmaxnreg.inc to the count it asks for only where no bulk-group wait
//    (a TMA store's) sits in that code: with one there, the consumers get the
//    launch's 128 and spill at four units of 16 channels (scripts/
//    torch_regcap_probe.py --k1, "a bulk wait in the consumers").
enum Form : int { WARP2 = 0, WG3 = 1 };

template <int L>
struct FormCfg {
  static constexpr int NWG = L == WG3 ? 3 : 2;   // consumer warpgroups
  static constexpr bool PRODUCER_WG = L == WG3;  // else a producer warp
  static constexpr int THREADS = 128 * NWG + (PRODUCER_WG ? 128 : 32);
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 160;   // setmaxnreg (WG3)
  static_assert(!PRODUCER_WG || (PRODUCER_REGS + NWG * CONSUMER_REGS) * 128 <= 65536,
                "the setmaxnreg counts fit the register file");
};

__host__ __device__ constexpr int nwg_of(int layout) { return layout == WG3 ? 3 : 2; }

// The layouts a head width may take: WG3 at 8 only (at 16 its 192-row items
// waste a ninth of i2vgen-xl's L1 tiles and measured slower).
__host__ __device__ constexpr bool layout_ok(int dh, int layout) {
  return layout == WARP2 || (layout == WG3 && dh == 8);
}

// The units a consumer warpgroup holds at most, by head width: each keeps
// DH/2 + 4 accumulators and 2 maxima a thread across the key loop.
__host__ __device__ constexpr int max_units(int dh) {
  return dh <= 16 ? 4 : dh == 32 ? 2 : 1;
}

// The shared memory of one launch, in bytes from the 128-aligned base: the
// Q ring, the K ring, the V ring, with WARP2 the output staging (units of
// [chunk][64 rows][8] for every consumer warpgroup), the zero chunk and the
// ones chunk (64 rows of 16 bytes each), the barriers.
// ops/folded_attention.py folded_layout_bytes is the same formula.
struct Layout {
  int q_bytes, kv_bytes, o_unit, q_off, k_off, v_off, o_off, zero_off, ones_off, bar_off, total;
};

// staged: the units staged for TMA stores (WARP2: every consumer
// warpgroup's; WG3: none)
inline Layout make_layout(int dh, int hb, int tile_rows, int staged, int q_stages,
                          int kv_stages) {
  const int g = hb * dh;
  Layout l;
  l.q_bytes = tile_rows * g * 2;
  l.kv_bytes = BK * g * 2;
  l.o_unit = 64 * dh * 2;
  l.q_off = 0;
  l.k_off = q_stages * l.q_bytes;
  l.v_off = l.k_off + kv_stages * l.kv_bytes;
  l.o_off = l.v_off + kv_stages * l.kv_bytes;
  l.zero_off = l.o_off + staged * l.o_unit;
  l.ones_off = l.zero_off + BK * 16;
  l.bar_off = l.ones_off + BK * 16;
  l.total = l.bar_off + BARRIER_BYTES + ALIGN;
  return l;
}

// The TMA maps of q, k, v (loads) and o (WARP2's stores), the output, the
// shapes, and the launch plan's fields.
struct Params {
  CUtensorMap q, k, v, o;
  int B, Sq, Sk, H;
  int hb;          // heads of a group
  int ng;          // head groups
  int qt;          // 64-row query tiles of an item (1, or one a consumer warpgroup)
  int units;       // (query tile, head) units of an item: qt * hb
  int nqp;         // items of a (batch row, head group)
  int items, ntiles, q_stages, kv_stages;
  float scale_log2;
  Layout lay;
  __nv_bfloat16* out;
};

struct Item {
  int b, hg, q0;
};

__device__ __forceinline__ Item item_of(const Params& p, int it) {
  const int r = it / p.nqp;
  return {r / p.ng, r % p.ng, (it % p.nqp) * p.qt * 64};
}

template <int DH, int U, int L>
__global__ void __launch_bounds__(FormCfg<L>::THREADS, 1)
    folded_attention_kernel(const __grid_constant__ Params p) {
  using namespace hopper;
  using F = FormCfg<L>;
  constexpr int NWG = F::NWG;
  constexpr int DC = DH / 8;          // 8-channel chunks of a head
  constexpr int NACC = DH / 2 + 4;    // a unit's output and row-sum registers
  // the warpgroups take turns to issue, but at DH 8: timed in one call with
  // and without, turns cost L0 self and the Sq = Sk = 8192 class 1-2 % at
  // DH 8 and saved 1-9 % at DH 16, 32 and 64 (L1 self, L2 self, 300 keys)
  constexpr bool TURNS = DH != 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + (ALIGN - 1)) & ~uintptr_t(ALIGN - 1));
  const Layout& lay = p.lay;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t *qfull = bars, *qempty = bars + MAX_STAGES;
  uint64_t *kfull = bars + 2 * MAX_STAGES, *kempty = bars + 3 * MAX_STAGES;
  uint64_t *vfull = bars + 4 * MAX_STAGES, *vempty = bars + 5 * MAX_STAGES;
  const int QS = p.q_stages, KS = p.kv_stages, TR = p.qt * 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < QS; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 4 * NWG);   // one arrival per consumer warp
    }
    for (int s = 0; s < KS; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 4 * NWG);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 4 * NWG);
    }
    mbar_fence_init();
  }
  // the zero chunk (the score depth's second 8 channels at DH 8) and the
  // ones chunk (the row sums' column)
  for (int e = threadIdx.x; e < 2 * BK; e += blockDim.x)
    *reinterpret_cast<uint4*>(smem + lay.zero_off + e * 16) =
        e < BK ? make_uint4(0u, 0u, 0u, 0u) : make_uint4(ONES2, ONES2, ONES2, ONES2);
  fence_proxy_async();
  __syncthreads();

  // the warpgroup index (the producer's is NWG), warp-uniform
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == NWG) {
    // ---- producer ----
    if constexpr (F::PRODUCER_WG) setmaxnreg_dec<F::PRODUCER_REGS>();
    if (threadIdx.x != 128 * NWG) return;
    const int c0 = p.hb * DC;   // chunks of a head group
    int qi = 0, kv = 0;
    for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++qi) {
      const Item x = item_of(p, it);
      const int slot = qi % QS;
      if (qi >= QS) mbar_wait(&qempty[slot], ((qi / QS) - 1) & 1);
      mbar_arrive_expect_tx(&qfull[slot], lay.q_bytes);
      tma_load_4d(smem + lay.q_off + slot * lay.q_bytes, &p.q, &qfull[slot], 0, x.q0, x.hg * c0, x.b);
      for (int t = 0; t < p.ntiles; ++t, ++kv) {
        const int stage = kv % KS, round = kv / KS;
        if (round > 0) mbar_wait(&kempty[stage], (round - 1) & 1);
        mbar_arrive_expect_tx(&kfull[stage], lay.kv_bytes);
        tma_load_4d(smem + lay.k_off + stage * lay.kv_bytes, &p.k, &kfull[stage], 0, t * BK,
                    x.hg * c0, x.b);
        if (round > 0) mbar_wait(&vempty[stage], (round - 1) & 1);
        mbar_arrive_expect_tx(&vfull[stage], lay.kv_bytes);
        tma_load_4d(smem + lay.v_off + stage * lay.kv_bytes, &p.v, &vfull[stage], 0, t * BK,
                    x.hg * c0, x.b);
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (F::PRODUCER_WG) setmaxnreg_inc<F::CONSUMER_REGS>();
  const int wg = role, tw = threadIdx.x % 128, lane = tw % 32, g = lane / 4, t4 = lane % 4;
  const bool lead = lane == 0;
  const uint32_t sbase = smem_addr(smem);
  const uint32_t zero = sbase + lay.zero_off, ones = sbase + lay.ones_off;
  const float sl = p.scale_log2, lazy = LAZY_LOG2 / sl;   // the lazy margin on raw scores
  // this warpgroup's unit i is u = wg + NWG i: with NWG query tiles an
  // item, its own tile of head i; with one, head wg + NWG i. A unit past the
  // item's (a head past the group) computes the group's last head and is
  // not stored. Its offsets are recomputed where used (no division), not
  // held in registers.
  const int qtile = p.qt == NWG ? wg : 0;
  auto head_at = [&](int i) { return p.qt == NWG ? i : wg + NWG * i; };
  auto head_of = [&](int i) { return min(head_at(i), p.hb - 1); };
  auto qoff = [&](int i) { return (head_of(i) * DC * TR + qtile * 64) * 16; };   // [chunk][row][8]
  auto hoff = [&](int i) { return head_of(i) * DC * BK * 16; };   // in a K or V stage
  unsigned char* ostage = smem + lay.o_off + wg * U * lay.o_unit;
  const int T = p.ntiles;
  // the consumer warpgroups take turns to issue their products, in a ring
  // of named barriers (NWG + 1 ...), so that one's softmax runs while the
  // next waits for its scores instead of all waiting at once; warpgroup 0
  // goes first, and the last skips the very last arrival (all take the
  // same turns)
  auto turn_begin = [&] {
    if (TURNS) named_barrier(NWG + 1 + wg, 256);
  };
  auto turn_end = [&](bool final_turn) {
    if (TURNS && !(wg == NWG - 1 && final_turn))
      named_barrier_arrive(NWG + 1 + (wg + 1) % NWG, 256);
  };
  if (TURNS && wg == NWG - 1) named_barrier_arrive(NWG + 1, 256);

  int qi = 0, kv = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++qi) {
    const Item x = item_of(p, it);
    const int slot = qi % QS;
    const uint32_t qs = sbase + lay.q_off + slot * lay.q_bytes;
    auto kst = [&](int t) { return sbase + lay.k_off + ((kv + t) % KS) * lay.kv_bytes; };
    auto vst = [&](int t) { return sbase + lay.v_off + ((kv + t) % KS) * lay.kv_bytes; };
    auto ph = [&](int t) { return (uint32_t)(((kv + t) / KS) & 1); };

    float acc[U][NACC], m0[U], m1[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      m0[i] = m1[i] = -INFINITY;
#pragma unroll
      for (int r = 0; r < NACC; ++r) acc[i][r] = 0.f;
    }
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) pa[j][0] = pa[j][1] = pa[j][2] = pa[j][3] = 0u;

    // S = Q K^T of one unit against 64 keys at `ka` (a K stage's chunk)
    auto issue_qk = [&](uint32_t qa, uint32_t ka) {
      if constexpr (DH == 8) {
        wgmma_ss_n64(s, wgmma_desc(qa, zero - qa, 128), wgmma_desc(ka, zero - ka, 128), 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss_n64(s, wgmma_desc(qa + kk * 2 * TR * 16, TR * 16, 128),
                       wgmma_desc(ka + kk * 2 * BK * 16, BK * 16, 128), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V and the row sums of one unit over 64 keys at `va` (a V stage's
    // chunk, or the Q slot for the dummy step before the first, with P 0)
    auto issue_pv = [&](float (&o)[NACC], uint32_t va) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pv_sums_step<DH>(o, pa[kk], va + kk * 16 * 16, BK * 16, ones + kk * 16 * 16);
      wgmma_commit();
    };
    auto fence_pa = [&] {
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) fence_operand(pa[j][r]);
    };

    // Step k = t * U + i (stage t, unit i): issue its Q.K^T and step k-1's P.V
    // (two commit groups, the scores first; before the first step the P.V is
    // a dummy on the Q slot with P 0, so that every step issues the same
    // groups), wait for the scores only, run the softmax while that P.V runs,
    // then wait for it before P is repacked. No product is in flight from one
    // step to the next.
    auto step = [&](int t, int i) {
      const int ip = i > 0 ? i - 1 : U - 1, tp = i > 0 ? t : t - 1;   // step k-1
      const bool first = tp < 0;
      if (i == 0) mbar_spin(&kfull[(kv + t) % KS], ph(t));
      if (!first && ip == 0) mbar_spin(&vfull[(kv + tp) % KS], ph(tp));
      fence_frag(acc[ip]);
      fence_frag(s);
      fence_pa();
      turn_begin();
      wgmma_fence();
      issue_qk(qs + qoff(i), kst(t) + hoff(i));
      issue_pv(acc[ip], first ? qs : vst(tp) + hoff(ip));
      turn_end(false);
      wgmma_wait<1>();
      fence_frag(s);
      if (lead && i == U - 1) mbar_arrive(&kempty[(kv + t) % KS]);   // stage t's Q.K^T done
      // the online softmax: keys past Sk masked, the maxima on raw scores,
      // at DH 8 and 16 moved lazily: the warp's threads vote on their own
      // maxima, and only where one passes its row's by the margin do the
      // quad's shuffles and the correction run
      const int n = min(BK, p.Sk - t * BK);
      if (n < BK) mask_keys(s, n);
      float mx0 = tile_max(s, 0), mx1 = tile_max(s, 2), c0 = 1.f, c1 = 1.f;
      const bool grow =
          DH > 16 || __any_sync(0xffffffffu, mx0 > m0[i] + lazy || mx1 > m1[i] + lazy);
      if (grow) {
        quad_max(mx0, mx1);
        mx0 = fmaxf(mx0, m0[i]);
        mx1 = fmaxf(mx1, m1[i]);
        c0 = ex2((m0[i] - mx0) * sl);
        c1 = ex2((m1[i] - mx1) * sl);
        m0[i] = mx0;
        m1[i] = mx1;
      }
      exp2_frag(s, sl, -m0[i] * sl, -m1[i] * sl, (n + 7) / 8);
      // step k-1's P.V has read P and written its unit's output
      wgmma_wait<0>();
      fence_frag(acc[ip]);
      fence_pa();
      if (lead && i == 0 && !first) mbar_arrive(&vempty[(kv + tp) % KS]);   // stage t-1's P.V done
      pack_frag(s, pa);
      if (grow) {
#pragma unroll
        for (int r = 0; r < NACC; r += 4) {
          acc[i][r + 0] *= c0;
          acc[i][r + 1] *= c0;
          acc[i][r + 2] *= c1;
          acc[i][r + 3] *= c1;
        }
      }
    };

    mbar_spin(&qfull[slot], (qi / QS) & 1);
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < U; ++i) step(t, i);
    }
    // the last step's P.V (at U 1 its stage's V is awaited here first)
    mbar_spin(&vfull[(kv + T - 1) % KS], ph(T - 1));
    fence_frag(acc[U - 1]);
    fence_pa();
    turn_begin();
    wgmma_fence();
    issue_pv(acc[U - 1], vst(T - 1) + hoff(U - 1));
    turn_end(it + (int)gridDim.x >= p.items);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < U; ++i) fence_frag(acc[i]);
    if (lead) {
      mbar_arrive(&vempty[(kv + T - 1) % KS]);
      mbar_arrive(&qempty[slot]);
    }
    kv += T;

    if constexpr (F::PRODUCER_WG) {
      // normalise and store each unit's two rows a thread from the
      // registers, 4 bytes an 8-channel chunk (rows past Sq are not stored):
      // no bulk-group wait in the consumers' code (above)
      const int r = x.q0 + qtile * 64 + (tw / 32) * 16 + g, C = p.H * DH;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int h = head_at(i);
        if (h >= p.hb) continue;
        const float i0 = 1.f / acc[i][DH / 2], i1 = 1.f / acc[i][DH / 2 + 2];
        __nv_bfloat16* dst =
            p.out + ((size_t)x.b * p.Sq + r) * C + (x.hg * p.hb + h) * DH + 2 * t4;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          if (r < p.Sq)
            *reinterpret_cast<__nv_bfloat162*>(dst + c * 8) =
                __floats2bfloat162_rn(acc[i][c * 4 + 0] * i0, acc[i][c * 4 + 1] * i0);
          if (r + 8 < p.Sq)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * C + c * 8) =
                __floats2bfloat162_rn(acc[i][c * 4 + 2] * i1, acc[i][c * 4 + 3] * i1);
        }
      }
      continue;
    }
    // normalise, stage each unit as bf16 ([chunk][64 rows][8]) once the
    // previous item's stores have read the staging buffer, store by TMA
    if (tw == 0) bulk_wait_read();
    named_barrier(1 + wg, 128);
    const int r = (tw / 32) * 16 + g;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const float i0 = 1.f / acc[i][DH / 2], i1 = 1.f / acc[i][DH / 2 + 2];
      unsigned char* st = ostage + i * lay.o_unit;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        unsigned char* dst = st + (c * 64 + r) * 16 + 4 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[i][c * 4 + 0] * i0, acc[i][c * 4 + 1] * i0);
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * 16) =
            __floats2bfloat162_rn(acc[i][c * 4 + 2] * i1, acc[i][c * 4 + 3] * i1);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tw == 0) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int r0 = x.q0 + qtile * 64, h = head_at(i);
        if (h < p.hb && r0 < p.Sq)
          tma_store_4d(&p.o, ostage + i * lay.o_unit, 0, r0, (x.hg * p.hb + h) * DC, x.b);
      }
      bulk_commit();
    }
  }
  if (!F::PRODUCER_WG && tw == 0) bulk_wait();
}

// A 4-D map over a bf16 [B, S, C] tensor seen as [B, C / 8, S, 8]: one box
// of [chunks, rows, 8] lands in shared memory as the [chunk][row][8] tile;
// rows past S read as zeros (and are not written by a store).
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int C, int rows, int chunks) {
  const cuuint64_t dims[4] = {8, (cuuint64_t)S, (cuuint64_t)C / 8, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, 16, (cuuint64_t)S * C * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, (cuuint32_t)chunks, 1};
  return hopper::make_bf16_map(map, ptr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DH, int U, int L>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v, void* o, int grid,
                   cudaStream_t stream) {
  const int C = p.H * DH, chunks = p.hb * DH / 8;
  if (!make_map(&p.q, q, p.B, p.Sq, C, p.qt * 64, chunks) ||
      !make_map(&p.k, k, p.B, p.Sk, C, BK, chunks) || !make_map(&p.v, v, p.B, p.Sk, C, BK, chunks) ||
      (L == WARP2 && !make_map(&p.o, o, p.B, p.Sq, C, 64, DH / 8)))
    return cudaErrorInvalidValue;
  p.out = static_cast<__nv_bfloat16*>(o);
  auto kernel = folded_attention_kernel<DH, U, L>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.lay.total);
  if (err != cudaSuccess) return err;
  kernel<<<grid, FormCfg<L>::THREADS, p.lay.total, stream>>>(p);
  return cudaGetLastError();
}

template <int DH, int L>
cudaError_t launch_units(Params& p, int units, const void* q, const void* k, const void* v,
                         void* o, int grid, cudaStream_t stream) {
  switch (units) {
    case 1:
      return launch<DH, 1, L>(p, q, k, v, o, grid, stream);
    case 2:
      if constexpr (max_units(DH) >= 2) return launch<DH, 2, L>(p, q, k, v, o, grid, stream);
      break;
    case 3:
      if constexpr (max_units(DH) >= 3) return launch<DH, 3, L>(p, q, k, v, o, grid, stream);
      break;
    case 4:
      if constexpr (max_units(DH) >= 4) return launch<DH, 4, L>(p, q, k, v, o, grid, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

// ========= the short body: mma.sync on a cp.async ring =========

namespace short_body {

constexpr int KB = 64;          // keys per stage of the ring
constexpr int STAGES = 2;       // ring stages: two blocks share an SM
constexpr int GROUP = 128;      // channels of one block's tile, at most
constexpr int MAX_WARPS = 8;
constexpr uint32_t BF16_ONES = 0x3F803F80u;   // two bf16 1.0

// Row stride (bf16) of a tile W channels wide: an odd number of 16-byte units.
__host__ __device__ constexpr int row_stride(int w) { return w + 8 + 8 * ((w / 8) % 2); }

__host__ __device__ constexpr int items_per_warp(int dh) { return 64 / dh; }

template <int DH>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2) folded_attention_short_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int B, int Sq, int Sk,
    int H, int HB, int R, int QT, int KS, int n_qblocks, float scale_log2) {
  using namespace hopper;
  constexpr int IPW = items_per_warp(DH);
  constexpr int NT = DH / 8;   // 8-channel output tiles of one head
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = HB * DH, VW = R * G, VH = R * HB, LD = row_stride(VW), CH = VW / 8;
  const int BQ = 16 * QT, C = H * DH;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + BQ * LD;   // stage s: K at ring + s*2*KS*LD, V after it

  const int b0 = (blockIdx.x / n_qblocks) * R;
  const int q0 = (blockIdx.x % n_qblocks) * BQ;
  const int c0 = blockIdx.y * G;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // Each thread copies one 16-byte column chunk of every row it visits.
  const int rpp = nthreads / CH;   // rows per pass
  const bool copier = tid < rpp * CH;
  const int col = tid % CH, row0 = tid / CH;
  const int rr = col * 8 / G;                 // packed batch row of this chunk
  const int brow = min(b0 + rr, B - 1);
  const bool col_ok = b0 + rr < B;
  const int ch = c0 + (col * 8) % G;
  const __nv_bfloat16* qcol = q + (size_t)brow * Sq * C + ch;
  const __nv_bfloat16* kcol = k + (size_t)brow * Sk * C + ch;
  const __nv_bfloat16* vcol = v + (size_t)brow * Sk * C + ch;

  auto load_kv = [&](int t, int s) {
    if (!copier) return;
    __nv_bfloat16* ks = ring + s * 2 * KS * LD;
    __nv_bfloat16* vs = ks + KS * LD;
    for (int j = row0; j < KS; j += rpp) {
      const int key = t * KB + j;
      const bool ok = col_ok && key < Sk;
      const size_t off = (size_t)min(key, Sk - 1) * C;
      cp_async16(smem_addr(ks + j * LD + col * 8), kcol + off, ok);
      cp_async16(smem_addr(vs + j * LD + col * 8), vcol + off, ok);
    }
  };

  const int ntiles = (Sk + KB - 1) / KB;
  if (copier)
    for (int r = row0; r < BQ; r += rpp) {
      const int qi = q0 + r;
      cp_async16(smem_addr(qs + r * LD + col * 8), qcol + (size_t)min(qi, Sq - 1) * C,
                 col_ok && qi < Sq);
    }
  load_kv(0, 0);   // group 0: Q and tile 0
  cp_async_commit();

  const int lane = tid % 32, warp = tid / 32, nwarps = nthreads / 32;
  const int g = lane / 4, tq = lane % 4;
  const int items = VH * QT;
  float acc[IPW][NT][4], m[IPW][2], l[IPW][2];
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; every warp is done with tile t-1's stage
    if (t + 1 < ntiles) {   // tile t+1 flies while tile t is computed
      load_kv(t + 1, (t + 1) % STAGES);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + (t % STAGES) * 2 * KS * LD;
    const __nv_bfloat16* vs = ks + KS * LD;
    const int nk = min(KB, Sk - t * KB);   // real keys in this tile (>= 1)

#pragma unroll
    for (int i = 0; i < IPW; ++i) {
      const int it = warp + i * nwarps;
      if (it >= items) break;
      const int hc = (it / QT) * DH, qt = it % QT;
      float s[KB / 2];   // 8 tiles of 8 keys, m16n8 accumulators
#pragma unroll
      for (int x = 0; x < KB / 2; ++x) s[x] = 0.f;
      const __nv_bfloat16* qrow = qs + (qt * 16 + (lane & 15)) * LD + hc;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(qrow + kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < KB / 16; ++np) {
          if (np * 16 < nk) {
            uint32_t b[4];
            ldmatrix_x4(b, smem_addr(ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + hc +
                                     kk * 16 + ((lane >> 3) & 1) * 8));
            mma_m16n8k16(s + 4 * (2 * np), a, b[0], b[1]);
            mma_m16n8k16(s + 4 * (2 * np + 1), a, b[2], b[3]);
          }
        }
      }
      if constexpr (DH % 16 == 8) {   // dh 8: one m16n8k8 step
        constexpr int kb = DH / 16 * 16;
        uint32_t a0, a1;
        ldmatrix_x2(a0, a1, smem_addr(qrow + kb));
#pragma unroll
        for (int np = 0; np < KB / 16; ++np) {
          if (np * 16 < nk) {
            uint32_t b0, b1;
            ldmatrix_x2(b0, b1, smem_addr(ks + (np * 16 + (lane & 15)) * LD + hc + kb));
            mma_m16n8k8(s + 4 * (2 * np), a0, a1, b0);
            mma_m16n8k8(s + 4 * (2 * np + 1), a0, a1, b1);
          }
        }
      }
      if (nk < KB) {   // the ragged last tile: keys past Sk
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (nt * 8 + 2 * tq + (x & 1) >= nk) s[nt * 4 + x] = -INFINITY;
      }
      float mx0 = tile_max(s, 0), mx1 = tile_max(s, 2);
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // key 0 of the tile exists, so both maxima are finite; the first
      // tile's correction is ex2(-inf) = 0 on zero state
      const float mn0 = fmaxf(m[i][0], mx0), mn1 = fmaxf(m[i][1], mx1);
      const float corr0 = ex2((m[i][0] - mn0) * scale_log2);
      const float corr1 = ex2((m[i][1] - mn1) * scale_log2);
      m[i][0] = mn0;
      m[i][1] = mn1;
      const float o0 = -mn0 * scale_log2, o1 = -mn1 * scale_log2;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[i][n][0] *= corr0;
        acc[i][n][1] *= corr0;
        acc[i][n][2] *= corr1;
        acc[i][n][3] *= corr1;
      }
      // Each 16-key chunk: its exponentials, packed to a bf16 A fragment
      // and fed to P.V and to the row sums at once, so that only one
      // chunk's P is live. lt: this tile's row sums (rows g, g+8 in [0], [2]).
      float lt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int np = 0; np < KB / 16; ++np) {
        if (np * 16 < nk) {
          float p[8];
#pragma unroll
          for (int x = 0; x < 8; ++x)
            p[x] = ex2(fmaf(s[np * 8 + x], scale_log2, (x & 2) ? o1 : o0));
          const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                                  pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
          mma_m16n8k16(lt, pa, BF16_ONES, BF16_ONES);
          const __nv_bfloat16* vrow =
              vs + (np * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + hc;
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            if (n + 1 < NT) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, smem_addr(vrow + n * 8 + (lane >> 4) * 8));
              mma_m16n8k16(acc[i][n], pa, b[0], b[1]);
              mma_m16n8k16(acc[i][n + 1], pa, b[2], b[3]);
            } else {   // dh 8: one 8-channel tile
              uint32_t b0, b1;
              ldmatrix_x2_trans(b0, b1,
                                smem_addr(vs + (np * 16 + (lane & 15)) * LD + hc + n * 8));
              mma_m16n8k16(acc[i][n], pa, b0, b1);
            }
          }
        }
      }
      l[i][0] = fmaf(l[i][0], corr0, lt[0]);
      l[i][1] = fmaf(l[i][1], corr1, lt[2]);
    }
  }

  // Normalise each item into its own Q tile, then store whole rows.
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    const int it = warp + i * nwarps;
    if (it >= items) break;
    const int hc = (it / QT) * DH, qt = it % QT;
    const float l0 = l[i][0], l1 = l[i][1];
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      __nv_bfloat16* dst = qs + (qt * 16 + g) * LD + hc + n * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[i][n][0] * i0, acc[i][n][1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * LD) =
          __floats2bfloat162_rn(acc[i][n][2] * i1, acc[i][n][3] * i1);
    }
  }
  __syncthreads();
  if (copier && col_ok) {
    __nv_bfloat16* ocol = o + (size_t)brow * Sq * C + ch;
    for (int r = row0; r < BQ && q0 + r < Sq; r += rpp)
      *reinterpret_cast<uint4*>(ocol + (size_t)(q0 + r) * C) =
          *reinterpret_cast<const uint4*>(qs + r * LD + col * 8);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int HB, int R, int QT, int warps, int smem, float scale_log2,
                   cudaStream_t stream) {
  const int G = HB * DH, VW = R * G, KS = min(KB, (Sk + 15) / 16 * 16);
  if (H % HB != 0 || G > GROUP || (R > 1 && (HB != H || VW > GROUP)) || R > B ||
      QT < 1 || warps < 1 || warps > MAX_WARPS ||
      warps * items_per_warp(DH) < R * HB * QT || (VW / 8) > warps * 32 ||
      KS != min(KB, (Sk + 15) / 16 * 16) ||
      smem != (16 * QT + STAGES * 2 * KS) * row_stride(VW) * 2)
    return cudaErrorInvalidValue;
  const int n_qblocks = (Sq + 16 * QT - 1) / (16 * QT);
  const long long gx = (long long)n_qblocks * ((B + R - 1) / R);
  if (gx > 0x7fffffffLL || H / HB > 65535) return cudaErrorInvalidValue;
  auto kernel = folded_attention_short_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, (unsigned)(H / HB)), warps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, B, Sq, Sk, H, HB, R, QT, KS, n_qblocks, scale_log2);
  return cudaGetLastError();
}

}  // namespace short_body

}  // namespace

// The Hopper body, Sq > 32: DH 8/16/32/64, scale > 0, pointers 16-byte
// aligned. The launch plan (ops/folded_attention.py folded_plan): the block
// layout, heads a group, 64-row query tiles an item (1, or one a consumer
// warpgroup), units a warpgroup, the Q and K/V ring depths, the persistent
// grid and smem_bytes, refused unless the head width may take the layout,
// the units are the item's split over its warpgroups, the bytes are this
// file's layout of those fields and one block can hold them.
extern "C" int anyv2v_folded_attention(const void* q, const void* k, const void* v, void* o,
                                       int B, int Sq, int Sk, int H, int DH, float scale,
                                       int layout, int heads_per_block, int q_tiles, int units,
                                       int q_stages, int kv_stages, int grid, int smem_bytes,
                                       void* stream) {
  if (DH != 8 && DH != 16 && DH != 32 && DH != 64) return (int)cudaErrorInvalidValue;
  const int nwg = nwg_of(layout);
  if (B <= 0 || Sq <= 32 || Sk <= 0 || H <= 0 || !layout_ok(DH, layout) ||
      heads_per_block <= 0 || H % heads_per_block != 0 || heads_per_block * DH > 128 ||
      (q_tiles != 1 && q_tiles != nwg) || units < 1 || units > max_units(DH) ||
      units != (q_tiles * heads_per_block + nwg - 1) / nwg ||
      q_stages < 1 || q_stages > MAX_STAGES || kv_stages < 1 || kv_stages > MAX_STAGES ||
      !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.hb = heads_per_block;
  p.ng = H / heads_per_block;
  p.qt = q_tiles;
  p.units = q_tiles * heads_per_block;
  p.nqp = (Sq + 64 * q_tiles - 1) / (64 * q_tiles);
  const long long items = (long long)B * p.ng * p.nqp;
  if (items > 0x7fffffffLL || grid < 1 || grid > items) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  p.ntiles = (Sk + BK - 1) / BK;
  p.q_stages = q_stages;
  p.kv_stages = kv_stages;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.lay = make_layout(DH, heads_per_block, 64 * q_tiles, layout == WARP2 ? nwg * units : 0,
                      q_stages, kv_stages);
  if (smem_bytes != p.lay.total || p.lay.total > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
    case 8:
      return (int)(layout == WG3 ? launch_units<8, WG3>(p, units, q, k, v, o, grid, s)
                                 : launch_units<8, WARP2>(p, units, q, k, v, o, grid, s));
    case 16:
      return (int)launch_units<16, WARP2>(p, units, q, k, v, o, grid, s);
    case 32:
      return (int)launch_units<32, WARP2>(p, units, q, k, v, o, grid, s);
    default:
      return (int)launch_units<64, WARP2>(p, units, q, k, v, o, grid, s);
  }
}

// The short body (Sq <= 32, and the short-key class): DH 8/16/32/64, scale
// > 0; pointers 16-byte aligned. The launch plan (heads per block, packed batch rows,
// query tiles of 16, warps, dynamic shared bytes) comes from
// ops/folded_attention.py::folded_plan; a plan that does not match the
// shape is refused.
extern "C" int anyv2v_folded_attention_short(const void* q, const void* k, const void* v,
                                             void* o, int B, int Sq, int Sk, int H, int DH,
                                             float scale, int heads_per_block,
                                             int rows_per_block, int q_tiles, int warps,
                                             int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || heads_per_block <= 0 ||
      rows_per_block <= 0 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  const float sl = scale * 1.4426950408889634f;
  switch (DH) {
#define ANYV2V_CASE(D)                                                                    \
  case D:                                                                                 \
    return (int)short_body::launch<D>(q, k, v, o, B, Sq, Sk, H, heads_per_block,         \
                                      rows_per_block, q_tiles, warps, smem_bytes, sl, s);
    ANYV2V_CASE(8)
    ANYV2V_CASE(16)
    ANYV2V_CASE(32)
    ANYV2V_CASE(64)
#undef ANYV2V_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* anyv2v_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
