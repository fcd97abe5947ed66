// window_walk.cu — the block-window walk as a hand-written CUDA kernel
// for Hopper (sm_90a).
//
// Replaces the TPU kernel graphite_tpu/engine/kernels/window.py:163
// `window_walk`, which the JAX package runs through
// graphite_tpu/engine/kernels/dispatch.py:176 (`pl.pallas_call` gridded
// over tile blocks).  The plain PyTorch form of the same function is
// graphite_tpu_torch/engine/kernels/window.py `window_walk`; both must
// agree on every output element.
//
// Scope: simple in-order cores, private L1I / L1D / L2 under MSI, miss
// chains off (P = 0) or on (P = tpu/miss_chain > 0, with or without the
// fan-out replay's forwarding and boundary spanning), one-bit or no
// branch predictor, LRU or round-robin L1 replacement.  The wrapper
// refuses shared-L2 protocols, iocoom cores and windows wider than 64.
//
// Design: the JAX walk's own three steps, one block per tile and one
// thread per event of the tile's window (K <= 64 events, so one or two
// warps; at K = 16 half of the one warp idles — the card has 132 SMs
// and the main path 64 tiles, so packing two tiles into a block would
// buy no residency and cost a second barrier domain).
//
//   A. Every thread loads its event (coalesced across the block), probes
//      the window-start L1I, L1D and L2 rows of its line (the ways of the
//      three rows are loaded in one unrolled loop, so their loads are in
//      flight together), classifies the event (hit, local-L2 fill,
//      touch, bankable miss) and reads its predictor entry.  The block
//      stages the tile's pending chain bank (slots [mq_head, mq_count))
//      in shared memory.
//   B. Every thread runs the hazard and forwarding rules of its event
//      against the earlier events, from shared memory: chain forwarding
//      and the predictor's in-window read-after-write first, then — once
//      every event knows whether it banks — the banked-miss L2 hazards.
//      It prices its event (dt, clock floor).  Nothing here depends on
//      the retire cut: an event retires only if every earlier event did,
//      so for a retired event "every earlier event" is "every earlier
//      retired event", and what a non-retired event computes is never
//      observed.
//   C. One thread runs the K-step recurrence (the clock's max-plus
//      prefix, the chain's relative clock and bank count, the retire
//      cut) from shared memory alone and stops at the cut.
//   D. Every retired event applies its effects: touches, fill and
//      round-robin step, predictor write, bank slot; every event writes
//      its spawn outputs; the counters are warp reductions.
//
// In place.  The cache word arrays, the L1 round-robin pointers, the
// predictor table and the [P, T] chain bank are the state's own arrays,
// updated in place (the wrapper refuses operands that share storage).
// Exact because: every read of window-start state happens in phases A
// and B, before the barriers that precede any write; tile t's rows are
// written only by block t; the hazard rules keep a retired fill's set
// free of every other retired access of its window, so a fill is that
// set's one writer; several retired touches of one (set, way) differ
// only in the stamp field, so a 64-bit atomicMax gives the plain form's
// scatter-max whatever the thread order; the predictor slot is written
// by its last retired writer alone (decided by event index); banked
// elements go to slots [mq_count, ...) and pending slots are read only
// at [mq_head, mq_count).
//
// Cost.  The walk is latency-bound: a launch, two dependent global
// loads (the event, then its set rows), four barriers and a K-step
// recurrence of register and shared-memory operations.  The bytes it
// must move are a few set rows per event and its outputs (tens of KB at
// T = 64); its operations are a few thousand integer operations per
// tile.  No per-thread array is indexed at runtime, so nothing lives in
// local memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindow = 64;
constexpr int kMaxBank = 256;   // graphite_tpu_torch/params.py MISS_CHAIN_MAX
constexpr int kWarps = kMaxWindow / 32;
constexpr int kCtrs = 12;

// Event opcodes (graphite_tpu_torch/isa.py EventOp).
constexpr int OP_NOP = 0, OP_COMPUTE = 1, OP_MEM_READ = 2, OP_MEM_WRITE = 3,
              OP_BRANCH = 4, OP_SYNC = 7, OP_SPAWN = 8, OP_STALL = 9;
// Pending-request kinds (engine/state.py).
constexpr int64_t PEND_SH_REQ = 1, PEND_EX_REQ = 2, PEND_IFETCH = 3;
// Per-event flags, in shared memory for the other events' rules.
constexpr uint16_t F_FILL_D = 1, F_TOUCH_D = 2, F_FILL_I = 4, F_TOUCH_I = 8,
                   F_MBANK0 = 16, F_CBANK0 = 32, F_WR = 64, F_BR = 128,
                   F_TAKEN = 256;
// Retire classes, for the recurrence.
constexpr uint8_t OK_REL = 1, OK_ABS = 2, OK_BANK = 4;
// Coherence states (engine/cache.py).
constexpr int ST_I = 0, ST_S = 1, ST_M = 4;
constexpr int64_t kStampField = (1LL << 29) - 1;
constexpr int64_t kStampMask = kStampField << 3;
constexpr int64_t kNegFloor = -(1LL << 62);
constexpr int64_t kIcacheBytesPerInstruction = 4;

}  // namespace

struct WalkArgs {
  // inputs
  const int32_t* meta;            // [3, T, K] (op, arg, arg2)
  const int64_t* addr;            // [T, K]
  const uint8_t* valid_ev;        // [T, K]
  const uint8_t* tile_active;     // [T]
  const int32_t* tile_ids;        // [T]
  const int64_t* clock;           // [T]
  const int32_t* period_ps;       // [T, NM]
  const int64_t* boundary;        // []
  const uint8_t* models_enabled;  // []
  const int32_t* stamp_base;      // []
  // state, updated in place (the round-robin pointers only under
  // round_robin replacement)
  uint8_t* bp;                    // [T, bp_size]
  int64_t* l1i;                   // [Ai, T, Si]
  int32_t* l1i_rr;                // [T, Si]
  int64_t* l1d;                   // [Ad, T, Sd]
  int32_t* l1d_rr;                // [T, Sd]
  int64_t* l2;                    // [A2, T, S2]
  // fresh outputs
  int64_t* clock_out;             // [T]
  int32_t* n_ret;                 // [T]
  int64_t* ctr_inc;               // [12, T]
  uint8_t* spawn_mask;            // [T, K]
  int32_t* spawn_child;           // [T, K]
  int64_t* spawn_land;            // [T, K]
  // miss-chain state (P > 0; null at P = 0).  The [P, T] bank is
  // updated in place at the slots this window banks.
  const int64_t* chain_rel;       // [T]
  const int32_t* mq_count;        // [T]
  const int32_t* mq_head;         // [T]
  int64_t* mq_req;                // [P, T]
  int64_t* mq_delta;              // [P, T]
  int64_t* mq_extra;              // [P, T]
  int64_t* chain_rel_out;         // [T]
  int32_t* mq_count_out;          // [T]
  // geometry and timing
  int64_t T, K, NM;
  int64_t l1i_assoc, l1i_sets, l1i_round_robin;
  int64_t l1d_assoc, l1d_sets, l1d_round_robin;
  int64_t l2_assoc, l2_sets;
  int64_t bp_size;                // 0: no predictor (every branch correct)
  int64_t line_bits, line_size;
  int64_t l1i_cycles, l1d_cycles, l2_cycles, bp_penalty;
  int64_t col_core, col_l1i, col_l1d, col_l2, col_nu;
  int64_t s_ids, num_tiles, mesh_width;
  int64_t nu_magic, nu_hop_cycles, nu_ser_cycles;
  int64_t P;                      // miss_chain (0: no chains)
  int64_t wfwd;                   // fan-out replay forwarding (P > 0)
  int64_t qps;                    // quantum, ps: mid-chain overrun credit
  int64_t wbound_add;             // boundary span for empty chains
  int64_t l2_tags_cycles;
};

namespace {

// Python/JAX integer semantics: floor modulo for a positive divisor.
__device__ __forceinline__ int64_t fmod_pos(int64_t x, int64_t n) {
  int64_t r = x % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int32_t word_state(int64_t w) {
  return static_cast<int32_t>(w & 7);
}
__device__ __forceinline__ int32_t word_stamp(int64_t w) {
  return static_cast<int32_t>((w & kStampMask) >> 3);
}
__device__ __forceinline__ int32_t word_tag(int64_t w) {
  return static_cast<int32_t>(w >> 32);
}
__device__ __forceinline__ int64_t with_stamp(int64_t w, int64_t stamp) {
  return (w & ~kStampMask) | ((stamp & kStampField) << 3);
}
__device__ __forceinline__ int64_t pack_word(int32_t tag, int64_t stamp,
                                             int64_t state) {
  const uint64_t t = static_cast<uint64_t>(static_cast<int64_t>(tag)) << 32;
  return static_cast<int64_t>(t) | ((stamp & kStampField) << 3) | state;
}

// One probe of `line` in one tile's set row, built up way by way.
struct Probe {
  int64_t set;
  int32_t tag;
  bool hit;
  int way;        // first matching way (0 on a miss)
  int state;      // sum of matching ways' states (I on a miss)
  int64_t word;   // the matching way's window-start word (touch)
  bool has_inv;
  int first_inv;  // first invalid way
  int lru;        // first way of least stamp
  int32_t lru_stamp;
};

__device__ __forceinline__ Probe probe_init(int64_t line, int64_t S) {
  Probe p;
  p.set = fmod_pos(line, S);
  p.tag = static_cast<int32_t>(line);
  p.hit = false;
  p.way = 0;
  p.state = ST_I;
  p.word = 0;
  p.has_inv = false;
  p.first_inv = 0;
  p.lru = 0;
  p.lru_stamp = 0;
  return p;
}

__device__ __forceinline__ void probe_way(Probe& p, int w, int64_t word) {
  const int32_t st = word_state(word);
  if (word_tag(word) == p.tag && st != ST_I) {
    if (!p.hit) {
      p.way = w;
      p.word = word;
    }
    p.hit = true;
    p.state += st;
  }
  if (!p.has_inv && st == ST_I) {
    p.has_inv = true;
    p.first_inv = w;
  }
  const int32_t s = word_stamp(word);
  if (w == 0 || s < p.lru_stamp) {
    p.lru_stamp = s;
    p.lru = w;
  }
}

// Window fill (JAX _apply_fills): in place on a hit, else the first
// invalid way, else LRU or the round-robin pointer, which a miss steps.
// The filled set is written by no other event of the window.
__device__ __forceinline__ void apply_fill(int64_t* arr, int32_t* rr,
                                           int64_t A, int64_t T, int64_t S,
                                           bool round_robin, int64_t t,
                                           const Probe& p, int64_t line,
                                           int64_t stamp, int64_t state) {
  int64_t way = p.hit ? p.way : (p.has_inv ? p.first_inv : p.lru);
  if (round_robin && !p.hit) {
    const int64_t r = rr[t * S + p.set];
    if (!p.has_inv) way = fmod_pos(r, A);
    rr[t * S + p.set] = static_cast<int32_t>(fmod_pos(r + 1, A));
  }
  arr[(way * T + t) * S + p.set] =
      pack_word(static_cast<int32_t>(line), stamp, state);
}

// Touch: stamp (set, way) as most recently used.  Touches of one word
// differ only in the stamp field, so the max is the plain form's
// scatter-max in any order.
__device__ __forceinline__ void touch(int64_t* arr, int64_t T, int64_t S,
                                      int64_t t, const Probe& p,
                                      int64_t stamp) {
  atomicMax(reinterpret_cast<long long*>(arr + (p.way * T + t) * S + p.set),
            static_cast<long long>(with_stamp(p.word, stamp)));
}

__global__ void __launch_bounds__(kMaxWindow) window_walk_kernel(WalkArgs a) {
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t T = a.T;
  const int K = static_cast<int>(a.K);
  const int64_t P = a.P;
  const bool live = j < K;
  const int64_t e = t * K + j;

  __shared__ int64_t s_line[kMaxWindow];
  __shared__ int32_t s_set_d[kMaxWindow], s_set_i[kMaxWindow],
      s_set_2[kMaxWindow], s_bidx[kMaxWindow];
  __shared__ uint16_t s_flags[kMaxWindow];
  __shared__ uint8_t s_l2fill[kMaxWindow], s_ok[kMaxWindow];
  __shared__ int64_t s_dt[kMaxWindow], s_floor[kMaxWindow];
  __shared__ int64_t s_clk[kMaxWindow], s_base[kMaxWindow];
  __shared__ int16_t s_slot[kMaxWindow];
  __shared__ int64_t s_pline[kMaxBank];
  __shared__ int32_t s_pset[kMaxBank];
  __shared__ uint8_t s_pif[kMaxBank];
  __shared__ int64_t s_fin_clk;
  __shared__ int s_n;
  __shared__ uint32_t s_ctr[kWarps][kCtrs];

  const int32_t* per = a.period_ps + t * a.NM;
  const int64_t p_core = per[a.col_core];
  const int64_t p_nu = per[a.col_nu];
  const int64_t clk0 = a.clock[t];
  const int64_t boundary = a.boundary[0];
  const int64_t stamp_base = a.stamp_base[0];
  // the chain state before this window (P > 0)
  const int64_t nm0 = P > 0 ? a.mq_count[t] : 0;
  const int64_t rel0 = P > 0 ? a.chain_rel[t] : 0;
  const int64_t phead = P > 0 ? a.mq_head[t] : 0;

  // ---- the event (every thread of the window) and its spawn landing
  const bool valid = live && a.valid_ev[e] != 0;
  const int32_t op = valid ? a.meta[e] : OP_NOP;
  const int32_t arg = live ? a.meta[T * K + e] : 0;
  const int32_t arg2 = live ? a.meta[2 * T * K + e] : 0;
  const int64_t addr = live ? a.addr[e] : 0;
  const int64_t dt_spawn = static_cast<int64_t>(max(arg, 0)) * p_core;
  int32_t child = arg2 < 0 ? 0 : arg2;
  if (child > a.s_ids - 1) child = static_cast<int32_t>(a.s_ids - 1);
  int64_t net = 0;
  if (!a.nu_magic) {
    const int64_t dst = fmod_pos(child, a.num_tiles);
    const int64_t mw = a.mesh_width;
    const int64_t src = a.tile_ids[t];
    const int64_t sx = fmod_pos(src, mw), sy = src / mw;
    const int64_t dx = fmod_pos(dst, mw), dy = dst / mw;
    const int64_t hops = (sx > dx ? sx - dx : dx - sx) +
                         (sy > dy ? sy - dy : dy - sy);
    net = (hops * a.nu_hop_cycles + a.nu_ser_cycles) * p_nu;
  }

  // ---- a tile that retires nothing (inactive, or models disabled):
  // its clock, chain state and spawn landings pass through
  if (a.tile_active[t] == 0 || a.models_enabled[0] == 0) {
    if (live) {
      a.spawn_child[e] = child;
      a.spawn_land[e] = clk0 + dt_spawn + net;
      a.spawn_mask[e] = 0;
    }
    if (j < kCtrs) a.ctr_inc[j * T + t] = 0;
    if (j == 0) {
      a.clock_out[t] = clk0;
      a.n_ret[t] = 0;
      if (P > 0) {
        a.mq_count_out[t] = static_cast<int32_t>(nm0);
        a.chain_rel_out[t] = nm0 > 0 ? rel0 : 0;
      }
    }
    return;
  }

  const int64_t l1i_ps = a.l1i_cycles * per[a.col_l1i];
  const int64_t l1d_ps = a.l1d_cycles * per[a.col_l1d];
  const int64_t l2_ps = a.l2_cycles * per[a.col_l2];
  const bool wfwd = P > 0 && a.wfwd != 0;

  const int64_t line = addr >> a.line_bits;
  const bool is_comp = op == OP_COMPUTE, is_br = op == OP_BRANCH;
  const bool is_rd = op == OP_MEM_READ, is_wr = op == OP_MEM_WRITE;
  const bool is_mem = is_rd || is_wr;
  const bool is_stall = op == OP_STALL, is_sync = op == OP_SYNC;
  const bool is_spawn = op == OP_SPAWN;
  const bool taken = arg != 0;

  // ---- phase A: probes against window-start state, classification
  Probe pI = probe_init(line, a.l1i_sets);
  Probe pD = probe_init(line, a.l1d_sets);
  Probe pL2 = probe_init(line, a.l2_sets);
  if (is_mem || is_comp) {
    const int64_t* rowI = a.l1i + t * a.l1i_sets + pI.set;
    const int64_t* rowD = a.l1d + t * a.l1d_sets + pD.set;
    const int64_t* row2 = a.l2 + t * a.l2_sets + pL2.set;
    const int64_t stI = T * a.l1i_sets, stD = T * a.l1d_sets,
                  st2 = T * a.l2_sets;
    const int Ai = static_cast<int>(a.l1i_assoc);
    const int Ad = static_cast<int>(a.l1d_assoc);
    const int A2 = static_cast<int>(a.l2_assoc);
    const int amax = max(Ai, max(Ad, A2));
#pragma unroll 4
    for (int w = 0; w < amax; ++w) {
      const int64_t wI = w < Ai ? rowI[w * stI] : 0;
      const int64_t wD = w < Ad ? rowD[w * stD] : 0;
      const int64_t w2 = w < A2 ? row2[w * st2] : 0;
      if (w < Ai) probe_way(pI, w, wI);
      if (w < Ad) probe_way(pD, w, wD);
      if (w < A2) probe_way(pL2, w, w2);
    }
  }
  const bool l1_ok = pD.hit && (is_rd || pD.state >= ST_M);
  const bool mem_l2 =
      is_mem && !l1_ok && pL2.hit && (is_rd || pL2.state == ST_M);
  const bool comp_l2 = is_comp && !pI.hit && pL2.hit;
  const bool fill_d = mem_l2, fill_i = comp_l2;
  const bool touch_d = is_mem && l1_ok, touch_i = is_comp && pI.hit;
  // Bankable misses (P > 0): past the local L2.
  const bool mem_bank0 = P > 0 && is_mem && !l1_ok && !mem_l2;
  const bool comp_bank0 = P > 0 && is_comp && !pI.hit && !comp_l2;

  int64_t bidx = 0;
  bool tbl_pred = false;
  if (is_br && a.bp_size > 0) {
    bidx = fmod_pos(addr, a.bp_size);
    tbl_pred = a.bp[t * a.bp_size + bidx] != 0;
  }

  if (live) {
    s_line[j] = line;
    s_set_d[j] = static_cast<int32_t>(pD.set);
    s_set_i[j] = static_cast<int32_t>(pI.set);
    s_set_2[j] = static_cast<int32_t>(pL2.set);
    s_bidx[j] = static_cast<int32_t>(bidx);
    s_flags[j] = (fill_d ? F_FILL_D : 0) | (touch_d ? F_TOUCH_D : 0) |
                 (fill_i ? F_FILL_I : 0) | (touch_i ? F_TOUCH_I : 0) |
                 (mem_bank0 ? F_MBANK0 : 0) | (comp_bank0 ? F_CBANK0 : 0) |
                 (is_wr ? F_WR : 0) | (is_br ? F_BR : 0) |
                 (taken ? F_TAKEN : 0);
  }
  // The chain bank before this window (slots [mq_head, mq_count)).
  const int npend = static_cast<int>(nm0 > phead ? nm0 - phead : 0);
  if (P > 0) {
    for (int s = j; s < npend; s += blockDim.x) {
      const int64_t req = a.mq_req[(phead + s) * T + t];
      s_pline[s] = req >> 8;
      s_pset[s] = static_cast<int32_t>(fmod_pos(req >> 8, a.l2_sets));
      s_pif[s] = (req & 7) == PEND_IFETCH;
    }
  }
  __syncthreads();

  // ---- phase B1: hazards and forwarding against the earlier events and
  // the pending bank; the predictor's in-window read-after-write
  bool hazard = false, fwd_d = false, fwd_i = false;
  bool pred = tbl_pred;
  if (live) {
    for (int i = 0; i < j; ++i) {
      const uint16_t f = s_flags[i];
      if (is_br && (f & F_BR) && s_bidx[i] == bidx)
        pred = (f & F_TAKEN) != 0;       // the last earlier branch wins
      if (s_set_d[i] == pD.set) {
        if (is_mem && (f & F_FILL_D)) hazard = true;
        if (fill_d && (f & (F_FILL_D | F_TOUCH_D))) hazard = true;
      }
      if (s_set_i[i] == pI.set) {
        if (is_comp && (f & F_FILL_I)) hazard = true;
        if (fill_i && (f & (F_FILL_I | F_TOUCH_I))) hazard = true;
      }
      if (P > 0 && s_line[i] == line) {
        const bool mb0 = f & F_MBANK0, cb0 = f & F_CBANK0;
        const bool wr_i = f & F_WR;
        // hit-on-pending-fill forwarding within the window
        if (mb0 && is_rd) fwd_d = true;
        if (cb0) fwd_i = true;
        if (wfwd && mb0 && wr_i && is_wr) fwd_d = true;
        // same-line accesses behind a bank its forwarding misses
        const bool bank_w_uncov = wfwd ? (mb0 && !wr_i) : mb0;
        if ((is_mem && cb0) || (is_wr && bank_w_uncov) || (is_comp && mb0))
          hazard = true;
      }
    }
    if (is_mem || is_comp) {
      for (int s = 0; s < npend; ++s) {
        const int64_t pline = s_pline[s];
        const bool p_if = s_pif[s];
        const bool lm = pline == line;
        const bool cpd = lm && !p_if && is_rd;
        const bool cpi = lm && p_if;
        if (cpd) fwd_d = true;
        if (cpi) fwd_i = true;
        if (is_mem && lm && !cpd) hazard = true;
        if (is_comp && lm && !cpi) hazard = true;
        if (!(cpd || cpi) && s_pset[s] == pL2.set) hazard = true;
      }
    }
  }
  const bool mem_fwd = mem_bank0 && fwd_d;
  const bool comp_fwd = comp_bank0 && fwd_i;
  const bool mem_bank = mem_bank0 && !mem_fwd;
  const bool comp_bank = comp_bank0 && !comp_fwd;
  if (live) s_l2fill[j] = mem_bank || comp_bank;
  __syncthreads();

  // ---- phase B2: banked-miss L2 hazards (the set a banked element will
  // fill), then the event's price
  if (live && P > 0 && (is_mem || is_comp)) {
    for (int i = 0; i < j; ++i) {
      if (!s_l2fill[i] || s_set_2[i] != pL2.set) continue;
      const uint16_t f = s_flags[i];
      const bool mb0 = f & F_MBANK0, cb0 = f & F_CBANK0;
      const bool cover =
          s_line[i] == line &&
          ((is_mem && mb0 && is_rd) || (is_comp && cb0) ||
           (wfwd && is_wr && mb0 && (f & F_WR)));
      if (!cover) hazard = true;
    }
  }
  const bool correct = a.bp_size > 0 ? pred == taken : true;
  const bool mem_simple = is_mem && (l1_ok || mem_l2 || mem_fwd);
  const bool comp_simple = is_comp && (pI.hit || comp_l2 || comp_fwd);
  const int64_t icount_ev =
      static_cast<int64_t>(max(arg2 & ((1 << 20) - 1), 0));
  int64_t n_lines = (icount_ev * kIcacheBytesPerInstruction +
                     a.line_size - 1) / a.line_size;
  if (n_lines < 1) n_lines = 1;
  const int64_t cost_ps = static_cast<int64_t>(max(arg, 0)) * p_core;
  const int64_t fetch_ps = icount_ev * l1i_ps;
  if (live) {
    int64_t dt = 0;
    if (is_comp) dt = cost_ps + fetch_ps + (comp_l2 ? n_lines * l2_ps : 0);
    if (is_br) dt = (correct ? p_core : a.bp_penalty * p_core) + l1i_ps;
    if (is_mem) dt = mem_l2 ? l1d_ps + l2_ps : l1d_ps;
    if (is_sync) dt = cost_ps;
    if (is_spawn) dt = dt_spawn;
    const bool base_ok = valid && !hazard;
    s_dt[j] = dt;
    s_floor[j] = (is_stall || is_sync) ? addr : kNegFloor;
    s_ok[j] = (base_ok && (comp_simple || mem_simple || is_br) ? OK_REL : 0) |
              (base_ok && (is_stall || is_sync || is_spawn) ? OK_ABS : 0) |
              (base_ok && (mem_bank || comp_bank) ? OK_BANK : 0);
  }
  __syncthreads();

  // ---- phase C: the retire cut, the clock's max-plus prefix and the
  // chain bank, in event order.  At P > 0 a bankable miss banks while the
  // bank has room, and a mid-chain tile runs on its relative clock with
  // one quantum of overrun credit.
  if (j == 0) {
    const int64_t wbound = boundary + a.wbound_add;
    int64_t clk = clk0, nm = nm0, rel = rel0;
    int n = 0;
    for (; n < K; ++n) {
      const uint8_t ok = s_ok[n];
      bool can, bankc = false, abs_step;
      if (P > 0) {
        const bool bank_n = (ok & OK_BANK) && nm < P;
        const bool okn = (ok & OK_REL) || ((ok & OK_ABS) && nm == 0) || bank_n;
        const bool in_b = nm == 0 ? clk < wbound : (rel < a.qps && nm < P);
        can = okn && in_b;
        bankc = can && bank_n;
        abs_step = can && nm == 0 && !bankc;
      } else {
        can = (ok & (OK_REL | OK_ABS)) && clk < boundary;
        abs_step = can;
      }
      if (!can) break;
      s_clk[n] = clk;
      s_slot[n] = bankc ? static_cast<int16_t>(nm) : -1;
      if (bankc) {
        // issue point: absolute for the chain's first element, else
        // relative to the previous element's completion
        s_base[n] = nm == 0 ? clk : rel;
        rel = 0;
        nm += 1;
      } else if (P > 0 && nm > 0) {
        rel += s_dt[n];
      }
      if (abs_step) clk = (clk > s_floor[n] ? clk : s_floor[n]) + s_dt[n];
    }
    s_n = n;
    s_fin_clk = clk;
    a.clock_out[t] = clk;
    a.n_ret[t] = n;
    if (P > 0) {
      a.mq_count_out[t] = static_cast<int32_t>(nm);
      a.chain_rel_out[t] = nm > 0 ? rel : 0;
    }
  }
  __syncthreads();

  // ---- phase D: effects of the retired prefix, spawn outputs, counters
  const int n = s_n;
  const bool ret = live && j < n;
  if (live) {
    a.spawn_child[e] = child;
    a.spawn_land[e] = (ret ? s_clk[j] : s_fin_clk) + dt_spawn + net;
    a.spawn_mask[e] = (is_spawn && ret) ? 1 : 0;
  }
  uint32_t c[kCtrs];
#pragma unroll
  for (int k = 0; k < kCtrs; ++k) c[k] = 0;
  if (ret) {
    const int64_t stamp = stamp_base + j;
    if (touch_i) touch(a.l1i, T, a.l1i_sets, t, pI, stamp);
    if (touch_d) touch(a.l1d, T, a.l1d_sets, t, pD, stamp);
    if (mem_l2 || comp_l2) touch(a.l2, T, a.l2_sets, t, pL2, stamp);
    if (fill_d)
      apply_fill(a.l1d, a.l1d_rr, a.l1d_assoc, T, a.l1d_sets,
                 a.l1d_round_robin != 0, t, pD, line, stamp,
                 is_wr ? ST_M : ST_S);
    if (fill_i)
      apply_fill(a.l1i, a.l1i_rr, a.l1i_assoc, T, a.l1i_sets,
                 a.l1i_round_robin != 0, t, pI, line, stamp, ST_S);
    if (is_br && a.bp_size > 0) {
      // the last retired branch on a slot writes it
      bool later = false;
      for (int i = j + 1; i < n; ++i)
        if ((s_flags[i] & F_BR) && s_bidx[i] == bidx) later = true;
      if (!later) a.bp[t * a.bp_size + bidx] = taken;
    }
    if (mem_bank || comp_bank) {
      const int64_t slot = s_slot[j];
      if (slot >= 0) {
        // the element: kind | line << 8, its issue point and the local
        // cost owed at completion
        const int64_t kind = is_comp ? PEND_IFETCH
                             : (is_wr ? PEND_EX_REQ : PEND_SH_REQ);
        const int64_t off_ps = (is_comp ? l1i_ps : l1d_ps) +
                               a.l2_tags_cycles * per[a.col_l2];
        a.mq_req[slot * T + t] = kind | (line << 8);
        a.mq_delta[slot * T + t] = s_base[j] + off_ps;
        a.mq_extra[slot * T + t] =
            is_comp ? cost_ps + fetch_ps + (n_lines - 1) * l2_ps : 0;
      }
    }
    // counters (WINDOW_CTRS order); a window's sums fit in 32 bits
    // (icount_ev < 2^20, K <= 64)
    const uint32_t ic = is_comp ? static_cast<uint32_t>(icount_ev) : 0;
    c[0] = ic + (((is_mem && (arg2 & 0xFF) == 0) || is_br) ? 1 : 0);
    c[1] = ic + (is_br ? 1 : 0);
    c[2] = (is_comp && !pI.hit && !comp_fwd)
               ? static_cast<uint32_t>(n_lines) : 0;
    c[3] = is_rd;
    c[4] = is_rd && !l1_ok && !mem_fwd;
    c[5] = is_wr;
    c[6] = is_wr && !l1_ok && !mem_fwd;
    c[7] = mem_l2 || comp_l2 || mem_bank || comp_bank;
    c[8] = mem_bank || comp_bank;
    c[9] = is_br;
    c[10] = is_br && !correct;
    c[11] = is_spawn;
  }
#pragma unroll
  for (int k = 0; k < kCtrs; ++k) {
    const uint32_t v = __reduce_add_sync(0xffffffffu, c[k]);
    if ((j & 31) == 0) s_ctr[j >> 5][k] = v;
  }
  __syncthreads();
  if (j < kCtrs) {
    uint64_t v = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      v += s_ctr[w][j];
    a.ctr_inc[j * T + t] = static_cast<int64_t>(v);
  }
}

}  // namespace

extern "C" int window_walk_launch(const WalkArgs* args, void* stream) {
  if (args->K < 1 || args->K > kMaxWindow || args->P > kMaxBank)
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->T == 0) return 0;
  const unsigned threads =
      static_cast<unsigned>((args->K + 31) / 32 * 32);
  window_walk_kernel<<<static_cast<unsigned>(args->T), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
