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
// Design.  The JAX walk is vectorised over the window's K events with
// [T, K, K] (and, at P > 0, [T, K, P]) masks because the TPU wants wide
// vector operations.  Here each thread owns one tile and walks its K
// events in order: the running clock, the chain's relative clock and
// bank count, the hazard bookkeeping and the in-window predictor
// forwarding live in registers and small local arrays, and each event
// reads the one set row per cache level it touches straight from device
// memory.
//
// Why the sequential walk is exact.  Only the retired prefix is
// observable: an event retires only if every earlier event did, so its
// hazard, forwarding, predictor and clock inputs are the earlier events'
// own outcomes.  Every classification the JAX walk makes (hit, local-L2
// fill, bankable miss, forwarded miss, hazard) depends only on the
// window-start state and on earlier events' classifications, which the
// kernel keeps per event (line, set indices, flags); the chain bank
// before the window (slots [mq_head, mq_count) of the [P, T] arrays) is
// read from the inputs, as the JAX walk reads it.  Probes read the INPUT
// arrays; touches and fills write the OUTPUT arrays, which the wrapper
// has cloned from the inputs.  At P > 0 a banked miss retires without
// writing any cache word (the resolve pass installs the line at serve
// time) and a forwarded miss is priced as an L1 access with no touch and
// no fill, so the cache writes of a window are the P = 0 writes, further
// restricted by the chain hazards.  A retired fill's set is touched by no
// other retired event of its window (the hazard rules forbid it), so
// applying effects in event order equals the JAX scatter order.  Banked
// elements go to the next free slot (mq_count, then up), one slot per
// bank, so the [P, T] bank outputs have one writer per element.
//
// Cost.  The walk is bound by launch latency and by the bytes of the
// cache arrays (the wrapper's clones move the whole L1/L2 word arrays;
// the kernel itself touches a few set rows per event), not by
// arithmetic: a few hundred integer operations per event, plus a scan of
// the pending bank per event at P > 0.  One thread per tile, 32 tiles per
// block, is 64 threads on a 132-SM card at T = 64 — a known underfill,
// left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindow = 64;
constexpr int kTilesPerBlock = 32;

// Event opcodes (graphite_tpu_torch/isa.py EventOp).
constexpr int OP_NOP = 0, OP_COMPUTE = 1, OP_MEM_READ = 2, OP_MEM_WRITE = 3,
              OP_BRANCH = 4, OP_SYNC = 7, OP_SPAWN = 8, OP_STALL = 9;
// Pending-request kinds (engine/state.py).
constexpr int64_t PEND_SH_REQ = 1, PEND_EX_REQ = 2, PEND_IFETCH = 3;
// Per-event history flags.
constexpr uint16_t F_FILL_D = 1, F_TOUCH_D = 2, F_FILL_I = 4, F_TOUCH_I = 8,
                   F_MBANK0 = 16, F_CBANK0 = 32, F_RD = 64, F_WR = 128,
                   F_L2FILL = 256;
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
  const uint8_t* bp_in;           // [T, bp_size]
  const int64_t* l1i_in;          // [Ai, T, Si]
  const int32_t* l1i_rr_in;       // [T, Si]
  const int64_t* l1d_in;          // [Ad, T, Sd]
  const int32_t* l1d_rr_in;       // [T, Sd]
  const int64_t* l2_in;           // [A2, T, S2]
  const int64_t* boundary;        // []
  const uint8_t* models_enabled;  // []
  const int32_t* stamp_base;      // []
  // outputs (bp_out and the cache outputs hold clones of the inputs;
  // the rr outputs too under round_robin, and are untouched otherwise)
  int64_t* clock_out;             // [T]
  int32_t* n_ret;                 // [T]
  uint8_t* bp_out;
  int64_t* l1i_out;
  int32_t* l1i_rr_out;
  int64_t* l1d_out;
  int32_t* l1d_rr_out;
  int64_t* l2_out;
  int64_t* ctr_inc;               // [12, T]
  uint8_t* spawn_mask;            // [T, K]
  int32_t* spawn_child;           // [T, K]
  int64_t* spawn_land;            // [T, K]
  // miss-chain state (P > 0; null at P = 0).  The bank outputs hold
  // clones of the inputs; the kernel writes the slots it banks.
  const int64_t* chain_rel;       // [T]
  const int32_t* mq_count;        // [T]
  const int32_t* mq_head;         // [T]
  const int64_t* mq_req_in;       // [P, T]
  int64_t* chain_rel_out;         // [T]
  int32_t* mq_count_out;          // [T]
  int64_t* mq_req_out;            // [P, T]
  int64_t* mq_delta_out;          // [P, T]
  int64_t* mq_extra_out;          // [P, T]
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

struct Probe {
  bool hit;
  int way;      // first matching way (0 on a miss)
  int state;    // sum of matching ways' states (I on a miss)
  int64_t set;
};

// Probe `line` in one tile's set row of a [A, T, S] array.
__device__ Probe probe(const int64_t* arr, int64_t A, int64_t T, int64_t S,
                       int64_t t, int64_t line) {
  Probe p{false, 0, 0, fmod_pos(line, S)};
  const int32_t tag = static_cast<int32_t>(line);
  for (int64_t w = 0; w < A; ++w) {
    const int64_t word = arr[(w * T + t) * S + p.set];
    const int32_t st = word_state(word);
    if (word_tag(word) == tag && st != ST_I) {
      if (!p.hit) p.way = static_cast<int>(w);
      p.hit = true;
      p.state += st;
    }
  }
  return p;
}

// Touch: stamp (set, way) as most recently used, scatter-max semantics.
__device__ void touch(const int64_t* in, int64_t* out, int64_t T, int64_t S,
                      int64_t t, const Probe& p, int64_t stamp) {
  const int64_t idx = (p.way * T + t) * S + p.set;
  const int64_t nw = with_stamp(in[idx], stamp);
  if (nw > out[idx]) out[idx] = nw;
}

// Window fill (JAX _apply_fills): in place on a hit, else the first
// invalid way, else LRU (min stamp, first) or the round-robin pointer.
__device__ void apply_fill(const int64_t* in, int64_t* out,
                           const int32_t* rr_in, int32_t* rr_out,
                           int64_t A, int64_t T, int64_t S, bool round_robin,
                           int64_t t, const Probe& p, int64_t line,
                           int64_t stamp, int64_t fill_state) {
  bool has_inv = false;
  int64_t first_inv = 0, lru = 0;
  int32_t lru_stamp = 0;
  for (int64_t w = 0; w < A; ++w) {
    const int64_t word = in[(w * T + t) * S + p.set];
    if (!has_inv && word_state(word) == ST_I) {
      has_inv = true;
      first_inv = w;
    }
    const int32_t s = word_stamp(word);
    if (w == 0 || s < lru_stamp) {
      lru_stamp = s;
      lru = w;
    }
  }
  int64_t way;
  if (p.hit) {
    way = p.way;
  } else if (has_inv) {
    way = first_inv;
  } else if (round_robin) {
    way = fmod_pos(rr_in[t * S + p.set], A);
  } else {
    way = lru;
  }
  if (round_robin && !p.hit) {
    rr_out[t * S + p.set] =
        static_cast<int32_t>(fmod_pos(rr_in[t * S + p.set] + 1, A));
  }
  out[(way * T + t) * S + p.set] =
      pack_word(static_cast<int32_t>(line), stamp, fill_state);
}

__global__ void __launch_bounds__(kTilesPerBlock)
window_walk_kernel(WalkArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kTilesPerBlock +
                    threadIdx.x;
  if (t >= a.T) return;
  const int64_t T = a.T, K = a.K;

  const int32_t* per = a.period_ps + t * a.NM;
  const int64_t p_core = per[a.col_core];
  const int64_t l1i_ps = a.l1i_cycles * per[a.col_l1i];
  const int64_t l1d_ps = a.l1d_cycles * per[a.col_l1d];
  const int64_t l2_ps = a.l2_cycles * per[a.col_l2];
  const int64_t p_nu = per[a.col_nu];
  const int64_t cycle_ps = p_core;
  const bool en = a.models_enabled[0] != 0;
  const int64_t boundary = a.boundary[0];
  const int64_t stamp_base = a.stamp_base[0];

  const int64_t P = a.P;
  const bool wfwd = P > 0 && a.wfwd != 0;
  const int64_t wbound = boundary + a.wbound_add;
  const int64_t l2tag_ps = a.l2_tags_cycles * per[a.col_l2];

  // Per-event history for the hazard and forwarding rules (earlier
  // events of the window): line, L1D / L1I / L2 set index and flags.
  int64_t line_h[kMaxWindow];
  int32_t set_d[kMaxWindow], set_i[kMaxWindow], set_2[kMaxWindow];
  uint16_t flags[kMaxWindow];

  // Chain state: banked count and the relative clock since the last bank.
  int64_t nm = 0, rel = 0, phead = 0, pcount = 0;
  if (P > 0) {
    nm = a.mq_count[t];
    rel = a.chain_rel[t];
    phead = a.mq_head[t];
    pcount = a.mq_count[t];
  }

  int64_t ctr[12];
  for (int c = 0; c < 12; ++c) ctr[c] = 0;

  int64_t clk = a.clock[t];
  int32_t n = 0;
  bool run = a.tile_active[t] != 0;
  const int32_t tile_id = a.tile_ids[t];

  for (int64_t j = 0; j < K; ++j) {
    const int64_t e = t * K + j;
    const bool valid = a.valid_ev[e] != 0;
    const int32_t op = valid ? a.meta[e] : OP_NOP;
    const int32_t arg = a.meta[T * K + e];
    const int32_t arg2 = a.meta[2 * T * K + e];
    const int64_t addr = a.addr[e];
    const int64_t line = addr >> a.line_bits;

    const bool is_comp = op == OP_COMPUTE, is_br = op == OP_BRANCH;
    const bool is_rd = op == OP_MEM_READ, is_wr = op == OP_MEM_WRITE;
    const bool is_mem = is_rd || is_wr;
    const bool is_stall = op == OP_STALL, is_sync = op == OP_SYNC;
    const bool is_spawn = op == OP_SPAWN;

    // ---- probes against window-start state
    const Probe pI = probe(a.l1i_in, a.l1i_assoc, T, a.l1i_sets, t, line);
    const Probe pD = probe(a.l1d_in, a.l1d_assoc, T, a.l1d_sets, t, line);
    const Probe pL2 = probe(a.l2_in, a.l2_assoc, T, a.l2_sets, t, line);

    const bool l1_ok = pD.hit && (is_rd || pD.state >= ST_M);
    const bool mem_l2 =
        is_mem && !l1_ok && pL2.hit && (is_rd || pL2.state == ST_M);
    const bool comp_l2 = is_comp && !pI.hit && pL2.hit;
    bool mem_simple = is_mem && (l1_ok || mem_l2);
    bool comp_simple = is_comp && (pI.hit || comp_l2);
    const bool fill_d = mem_l2, fill_i = comp_l2;
    const bool touch_d = is_mem && l1_ok, touch_i = is_comp && pI.hit;
    // Bankable misses (P > 0): past the local L2.
    const bool mem_bank0 = P > 0 && is_mem && !l1_ok && !mem_l2;
    const bool comp_bank0 = P > 0 && is_comp && !pI.hit && !comp_l2;

    // ---- hazards and chain forwarding against the earlier events
    bool hazard = false;
    bool fwd_d = false, fwd_i = false;
    for (int64_t i = 0; i < j; ++i) {
      const uint16_t f = flags[i];
      if (set_d[i] == pD.set) {
        if (is_mem && (f & F_FILL_D)) hazard = true;
        if (fill_d && (f & (F_FILL_D | F_TOUCH_D))) hazard = true;
      }
      if (set_i[i] == pI.set) {
        if (is_comp && (f & F_FILL_I)) hazard = true;
        if (fill_i && (f & (F_FILL_I | F_TOUCH_I))) hazard = true;
      }
      if (P > 0) {
        const bool same = line_h[i] == line;
        const bool mb0 = f & F_MBANK0, cb0 = f & F_CBANK0;
        const bool wr_i = f & F_WR;
        if (same) {
          // hit-on-pending-fill forwarding within the window
          if (mb0 && is_rd) fwd_d = true;
          if (cb0) fwd_i = true;
          if (wfwd && mb0 && wr_i && is_wr) fwd_d = true;
          // same-line accesses behind a bank its forwarding misses
          const bool bank_w_uncov = wfwd ? (mb0 && !wr_i) : mb0;
          if ((is_mem && cb0) || (is_wr && bank_w_uncov) ||
              (is_comp && mb0))
            hazard = true;
        }
        // banked-miss L2 hazards: the set a banked element will fill
        if ((is_mem || is_comp) && (f & F_L2FILL) && set_2[i] == pL2.set) {
          const bool cover =
              same && ((is_mem && mb0 && is_rd) || (is_comp && cb0) ||
                       (wfwd && is_wr && mb0 && wr_i));
          if (!cover) hazard = true;
        }
      }
    }
    // ---- the bank before this window: forwarding and stall-on-use
    if (P > 0 && (is_mem || is_comp)) {
      for (int64_t sl = phead; sl < pcount; ++sl) {
        const int64_t req = a.mq_req_in[sl * T + t];
        const int64_t pline = req >> 8;
        const bool p_if = (req & 7) == PEND_IFETCH;
        const bool lm = pline == line;
        const bool cpd = lm && !p_if && is_rd;
        const bool cpi = lm && p_if;
        if (cpd) fwd_d = true;
        if (cpi) fwd_i = true;
        if (is_mem && lm && !cpd) hazard = true;
        if (is_comp && lm && !cpi) hazard = true;
        if (!(cpd || cpi) && fmod_pos(pline, a.l2_sets) == pL2.set)
          hazard = true;
      }
    }
    const bool mem_fwd = mem_bank0 && fwd_d;
    const bool comp_fwd = comp_bank0 && fwd_i;
    const bool mem_bank = mem_bank0 && !mem_fwd;
    const bool comp_bank = comp_bank0 && !comp_fwd;
    mem_simple = mem_simple || mem_fwd;
    comp_simple = comp_simple || comp_fwd;

    line_h[j] = line;
    set_d[j] = static_cast<int32_t>(pD.set);
    set_i[j] = static_cast<int32_t>(pI.set);
    set_2[j] = static_cast<int32_t>(pL2.set);
    flags[j] = (fill_d ? F_FILL_D : 0) | (touch_d ? F_TOUCH_D : 0) |
               (fill_i ? F_FILL_I : 0) | (touch_i ? F_TOUCH_I : 0) |
               (mem_bank0 ? F_MBANK0 : 0) | (comp_bank0 ? F_CBANK0 : 0) |
               (is_rd ? F_RD : 0) | (is_wr ? F_WR : 0) |
               ((mem_bank || comp_bank) ? F_L2FILL : 0);

    // ---- branch predictor: the output table holds the table as updated
    // by this window's earlier retired branches (last write wins), which
    // is exactly the in-window read-after-write forwarding.
    const bool taken = arg != 0;
    bool correct = true;
    int64_t bidx = 0;
    if (a.bp_size > 0) {
      bidx = fmod_pos(addr, a.bp_size);
      correct = (a.bp_out[t * a.bp_size + bidx] != 0) == taken;
    }

    // ---- dt and floor
    const int64_t icount_ev =
        static_cast<int64_t>(max(arg2 & ((1 << 20) - 1), 0));
    int64_t n_lines = (icount_ev * kIcacheBytesPerInstruction +
                       a.line_size - 1) / a.line_size;
    if (n_lines < 1) n_lines = 1;
    const int64_t cost_ps = static_cast<int64_t>(max(arg, 0)) * p_core;
    const int64_t fetch_ps = icount_ev * l1i_ps;
    int64_t dt = 0;
    if (is_comp) dt = cost_ps + fetch_ps + (comp_l2 ? n_lines * l2_ps : 0);
    if (is_br) dt = (correct ? cycle_ps : a.bp_penalty * p_core) + l1i_ps;
    if (is_mem) dt = mem_l2 ? l1d_ps + l2_ps : l1d_ps;
    if (is_sync) dt = cost_ps;
    if (!en) dt = is_sync ? cost_ps : 0;
    const int64_t dt_spawn = static_cast<int64_t>(max(arg, 0)) * p_core;
    if (is_spawn) dt = dt_spawn;
    const int64_t floor_t = (is_stall || is_sync) ? addr : kNegFloor;

    // ---- retire decision (prefix): ok & inside the quantum boundary; at
    // P > 0 a bankable miss banks while the bank has room, and a
    // mid-chain tile runs on its relative clock with one quantum of
    // overrun credit
    const bool base_ok = valid && !hazard && en;
    const bool ok_rel = base_ok && (comp_simple || mem_simple || is_br);
    const bool ok_abs = base_ok && (is_stall || is_sync || is_spawn);
    bool can, bankc = false, abs_step;
    if (P > 0) {
      const bool bank_j = base_ok && (mem_bank || comp_bank) && nm < P;
      const bool okj = ok_rel || (ok_abs && nm == 0) || bank_j;
      const bool in_b = nm == 0 ? clk < wbound : (rel < a.qps && nm < P);
      can = run && okj && in_b;
      bankc = can && bank_j;
      abs_step = can && nm == 0 && !bankc;
    } else {
      can = run && (ok_rel || ok_abs) && clk < boundary;
      abs_step = can;
    }

    // ---- SPAWN landing (every event; the mask marks retired spawns)
    int32_t child = arg2 < 0 ? 0 : arg2;
    if (child > a.s_ids - 1) child = static_cast<int32_t>(a.s_ids - 1);
    int64_t net = 0;
    if (!a.nu_magic) {
      const int64_t dst = fmod_pos(child, a.num_tiles);
      const int64_t mw = a.mesh_width;
      const int64_t sx = fmod_pos(tile_id, mw), sy = tile_id / mw;
      const int64_t dx = fmod_pos(dst, mw), dy = dst / mw;
      const int64_t hops = (sx > dx ? sx - dx : dx - sx) +
                           (sy > dy ? sy - dy : dy - sy);
      net = (hops * a.nu_hop_cycles + a.nu_ser_cycles) * p_nu;
    }
    a.spawn_child[e] = child;
    a.spawn_land[e] = clk + dt_spawn + net;
    a.spawn_mask[e] = (is_spawn && can) ? 1 : 0;

    if (can) {
      const int64_t stamp = stamp_base + j;
      // LRU touches
      if (touch_i)
        touch(a.l1i_in, a.l1i_out, T, a.l1i_sets, t, pI, stamp);
      if (touch_d)
        touch(a.l1d_in, a.l1d_out, T, a.l1d_sets, t, pD, stamp);
      if (mem_l2 || comp_l2)
        touch(a.l2_in, a.l2_out, T, a.l2_sets, t, pL2, stamp);
      // fills from local L2 hits
      if (fill_d)
        apply_fill(a.l1d_in, a.l1d_out, a.l1d_rr_in, a.l1d_rr_out,
                   a.l1d_assoc, T, a.l1d_sets, a.l1d_round_robin != 0, t, pD,
                   line, stamp, is_wr ? ST_M : ST_S);
      if (fill_i)
        apply_fill(a.l1i_in, a.l1i_out, a.l1i_rr_in, a.l1i_rr_out,
                   a.l1i_assoc, T, a.l1i_sets, a.l1i_round_robin != 0, t, pI,
                   line, stamp, ST_S);
      if (is_br && a.bp_size > 0) a.bp_out[t * a.bp_size + bidx] = taken;

      // counters (WINDOW_CTRS order)
      if (is_comp) {
        ctr[0] += icount_ev;
        ctr[1] += icount_ev;
      }
      if ((is_mem && (arg2 & 0xFF) == 0) || is_br) ctr[0] += 1;
      if (is_br) ctr[1] += 1;
      if (is_comp && !pI.hit && !comp_fwd) ctr[2] += n_lines;
      if (is_rd) ctr[3] += 1;
      if (is_rd && !l1_ok && !mem_fwd) ctr[4] += 1;
      if (is_wr) ctr[5] += 1;
      if (is_wr && !l1_ok && !mem_fwd) ctr[6] += 1;
      const bool l2_fill_cand = mem_bank || comp_bank;
      if (mem_l2 || comp_l2 || l2_fill_cand) ctr[7] += 1;
      if (l2_fill_cand) ctr[8] += 1;
      if (is_br) ctr[9] += 1;
      if (is_br && !correct) ctr[10] += 1;
      if (is_spawn) ctr[11] += 1;

      if (bankc) {
        // Record the element: kind | line << 8, its issue point (absolute
        // for the chain's first element, else relative to the previous
        // element's completion) and the local cost owed at completion.
        const int64_t kind = is_comp ? PEND_IFETCH
                             : (is_wr ? PEND_EX_REQ : PEND_SH_REQ);
        const int64_t off_ps = (is_comp ? l1i_ps : l1d_ps) + l2tag_ps;
        const int64_t slot = nm * T + t;
        a.mq_req_out[slot] = kind | (line << 8);
        a.mq_delta_out[slot] = (nm == 0 ? clk : rel) + off_ps;
        a.mq_extra_out[slot] =
            is_comp ? cost_ps + fetch_ps + (n_lines - 1) * l2_ps : 0;
        rel = 0;
        nm += 1;
      } else if (P > 0 && nm > 0) {
        rel += dt;
      }
      if (abs_step) clk = (clk > floor_t ? clk : floor_t) + dt;
      n += 1;
    }
    run = can;
  }

  a.clock_out[t] = clk;
  a.n_ret[t] = n;
  for (int c = 0; c < 12; ++c) a.ctr_inc[c * T + t] = ctr[c];
  if (P > 0) {
    a.mq_count_out[t] = static_cast<int32_t>(nm);
    a.chain_rel_out[t] = nm > 0 ? rel : 0;
  }
}

}  // namespace

extern "C" int window_walk_launch(const WalkArgs* args, void* stream) {
  if (args->K > kMaxWindow) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(
      (args->T + kTilesPerBlock - 1) / kTilesPerBlock);
  if (blocks == 0) return 0;
  window_walk_kernel<<<blocks, kTilesPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
