// chain_classify.cu — one chain-replay iteration as a hand-written CUDA
// kernel for Hopper (sm_90a): each tile's chain-head gathers, the
// directory-row gathers and the classify step, in ONE launch.
//
// Replaces the TPU kernel graphite_tpu/engine/kernels/chain.py:134
// `chain_classify`, which the JAX package runs through
// graphite_tpu/engine/kernels/dispatch.py:176 (one `pl.pallas_call`, a
// single grid step, per replay iteration), together with the head and
// directory-row gathers the JAX package leaves outside that kernel
// (graphite_tpu/engine/resolve.py:264-285).  The plain PyTorch form of
// the same function is graphite_tpu_torch/engine/kernels/chain.py
// `chain_head` + `chain_rows` + `chain_classify` (what `run_chain_step`
// runs on CPU tensors); both must agree on every output element.
//
// Scope: private L1/L2 under MSI, full-map directory, zero-load memory
// network (magic or emesh_hop_counter), fan-out replay on or off, the
// DRAM queue model on (the caller prices the queue) or off (this kernel
// computes the completion and writes the per-line floor table IN PLACE).
// The wrapper refuses anything else.
//
// Operands by pointer.  Each tile's thread reads its chain head
// mq_*[clamp(head, 0, P - 1), t], and derives line, kind, home, directory
// set, flat set and hash slot itself (home_fold, the XOR fold and fmix64
// copied from engine/dense.py).  Lines are non-negative, so C's / and %
// equal the floor forms of the plain code.  No division instruction on
// the hot path: every runtime divisor (H, the controller count, the
// directory sets) comes with a magic number computed on the host
// (chain.py fast_divisor), and tile coordinates come from a per-tile
// (x, y) table built once in shared memory with 32-bit arithmetic.
//
// Design.  The hash tables of the function (victim-way exclusion,
// way-slot election, shared-read combining, the floor maximum) are global
// over tiles, so the kernel is ONE block: one thread per tile for the
// per-tile work, and the whole block (256 threads, or T rounded up to
// whole warps if larger) for the table initialisation, the staging of
// the directory rows and the [KF, T] invalidation masks.  Shared memory:
//
//   tblA  int64[H]   election minimum (BIG empty), later the floor max
//   tblB  int32[H]   hit-held way bits per set, later the combining
//                    representative's row (-1 empty)
//   exa   uint8[H]   "an exclusive request hashes here"
//   drow  int64[A, T] each head's directory row, way-major (the probe and
//                    the victim scan read it from here, once each)
//   per row: FCFS key, line, flat set, home, owner, way, (x, y), the
//   invalidation bitmap words, two flags; per fan-out slot its row,
//   target count and farthest hop.
//
// Only the chosen way's W sharer words are read from the sharer array
// (the whole [A, W] row of every head would need T * A * W * 8 bytes, 512
// KB at T = 512); a combining member reads none of its own, because a
// member has its representative's line, hence the same directory row,
// probe and victim, hence the same way.
//
// Phases, separated by __syncthreads():
//   0  tables empty; per tile: the head, its coordinates, ChainHead out;
//   1  whole block: stage the directory rows; issue minimum, exclusive
//      flags;
//   2  per tile: the probe, hit-held ways;
//   3  per tile: victim way, FCFS key, election (atomicMin), the MSI
//      transition against the chosen way's sharer words, delta out;
//   4  per tile: election result, fan-out and owner-budget flags (an
//      owner leg needs an M entry, which has no invalidations, so its
//      candidacy needs no fan-out rank);
//   5  per tile: fan-out rank and per-owner rank (loops over the staged
//      rows), serve, combining representatives (atomicMax of the row:
//      the JAX package's CPU scatter lets the LAST row win);
//   6  per tile: members, hard stops, timing legs, outputs; whole block:
//      the [KF, T] masks, one thread per (slot, tile), with counts and
//      farthest hops by shared-memory atomics (fan-out only);
//   7  per tile: fan-out legs; queue off: completion and the floor key
//      (atomicMax on the unique t_data * T + row);
//   8  queue off: each slot's single winner writes the floor table.
//
// Cost.  Launch latency bounds it: a few KB of operands and outputs per
// iteration at T = 64, a few hundred integer operations per thread, and
// four dependent global round trips (head, bank row, directory rows,
// sharer words).  The P iterations of one pass are P launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ST_I = 0, ST_S = 1, ST_O = 2, ST_M = 4;
constexpr int64_t PEND_EX_REQ = 2, PEND_IFETCH = 3;
constexpr int64_t kBig = 1LL << 62;
constexpr int32_t kNever = 2147483647;
constexpr int kJOwn = 8;
constexpr int64_t kKeyClip = 1LL << 40;
constexpr int kMaxThreads = 512;  // T <= 512
constexpr int kMinThreads = 256;
constexpr int kMaxWords = 8;      // T <= 512 -> at most 8 bitmap words

}  // namespace

// Exact uint64 division by d without a divide instruction (host side:
// chain.py fast_divisor).
struct FastDiv {
  uint64_t d, magic;
  int64_t shift;
};

struct StepArgs {
  // operands (graphite_tpu_torch/engine/kernels/chain.py ChainStepIn)
  const int64_t* mq_req;       // [P, T]
  const int64_t* mq_delta;     // [P, T]
  const int64_t* mq_extra;     // [P, T]
  const int32_t* head;         // [T]
  const uint8_t* stopped;      // [T]
  const int32_t* stop_hi;      // [T]
  const int64_t* base;         // [T]
  const int64_t* dir_word;     // [A, D]
  const int64_t* dir_sharers;  // [W * A, D]
  const int32_t* p_net;        // [T] periods
  const int32_t* p_dir;
  const int32_t* p_l2;
  const int32_t* p_l1d;
  const int32_t* p_l1i;
  const int32_t* p_core;
  int64_t* ftbl;               // [2, H] (queue off, in place) or null
  unsigned char* out;          // one buffer holding every output leaf
  // byte offsets of the leaves in `out` (chain.py _LEAVES; -1 absent)
  int64_t off_line, off_issue, off_extra, off_t_dir, off_owner_ps,
      off_inv_ps, off_reply_ps, off_from_dram_ps, off_dram_arrival,
      off_l1_fill_ps, off_inv_count, off_completion, off_t_data,
      off_delta_sh, off_line_fr, off_home, off_dset, off_fidx, off_hidx,
      off_way, off_owner, off_ow_slot, off_down_to, off_new_state,
      off_new_owner, off_active, off_is_ex, off_is_if, off_hit, off_serve,
      off_serve_all, off_member, off_member_add, off_hard_stop, off_fan_go,
      off_owner_leg, off_evicting, off_dram_read, off_dram_write,
      off_need_read, off_dram_wb, off_inv_bool;
  // geometry and timing
  int64_t T, P, A, W, D, H, KF;
  int64_t fanout, queue_on, ndsets, home_stride, fold_bits, dset_bits;
  int64_t mesh_width, net_magic, hop_cycles, ser_req, ser_data;
  int64_t inv_ack_cycles, dir_cycles, l2_cycles, l1d_cycles, l1i_cycles;
  int64_t dram_latency_ps, dram_processing_ps;
  FastDiv div_h, div_ctrl, div_dsets;
};

namespace {

__device__ __forceinline__ uint64_t fast_div(uint64_t x, const FastDiv& f) {
  if (f.d == 1) return x;
  const uint64_t hi = __umul64hi(f.magic, x);
  return (((x - hi) >> 1) + hi) >> f.shift;
}

__device__ __forceinline__ uint64_t fast_mod(uint64_t x, const FastDiv& f) {
  return x - fast_div(x, f) * f.d;
}

__device__ __forceinline__ uint64_t fmix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDULL;
  x ^= x >> 33;
  return x;
}

// engine/dense.py home_fold / home_of_line / dir_set_of_line (line >= 0).
__device__ __forceinline__ uint64_t fold(uint64_t x, int64_t bits) {
  return x ^ (x >> bits) ^ (x >> (2 * bits)) ^ (x >> (3 * bits));
}

__device__ __forceinline__ int32_t word_state(int64_t w) {
  return static_cast<int32_t>(w & 7);
}
__device__ __forceinline__ int32_t word_owner(int64_t w) {
  return static_cast<int32_t>((w >> 3) & 0x1FFF) - 1;
}
__device__ __forceinline__ int32_t word_stamp(int64_t w) {
  return static_cast<int32_t>((w >> 16) & 0x1FFFF);
}
__device__ __forceinline__ int32_t word_tag(int64_t w) {
  return static_cast<int32_t>(w >> 33);
}

// Manhattan distance between two tiles from the (x, y) table.
__device__ __forceinline__ int hops(const uint32_t* xy, int s, int d) {
  const int sx = xy[s] & 0xFFFF, sy = xy[s] >> 16;
  const int dx = xy[d] & 0xFFFF, dy = xy[d] >> 16;
  return abs(sx - dx) + abs(sy - dy);
}

// Zero-load unicast latency in ps (noc.unicast_ps).
__device__ __forceinline__ int64_t unicast(const StepArgs& a,
                                           const uint32_t* xy, int s, int d,
                                           int64_t ser, int64_t period) {
  if (a.net_magic) return 0;
  return (hops(xy, s, d) * a.hop_cycles + ser) * period;
}

__host__ __device__ __forceinline__ size_t align8(size_t x) {
  return (x + 7) & ~static_cast<size_t>(7);
}

template <typename V>
__device__ __forceinline__ V* leaf(const StepArgs& a, int64_t off) {
  return reinterpret_cast<V*>(a.out + off);
}

__global__ void __launch_bounds__(kMaxThreads)
chain_classify_kernel(StepArgs a) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int T = static_cast<int>(a.T), A = static_cast<int>(a.A);
  const int W = static_cast<int>(a.W), KF = static_cast<int>(a.KF);
  const int64_t H = a.H, D = a.D;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // ---- shared-memory layout (sizes mirror chain_classify_smem_bytes)
  size_t off = 0;
  long long* tblA = reinterpret_cast<long long*>(smem + off);
  off = align8(off + sizeof(long long) * H);
  int32_t* tblB = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * H);
  uint8_t* exa = smem + off;
  off = align8(off + H);
  int64_t* drow_s = reinterpret_cast<int64_t*>(smem + off);
  off = align8(off + sizeof(int64_t) * T * A);
  long long* packed_s = reinterpret_cast<long long*>(smem + off);
  off = align8(off + sizeof(long long) * T);
  int64_t* line_s = reinterpret_cast<int64_t*>(smem + off);
  off = align8(off + sizeof(int64_t) * T);
  uint64_t* invt_s = reinterpret_cast<uint64_t*>(smem + off);
  off = align8(off + sizeof(uint64_t) * T * W);
  long long* issue0_s = reinterpret_cast<long long*>(smem + off);
  off = align8(off + sizeof(long long));
  int32_t* fidx_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * T);
  int32_t* home_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * T);
  int32_t* owner_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * T);
  int32_t* way_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * T);
  uint32_t* xy_s = reinterpret_cast<uint32_t*>(smem + off);
  off = align8(off + sizeof(uint32_t) * T);
  int32_t* frrow_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * KF);
  int32_t* kcnt_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * KF);
  int32_t* kmaxh_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * KF);
  uint8_t* fan_s = smem + off;     // needs the fan-out budget
  off = align8(off + T);
  uint8_t* oact_s = smem + off;    // needs the owner-delivery budget

  // ---- phase 0: tables empty; each tile's chain head
  for (int64_t i = tid; i < H; i += nthr) {
    tblA[i] = kBig;
    tblB[i] = 0;
    exa[i] = 0;
  }
  for (int k = tid; k < KF; k += nthr) {
    frrow_s[k] = -1;
    kcnt_s[k] = 0;
    kmaxh_s[k] = 0;
  }
  if (tid == 0) issue0_s[0] = kBig;

  const int t = tid;
  const bool row = t < T;
  bool act = false, isx = false, isf = false;
  int64_t ln = 0, iss = 0, ext = 0;
  int32_t hm = 0, ds = 0, fi = 0, hx = 0;
  uint64_t fhash = 0;
  int64_t pn = 0, pnh = 0, pdir = 0, pl2 = 0, l1f = 0, pcore = 0;
  if (row) {
    const int32_t hd = a.head[t];
    const int64_t hs = hd < 0 ? 0 : (hd > a.P - 1 ? a.P - 1 : hd);
    const int64_t req = a.mq_req[hs * T + t];
    const int64_t delta = a.mq_delta[hs * T + t];
    ext = a.mq_extra[hs * T + t];
    act = a.stopped[t] == 0 && hd < a.stop_hi[t];
    const int64_t kind = req & 7;
    ln = act ? (req >> 8) : 0;
    isx = act && kind == PEND_EX_REQ;
    isf = act && kind == PEND_IFETCH;
    const uint64_t ul = static_cast<uint64_t>(ln);
    hm = static_cast<int32_t>(fast_mod(fold(ul, a.fold_bits), a.div_ctrl) *
                              a.home_stride);
    ds = static_cast<int32_t>(
        fast_mod(fold(fast_div(ul, a.div_ctrl), a.dset_bits), a.div_dsets));
    fi = hm * static_cast<int32_t>(a.ndsets) + ds;
    iss = a.base[t] + delta;
    hx = static_cast<int32_t>(fast_mod(fmix64(ul), a.div_h));
    fhash = fast_mod(fmix64(static_cast<uint64_t>(fi)), a.div_h);

    leaf<uint8_t>(a, a.off_active)[t] = act;
    leaf<uint8_t>(a, a.off_is_ex)[t] = isx;
    leaf<uint8_t>(a, a.off_is_if)[t] = isf;
    leaf<int64_t>(a, a.off_line)[t] = ln;
    leaf<int64_t>(a, a.off_issue)[t] = iss;
    leaf<int64_t>(a, a.off_extra)[t] = ext;
    leaf<int32_t>(a, a.off_home)[t] = hm;
    leaf<int32_t>(a, a.off_dset)[t] = ds;
    leaf<int32_t>(a, a.off_fidx)[t] = fi;
    leaf<int32_t>(a, a.off_hidx)[t] = hx;

    fidx_s[t] = fi;
    line_s[t] = ln;
    home_s[t] = hm;
    const uint32_t mw = static_cast<uint32_t>(a.mesh_width);
    xy_s[t] = (static_cast<uint32_t>(t) % mw) |
              ((static_cast<uint32_t>(t) / mw) << 16);
    // the periods this row reads
    pn = a.p_net[t];
    pnh = a.p_net[hm];
    pdir = a.p_dir[hm];
    pl2 = a.p_l2[t];
    pcore = a.p_core[t];
    l1f = isf ? a.l1i_cycles * static_cast<int64_t>(a.p_l1i[t])
              : a.l1d_cycles * static_cast<int64_t>(a.p_l1d[t]);
  }
  __syncthreads();

  // ---- phase 1: stage the directory rows (whole block, way-major so
  // that both the stores and the per-row scans are conflict-free); the
  // earliest active issue; exclusive requests per combining slot
  for (int i = tid; i < T * A; i += nthr) {
    const int w = i / T;
    drow_s[i] = a.dir_word[static_cast<int64_t>(w) * D + fidx_s[i - w * T]];
  }
  if (row) {
    if (act) atomicMin(issue0_s, static_cast<long long>(iss));
    if (isx) exa[hx] = 1;
  }
  __syncthreads();

  // ---- phase 2: the probe at (home, dset); hit-held ways per set
  bool hit = false;
  int hway = 0;
  if (row) {
    bool any = false;
    for (int w = 0; w < A; ++w) {
      const int64_t word = drow_s[w * T + t];
      if (word_tag(word) == static_cast<int32_t>(ln) &&
          word_state(word) != ST_I) {
        if (!any) hway = w;
        any = true;
      }
    }
    hit = any && act;
    if (hit) atomicOr(reinterpret_cast<unsigned int*>(&tblB[fhash]),
                      1u << hway);
  }
  __syncthreads();

  // ---- phase 3: victim way (invalid first, then stamp-LRU, hit-held
  // ways excluded), FCFS key, way-slot election; the MSI transition
  // against the chosen way's sharer words
  int way = 0;
  long long packed = 0;
  uint64_t aidx = 0;
  bool can_alloc = false, vic_dead = false, has_inv = false;
  bool own_act = false;
  int way_state = ST_I, entry_state = ST_I;
  int32_t own_tile = 0;
  uint64_t own_w = 0;
  int64_t pno = 0, pl2o = 0;      // the owner's periods (an owner leg)
  if (row) {
    const unsigned used = static_cast<unsigned>(tblB[fhash]);
    int best = 0;
    int32_t best_key = 0;
    for (int w = 0; w < A; ++w) {
      const int64_t word = drow_s[w * T + t];
      const int32_t key = ((used >> w) & 1u)
                              ? kNever
                              : (word_state(word) == ST_I ? -1
                                                          : word_stamp(word));
      if (w == 0 || key < best_key) {
        best_key = key;
        best = w;
      }
    }
    can_alloc = act && !hit && best_key != kNever;
    way = hit ? hway : best;
    const int64_t am = (static_cast<int64_t>(hm) * a.ndsets + ds) * A + way;
    aidx = fast_mod(fmix64(static_cast<uint64_t>(am)), a.div_h);
    int64_t d = iss - static_cast<int64_t>(issue0_s[0]);
    d = d < 0 ? 0 : (d > kKeyClip ? kKeyClip : d);
    packed = static_cast<long long>(d * T + t);
    if (act) atomicMin(&tblA[aidx], packed);

    const int64_t wword = drow_s[way * T + t];
    way_state = word_state(wword);
    entry_state = hit ? way_state : ST_I;
    const int entry_owner = hit ? word_owner(wword) : -1;
    own_act = entry_state == ST_M && entry_owner >= 0 && entry_owner != t;
    own_tile = entry_owner < 0 ? 0 : entry_owner;
    if (own_act) {
      pno = a.p_net[own_tile];
      pl2o = a.p_l2[own_tile];
    }
    const int req_w = t >> 6;
    const uint64_t req_b = 1ULL << (t & 63);
    bool all_zero = true;
    const int64_t* sh = a.dir_sharers + static_cast<int64_t>(way) * D + fi;
    int64_t* delta = leaf<int64_t>(a, a.off_delta_sh) + t * W;
    for (int k = 0; k < W; ++k) {
      const uint64_t er = static_cast<uint64_t>(
          sh[static_cast<int64_t>(k) * A * D]);
      all_zero = all_zero && er == 0;
      const uint64_t es = hit ? er : 0;
      const uint64_t rb = k == req_w ? req_b : 0;
      uint64_t nsh;
      if (isx) {
        nsh = rb;
      } else if (entry_state == ST_M) {
        nsh = ((own_tile >> 6) == k ? (1ULL << (own_tile & 63)) : 0) | rb;
      } else {
        nsh = es | rb;
      }
      const uint64_t iv = (isx && entry_state == ST_S) ? (es & ~rb) : 0;
      invt_s[t * W + k] = iv;
      has_inv = has_inv || iv != 0;
      delta[k] = static_cast<int64_t>(nsh - er);  // wraps like uint64
      if (k == req_w) own_w = er;
    }
    vic_dead = way_state == ST_I ||
               ((way_state == ST_S || way_state == ST_O) && all_zero);
    packed_s[t] = packed;
    owner_s[t] = own_tile;
  }
  __syncthreads();

  // ---- phase 4: the election's result; which rows need the fan-out and
  // the owner-delivery budgets.  An owner leg needs an M entry, and an M
  // entry has no invalidation targets, so its candidacy is cand0.
  bool cand0 = false, need_fan = false, oact = false;
  if (row) {
    const bool wslot = act && tblA[aidx] == packed;
    cand0 = wslot && (hit || (can_alloc && vic_dead));
    need_fan = a.fanout && cand0 && has_inv;
    oact = cand0 && own_act;
    fan_s[t] = need_fan;
    oact_s[t] = oact;
  }
  // tblB becomes the combining representative table
  for (int64_t i = tid; i < H; i += nthr) tblB[i] = -1;
  __syncthreads();

  // ---- phase 5: fan-out rank and per-owner rank (FCFS, over the staged
  // rows), serve, combining representatives
  int fan_rank = 0, posr = 0;
  bool serve = false, owner_leg = false, fan_go = false, sh_ok = false;
  if (row) {
    if (need_fan) {
      for (int j = 0; j < T; ++j)
        if (fan_s[j] && packed_s[j] < packed) ++fan_rank;
    }
    const bool cand = a.fanout
                          ? cand0 && (!has_inv || (need_fan && fan_rank < KF))
                          : cand0 && !has_inv;
    if (oact) {
      for (int j = 0; j < T; ++j) {
        if (oact_s[j] && owner_s[j] == own_tile &&
            (packed_s[j] < packed || (packed_s[j] == packed && j < t)))
          ++posr;
      }
    }
    serve = cand && !(own_act && posr >= kJOwn);
    owner_leg = own_act && serve;
    fan_go = serve && has_inv;
    sh_ok = entry_state == ST_I || entry_state == ST_S;
    if (serve && !isx && sh_ok) atomicMax(&tblB[hx], t);
    if (fan_go) frrow_s[fan_rank] = t;
    way_s[t] = way;
  }
  // tblA becomes the floor-table maximum
  for (int64_t i = tid; i < H; i += nthr) tblA[i] = -1;
  __syncthreads();

  // ---- phase 6: combining members, hard stops, timing legs, the
  // outputs; the fan-out invalidation masks
  bool serve_all = false, need_read = false;
  int64_t tdir = 0, ops = 0, rps = 0;
  if (row) {
    const int r = tblB[hx];
    const int64_t rep_line = r >= 0 ? line_s[r] : -1;
    const int rep_way = r >= 0 ? way_s[r] : 0;
    const bool member = act && !serve && !isx && sh_ok && !exa[hx] &&
                        rep_line == ln;
    const int wayf = member ? rep_way : way;
    serve_all = serve || member;
    const bool stop_inv = !a.fanout && has_inv;
    const bool hard = act && !serve_all &&
                      (stop_inv || (can_alloc && !vic_dead) ||
                       (!hit && !can_alloc) || (own_act && posr >= kJOwn));

    const int64_t net_req = unicast(a, xy_s, t, hm, a.ser_req, pn);
    rps = unicast(a, xy_s, hm, t, a.ser_data, pnh);
    tdir = iss + net_req + a.dir_cycles * pdir;
    if (owner_leg) {
      ops = unicast(a, xy_s, hm, own_tile, a.ser_req, pnh) +
            a.l2_cycles * pl2o + unicast(a, xy_s, own_tile, hm, a.ser_data,
                                         pno);
    }
    need_read = serve_all && !own_act;
    // A member's way is its representative's (same line, same row), so
    // its own sharer word is the one phase 3 read.
    const bool madd = member && (!hit || (own_w & (1ULL << (t & 63))) == 0);

    leaf<int32_t>(a, a.off_way)[t] = wayf;
    leaf<uint8_t>(a, a.off_hit)[t] = hit;
    leaf<uint8_t>(a, a.off_serve)[t] = serve;
    leaf<uint8_t>(a, a.off_serve_all)[t] = serve_all;
    leaf<uint8_t>(a, a.off_member)[t] = member;
    leaf<uint8_t>(a, a.off_member_add)[t] = madd;
    leaf<uint8_t>(a, a.off_hard_stop)[t] = hard;
    leaf<uint8_t>(a, a.off_fan_go)[t] = fan_go;
    leaf<uint8_t>(a, a.off_owner_leg)[t] = owner_leg;
    leaf<uint8_t>(a, a.off_evicting)[t] = serve && !hit && way_state != ST_I;
    leaf<int32_t>(a, a.off_owner)[t] = own_tile;
    leaf<int32_t>(a, a.off_ow_slot)[t] = posr < kJOwn - 1 ? posr : kJOwn - 1;
    leaf<int32_t>(a, a.off_down_to)[t] = isx ? ST_I : ST_S;
    leaf<int32_t>(a, a.off_new_state)[t] = isx ? ST_M : ST_S;
    leaf<int32_t>(a, a.off_new_owner)[t] = isx ? t : -1;
    leaf<uint8_t>(a, a.off_dram_read)[t] = !own_act;
    leaf<uint8_t>(a, a.off_dram_write)[t] = own_act;
    leaf<uint8_t>(a, a.off_need_read)[t] = need_read;
    leaf<uint8_t>(a, a.off_dram_wb)[t] = own_act && serve_all;
    leaf<int64_t>(a, a.off_t_dir)[t] = tdir;
    leaf<int64_t>(a, a.off_owner_ps)[t] = ops;
    leaf<int64_t>(a, a.off_reply_ps)[t] = rps;
    leaf<int64_t>(a, a.off_from_dram_ps)[t] = 0;
    leaf<int64_t>(a, a.off_dram_arrival)[t] = tdir + ops;
    leaf<int64_t>(a, a.off_l1_fill_ps)[t] = l1f;
  }
  if (a.fanout) {
    uint8_t* inv_bool = leaf<uint8_t>(a, a.off_inv_bool);
    for (int i = tid; i < KF * T; i += nthr) {
      const int k = i / T, j = i - k * T;
      const int r = frrow_s[k];
      const bool bit =
          r >= 0 && ((invt_s[r * W + (j >> 6)] >> (j & 63)) & 1ULL) != 0;
      inv_bool[i] = bit;
      if (bit) {
        atomicAdd(&kcnt_s[k], 1);
        atomicMax(&kmaxh_s[k], hops(xy_s, home_s[r], j));
      }
    }
    for (int k = tid; k < KF; k += nthr) {
      const int r = frrow_s[k];
      leaf<int64_t>(a, a.off_line_fr)[k] = r >= 0 ? line_s[r] : 0;
    }
    __syncthreads();
  }

  // ---- phase 7: the fan-out legs (a served fan-out row is its own
  // slot's row); with the queue model off the completion and the floor
  // key
  int64_t tdata = 0, tkey = 0;
  if (row) {
    int64_t ips = 0, icnt = 0;
    if (a.fanout && fan_go) {
      icnt = kcnt_s[fan_rank];
      const int64_t mh_ps =
          (!a.net_magic && icnt > 0)
              ? (kmaxh_s[fan_rank] * a.hop_cycles + a.ser_req) * pnh
              : 0;
      ips = 2 * mh_ps + a.inv_ack_cycles * pcore;
    }
    leaf<int64_t>(a, a.off_inv_ps)[t] = ips;
    leaf<int64_t>(a, a.off_inv_count)[t] = icnt;
    if (!a.queue_on) {
      const int64_t dstart = need_read ? tdir + ops : 0;
      const int64_t dready = dstart + a.dram_latency_ps +
                             a.dram_processing_ps;
      tdata = tdir + ops;
      if (need_read && dready > tdata) tdata = dready;
      if (!need_read && tdata < 0) tdata = 0;
      if (a.fanout && tdir + ips > tdata) tdata = tdir + ips;
      leaf<int64_t>(a, a.off_t_data)[t] = tdata;
      leaf<int64_t>(a, a.off_completion)[t] =
          tdata + rps + a.l2_cycles * pl2 + l1f + ext;
      tkey = tdata * T + t;
      if (serve_all) atomicMax(&tblA[hx], static_cast<long long>(tkey));
    }
  }

  // ---- phase 8: the floor write by each slot's single winner, in place
  if (!a.queue_on) {
    __syncthreads();
    if (row && serve_all && tblA[hx] == tkey) {
      a.ftbl[hx] = ln;
      a.ftbl[H + hx] = tdata;
    }
  }
}

}  // namespace

extern "C" size_t chain_classify_smem_bytes(int64_t T, int64_t A, int64_t W,
                                            int64_t H, int64_t KF) {
  size_t off = 0;
  off = align8(off + sizeof(long long) * H);
  off = align8(off + sizeof(int32_t) * H);
  off = align8(off + H);
  off = align8(off + sizeof(int64_t) * T * A);
  off = align8(off + sizeof(long long) * T);
  off = align8(off + sizeof(int64_t) * T);
  off = align8(off + sizeof(uint64_t) * T * W);
  off = align8(off + sizeof(long long));
  off = align8(off + sizeof(int32_t) * T);
  off = align8(off + sizeof(int32_t) * T);
  off = align8(off + sizeof(int32_t) * T);
  off = align8(off + sizeof(int32_t) * T);
  off = align8(off + sizeof(uint32_t) * T);
  off = align8(off + sizeof(int32_t) * KF);
  off = align8(off + sizeof(int32_t) * KF);
  off = align8(off + sizeof(int32_t) * KF);
  off = align8(off + T);
  off += T;
  return off;
}

extern "C" int chain_classify_launch(const StepArgs* args, void* stream) {
  // The wrapper (chain.py _Step) holds T, W and A to the limits of this
  // kernel and the shared memory to the card's.
  if (args->T <= 0) return 0;
  if (args->T > kMaxThreads || args->W > kMaxWords || args->A > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = chain_classify_smem_bytes(args->T, args->A, args->W,
                                                args->H, args->KF);
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    // Above 48 KB a block's dynamic shared memory needs an opt-in.
    const cudaError_t err = cudaFuncSetAttribute(
        chain_classify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const int64_t warps = (args->T + 31) / 32 * 32;
  const unsigned threads =
      static_cast<unsigned>(warps > kMinThreads ? warps : kMinThreads);
  chain_classify_kernel<<<1, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
