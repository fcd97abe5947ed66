// chain_classify.cu — one chain-replay iteration's classify step as a
// hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel graphite_tpu/engine/kernels/chain.py:134
// `chain_classify`, which the JAX package runs through
// graphite_tpu/engine/kernels/dispatch.py:176 (one `pl.pallas_call`, a
// single grid step, per replay iteration).  The plain PyTorch form of the
// same function is graphite_tpu_torch/engine/kernels/chain.py
// `chain_classify`; both must agree on every output element.
//
// Scope: private L1/L2 under MSI, full-map directory, zero-load memory
// network (magic or emesh_hop_counter), fan-out replay on or off, the
// DRAM queue model on (the caller prices the queue) or off (this kernel
// computes the completion and writes the per-line floor table).  The
// wrapper refuses anything else.
//
// Design.  The hash tables of the JAX function (victim-way exclusion,
// way-slot election, shared-read combining, the floor maximum) are global
// over tiles, so the kernel is ONE block with one thread per tile
// (T <= 512 is enforced by the simulator) and the H-sized tables live in
// dynamic shared memory:
//
//   region A  int64[H]   election minimum (BIG = 2^62 empty), later the
//                        floor-table maximum (-1 empty)
//   region B  uint32[H]  hit-held way bits per directory set, later the
//                        combining representative's row (-1 empty)
//   region C  uint8[H]   "an exclusive request hashes here"
//   per row   packed FCFS key, owner tile, budget flags, line, way, the
//             invalidation bitmap words; per fan-out slot its row, round
//             trip and target count
//
// Phases are separated by __syncthreads(): probe and victim way; FCFS
// keys and the election (atomicMin on 64-bit keys); transition and
// budgets — fan-out rank and per-owner rank are loops over the [T] rows
// staged in shared memory, replacing the JAX [T, T] masks; combining and
// timing legs; the [KF, T] invalidation masks, one thread per fan-out
// slot; the queue-off completion and floor scatter (atomicMax on the
// unique key t_data * T + row, then a set by the single winner).
//
// Duplicate-index writes.  Two served shared-read representatives of
// different lines may hash to one combining slot.  The JAX package's CPU
// scatter applies updates in row order, so the last row wins; here
// atomicMax over row indices picks that same row, and its line and way
// are read from the per-row arrays.  Every other table is order-free
// (bit-or, min, max) or written by a unique row.
//
// Unsigned words.  Sharer bitmaps and hashes are uint64 arithmetic here
// (the tensors hold int64 bit patterns); the delta new - old wraps as in
// the JAX package.
//
// Cost.  Launch latency bounds it: a few KB of operands and outputs per
// iteration at T = 64, a few hundred integer operations per thread.  The
// P iterations of one pass are P launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ST_I = 0, ST_S = 1, ST_O = 2, ST_M = 4;
constexpr int64_t kBig = 1LL << 62;
constexpr int32_t kNever = 2147483647;
constexpr int64_t kJOwn = 8;
constexpr int64_t kKeyClip = 1LL << 40;
constexpr int kMaxWords = 8;      // T <= 512 -> at most 8 bitmap words

}  // namespace

struct ChainArgs {
  // inputs, [T] unless noted
  const uint8_t* active;
  const uint8_t* is_ex;
  const uint8_t* is_if;
  const int64_t* line;
  const int64_t* issue;
  const int64_t* extra;
  const int32_t* home;
  const int32_t* dset;
  const int32_t* fidx;
  const int32_t* hidx;
  const int64_t* drow;        // [T, A]
  const int64_t* dsharers;    // [T, A, W]
  const int32_t* p_net;
  const int32_t* p_dir;
  const int32_t* p_l2;
  const int32_t* p_l1d;
  const int32_t* p_l1i;
  const int32_t* p_core;
  const int64_t* ftbl_in;     // [2, H] (queue off) or null
  // outputs, [T] unless noted
  int32_t* way;
  uint8_t* hit;
  uint8_t* serve;
  uint8_t* serve_all;
  uint8_t* member;
  uint8_t* member_add;
  uint8_t* hard_stop;
  uint8_t* fan_go;
  uint8_t* owner_leg;
  uint8_t* evicting;
  int32_t* owner;
  int32_t* ow_slot;
  int32_t* down_to;
  int32_t* new_state;
  int32_t* new_owner;
  int64_t* delta_sh;          // [T, W]
  uint8_t* dram_read;
  uint8_t* dram_write;
  uint8_t* need_read;
  uint8_t* dram_wb;
  int64_t* t_dir;
  int64_t* owner_ps;
  int64_t* inv_ps;
  int64_t* reply_ps;
  int64_t* from_dram_ps;
  int64_t* dram_arrival;
  int64_t* l1_fill_ps;
  uint8_t* inv_bool;          // [KF, T] (fanout) or null
  int64_t* line_fr;           // [KF] (fanout) or null
  int64_t* inv_count;
  int64_t* completion;        // (queue off) or null
  int64_t* t_data;            // (queue off) or null
  int64_t* ftbl_out;          // [2, H] (queue off) or null
  // geometry and timing
  int64_t T, A, W, H, KF;
  int64_t fanout, queue_on, ndsets, mesh_width;
  int64_t net_magic, hop_cycles, ser_req, ser_data;
  int64_t inv_ack_cycles, dir_cycles, l2_cycles, l1d_cycles, l1i_cycles;
  int64_t dram_latency_ps, dram_processing_ps;
};

namespace {

__device__ __forceinline__ uint64_t fmix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDULL;
  x ^= x >> 33;
  return x;
}

__device__ __forceinline__ int64_t fmod_pos(int64_t x, int64_t n) {
  int64_t r = x % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int64_t hops(int64_t s, int64_t d, int64_t mw) {
  const int64_t sx = fmod_pos(s, mw), sy = s / mw;
  const int64_t dx = fmod_pos(d, mw), dy = d / mw;
  return (sx > dx ? sx - dx : dx - sx) + (sy > dy ? sy - dy : dy - sy);
}

// Zero-load unicast latency in ps (noc.unicast_ps).
__device__ __forceinline__ int64_t unicast(const ChainArgs& a, int64_t s,
                                           int64_t d, int64_t ser,
                                           int64_t period) {
  if (a.net_magic) return 0;
  return (hops(s, d, a.mesh_width) * a.hop_cycles + ser) * period;
}

__host__ __device__ __forceinline__ size_t align8(size_t x) {
  return (x + 7) & ~static_cast<size_t>(7);
}

__global__ void chain_classify_kernel(ChainArgs a) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int64_t T = a.T, A = a.A, W = a.W, H = a.H, KF = a.KF;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // ---- shared-memory layout (sizes mirror chain_classify_smem_bytes)
  size_t off = 0;
  long long* tblA = reinterpret_cast<long long*>(smem + off);
  off = align8(off + sizeof(long long) * H);
  int32_t* tblB = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * H);
  uint8_t* ex_any = smem + off;
  off = align8(off + H);
  long long* packed_s = reinterpret_cast<long long*>(smem + off);
  off = align8(off + sizeof(long long) * T);
  int64_t* line_s = reinterpret_cast<int64_t*>(smem + off);
  off = align8(off + sizeof(int64_t) * T);
  uint64_t* invt_s = reinterpret_cast<uint64_t*>(smem + off);
  off = align8(off + sizeof(uint64_t) * T * W);
  int64_t* kps_s = reinterpret_cast<int64_t*>(smem + off);
  off = align8(off + sizeof(int64_t) * KF);
  int64_t* kcnt_s = reinterpret_cast<int64_t*>(smem + off);
  off = align8(off + sizeof(int64_t) * KF);
  long long* issue0_s = reinterpret_cast<long long*>(smem + off);
  off = align8(off + sizeof(long long));
  int32_t* owner_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * T);
  int32_t* way_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * T);
  int32_t* frrow_s = reinterpret_cast<int32_t*>(smem + off);
  off = align8(off + sizeof(int32_t) * KF);
  uint8_t* flag_s = smem + off;   // bit0 need_fan, bit1 owner-budget row

  // ---- phase 0: tables empty, floor table copied through
  for (int64_t i = tid; i < H; i += nthr) {
    tblA[i] = kBig;
    tblB[i] = 0;
    ex_any[i] = 0;
  }
  for (int64_t k = tid; k < KF; k += nthr) frrow_s[k] = -1;
  if (tid == 0) issue0_s[0] = kBig;
  if (!a.queue_on) {
    for (int64_t i = tid; i < 2 * H; i += nthr) a.ftbl_out[i] = a.ftbl_in[i];
  }
  __syncthreads();

  const int64_t t = tid;
  const bool row = t < T;
  bool act = false, isx = false, isf = false, hit = false;
  int64_t ln = 0, iss = 0;
  int32_t hm = 0, ds = 0, fi = 0, hx = 0;
  int hway = 0;
  uint64_t fhash = 0;

  // ---- phase 1: directory probe at (home, dset); hit-held ways; the
  // earliest active issue; exclusive requests per combining slot
  if (row) {
    act = a.active[t] != 0;
    isx = a.is_ex[t] != 0;
    isf = a.is_if[t] != 0;
    ln = a.line[t];
    iss = a.issue[t];
    hm = a.home[t];
    ds = a.dset[t];
    fi = a.fidx[t];
    hx = a.hidx[t];
    bool any = false;
    for (int64_t w = 0; w < A; ++w) {
      const int64_t word = a.drow[t * A + w];
      const int st = static_cast<int>(word & 7);
      const int32_t tag = static_cast<int32_t>(word >> 33);
      if (tag == static_cast<int32_t>(ln) && st != ST_I) {
        if (!any) hway = static_cast<int>(w);
        any = true;
      }
    }
    hit = any && act;
    fhash = fmix64(static_cast<uint64_t>(static_cast<int64_t>(fi))) %
            static_cast<uint64_t>(H);
    if (hit) atomicOr(reinterpret_cast<unsigned int*>(&tblB[fhash]),
                      1u << hway);
    if (act) atomicMin(issue0_s, static_cast<long long>(iss));
    if (act && isx) ex_any[hx] = 1;
    line_s[t] = ln;
  }
  __syncthreads();

  // ---- phase 2: victim way, FCFS key, way-slot election; the MSI
  // transition against the replayed entry
  int64_t way = 0, packed = 0, posr = 0;
  uint64_t aidx = 0;
  bool can_alloc = false, vic_dead = false, has_inv = false;
  int way_state = ST_I, way_owner = -1, entry_state = ST_I;
  bool own_act = false, dram_rd = false;
  int32_t own_tile = 0, dgrade = ST_I, nstate = ST_I, nowner = -1;
  uint64_t entry_row[kMaxWords], new_sh[kMaxWords];
  if (row) {
    const unsigned used = static_cast<unsigned>(tblB[fhash]);
    int64_t best = 0;
    int32_t best_key = 0;
    for (int64_t w = 0; w < A; ++w) {
      const int64_t word = a.drow[t * A + w];
      const int st = static_cast<int>(word & 7);
      const int32_t stamp = static_cast<int32_t>((word >> 16) & 0x1FFFF);
      const int32_t key = ((used >> w) & 1u) ? kNever
                          : (st == ST_I ? -1 : stamp);
      if (w == 0 || key < best_key) {
        best_key = key;
        best = w;
      }
    }
    can_alloc = act && !hit && best_key != kNever;
    way = hit ? hway : best;
    const int64_t am = (static_cast<int64_t>(hm) * a.ndsets + ds) * A + way;
    aidx = fmix64(static_cast<uint64_t>(am)) % static_cast<uint64_t>(H);
    int64_t d = iss - static_cast<int64_t>(issue0_s[0]);
    d = d < 0 ? 0 : (d > kKeyClip ? kKeyClip : d);
    packed = d * T + t;
    if (act) atomicMin(&tblA[aidx], static_cast<long long>(packed));

    const int64_t wword = a.drow[t * A + way];
    way_state = static_cast<int>(wword & 7);
    way_owner = static_cast<int>((wword >> 3) & 0x1FFF) - 1;
    entry_state = hit ? way_state : ST_I;
    const int entry_owner = hit ? way_owner : -1;
    const int64_t req_w = t / 64;
    const uint64_t req_b = 1ULL << (t % 64);
    own_act = entry_state == ST_M && entry_owner >= 0 && entry_owner != t;
    own_tile = entry_owner < 0 ? 0 : entry_owner;
    bool all_zero = true;
    for (int64_t w = 0; w < W; ++w) {
      const uint64_t er = static_cast<uint64_t>(
          a.dsharers[(t * A + way) * W + w]);
      entry_row[w] = er;
      all_zero = all_zero && er == 0;
      const uint64_t es = hit ? er : 0;
      const uint64_t rb = w == req_w ? req_b : 0;
      uint64_t sh;
      if (isx) {
        sh = rb;
      } else if (entry_state == ST_M) {
        const uint64_t ob = (own_tile / 64 == w) ? (1ULL << (own_tile % 64))
                                                 : 0;
        sh = ob | rb;
      } else {
        sh = es | rb;
      }
      new_sh[w] = sh;
      const uint64_t iv = (isx && entry_state == ST_S) ? (es & ~rb) : 0;
      invt_s[t * W + w] = iv;
      has_inv = has_inv || iv != 0;
    }
    nstate = isx ? ST_M : ST_S;
    nowner = isx ? static_cast<int32_t>(t) : -1;
    dgrade = isx ? ST_I : ST_S;
    dram_rd = !own_act;
    vic_dead = way_state == ST_I ||
               ((way_state == ST_S || way_state == ST_O) && all_zero);
    packed_s[t] = packed;
    owner_s[t] = own_tile;
  }
  __syncthreads();

  // ---- phase 3: election result and the fan-out candidates
  bool cand0 = false, need_fan = false;
  if (row) {
    const bool wslot = act && tblA[aidx] == packed;
    cand0 = act && wslot && (hit || (can_alloc && vic_dead));
    need_fan = a.fanout && cand0 && has_inv;
    flag_s[t] = need_fan ? 1 : 0;
  }
  // region B becomes the combining representative table
  for (int64_t i = tid; i < H; i += nthr) tblB[i] = -1;
  __syncthreads();

  // ---- phase 4: fan-out budget (FCFS rank among fan-out candidates)
  int64_t fan_rank = 0;
  bool cand = false, oact = false;
  if (row) {
    if (need_fan) {
      for (int64_t j = 0; j < T; ++j)
        if ((flag_s[j] & 1) && packed_s[j] < packed) ++fan_rank;
    }
    if (a.fanout) {
      cand = cand0 && (!has_inv || (need_fan && fan_rank < KF));
    } else {
      cand = cand0 && !has_inv;
    }
    oact = cand && own_act;
  }
  __syncthreads();
  if (row && oact) flag_s[t] |= 2;
  __syncthreads();

  // ---- phase 5: per-owner delivery budget, serve, combining reps
  bool serve = false, owner_leg = false, fan_go = false, evict = false;
  bool sh_ok = false;
  if (row) {
    if (oact) {
      for (int64_t j = 0; j < T; ++j) {
        if ((flag_s[j] & 2) && owner_s[j] == own_tile &&
            (packed_s[j] < packed || (packed_s[j] == packed && j < t)))
          ++posr;
      }
    }
    serve = cand && !(own_act && posr >= kJOwn);
    owner_leg = own_act && serve;
    fan_go = serve && has_inv;
    evict = serve && !hit && way_state != ST_I;
    sh_ok = entry_state == ST_I || entry_state == ST_S;
    if (serve && !isx && sh_ok) atomicMax(&tblB[hx], static_cast<int>(t));
    if (fan_go) frrow_s[fan_rank] = static_cast<int32_t>(t);
    way_s[t] = static_cast<int32_t>(way);
  }
  // region A becomes the floor-table maximum
  for (int64_t i = tid; i < H; i += nthr) tblA[i] = -1;
  __syncthreads();

  // ---- phase 6: combining members, hard stops, timing legs, apply
  // operands
  bool serve_all = false, need_read = false;
  int64_t tdir = 0, ops = 0, rps = 0;
  if (row) {
    const int r = tblB[hx];
    const int64_t rep_line = r >= 0 ? line_s[r] : -1;
    const int64_t rep_way = r >= 0 ? way_s[r] : 0;
    const bool member = act && !serve && !isx && sh_ok && !ex_any[hx] &&
                        rep_line == ln;
    const int64_t wayf = member ? rep_way : way;
    serve_all = serve || member;
    const bool stop_inv = !a.fanout && has_inv;
    const bool hard = act && !serve_all &&
                      (stop_inv || (can_alloc && !vic_dead) ||
                       (!hit && !can_alloc) || (own_act && posr >= kJOwn));

    const int64_t pn = a.p_net[t];
    const int64_t pnh = a.p_net[hm];
    const int64_t net_req = unicast(a, t, hm, a.ser_req, pn);
    rps = unicast(a, hm, t, a.ser_data, pnh);
    tdir = iss + net_req + a.dir_cycles * static_cast<int64_t>(a.p_dir[hm]);
    const int64_t pno = a.p_net[own_tile];
    const int64_t leg = unicast(a, hm, own_tile, a.ser_req, pnh) +
                        a.l2_cycles * static_cast<int64_t>(a.p_l2[own_tile]) +
                        unicast(a, own_tile, hm, a.ser_data, pno);
    ops = owner_leg ? leg : 0;
    need_read = serve_all && dram_rd;
    const int64_t l1f =
        isf ? a.l1i_cycles * static_cast<int64_t>(a.p_l1i[t])
            : a.l1d_cycles * static_cast<int64_t>(a.p_l1d[t]);

    for (int64_t w = 0; w < W; ++w)
      a.delta_sh[t * W + w] = static_cast<int64_t>(new_sh[w] - entry_row[w]);
    const uint64_t own_w = static_cast<uint64_t>(
        a.dsharers[(t * A + wayf) * W + t / 64]);
    const bool madd = member && (!hit || (own_w & (1ULL << (t % 64))) == 0);

    a.way[t] = static_cast<int32_t>(wayf);
    a.hit[t] = hit;
    a.serve[t] = serve;
    a.serve_all[t] = serve_all;
    a.member[t] = member;
    a.member_add[t] = madd;
    a.hard_stop[t] = hard;
    a.fan_go[t] = fan_go;
    a.owner_leg[t] = owner_leg;
    a.evicting[t] = evict;
    a.owner[t] = own_tile;
    a.ow_slot[t] = static_cast<int32_t>(posr < kJOwn - 1 ? posr : kJOwn - 1);
    a.down_to[t] = dgrade;
    a.new_state[t] = nstate;
    a.new_owner[t] = nowner;
    a.dram_read[t] = dram_rd;
    a.dram_write[t] = own_act;
    a.need_read[t] = need_read;
    a.dram_wb[t] = own_act && serve_all;
    a.t_dir[t] = tdir;
    a.owner_ps[t] = ops;
    a.reply_ps[t] = rps;
    a.from_dram_ps[t] = 0;
    a.dram_arrival[t] = tdir + ops;
    a.l1_fill_ps[t] = l1f;
  }

  // ---- phase 7: fan-out invalidation masks, one thread per slot
  if (a.fanout && tid < KF) {
    const int64_t k = tid;
    const int r = frrow_s[k];
    int64_t maxh = 0, cnt = 0, ack = 0, pnh = 0, hfr = 0, lfr = 0;
    if (r >= 0) {
      hfr = a.home[r];
      pnh = a.p_net[hfr];
      ack = a.inv_ack_cycles * static_cast<int64_t>(a.p_core[r]);
      lfr = line_s[r];
    }
    for (int64_t j = 0; j < T; ++j) {
      const bool bit =
          r >= 0 && ((invt_s[r * W + j / 64] >> (j % 64)) & 1ULL) != 0;
      a.inv_bool[k * T + j] = bit;
      if (bit) {
        ++cnt;
        const int64_t h = hops(hfr, j, a.mesh_width);
        if (h > maxh) maxh = h;
      }
    }
    int64_t mh_ps = 0;
    if (!a.net_magic && cnt > 0)
      mh_ps = (maxh * a.hop_cycles + a.ser_req) * pnh;
    kps_s[k] = 2 * mh_ps + ack;
    kcnt_s[k] = cnt;
    a.line_fr[k] = lfr;
  }
  __syncthreads();

  // ---- phase 8: fan-out legs per row; the queue-off completion
  int64_t tdata = 0, tkey = 0;
  if (row) {
    const int64_t ips = (a.fanout && fan_go) ? kps_s[fan_rank] : 0;
    a.inv_ps[t] = ips;
    a.inv_count[t] = (a.fanout && fan_go) ? kcnt_s[fan_rank] : 0;
    if (!a.queue_on) {
      const int64_t dstart = need_read ? tdir + ops : 0;
      const int64_t dready = dstart + a.dram_latency_ps +
                             a.dram_processing_ps;
      tdata = tdir + ops;
      if (need_read && dready > tdata) tdata = dready;
      if (!need_read && tdata < 0) tdata = 0;
      if (a.fanout && tdir + ips > tdata) tdata = tdir + ips;
      a.t_data[t] = tdata;
      a.completion[t] = tdata + rps +
                        a.l2_cycles * static_cast<int64_t>(a.p_l2[t]) +
                        (isf ? a.l1i_cycles * static_cast<int64_t>(a.p_l1i[t])
                             : a.l1d_cycles *
                                   static_cast<int64_t>(a.p_l1d[t])) +
                        a.extra[t];
      tkey = tdata * T + t;
      if (serve_all) atomicMax(&tblA[hx], static_cast<long long>(tkey));
    }
  }
  __syncthreads();

  // ---- phase 9: the floor write by each slot's single winner
  if (row && !a.queue_on && serve_all && tblA[hx] == tkey) {
    a.ftbl_out[hx] = ln;
    a.ftbl_out[H + hx] = tdata;
  }
}

}  // namespace

extern "C" size_t chain_classify_smem_bytes(int64_t T, int64_t W, int64_t H,
                                            int64_t KF) {
  size_t off = 0;
  off = align8(off + sizeof(long long) * H);
  off = align8(off + sizeof(int32_t) * H);
  off = align8(off + H);
  off = align8(off + sizeof(long long) * T);
  off = align8(off + sizeof(int64_t) * T);
  off = align8(off + sizeof(uint64_t) * T * W);
  off = align8(off + sizeof(int64_t) * KF);
  off = align8(off + sizeof(int64_t) * KF);
  off = align8(off + sizeof(long long));
  off = align8(off + sizeof(int32_t) * T);
  off = align8(off + sizeof(int32_t) * T);
  off = align8(off + sizeof(int32_t) * KF);
  off += T;
  return off;
}

extern "C" int chain_classify_launch(const ChainArgs* args, void* stream) {
  // The wrapper (chain.py _check_inputs) holds T, W and A to the limits
  // of this kernel: T <= 512, W <= kMaxWords, A <= 32.
  if (args->T <= 0) return 0;
  const size_t smem =
      chain_classify_smem_bytes(args->T, args->W, args->H, args->KF);
  if (smem > 48 * 1024) {
    // Above 48 KB a block's dynamic shared memory needs an opt-in.
    const cudaError_t err = cudaFuncSetAttribute(
        chain_classify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chain_classify_kernel<<<1, static_cast<unsigned>(args->T), smem,
                          static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
