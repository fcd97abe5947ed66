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
// Scope: a full-map directory under every coherence protocol of the
// engine (`proto`: MSI or MOSI with private L2; shared-L2 MSI or MESI,
// where the directory is the per-tile L2 slice), every memory-network
// model in its zero-load form (`net_kind`: magic; the electrical mesh of
// emesh_hop_counter and of emesh_hop_by_hop, which prices as the hop
// counter wherever the chain pass runs; atac, whose unicast legs take
// the ENet or the ONet by the sender's and receiver's clusters, from the
// per-tile `cluster_of` and `ap_hops` tables), fan-out replay on or off, the
// DRAM queue model on (the caller prices the queue) or off (this kernel
// computes the completion and writes the per-line floor table IN PLACE).
// The wrapper refuses anything else.  The protocol's transition is one
// device function (`transition`, engine/directory.py's four FSMs); with
// shared L2 a line's home is its slice (the fold over every tile), an
// owner looks the line up in its L1D, a slice miss whose memory
// controller is another tile adds the slice->controller legs, and the
// completion has no private-L2 fill.
//
// Operands by pointer.  Each tile's thread reads its chain head
// mq_*[clamp(head, 0, P - 1), t], and derives line, kind, home, directory
// set, flat set and hash slot itself (home_fold, the XOR fold and fmix64
// copied from engine/dense.py).  Lines are non-negative, so C's / and %
// equal the floor forms of the plain code.  No division instruction on
// the hot path: every runtime divisor (H, the homes a line folds over,
// the controller count, the directory sets) comes with a magic number
// computed on the host
// (chain.py fast_divisor), and tile coordinates come from a per-tile
// (x, y) table built once per launch (in shared memory, or the grid
// form's workspace) with 32-bit arithmetic.
//
// Design.  The hash tables of the function (victim-way exclusion,
// way-slot election, shared-read combining, the floor maximum) are global
// over tiles: one thread per tile for the per-tile work, and every thread
// of the launch for the table initialisation, the staging of the
// directory rows and the [KF, T] invalidation masks, with a barrier over
// the whole launch wherever a phase reads what another thread wrote.
// Its arrays (make_layout):
//
//   tblA  int64[H]   election minimum (BIG empty), later the floor max
//   tblB  int32[H, NW] hit-held way bits per set (NW words of 32 ways;
//                    one word in the one-block forms), there later the
//                    combining representative's row (-1 empty)
//   rep   int32[H]   the grid form's combining representative's row
//   exa   uint8[H]   "an exclusive request hashes here"
//   drow  int64[A, T] each head's directory row, way-major (the probe and
//                    the victim scan read it from here, once each)
//   invt  uint64[T, W] each row's invalidation bitmap words
//   per row: FCFS key, line, flat set, home, owner, way, (x, y), two
//   flags; per fan-out slot its row, target count and the network
//   cycles to its farthest target.
//
// Three forms, chosen by the wrapper from the sizes (chain.py step_form),
// never as a fallback:
//   * shared (F_SHARED; T <= 512, ONE block of at most 512 threads,
//     A <= 32): every array in shared memory, while they fit one block's
//     227 KB;
//   * wide (F_WIDE; T <= 1024, ONE block of at most 1024 threads, A <=
//     32): the H-sized tables and the invalidation words in a device
//     workspace the wrapper allocates once and this kernel clears itself
//     (phase 0 and the table turnovers), the directory rows read where
//     they lie in dir_word and not staged, the per-row arrays still in
//     shared memory.  Its atomics are global ones; __syncthreads() orders
//     the block's global accesses as it does its shared ones.  At T =
//     1024 and H = 16,384 the tables and staged rows alone would need
//     about 344 KB.
//   * grid (F_GRID; any T, any A; what neither other form takes: T >
//     1024, or more than 32 ways): ceil(T / 256) blocks of 256 threads in
//     ONE cooperative launch (cudaLaunchCooperativeKernel), every array in
//     the workspace (the per-row arrays too: phases 5, 5b and 6 read other
//     blocks' rows), the block barriers replaced by grid-wide ones
//     (cooperative_groups::this_grid().sync(), which is valid because the
//     launch is cooperative, so every block is resident at once), the
//     shared-memory atomics by global ones.  The hit-held ways of a set
//     are ceil(A / 32) words, and the combining table has its own rep[H]
//     (cleared in phase 0), so phase 4 clears nothing.  Phases 1 and 2
//     share one barrier interval (no staged rows to wait for).  The
//     wrapper refuses, at construction, a grid larger than the card holds
//     at once (chain_classify_grid_capacity).
//
// Duplicates resolve as in the plain form whatever the form: the election
// is the minimum of the packed FCFS key (atomicMin), a combining slot
// keeps the LAST representative row (atomicMax), and the floor slot goes
// to the largest t_data * T + row (atomicMax; the product fits int64
// while t_data < 2^63 / 8,192 ps, over 10^15 ps, and is the plain form's
// own int64 product).
//
// Only the chosen way's W sharer words are read from the sharer array
// (the whole [A, W] row of every head would need T * A * W * 8 bytes, 512
// KB at T = 512); a combining member reads none of its own, because a
// member has its representative's line, hence the same directory row,
// probe and victim, hence the same way.
//
// Phases, separated by barriers (sync(): the block's, or the grid's):
//   0  tables empty; per tile: the head, its coordinates, ChainHead out;
//   1  whole block: stage the directory rows; issue minimum, exclusive
//      flags;
//   2  per tile: the probe, hit-held ways;
//   3  per tile: victim way, FCFS key, election (atomicMin), the
//      protocol's transition against the chosen way's sharer words,
//      delta out;
//   4  per tile: election result, the fan-out flags;
//   5  per tile: fan-out rank (a loop over the staged rows), candidacy,
//      the owner-budget flags (under MOSI an O entry has an owner leg
//      AND invalidations, so the flag waits for the fan-out rank);
//   5b per tile: per-owner rank, serve, combining representatives
//      (atomicMax of the row: the JAX package's CPU scatter lets the
//      LAST row win);
//   6  per tile: members, hard stops, timing legs, outputs; every thread:
//      the [KF, T] masks, one thread per (slot, tile), with counts and
//      the farthest target's cycles by atomics (shared memory but in the
//      grid form; fan-out
//      only; under atac each target is priced by its own route, and on
//      the mesh the cycles are the hops times a constant, so one
//      maximum serves every network);
//   7  per tile: fan-out legs; queue off: completion and the floor key
//      (atomicMax on the unique t_data * T + row);
//   8  queue off: each slot's single winner writes the floor table.
//
// Cost.  Launch latency bounds it: a few KB of operands and outputs per
// iteration at T = 64, a few hundred integer operations per thread, and
// four dependent global round trips (head, bank row, directory rows,
// sharer words).  The P iterations of one pass are P launches.  The grid
// form adds up to eight grid barriers of a few microseconds each; its
// rank loops (phases 5 and 5b) read every row's key from global memory
// (L2-resident at these sizes).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ST_I = 0, ST_S = 1, ST_O = 2, ST_E = 3, ST_M = 4;
// Protocols (chain.py PROTO_CODES).
constexpr int64_t P_MSI = 0, P_MOSI = 1, P_SH_MSI = 2, P_SH_MESI = 3;
// Memory-network kinds (noc_atac.KERNEL_NET_CODES).
constexpr int64_t NET_MAGIC = 0, NET_MESH = 1, NET_ATAC = 2;
// A row's flags, kept in one register across the block's barriers (the
// wide form's 1,024 threads leave each one 64 registers).
constexpr uint32_t R_ACT = 1u << 0, R_ISX = 1u << 1, R_ISF = 1u << 2,
                   R_HIT = 1u << 3, R_CANALLOC = 1u << 4,
                   R_VICDEAD = 1u << 5, R_HASINV = 1u << 6,
                   R_OWNACT = 1u << 7, R_SHOK = 1u << 8,
                   R_WAYLIVE = 1u << 9, R_CAND0 = 1u << 10,
                   R_NEEDFAN = 1u << 11, R_CAND = 1u << 12,
                   R_SERVE = 1u << 13, R_OWNERLEG = 1u << 14,
                   R_FANGO = 1u << 15, R_SERVEALL = 1u << 16,
                   R_NEEDREAD = 1u << 17;
constexpr int64_t PEND_EX_REQ = 2, PEND_IFETCH = 3;
constexpr int64_t kBig = 1LL << 62;
constexpr int32_t kNever = 2147483647;
constexpr int kJOwn = 8;
constexpr int64_t kKeyClip = 1LL << 40;
// The forms (chain.py SHARED, WIDE, GRID).
constexpr int F_SHARED = 0, F_WIDE = 1, F_GRID = 2;
constexpr int kMaxThreadsShared = 512;  // the shared form: T <= 512
constexpr int kMaxThreadsWide = 1024;   // the wide form: T <= 1024
constexpr int kMinThreads = 256;
constexpr int kGridThreads = 256;       // the grid form's block
// The one-block forms: T <= 1024 -> at most 16 bitmap words, and the
// hit-held ways of a set are the bits of one int32.
constexpr int kMaxWords = 16;
constexpr int kMaxWays = 32;

}  // namespace

// Exact uint64 division by d without a divide instruction (host side:
// chain.py fast_divisor).
struct FastDiv {
  uint64_t d, magic;
  int64_t shift;
};

// Byte offsets of the launch's arrays: in shared memory, except that the
// wide form keeps the H-sized tables and the invalidation words in its
// workspace and stages no directory rows, and the grid form keeps every
// array there.  `smem` and `ws` are the sizes.
struct Layout {
  size_t tblA, tblB, exa, drow, packed, line, invt, issue0, fidx, home,
      owner, way, xy, frrow, kcnt, kmaxc, fan, oact, rep;
  size_t smem, ws;
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
  unsigned char* ws;           // the wide form's workspace (else null)
  const int32_t* cluster_of;   // [T] atac: each tile's cluster (else null)
  const int32_t* ap_hops;      // [T] atac: hops to its access point
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
  int64_t fanout, queue_on, ndsets, home_stride, home_bits, site_stride,
      site_bits, dset_bits;
  int64_t mesh_width, net_kind, hop_cycles, ser_req, ser_data;
  // atac: the ONet's cycles past the access point, distance_based
  // routing (1) or cluster_based (0), and its unicast hop threshold
  int64_t onet_cycles, atac_dist, atac_thresh;
  int64_t inv_ack_cycles, dir_cycles, l2_cycles, l1d_cycles, l1i_cycles;
  int64_t dram_latency_ps, dram_processing_ps;
  int64_t form;                // F_SHARED, F_WIDE or F_GRID
  int64_t proto;               // P_MSI, P_MOSI, P_SH_MSI or P_SH_MESI
  // H; the homes (controllers, or every slice with shared L2); the
  // controllers (the DRAM site); the directory sets
  FastDiv div_h, div_home, div_site, div_dsets;
  // The arrays' offsets (make_layout), filled in by chain_classify_launch
  // on the host: the kernel reads them from its parameters where it uses
  // them and holds none in a register.
  Layout lay;
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

__device__ __forceinline__ bool on(uint32_t fl, uint32_t f) {
  return (fl & f) != 0;
}
__device__ __forceinline__ uint32_t flag(bool b, uint32_t f) {
  return b ? f : 0u;
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

// Zero-load unicast cycles s -> d before the tail's serialisation (the
// mesh: hops; atac: noc_atac.unicast_cycles, the ENet within a cluster
// or, distance_based, within the threshold, else the ONet).
__device__ __forceinline__ int32_t net_cycles(const StepArgs& a,
                                              const uint32_t* xy, int s,
                                              int d) {
  const int h = hops(xy, s, d);
  if (a.net_kind == NET_ATAC && a.cluster_of[s] != a.cluster_of[d] &&
      !(a.atac_dist && h <= a.atac_thresh))
    return static_cast<int32_t>(a.ap_hops[s] * a.hop_cycles + a.onet_cycles);
  return static_cast<int32_t>(h * a.hop_cycles);
}

// Zero-load unicast latency in ps (noc.unicast_ps).
__device__ __forceinline__ int64_t unicast(const StepArgs& a,
                                           const uint32_t* xy, int s, int d,
                                           int64_t ser, int64_t period) {
  if (a.net_kind == NET_MAGIC) return 0;
  return (net_cycles(a, xy, s, d) + ser) * period;
}

// One request's directory transition (engine/directory.py transition):
// against the entry's state `st` and owner `own` (I and -1 on a miss),
// the entry after it, the owner leg, the DRAM traffic and how the new
// sharer words and the invalidation targets are made from the entry's.
struct Trans {
  int32_t new_state, new_owner, down_to;
  bool owner_leg;      // a flush / downgrade round trip to the owner
  bool dram_read, dram_write;
  bool own_keep;       // SH on an owned entry: sharers = {owner, req}
  bool inv_on;         // EX on a shared entry: invalidate the sharers
  bool inv_skip_owner; // ... but the owner, which the flush leg reaches
};

__device__ __forceinline__ Trans transition(int64_t proto, bool isx,
                                            bool isf, int t, int st,
                                            int own) {
  Trans r;
  const bool mosi = proto == P_MOSI;
  const bool shared = proto == P_SH_MSI || proto == P_SH_MESI;
  // The states in which the entry has a live owner.
  const bool owned = st == ST_M || (mosi && st == ST_O) ||
                     (shared && st == ST_E);
  const bool live = owned && own >= 0;
  r.owner_leg = live && own != t;
  r.down_to = isx ? ST_I : (mosi ? ST_O : ST_S);
  r.own_keep = !isx && (shared ? owned : st == ST_M);
  r.inv_on = isx && (st == ST_S || ((mosi || shared) && st == ST_O));
  r.inv_skip_owner = mosi && r.owner_leg;
  r.dram_write = proto == P_MSI && r.owner_leg;
  if (shared) {
    // The slice line: a miss (I) is the only DRAM read; MESI grants E to
    // a sole first reader that is no instruction fetch.
    const bool miss = st == ST_I;
    const bool grant_e = miss && proto == P_SH_MESI && !isf;
    r.dram_read = miss;
    r.new_state = isx ? ST_M
                      : (miss ? (grant_e ? ST_E : ST_S)
                              : (owned ? ST_O : st));
    r.new_owner = (isx || grant_e) ? t : -1;
  } else if (mosi) {
    // The owner keeps an O copy and forwards; no DRAM when an owner
    // (or the requester itself) holds the data.
    r.dram_read = !r.owner_leg && !(live && own == t);
    r.new_state = isx ? ST_M : (owned ? ST_O : ST_S);
    r.new_owner = isx ? t : (owned ? own : -1);
  } else {
    r.dram_read = !r.owner_leg;
    r.new_state = isx ? ST_M : ST_S;
    r.new_owner = isx ? t : -1;
  }
  return r;
}

__host__ __device__ __forceinline__ size_t align8(size_t x) {
  return (x + 7) & ~static_cast<size_t>(7);
}

__host__ __device__ __forceinline__ size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off = align8(off + bytes);
  return at;
}

// Hit-held way words per hash slot: ceil(A / 32) in the grid form, one
// in the one-block forms (A <= 32).
__host__ __device__ __forceinline__ int64_t way_words(int64_t A, int form) {
  return form == F_GRID ? (A + 31) / 32 : 1;
}

__host__ __device__ __forceinline__ Layout make_layout(int64_t T, int64_t A,
                                                      int64_t W, int64_t H,
                                                      int64_t KF, int form) {
  Layout L;
  size_t s = 0, g = 0;
  size_t& big = form == F_SHARED ? s : g;   // the H-sized tables, invt
  size_t& per = form == F_GRID ? g : s;     // the per-row arrays
  L.tblA = take(big, sizeof(long long) * H);
  L.tblB = take(big, sizeof(int32_t) * H * way_words(A, form));
  L.exa = take(big, H);
  L.drow = form == F_SHARED ? take(s, sizeof(int64_t) * T * A) : 0;
  L.packed = take(per, sizeof(long long) * T);
  L.line = take(per, sizeof(int64_t) * T);
  L.invt = take(big, sizeof(uint64_t) * T * W);
  L.issue0 = take(per, sizeof(long long));
  L.fidx = take(per, sizeof(int32_t) * T);
  L.home = take(per, sizeof(int32_t) * T);
  L.owner = take(per, sizeof(int32_t) * T);
  L.way = take(per, sizeof(int32_t) * T);
  L.xy = take(per, sizeof(uint32_t) * T);
  L.frrow = take(per, sizeof(int32_t) * KF);
  L.kcnt = take(per, sizeof(int32_t) * KF);
  L.kmaxc = take(per, sizeof(int32_t) * KF);
  L.fan = take(per, T);
  L.oact = per;
  per += T;
  L.rep = 0;
  if (form == F_GRID) {
    g = align8(g);
    L.rep = take(g, sizeof(int32_t) * H);
  }
  L.smem = s;
  L.ws = g;
  return L;
}

template <typename V>
__device__ __forceinline__ V* leaf(const StepArgs& a, int64_t off) {
  return reinterpret_cast<V*>(a.out + off);
}

template <int kForm>
__global__ void __launch_bounds__(kForm == F_WIDE     ? kMaxThreadsWide
                                  : kForm == F_SHARED ? kMaxThreadsShared
                                                      : kGridThreads)
chain_classify_kernel(StepArgs a) {
  // The tables in the workspace, the directory rows read in place (wide
  // and grid); every array in the workspace, many blocks (grid).
  constexpr bool kWide = kForm != F_SHARED;
  constexpr bool kGrid = kForm == F_GRID;
  extern __shared__ __align__(8) unsigned char smem[];
  const int T = static_cast<int>(a.T), A = static_cast<int>(a.A);
  const int W = static_cast<int>(a.W), KF = static_cast<int>(a.KF);
  const int64_t H = a.H, D = a.D;
  const int64_t NW = way_words(a.A, kForm);
  // Tile / element index over the whole launch (one block but in the
  // grid form).
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthr = gridDim.x * blockDim.x;
  // The barrier between phases: over the block, or over the cooperative
  // grid (which also orders the global accesses across blocks).
  auto sync = [] {
    if constexpr (kForm == F_GRID)
      cooperative_groups::this_grid().sync();
    else
      __syncthreads();
  };

  // ---- the arrays (make_layout, computed on the host; the wrapper sized
  // both regions)
  const Layout& L = a.lay;
  unsigned char* big = kWide ? a.ws : smem;
  unsigned char* per = kGrid ? a.ws : smem;
  long long* tblA = reinterpret_cast<long long*>(big + L.tblA);
  int32_t* tblB = reinterpret_cast<int32_t*>(big + L.tblB);
  int32_t* rep = kGrid ? reinterpret_cast<int32_t*>(a.ws + L.rep) : tblB;
  uint8_t* exa = big + L.exa;
  uint64_t* invt = reinterpret_cast<uint64_t*>(big + L.invt);
  int64_t* drow_s = reinterpret_cast<int64_t*>(smem + L.drow);  // shared form
  long long* packed_s = reinterpret_cast<long long*>(per + L.packed);
  int64_t* line_s = reinterpret_cast<int64_t*>(per + L.line);
  long long* issue0_s = reinterpret_cast<long long*>(per + L.issue0);
  int32_t* fidx_s = reinterpret_cast<int32_t*>(per + L.fidx);
  int32_t* home_s = reinterpret_cast<int32_t*>(per + L.home);
  int32_t* owner_s = reinterpret_cast<int32_t*>(per + L.owner);
  int32_t* way_s = reinterpret_cast<int32_t*>(per + L.way);
  uint32_t* xy_s = reinterpret_cast<uint32_t*>(per + L.xy);
  int32_t* frrow_s = reinterpret_cast<int32_t*>(per + L.frrow);
  int32_t* kcnt_s = reinterpret_cast<int32_t*>(per + L.kcnt);
  int32_t* kmaxc_s = reinterpret_cast<int32_t*>(per + L.kmaxc);
  uint8_t* fan_s = per + L.fan;      // needs the fan-out budget
  uint8_t* oact_s = per + L.oact;    // needs the owner-delivery budget

  // ---- phase 0: tables empty; each tile's chain head
  for (int64_t i = tid; i < H; i += nthr) {
    tblA[i] = kBig;
    exa[i] = 0;
    if constexpr (kGrid)
      rep[i] = -1;
    else
      tblB[i] = 0;
  }
  if constexpr (kGrid) {
    for (int64_t i = tid; i < H * NW; i += nthr) tblB[i] = 0;
  }
  for (int k = tid; k < KF; k += nthr) {
    frrow_s[k] = -1;
    kcnt_s[k] = 0;
    kmaxc_s[k] = 0;
  }
  if (tid == 0) issue0_s[0] = kBig;

  const int t = tid;
  const bool row = t < T;
  // This row's flags (R_*), one register across the block's barriers.
  uint32_t fl = 0;
  int32_t fi = 0, hx = 0;
  uint32_t fhash = 0;              // H < 2^32: slots fit 32 bits
  // This row's directory word of way w: staged in shared memory, or (the
  // wide form) read where it lies.
  auto dword = [&](int w) -> int64_t {
    return kWide ? a.dir_word[static_cast<int64_t>(w) * D + fi]
                 : drow_s[w * T + t];
  };
  // The periods and the local cost are read where they are used (phases
  // 6 and 7), and the line, issue, home, set, FCFS key and owner from
  // where this thread wrote them, not held across the barriers before:
  // the wide form's 1,024-thread block leaves each thread 64 registers.
  if (row) {
    const int32_t hd = a.head[t];
    const int64_t hs = hd < 0 ? 0 : (hd > a.P - 1 ? a.P - 1 : hd);
    const int64_t req = a.mq_req[hs * T + t];
    const int64_t delta = a.mq_delta[hs * T + t];
    const int64_t ext = a.mq_extra[hs * T + t];
    const bool act = a.stopped[t] == 0 && hd < a.stop_hi[t];
    const int64_t kind = req & 7;
    const int64_t ln = act ? (req >> 8) : 0;
    const bool isx = act && kind == PEND_EX_REQ;
    const bool isf = act && kind == PEND_IFETCH;
    fl = flag(act, R_ACT) | flag(isx, R_ISX) | flag(isf, R_ISF);
    const uint64_t ul = static_cast<uint64_t>(ln);
    const int32_t hm = static_cast<int32_t>(
        fast_mod(fold(ul, a.home_bits), a.div_home) * a.home_stride);
    const int32_t ds = static_cast<int32_t>(
        fast_mod(fold(fast_div(ul, a.div_home), a.dset_bits), a.div_dsets));
    fi = hm * static_cast<int32_t>(a.ndsets) + ds;
    const int64_t iss = a.base[t] + delta;
    hx = static_cast<int32_t>(fast_mod(fmix64(ul), a.div_h));
    fhash = static_cast<uint32_t>(
        fast_mod(fmix64(static_cast<uint64_t>(fi)), a.div_h));

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
    // The line's memory controller (with shared L2 it may be another
    // tile than the slice), parked in the from_dram_ps leaf until phase
    // 6 prices the slice->controller legs.
    leaf<int64_t>(a, a.off_from_dram_ps)[t] = static_cast<int64_t>(
        fast_mod(fold(ul, a.site_bits), a.div_site) * a.site_stride);

    fidx_s[t] = fi;
    line_s[t] = ln;
    home_s[t] = hm;
    const uint32_t mw = static_cast<uint32_t>(a.mesh_width);
    xy_s[t] = (static_cast<uint32_t>(t) % mw) |
              ((static_cast<uint32_t>(t) / mw) << 16);
  }
  sync();

  // ---- phase 1: stage the directory rows (whole block, way-major so
  // that both the stores and the per-row scans are conflict-free; not in
  // the wide form); the earliest active issue; exclusive requests per
  // combining slot
  if constexpr (!kWide) {
    for (int i = tid; i < T * A; i += nthr) {
      const int w = i / T;
      drow_s[i] = a.dir_word[static_cast<int64_t>(w) * D + fidx_s[i - w * T]];
    }
  }
  if (row) {
    if (on(fl, R_ACT))
      atomicMin(issue0_s,
                static_cast<long long>(leaf<int64_t>(a, a.off_issue)[t]));
    if (on(fl, R_ISX)) exa[hx] = 1;
  }
  // (the grid form stages no rows, and phase 2 reads nothing phase 1
  // writes: one barrier interval)
  if constexpr (!kGrid) __syncthreads();

  // ---- phase 2: the probe at (home, dset); hit-held ways per set
  int hway = 0;
  if (row) {
    bool any = false;
    const int32_t tag = static_cast<int32_t>(line_s[t]);
    for (int w = 0; w < A; ++w) {
      const int64_t word = dword(w);
      if (word_tag(word) == tag &&
          word_state(word) != ST_I) {
        if (!any) hway = w;
        any = true;
      }
    }
    fl |= flag(any && on(fl, R_ACT), R_HIT);
    if (on(fl, R_HIT))
      atomicOr(reinterpret_cast<unsigned int*>(
                   &tblB[static_cast<int64_t>(fhash) * NW + (hway >> 5)]),
               1u << (hway & 31));
  }
  sync();

  // ---- phase 3: victim way (invalid first, then stamp-LRU, hit-held
  // ways excluded), FCFS key, way-slot election; the protocol's
  // transition against the chosen way's sharer words (its entry and DRAM
  // leaves are written here and read back where they are needed)
  int way = 0;
  uint32_t aidx = 0;
  if (row) {
    const bool act = on(fl, R_ACT), isx = on(fl, R_ISX);
    const bool hit = on(fl, R_HIT);
    const int32_t* used = tblB + static_cast<int64_t>(fhash) * NW;
    unsigned uw = 0;   // the word of 32 hit-held ways that holds way w
    int best = 0;
    int32_t best_key = 0;
    for (int w = 0; w < A; ++w) {
      if ((w & 31) == 0) uw = static_cast<unsigned>(used[w >> 5]);
      const int64_t word = dword(w);
      const int32_t key = ((uw >> (w & 31)) & 1u)
                              ? kNever
                              : (word_state(word) == ST_I ? -1
                                                          : word_stamp(word));
      if (w == 0 || key < best_key) {
        best_key = key;
        best = w;
      }
    }
    fl |= flag(act && !hit && best_key != kNever, R_CANALLOC);
    way = hit ? hway : best;
    const int64_t am = static_cast<int64_t>(fi) * A + way;
    aidx = static_cast<uint32_t>(
        fast_mod(fmix64(static_cast<uint64_t>(am)), a.div_h));
    int64_t d = leaf<int64_t>(a, a.off_issue)[t] -
                static_cast<int64_t>(issue0_s[0]);
    d = d < 0 ? 0 : (d > kKeyClip ? kKeyClip : d);
    const long long packed = static_cast<long long>(d * T + t);
    if (act) atomicMin(&tblA[aidx], packed);
    packed_s[t] = packed;

    const int64_t wword = dword(way);
    const int way_state = word_state(wword);
    const int entry_state = hit ? way_state : ST_I;
    const int entry_owner = hit ? word_owner(wword) : -1;
    const Trans tr = transition(a.proto, isx, on(fl, R_ISF), t,
                                entry_state, entry_owner);
    const int32_t own_tile = entry_owner < 0 ? 0 : entry_owner;
    owner_s[t] = own_tile;
    // Combining takes I / S entries, with shared L2 S entries only (the
    // slice fills an uncached line once).
    fl |= flag(tr.owner_leg, R_OWNACT) | flag(way_state != ST_I, R_WAYLIVE) |
          flag(entry_state == ST_S ||
                   (entry_state == ST_I && a.proto != P_SH_MSI &&
                    a.proto != P_SH_MESI),
               R_SHOK);
    leaf<int32_t>(a, a.off_down_to)[t] = tr.down_to;
    leaf<int32_t>(a, a.off_new_state)[t] = tr.new_state;
    leaf<int32_t>(a, a.off_new_owner)[t] = tr.new_owner;
    leaf<uint8_t>(a, a.off_dram_read)[t] = tr.dram_read;
    leaf<uint8_t>(a, a.off_dram_write)[t] = tr.dram_write;
    const int req_w = t >> 6;
    const uint64_t req_b = 1ULL << (t & 63);
    bool all_zero = true, has_inv = false;
    const int64_t* sh = a.dir_sharers + static_cast<int64_t>(way) * D + fi;
    int64_t* delta = leaf<int64_t>(a, a.off_delta_sh) + t * W;
    for (int k = 0; k < W; ++k) {
      const uint64_t er = static_cast<uint64_t>(
          sh[static_cast<int64_t>(k) * A * D]);
      all_zero = all_zero && er == 0;
      const uint64_t es = hit ? er : 0;
      const uint64_t rb = k == req_w ? req_b : 0;
      const uint64_t ob =
          (own_tile >> 6) == k ? (1ULL << (own_tile & 63)) : 0;
      const uint64_t nsh = isx ? rb : ((tr.own_keep ? ob : es) | rb);
      const uint64_t iv =
          tr.inv_on ? (es & ~rb & ~(tr.inv_skip_owner ? ob : 0)) : 0;
      invt[t * W + k] = iv;
      has_inv = has_inv || iv != 0;
      delta[k] = static_cast<int64_t>(nsh - er);  // wraps like uint64
    }
    fl |= flag(has_inv, R_HASINV) |
          flag(way_state == ST_I ||
                   ((way_state == ST_S || way_state == ST_O) && all_zero),
               R_VICDEAD);
  }
  sync();

  // ---- phase 4: the election's result; which rows need the fan-out
  // budget
  if (row) {
    const bool wslot = on(fl, R_ACT) && tblA[aidx] == packed_s[t];
    const bool cand0 = wslot && (on(fl, R_HIT) || (on(fl, R_CANALLOC) &&
                                                   on(fl, R_VICDEAD)));
    const bool need_fan = a.fanout && cand0 && on(fl, R_HASINV);
    fl |= flag(cand0, R_CAND0) | flag(need_fan, R_NEEDFAN);
    fan_s[t] = need_fan;
  }
  // tblB becomes the combining representative table (the grid form's
  // has its own, cleared in phase 0)
  if constexpr (!kGrid) {
    for (int64_t i = tid; i < H; i += nthr) tblB[i] = -1;
  }
  sync();

  // ---- phase 5: fan-out rank (FCFS, over the staged rows), candidacy,
  // which rows need the owner-delivery budget
  int fan_rank = 0, posr = 0;
  if (row) {
    const long long pk = packed_s[t];   // this row's FCFS key, phase 3
    const bool need_fan = on(fl, R_NEEDFAN), has_inv = on(fl, R_HASINV);
    if (need_fan) {
      for (int j = 0; j < T; ++j)
        if (fan_s[j] && packed_s[j] < pk) ++fan_rank;
    }
    const bool cand = on(fl, R_CAND0) &&
                      (a.fanout ? (!has_inv || (need_fan && fan_rank < KF))
                                : !has_inv);
    fl |= flag(cand, R_CAND);
    oact_s[t] = cand && on(fl, R_OWNACT);
  }
  sync();

  // ---- phase 5b: per-owner rank (FCFS, over the staged rows), serve,
  // combining representatives
  if (row) {
    const long long pk = packed_s[t];
    const int32_t own_tile = owner_s[t];
    const bool own_act = on(fl, R_OWNACT);
    if (on(fl, R_CAND) && own_act) {
      for (int j = 0; j < T; ++j) {
        if (oact_s[j] && owner_s[j] == own_tile &&
            (packed_s[j] < pk || (packed_s[j] == pk && j < t)))
          ++posr;
      }
    }
    const bool serve = on(fl, R_CAND) && !(own_act && posr >= kJOwn);
    const bool fan_go = serve && on(fl, R_HASINV);
    fl |= flag(serve, R_SERVE) | flag(own_act && serve, R_OWNERLEG) |
          flag(fan_go, R_FANGO);
    if (serve && !on(fl, R_ISX) && on(fl, R_SHOK))
      atomicMax(&rep[hx], t);
    if (fan_go) frrow_s[fan_rank] = t;
    way_s[t] = way;
  }
  // tblA becomes the floor-table maximum
  for (int64_t i = tid; i < H; i += nthr) tblA[i] = -1;
  sync();

  // ---- phase 6: combining members, hard stops, timing legs, the
  // outputs; the fan-out invalidation masks
  // The timing legs go to their output leaves here and phase 7 reads
  // them back from there, so none is held across the barrier between.
  if (row) {
    const bool serve = on(fl, R_SERVE), hit = on(fl, R_HIT);
    const int r = rep[hx];
    const int64_t rep_line = r >= 0 ? line_s[r] : -1;
    const int rep_way = r >= 0 ? way_s[r] : 0;
    const bool member = on(fl, R_ACT) && !serve && !on(fl, R_ISX) &&
                        on(fl, R_SHOK) && !exa[hx] && rep_line == line_s[t];
    const int wayf = member ? rep_way : way;
    const bool serve_all = serve || member;
    fl |= flag(serve_all, R_SERVEALL);
    const bool stop_inv = !a.fanout && on(fl, R_HASINV);
    const bool can_alloc = on(fl, R_CANALLOC);
    leaf<int32_t>(a, a.off_way)[t] = wayf;
    leaf<uint8_t>(a, a.off_hit)[t] = hit;
    leaf<uint8_t>(a, a.off_serve)[t] = serve;
    leaf<uint8_t>(a, a.off_serve_all)[t] = serve_all;
    leaf<uint8_t>(a, a.off_member)[t] = member;
    leaf<uint8_t>(a, a.off_hard_stop)[t] =
        on(fl, R_ACT) && !serve_all &&
        (stop_inv || (can_alloc && !on(fl, R_VICDEAD)) ||
         (!hit && !can_alloc) || (on(fl, R_OWNACT) && posr >= kJOwn));
    leaf<uint8_t>(a, a.off_fan_go)[t] = on(fl, R_FANGO);
    leaf<uint8_t>(a, a.off_owner_leg)[t] = on(fl, R_OWNERLEG);
    leaf<uint8_t>(a, a.off_evicting)[t] =
        serve && !hit && on(fl, R_WAYLIVE);
    const int32_t own_tile = owner_s[t];
    leaf<int32_t>(a, a.off_owner)[t] = own_tile;
    leaf<int32_t>(a, a.off_ow_slot)[t] = posr < kJOwn - 1 ? posr : kJOwn - 1;

    const bool shared = a.proto == P_SH_MSI || a.proto == P_SH_MESI;
    const int32_t hm = home_s[t];
    const int32_t pnh = a.p_net[hm];
    const int64_t net_req = unicast(a, xy_s, t, hm, a.ser_req, a.p_net[t]);
    leaf<int64_t>(a, a.off_reply_ps)[t] =
        unicast(a, xy_s, hm, t, a.ser_data, pnh);
    const int64_t tdir = leaf<int64_t>(a, a.off_issue)[t] + net_req +
                         a.dir_cycles * a.p_dir[hm];
    int64_t ops = 0;
    if (on(fl, R_OWNERLEG)) {
      // The owner looks the line up in its private L2, or with shared L2
      // in its L1D.
      ops = unicast(a, xy_s, hm, own_tile, a.ser_req, pnh) +
            (shared ? a.l1d_cycles * a.p_l1d[own_tile]
                    : a.l2_cycles * a.p_l2[own_tile]) +
            unicast(a, xy_s, own_tile, hm, a.ser_data, a.p_net[own_tile]);
    }
    const bool need_read =
        serve_all && leaf<uint8_t>(a, a.off_dram_read)[t] != 0;
    fl |= flag(need_read, R_NEEDREAD);
    leaf<int64_t>(a, a.off_t_dir)[t] = tdir;
    leaf<int64_t>(a, a.off_owner_ps)[t] = ops;
    // With shared L2 the line's memory controller (phase 0) may be
    // another tile than its slice: the slice->controller request and
    // data legs.
    {
      const int ds_t =
          static_cast<int>(leaf<int64_t>(a, a.off_from_dram_ps)[t]);
      int64_t to_dram = 0, from_dram = 0;
      if (shared && ds_t != hm) {
        to_dram = unicast(a, xy_s, hm, ds_t, a.ser_req, pnh);
        from_dram = unicast(a, xy_s, ds_t, hm, a.ser_data, a.p_net[ds_t]);
      }
      leaf<int64_t>(a, a.off_from_dram_ps)[t] = from_dram;
      leaf<int64_t>(a, a.off_dram_arrival)[t] = tdir + ops + to_dram;
    }
    // A member's way is its representative's (same line, same row), so
    // its own sharer word is that of the way phase 3 chose.
    const bool madd =
        member &&
        (!hit || ((static_cast<uint64_t>(
                       a.dir_sharers[(static_cast<int64_t>(t >> 6) * A + way) *
                                         D + fi]) >> (t & 63)) & 1ULL) == 0);

    leaf<uint8_t>(a, a.off_member_add)[t] = madd;
    leaf<uint8_t>(a, a.off_need_read)[t] = need_read;
    leaf<uint8_t>(a, a.off_dram_wb)[t] =
        serve_all && leaf<uint8_t>(a, a.off_dram_write)[t] != 0;
    leaf<int64_t>(a, a.off_l1_fill_ps)[t] =
        on(fl, R_ISF) ? a.l1i_cycles * a.p_l1i[t] : a.l1d_cycles * a.p_l1d[t];
  }
  if (a.fanout) {
    uint8_t* inv_bool = leaf<uint8_t>(a, a.off_inv_bool);
    for (int i = tid; i < KF * T; i += nthr) {
      const int k = i / T, j = i - k * T;
      const int r = frrow_s[k];
      const bool bit =
          r >= 0 && ((invt[r * W + (j >> 6)] >> (j & 63)) & 1ULL) != 0;
      inv_bool[i] = bit;
      if (bit) {
        atomicAdd(&kcnt_s[k], 1);
        atomicMax(&kmaxc_s[k], net_cycles(a, xy_s, home_s[r], j));
      }
    }
    for (int k = tid; k < KF; k += nthr) {
      const int r = frrow_s[k];
      leaf<int64_t>(a, a.off_line_fr)[k] = r >= 0 ? line_s[r] : 0;
    }
    sync();
  }

  // ---- phase 7: the fan-out legs (a served fan-out row is its own
  // slot's row); with the queue model off the completion and the floor
  // key
  int64_t tdata = 0, tkey = 0;
  if (row) {
    int64_t ips = 0, icnt = 0;
    if (a.fanout && on(fl, R_FANGO)) {
      icnt = kcnt_s[fan_rank];
      const int64_t mh_ps =
          (a.net_kind != NET_MAGIC && icnt > 0)
              ? (kmaxc_s[fan_rank] + a.ser_req) * a.p_net[home_s[t]]
              : 0;
      ips = 2 * mh_ps + a.inv_ack_cycles * a.p_core[t];
    }
    leaf<int64_t>(a, a.off_inv_ps)[t] = ips;
    leaf<int64_t>(a, a.off_inv_count)[t] = icnt;
    if (!a.queue_on) {
      const int64_t tdir = leaf<int64_t>(a, a.off_t_dir)[t];
      const int64_t ops = leaf<int64_t>(a, a.off_owner_ps)[t];
      const bool need_read = on(fl, R_NEEDREAD);
      const int64_t dstart =
          need_read ? leaf<int64_t>(a, a.off_dram_arrival)[t] : 0;
      const int64_t dready = dstart + a.dram_latency_ps +
                             a.dram_processing_ps +
                             leaf<int64_t>(a, a.off_from_dram_ps)[t];
      tdata = tdir + ops;
      if (need_read && dready > tdata) tdata = dready;
      if (!need_read && tdata < 0) tdata = 0;
      if (a.fanout && tdir + ips > tdata) tdata = tdir + ips;
      leaf<int64_t>(a, a.off_t_data)[t] = tdata;
      // (no fill through a private L2 with shared L2)
      const bool shared = a.proto == P_SH_MSI || a.proto == P_SH_MESI;
      leaf<int64_t>(a, a.off_completion)[t] =
          tdata + leaf<int64_t>(a, a.off_reply_ps)[t] +
          (shared ? 0 : a.l2_cycles * a.p_l2[t]) +
          leaf<int64_t>(a, a.off_l1_fill_ps)[t] +
          leaf<int64_t>(a, a.off_extra)[t];  // all this thread's
      tkey = tdata * T + t;
      if (on(fl, R_SERVEALL))
        atomicMax(&tblA[hx], static_cast<long long>(tkey));
    }
  }

  // ---- phase 8: the floor write by each slot's single winner, in place
  if (!a.queue_on) {
    sync();
    if (row && on(fl, R_SERVEALL) && tblA[hx] == tkey) {
      a.ftbl[hx] = line_s[t];
      a.ftbl[H + hx] = tdata;
    }
  }
}

template <int kForm>
cudaError_t launch(const StepArgs& a, size_t smem, cudaStream_t stream) {
  if constexpr (kForm == F_GRID) {
    // One cooperative launch: every block resident at once, so the grid
    // barriers are valid (a grid the card cannot hold is refused with
    // cudaErrorCooperativeLaunchTooLarge; the wrapper refuses it first).
    const unsigned blocks =
        static_cast<unsigned>((a.T + kGridThreads - 1) / kGridThreads);
    void* params[] = {const_cast<StepArgs*>(&a)};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&chain_classify_kernel<F_GRID>),
        dim3(blocks), dim3(kGridThreads), params, 0, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  } else {
    static size_t opted = 48 * 1024;  // one opt-in per form
    if (smem > opted) {
      // Above 48 KB a block's dynamic shared memory needs an opt-in.
      const cudaError_t err = cudaFuncSetAttribute(
          chain_classify_kernel<kForm>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      opted = smem;
    }
    const int64_t warps = (a.T + 31) / 32 * 32;
    const unsigned threads =
        static_cast<unsigned>(warps > kMinThreads ? warps : kMinThreads);
    chain_classify_kernel<kForm><<<1, threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

}  // namespace

// Shared-memory bytes of one launch of `form`; `ws` (if not null)
// receives its workspace bytes (0 for the shared form).
extern "C" size_t chain_classify_bytes(int64_t T, int64_t A, int64_t W,
                                       int64_t H, int64_t KF, int64_t form,
                                       int64_t* ws) {
  const Layout L = make_layout(T, A, W, H, KF, static_cast<int>(form));
  if (ws != nullptr) *ws = static_cast<int64_t>(L.ws);
  return L.smem;
}

// The most blocks of the grid form that the card `device` holds at once
// (blocks per SM at kGridThreads threads, times the SMs; 0 where the card
// takes no cooperative launch), and its block size.
extern "C" int chain_classify_grid_capacity(int device, int64_t* blocks,
                                            int64_t* threads) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chain_classify_kernel<F_GRID>, kGridThreads, 0);
  *blocks = coop ? static_cast<int64_t>(per_sm) * sms : 0;
  *threads = kGridThreads;
  return static_cast<int>(err);
}

extern "C" int chain_classify_launch(const StepArgs* args, void* stream) {
  // The wrapper (chain.py _Step) holds T, W and A to the limits of the
  // form it chose, the shared memory to the card's and the grid to what
  // the card holds at once.
  if (args->T <= 0) return 0;
  const int form = static_cast<int>(args->form);
  const bool one_block = form == F_SHARED || form == F_WIDE;
  if ((!one_block && form != F_GRID) ||
      (one_block &&
       (args->T > (form == F_WIDE ? kMaxThreadsWide : kMaxThreadsShared) ||
        args->W > kMaxWords || args->A > kMaxWays)) ||
      (form != F_SHARED && args->ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a = *args;
  a.lay = make_layout(a.T, a.A, a.W, a.H, a.KF, form);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case F_SHARED:
      return static_cast<int>(launch<F_SHARED>(a, a.lay.smem, st));
    case F_WIDE:
      return static_cast<int>(launch<F_WIDE>(a, a.lay.smem, st));
    default:
      return static_cast<int>(launch<F_GRID>(a, 0, st));
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
