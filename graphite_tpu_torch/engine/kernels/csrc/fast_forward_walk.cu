// fast_forward_walk.cu — the analytic fast-forward walk as a hand-written
// CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel graphite_tpu/engine/kernels/window.py:779
// `fast_forward_walk`, which the JAX package runs through
// graphite_tpu/engine/kernels/dispatch.py:176 (`pl.pallas_call` gridded
// over tile blocks).  The plain PyTorch form of the same function is
// graphite_tpu_torch/engine/kernels/window.py `fast_forward_walk`; both
// must agree on every output element.
//
// What it computes.  For each candidate tile, the longest prefix of its
// F-event span whose events are all eligible — COMPUTE with an L1I hit,
// BRANCH, MEM_READ with an L1D hit, MEM_WRITE with a writable L1D hit
// (M, or E under sh_l2_mesi) — and whose pre-clock stays under the
// fast-forward bound
// (boundary + the spanning quantum + tpu/fast_forward_span).  The tile
// engages when that prefix is longer than one window round (n > K) and
// some committed event starts at or past the window's own bound; an
// engaged tile commits the prefix (clock, n_ret, LRU touches, predictor
// writes, counters), a declined one returns its clock, n_ret = 0, zero
// counters and untouched rows.
//
// Scope: simple cores under every coherence protocol; the wrapper refuses
// iocoom cores.  bp_size = 0 means no predictor: every branch is
// predicted correctly.  Under sh_l2_mesi (`mesi`) a committed write to
// an E line upgrades it to M, sticky for the rest of the span: each
// committed touch of a line that some committed write at or before it
// wrote carries M (the earliest such write is a per-line position each
// thread finds from the span's staged lines and write flags; commits are
// a prefix, so every event before a committed one is committed).
//
// Design: one block per tile, one thread per span event (F <= 64 events,
// one or two warps), no serial recurrence — the span's clock is a plain
// prefix sum of per-event times.
//
//   A. Every thread loads its event (coalesced across the block), probes
//      the span-start L1I (COMPUTE) or L1D (MEM) row of its line with
//      all ways loaded together (the probe's state is the sum of the
//      matching ways' states, as in the plain form), decides eligibility
//      and, for a branch, its predictor slot, outcome and table entry.
//      Pure hits install no lines, so span-start probes are the probes
//      each window round would make.  A barrier follows: every probe and
//      every predictor read happens before any write.
//   B. A branch predicts from the last earlier branch of the span on its
//      slot, else from the table (shared memory).  Only committed
//      events' predictions are observed, and every event before a
//      committed one is committed, so "the last earlier branch" is the
//      plain form's "last earlier in-lead branch".  Each event prices
//      its time dt.
//   C. The exclusive prefix of dt (64-bit warp shuffles and one
//      cross-warp step) gives each event's pre-clock; lead = the events
//      before the first ineligible one (ballot); the committed events
//      are the lead's events whose pre-clock is under the fast-forward
//      bound, a prefix because dt >= 0; crossed = some committed
//      pre-clock at or past the window bound (ballot); engage = n > K
//      and crossed.  (The prefix runs over every event: for an event of
//      the lead every earlier event is in the lead, so its pre-clock is
//      the plain form's.)
//   D. An engaged tile's committed events apply their effects: touches
//      as a 64-bit atomicMax of with_stamp(word, stamp_base + j), the
//      predictor entry written by the last committed branch on its slot
//      (decided by event index), the counters by warp reductions; the
//      last committed event writes clock and n_ret.
//
// In place.  The predictor table and the L1I / L1D word arrays are the
// state's own arrays (the wrapper refuses operands that share storage).
// Exact because every read of span-start state happens in phase A,
// before the barrier that precedes any write; tile t's rows are written
// only by block t; touches of one word differ only in the stamp field,
// so the atomicMax is the plain form's scatter-max in any thread order;
// a predictor slot has one writer.  A declined or inactive tile touches
// no state array.
//
// Cost.  Latency-bound: a launch, two dependent global loads (the event,
// then its set row), three barriers and a few dozen integer operations
// per event.  The bytes it must move are one set row per probed event
// and its outputs (about 23 KB on a captured radix64 round at T = 64).
// No per-thread array is indexed at runtime, so nothing lives in local
// memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpan = 64;
constexpr int kWarps = kMaxSpan / 32;
constexpr int kCtrs = 12;
constexpr unsigned kFull = 0xffffffffu;

// Event opcodes (graphite_tpu_torch/isa.py EventOp).
constexpr int OP_NOP = 0, OP_COMPUTE = 1, OP_MEM_READ = 2, OP_MEM_WRITE = 3,
              OP_BRANCH = 4;
// Coherence states (engine/cache.py).
constexpr int ST_I = 0, ST_E = 3, ST_M = 4;
constexpr int64_t kStateMask = 7;
constexpr int64_t kStampField = (1LL << 29) - 1;
constexpr int64_t kStampMask = kStampField << 3;
// Per-event branch flags, in shared memory for the later events.
constexpr uint8_t B_BR = 1, B_TAKEN = 2, B_WR = 4;

}  // namespace

struct FFArgs {
  // inputs
  const int32_t* meta;            // [3, T, F] (op, arg, arg2)
  const int64_t* addr;            // [T, F]
  const uint8_t* valid_ev;        // [T, F]
  const uint8_t* tile_active;     // [T]
  const int64_t* clock;           // [T]
  const int32_t* period_ps;       // [T, NM]
  const int64_t* boundary;        // []
  const uint8_t* models_enabled;  // []
  const int32_t* stamp_base;      // []
  // state, updated in place
  uint8_t* bp;                    // [T, bp_size]
  int64_t* l1i;                   // [Ai, T, Si]
  int64_t* l1d;                   // [Ad, T, Sd]
  // fresh outputs
  int64_t* clock_out;             // [T]
  int32_t* n_ret;                 // [T]
  int64_t* ctr_inc;               // [12, T]
  // geometry and timing
  int64_t T, F, NM;
  int64_t K;                      // block_events: the engage threshold
  int64_t l1i_assoc, l1i_sets, l1d_assoc, l1d_sets;
  int64_t bp_size;                // 0: no predictor (every branch correct)
  int64_t line_bits;
  int64_t l1i_cycles, l1d_cycles, bp_penalty;
  int64_t col_core, col_l1i, col_l1d;
  int64_t wbound_add;             // window bound = boundary + wbound_add
  int64_t span_add;               // ff bound = window bound + span_add
  int64_t mesi;                   // E lines writable, sticky upgrades
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
__device__ __forceinline__ int32_t word_tag(int64_t w) {
  return static_cast<int32_t>(w >> 32);
}
__device__ __forceinline__ int64_t with_stamp(int64_t w, int64_t stamp) {
  return (w & ~kStampMask) | ((stamp & kStampField) << 3);
}

__global__ void __launch_bounds__(kMaxSpan)
fast_forward_walk_kernel(FFArgs a) {
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const int nwarps = static_cast<int>(blockDim.x >> 5);
  const int64_t T = a.T;
  const int F = static_cast<int>(a.F);
  const bool live = j < F;

  __shared__ int32_t s_slot[kMaxSpan];
  __shared__ uint8_t s_br[kMaxSpan];
  __shared__ int64_t s_line[kMaxSpan];
  __shared__ uint32_t s_inel[kWarps], s_commit[kWarps], s_cross[kWarps];
  __shared__ long long s_wsum[kWarps];
  __shared__ uint32_t s_ctr[kWarps][kCtrs];

  const int64_t clk0 = a.clock[t];

  // ---- a tile that is no candidate, or models disabled: nothing moves
  if (a.tile_active[t] == 0 || a.models_enabled[0] == 0) {
    if (j == 0) {
      a.clock_out[t] = clk0;
      a.n_ret[t] = 0;
    }
    if (j < kCtrs) a.ctr_inc[j * T + t] = 0;
    return;
  }

  const int32_t* per = a.period_ps + t * a.NM;
  const int64_t p_core = per[a.col_core];
  const int64_t l1i_ps = a.l1i_cycles * per[a.col_l1i];
  const int64_t l1d_ps = a.l1d_cycles * per[a.col_l1d];
  const int64_t wbound = a.boundary[0] + a.wbound_add;
  const int64_t bound = wbound + a.span_add;

  // ---- phase A: the event, its probe against span-start state, its
  // eligibility; a branch's slot, outcome and table prediction
  const int64_t e = t * F + j;
  const bool valid = live && a.valid_ev[e] != 0;
  const int32_t op = valid ? a.meta[e] : OP_NOP;
  const int32_t arg = live ? a.meta[T * F + e] : 0;
  const int32_t arg2 = live ? a.meta[2 * T * F + e] : 0;
  const int64_t addr = live ? a.addr[e] : 0;
  const bool is_comp = op == OP_COMPUTE, is_br = op == OP_BRANCH;
  const bool is_rd = op == OP_MEM_READ, is_wr = op == OP_MEM_WRITE;
  const bool is_mem = is_rd || is_wr;

  // The probed row: L1I for a COMPUTE, L1D for a MEM access.
  bool hit = false;
  int pstate = ST_I;
  int64_t* arr = nullptr;
  int64_t widx = 0, word = 0;
  const int64_t line = addr >> a.line_bits;
  if (is_comp || is_mem) {
    const int64_t S = is_comp ? a.l1i_sets : a.l1d_sets;
    const int A = static_cast<int>(is_comp ? a.l1i_assoc : a.l1d_assoc);
    arr = is_comp ? a.l1i : a.l1d;
    const int64_t base = t * S + fmod_pos(line, S);
    const int64_t stride = T * S;
    const int32_t tag = static_cast<int32_t>(line);
#pragma unroll 4
    for (int w = 0; w < A; ++w) {
      const int64_t wv = arr[base + w * stride];
      const int32_t st = word_state(wv);
      if (word_tag(wv) == tag && st != ST_I) {
        if (!hit) {
          widx = base + w * stride;
          word = wv;
        }
        hit = true;
        pstate += st;
      }
    }
  }
  const bool elig =
      (is_comp && hit) || is_br ||
      (is_mem && hit && (is_rd || pstate >= (a.mesi ? ST_E : ST_M)));
  const bool taken = arg != 0;
  int32_t slot = 0;
  bool pred = false;
  const bool bp_on = a.bp_size > 0;
  if (is_br && bp_on) {
    slot = static_cast<int32_t>(fmod_pos(addr, a.bp_size));
    pred = a.bp[t * a.bp_size + slot] != 0;
  }
  if (live) {
    s_slot[j] = slot;
    s_br[j] = (is_br ? B_BR : 0) | (taken ? B_TAKEN : 0) |
              (is_wr ? B_WR : 0);
    s_line[j] = line;
  }
  __syncthreads();

  // ---- phase B: the prediction (the last earlier branch on the slot,
  // else the table) and the event's time
  if (is_br && bp_on) {
    for (int i = 0; i < j; ++i)
      if ((s_br[i] & B_BR) && s_slot[i] == slot) pred = (s_br[i] & B_TAKEN);
  }
  const bool correct = bp_on ? pred == taken : true;
  const int64_t icount_ev =
      static_cast<int64_t>(max(arg2 & ((1 << 20) - 1), 0));
  int64_t dt = 0;
  if (is_comp) dt = static_cast<int64_t>(max(arg, 0)) * p_core +
                    icount_ev * l1i_ps;
  if (is_br) dt = (correct ? p_core : a.bp_penalty * p_core) + l1i_ps;
  if (is_mem) dt = l1d_ps;

  // ---- phase C: the lead, the pre-clocks, the committed prefix
  const uint32_t inel = __ballot_sync(kFull, !(live && elig));
  long long incl = dt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 0) s_inel[warp] = inel;
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  int lead_end = nwarps * 32;     // the first ineligible event
  for (int w = nwarps - 1; w >= 0; --w)
    if (s_inel[w]) lead_end = w * 32 + __ffs(s_inel[w]) - 1;
  for (int w = 0; w < warp; ++w) incl += s_wsum[w];
  const int64_t pre = clk0 + incl - dt;
  const bool commit = j < lead_end && pre < bound;
  const uint32_t bc = __ballot_sync(kFull, commit);
  const uint32_t bx = __ballot_sync(kFull, commit && pre >= wbound);
  if (lane == 0) {
    s_commit[warp] = bc;
    s_cross[warp] = bx;
  }
  __syncthreads();
  int n = 0;
  bool crossed = false;
  for (int w = 0; w < nwarps; ++w) {
    n += __popc(s_commit[w]);
    crossed = crossed || s_cross[w] != 0;
  }
  const bool engage = n > a.K && crossed;

  // ---- phase D: an engaged tile's committed prefix
  if (!engage) {
    if (j == 0) {
      a.clock_out[t] = clk0;
      a.n_ret[t] = 0;
    }
    if (j < kCtrs) a.ctr_inc[j * T + t] = 0;
    return;
  }
  uint32_t c[kCtrs];
#pragma unroll
  for (int k = 0; k < kCtrs; ++k) c[k] = 0;
  if (commit) {
    if (is_mem && a.mesi) {
      // the touch word carries the probe's state, or M after a committed
      // write of the line at or before this event
      bool upgraded = false;
      for (int i = 0; i <= j; ++i)
        if ((s_br[i] & B_WR) && s_line[i] == line) upgraded = true;
      word = (word & ~kStateMask) |
             ((upgraded && pstate == ST_E) ? ST_M : pstate);
    }
    if (is_comp || is_mem)
      atomicMax(reinterpret_cast<long long*>(arr + widx),
                static_cast<long long>(
                    with_stamp(word, static_cast<int64_t>(a.stamp_base[0]) +
                                         j)));
    if (is_br && bp_on) {
      // the last committed branch on a slot writes it
      bool later = false;
      for (int i = j + 1; i < n; ++i)
        if ((s_br[i] & B_BR) && s_slot[i] == slot) later = true;
      if (!later) a.bp[t * a.bp_size + slot] = taken;
    }
    // counters (WINDOW_CTRS order; miss, L2 and spawn rows stay 0); a
    // span's sums fit in 32 bits (icount_ev < 2^20, F <= 64)
    const uint32_t ic = is_comp ? static_cast<uint32_t>(icount_ev) : 0;
    c[0] = ic + (((is_mem && (arg2 & 0xFF) == 0) || is_br) ? 1 : 0);
    c[1] = ic + (is_br ? 1 : 0);
    c[3] = is_rd;
    c[5] = is_wr;
    c[9] = is_br;
    c[10] = is_br && !correct;
  }
  if (j == n - 1) {
    a.clock_out[t] = clk0 + incl;
    a.n_ret[t] = n;
  }
#pragma unroll
  for (int k = 0; k < kCtrs; ++k) {
    const uint32_t v = __reduce_add_sync(kFull, c[k]);
    if (lane == 0) s_ctr[warp][k] = v;
  }
  __syncthreads();
  if (j < kCtrs) {
    uint64_t v = 0;
    for (int w = 0; w < nwarps; ++w) v += s_ctr[w][j];
    a.ctr_inc[j * T + t] = static_cast<int64_t>(v);
  }
}

}  // namespace

extern "C" int fast_forward_walk_launch(const FFArgs* args, void* stream) {
  if (args->F < 1 || args->F > kMaxSpan)
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->T == 0) return 0;
  const unsigned threads = static_cast<unsigned>((args->F + 31) / 32 * 32);
  fast_forward_walk_kernel<<<static_cast<unsigned>(args->T), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
