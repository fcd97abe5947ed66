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
// BRANCH, MEM_READ with an L1D hit, MEM_WRITE with a writable (M) L1D
// hit — and whose pre-clock stays under the fast-forward bound
// (boundary + the spanning quantum + tpu/fast_forward_span).  The tile
// engages when that prefix is longer than one window round (n > K) and
// some committed event starts at or past the window's own bound; an
// engaged tile commits the prefix (clock, n_ret, LRU touches, predictor
// writes, counters), a declined one returns its clock, n_ret = 0, zero
// counters and untouched rows.
//
// Scope: simple cores under MSI; the wrapper refuses sh_l2_mesi (whose
// sticky E->M upgrade this kernel does not model) and iocoom cores.
// bp_size = 0 means no predictor: every branch is predicted correctly.
//
// Design.  The JAX walk is vectorised over the span with [T, F, F]
// masks (earlier-write forwarding, last-writer winners).  Here each
// thread owns one tile and walks its span in order, in two passes:
//
//   1. Classify and price.  Each event probes L1I (COMPUTE) or L1D (MEM)
//      in the span-start INPUT arrays — pure hits install no lines, so
//      span-start probes are the probes each window round would make —
//      and stops at the first ineligible event or the first event whose
//      pre-clock reaches the bound.  dt >= 0, so the committed events
//      are a prefix and the clock is a running sum.  A branch predicts
//      from the last earlier branch of the span to its slot, else from
//      the table: every earlier event of the walk is in the lead, which
//      is the JAX rule.  The pass keeps, per committed event, the word
//      it will touch and its branch slot, and tallies the counters.
//   2. Commit, only if the tile engages.  Touches write
//      max(out, with_stamp(in, stamp_base + j)) into the OUTPUT arrays
//      (clones of the inputs), which is the JAX scatter-max: repeated
//      touches of one (set, way) leave the largest word, and no touch
//      lowers a word.  Predictor writes go in event order, so the last
//      committed write per slot wins.
//
// Cost.  Launch latency and the bytes of the rows it probes bound it: a
// few dozen integer operations per event, one set row (A words) per
// memory or compute event.  One thread per tile, 32 tiles per block, is
// 64 threads on a 132-SM card at T = 64 — the same underfill as
// window_walk, left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpan = 64;
constexpr int kTilesPerBlock = 32;

// Event opcodes (graphite_tpu_torch/isa.py EventOp).
constexpr int OP_COMPUTE = 1, OP_MEM_READ = 2, OP_MEM_WRITE = 3,
              OP_BRANCH = 4;
// Coherence states (engine/cache.py).
constexpr int ST_I = 0, ST_M = 4;
constexpr int64_t kStampField = (1LL << 29) - 1;
constexpr int64_t kStampMask = kStampField << 3;
// Which L1 array a committed event touches.
constexpr uint8_t TOUCH_NONE = 0, TOUCH_I = 1, TOUCH_D = 2;

}  // namespace

struct FFArgs {
  // inputs
  const int32_t* meta;            // [3, T, F] (op, arg, arg2)
  const int64_t* addr;            // [T, F]
  const uint8_t* valid_ev;        // [T, F]
  const uint8_t* tile_active;     // [T]
  const int64_t* clock;           // [T]
  const int32_t* period_ps;       // [T, NM]
  const uint8_t* bp_in;           // [T, bp_size]
  const int64_t* l1i_in;          // [Ai, T, Si]
  const int64_t* l1d_in;          // [Ad, T, Sd]
  const int64_t* boundary;        // []
  const uint8_t* models_enabled;  // []
  const int32_t* stamp_base;      // []
  // outputs (bp_out and the cache outputs hold clones of the inputs)
  int64_t* clock_out;             // [T]
  int32_t* n_ret;                 // [T]
  uint8_t* bp_out;
  int64_t* l1i_out;
  int64_t* l1d_out;
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

// Probe `line` in one tile's set row of a [A, T, S] array: hit, the flat
// index of the first matching way's word, and the sum of the matching
// ways' states (the JAX probe's state).
struct Probe {
  bool hit;
  int32_t idx;
  int state;
};

__device__ Probe probe(const int64_t* arr, int64_t A, int64_t T, int64_t S,
                       int64_t t, int64_t line) {
  Probe p{false, 0, 0};
  const int64_t set = fmod_pos(line, S);
  const int32_t tag = static_cast<int32_t>(line);
  for (int64_t w = 0; w < A; ++w) {
    const int64_t idx = (w * T + t) * S + set;
    const int64_t word = arr[idx];
    const int32_t st = word_state(word);
    if (word_tag(word) == tag && st != ST_I) {
      if (!p.hit) p.idx = static_cast<int32_t>(idx);
      p.hit = true;
      p.state += st;
    }
  }
  return p;
}

__global__ void __launch_bounds__(kTilesPerBlock)
fast_forward_walk_kernel(FFArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kTilesPerBlock +
                    threadIdx.x;
  if (t >= a.T) return;
  const int64_t T = a.T, F = a.F;

  const int32_t* per = a.period_ps + t * a.NM;
  const int64_t p_core = per[a.col_core];
  const int64_t l1i_ps = a.l1i_cycles * per[a.col_l1i];
  const int64_t l1d_ps = a.l1d_cycles * per[a.col_l1d];
  const int64_t wbound = a.boundary[0] + a.wbound_add;
  const int64_t bound = wbound + a.span_add;
  const int64_t clk0 = a.clock[t];

  // Per committed event: the word it touches and its branch slot.
  int32_t touch_idx[kMaxSpan];
  uint8_t touch_arr[kMaxSpan];
  int32_t br_slot[kMaxSpan];
  uint8_t br_taken[kMaxSpan];
  int nb = 0;

  int64_t ctr[12];
  for (int c = 0; c < 12; ++c) ctr[c] = 0;

  int64_t clk = clk0;
  int n = 0;
  bool crossed = false;   // some committed event starts at/past wbound

  // ---- pass 1: classify, price, and find the committed prefix
  if (a.tile_active[t] != 0 && a.models_enabled[0] != 0) {
    for (int64_t j = 0; j < F; ++j) {
      const int64_t e = t * F + j;
      if (a.valid_ev[e] == 0) break;
      const int32_t op = a.meta[e];
      const int32_t arg = a.meta[T * F + e];
      const int32_t arg2 = a.meta[2 * T * F + e];
      const int64_t addr = a.addr[e];
      const bool is_comp = op == OP_COMPUTE, is_br = op == OP_BRANCH;
      const bool is_rd = op == OP_MEM_READ, is_wr = op == OP_MEM_WRITE;

      uint8_t arr = TOUCH_NONE;
      int32_t idx = 0;
      if (is_comp) {
        const Probe p = probe(a.l1i_in, a.l1i_assoc, T, a.l1i_sets, t,
                              addr >> a.line_bits);
        if (!p.hit) break;
        arr = TOUCH_I;
        idx = p.idx;
      } else if (is_rd || is_wr) {
        const Probe p = probe(a.l1d_in, a.l1d_assoc, T, a.l1d_sets, t,
                              addr >> a.line_bits);
        if (!(p.hit && (is_rd || p.state >= ST_M))) break;
        arr = TOUCH_D;
        idx = p.idx;
      } else if (!is_br) {
        break;
      }

      // Branch prediction: last earlier branch of the span to this slot,
      // else the table.
      const bool taken = arg != 0;
      bool correct = true;
      int32_t slot = 0;
      if (is_br && a.bp_size > 0) {
        slot = static_cast<int32_t>(fmod_pos(addr, a.bp_size));
        bool pred = a.bp_in[t * a.bp_size + slot] != 0;
        for (int b = nb - 1; b >= 0; --b) {
          if (br_slot[b] == slot) {
            pred = br_taken[b] != 0;
            break;
          }
        }
        correct = pred == taken;
      }

      const int64_t icount_ev =
          static_cast<int64_t>(max(arg2 & ((1 << 20) - 1), 0));
      int64_t dt;
      if (is_comp) {
        dt = static_cast<int64_t>(max(arg, 0)) * p_core + icount_ev * l1i_ps;
      } else if (is_br) {
        dt = (correct ? p_core : a.bp_penalty * p_core) + l1i_ps;
      } else {
        dt = l1d_ps;
      }

      // Commit cut: the clock before this event under the bound.
      if (clk >= bound) break;
      if (clk >= wbound) crossed = true;

      touch_arr[j] = arr;
      touch_idx[j] = idx;
      if (is_br && a.bp_size > 0) {
        br_slot[nb] = slot;
        br_taken[nb] = taken ? 1 : 0;
        ++nb;
      }
      // counters (WINDOW_CTRS order; miss, L2 and spawn rows stay 0)
      if (is_comp) {
        ctr[0] += icount_ev;
        ctr[1] += icount_ev;
      }
      if (((is_rd || is_wr) && (arg2 & 0xFF) == 0) || is_br) ctr[0] += 1;
      if (is_br) {
        ctr[1] += 1;
        ctr[9] += 1;
        if (!correct) ctr[10] += 1;
      }
      if (is_rd) ctr[3] += 1;
      if (is_wr) ctr[5] += 1;
      clk += dt;
      ++n;
    }
  }

  // ---- pass 2: commit the prefix of an engaged tile
  const bool engage = n > a.K && crossed;
  if (engage) {
    const int64_t stamp_base = a.stamp_base[0];
    for (int j = 0; j < n; ++j) {
      if (touch_arr[j] == TOUCH_NONE) continue;
      const int64_t* in = touch_arr[j] == TOUCH_I ? a.l1i_in : a.l1d_in;
      int64_t* out = touch_arr[j] == TOUCH_I ? a.l1i_out : a.l1d_out;
      const int32_t idx = touch_idx[j];
      const int64_t nw = with_stamp(in[idx], stamp_base + j);
      if (nw > out[idx]) out[idx] = nw;
    }
    for (int b = 0; b < nb; ++b)
      a.bp_out[t * a.bp_size + br_slot[b]] = br_taken[b];
  }
  a.clock_out[t] = engage ? clk : clk0;
  a.n_ret[t] = engage ? n : 0;
  for (int c = 0; c < 12; ++c) a.ctr_inc[c * T + t] = engage ? ctr[c] : 0;
}

}  // namespace

extern "C" int fast_forward_walk_launch(const FFArgs* args, void* stream) {
  if (args->F > kMaxSpan) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(
      (args->T + kTilesPerBlock - 1) / kTilesPerBlock);
  if (blocks == 0) return 0;
  fast_forward_walk_kernel<<<blocks, kTilesPerBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
