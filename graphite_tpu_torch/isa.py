"""Instruction/event type taxonomy.

Mirrors the reference's InstructionType enum (reference:
common/tile/core/instruction.h:20-58) — the static types carry table-driven
costs ([core/static_instruction_costs], carbon_sim.cfg:189-200); the dynamic
types (recv/sync/spawn/stall) carry a latency computed at event-generation
time (reference: common/tile/core/instruction.h:166-200).

The TPU build folds both into one event stream: each event slot is either a
COMPUTE block (a run of non-memory instructions collapsed into an aggregate
cost — a trace-side optimization the event-driven reference doesn't need), a
single modeled instruction with a memory operand, a BRANCH, or a dynamic
event (SYNC/RECV/...).
"""

from __future__ import annotations

import enum


class InstructionType(enum.IntEnum):
    """Static instruction classes with config-table costs."""

    GENERIC = 0
    MOV = 1
    IALU = 2
    IMUL = 3
    IDIV = 4
    FALU = 5
    FMUL = 6
    FDIV = 7
    XMM_SS = 8
    XMM_SD = 9
    XMM_PS = 10
    BRANCH = 11

    @property
    def config_key(self) -> str:
        return self.name.lower()


# Order matters: index into the static-cost table array.
STATIC_COST_TYPES = [
    InstructionType.GENERIC,
    InstructionType.MOV,
    InstructionType.IALU,
    InstructionType.IMUL,
    InstructionType.IDIV,
    InstructionType.FALU,
    InstructionType.FMUL,
    InstructionType.FDIV,
    InstructionType.XMM_SS,
    InstructionType.XMM_SD,
    InstructionType.XMM_PS,
]


class EventOp(enum.IntEnum):
    """Per-slot event opcodes in the trace stream (see events/schema.py)."""

    NOP = 0          # empty slot / padding
    COMPUTE = 1      # run of non-memory instructions: cost + count aggregated
    MEM_READ = 2     # modeled data read  (lite::handleMemoryRead analog)
    MEM_WRITE = 3    # modeled data write (lite::handleMemoryWrite analog)
    BRANCH = 4       # conditional branch: predictor query + penalty on miss
    RECV = 5         # blocking user-network receive (CAPI_message_receive_w)
    SEND = 6         # user-network send (CAPI_message_send_w)
    SYNC = 7         # sync-op completion with frontend-supplied wake time
    SPAWN = 8        # thread spawn overhead event
    STALL = 9        # explicit stall until given absolute time
    DVFS_SET = 10    # change this tile's domain frequency
    ATOMIC = 11      # atomic read-modify-write (exclusive request + update)
    DONE = 12        # tile finished its stream
    BARRIER_WAIT = 13  # block until all participants arrive (SimBarrier analog,
                       # reference: common/system/sync_server.h:15-121)
    MUTEX_LOCK = 14    # FCFS simulated mutex acquire (SimMutex analog)
    MUTEX_UNLOCK = 15  # release; wakes earliest waiter
    COND_WAIT = 16     # release held mutex + park until signaled, then
                       # re-acquire (SimCond::wait, sync_server.cc:67-74)
    COND_SIGNAL = 17   # wake earliest waiter parked at signal time; lost
                       # if none (SimCond::signal, sync_server.cc:76-100)
    COND_BROADCAST = 18  # wake every waiter parked at broadcast time
    JOIN = 19          # block until the named tile's stream is DONE
                       # (ThreadManager join protocol, thread_manager.cc)
    THREAD_START = 20  # block the stream until some tile SPAWNs this one
    ENABLE_MODELS = 21   # region-of-interest start: turn timing models on
                         # (CarbonEnableModels, simulator.cc:287-301)
    DISABLE_MODELS = 22  # region-of-interest end: fast-forward (zero cost,
                         # no counters) until re-enabled
    SYSCALL = 23       # marshalled system call to the MCP's syscall server
                       # (reference: common/tile/core/syscall_model.cc packs
                       # args, common/system/syscall_server.cc:43-130 serves;
                       # arg = SyscallClass, arg2 = marshalled byte count)
    YIELD = 24         # voluntarily give up the core: the ThreadScheduler
                       # rotates the next queued stream onto this tile
                       # (CarbonThreadYield -> ThreadScheduler::yieldThread,
                       # thread_scheduler.cc:615-660; no-op when the trace
                       # has one stream per tile)


class SyscallClass(enum.IntEnum):
    """Syscall cost classes (reference: the IF_ORIG_ENUM dispatch table in
    syscall_server.cc:43-130 — open/read/write/close/access/stat/mmap/brk
    each marshal through the MCP; futex ops re-enter the sync machinery
    and therefore surface as the sync events above, not as SYSCALL)."""

    OTHER = 0
    OPEN = 1
    CLOSE = 2
    READ = 3
    WRITE = 4
    LSEEK = 5
    ACCESS = 6
    STAT = 7
    MMAP = 8
    MUNMAP = 9
    BRK = 10


class MemComponent(enum.IntEnum):
    """Memory components addressed by an access (reference:
    common/tile/memory_subsystem/memory_manager.h MemComponent)."""

    INVALID = 0
    L1_ICACHE = 1
    L1_DCACHE = 2
    L2_CACHE = 3
    DRAM_DIRECTORY = 4
    DRAM = 5


class DVFSModule(enum.IntEnum):
    """Frequency/voltage domain modules (reference: common/system/dvfs_manager.h,
    [dvfs/domains] carbon_sim.cfg:147-155)."""

    CORE = 0
    L1_ICACHE = 1
    L1_DCACHE = 2
    L2_CACHE = 3
    DIRECTORY = 4
    NETWORK_USER = 5
    NETWORK_MEMORY = 6

    @classmethod
    def parse(cls, name: str) -> "DVFSModule":
        return cls[name.strip().upper()]
