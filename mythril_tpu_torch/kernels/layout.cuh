// Slot indices of the kernels' parameter blocks and scratch rows.
//
// This file is the single source of truth: kernels/layout.py parses every
// `NAME = number,` line below, so the Python wrappers fill exactly the
// slots the kernels read. Keep one entry per line, with explicit numbers.
#pragma once

enum Layout {
    MTPU_MAX_ARGS = 256,

    // the 46 leaves of a lane row: StateBatch fields, then SymPlanes fields
    L_STACK = 0,
    L_SP = 1,
    L_PC = 2,
    L_GAS_USED = 3,
    L_GAS_LIMIT = 4,
    L_STATUS = 5,
    L_MEMORY = 6,
    L_MSIZE = 7,
    L_CODE = 8,
    L_CODE_LEN = 9,
    L_JUMPDEST = 10,
    L_CALLDATA = 11,
    L_CALLDATA_LEN = 12,
    L_RETDATA = 13,
    L_RETDATA_LEN = 14,
    L_STORAGE_KEYS = 15,
    L_STORAGE_VALS = 16,
    L_STORAGE_USED = 17,
    L_TSTORE_KEYS = 18,
    L_TSTORE_VALS = 19,
    L_TSTORE_USED = 20,
    L_ADDRESS = 21,
    L_CALLER = 22,
    L_ORIGIN = 23,
    L_CALLVALUE = 24,
    L_GASPRICE = 25,
    L_COINBASE = 26,
    L_TIMESTAMP = 27,
    L_NUMBER = 28,
    L_PREVRANDAO = 29,
    L_BLOCK_GASLIMIT = 30,
    L_CHAINID = 31,
    L_BASEFEE = 32,
    L_SELFBALANCE = 33,
    L_STACK_SYM = 34,
    L_MEM_SYM = 35,
    L_STORAGE_SYM = 36,
    L_STORAGE_DIRTY = 37,
    L_STORAGE_BASE_SYM = 38,
    L_CONDS = 39,
    L_COND_COUNT = 40,
    L_FORK_COND = 41,
    L_SYMBOLIC_ENV = 42,
    L_CTX_ID = 43,
    L_BRANCHES = 44,
    L_LAST_JUMP = 45,
    N_STATE_LEAVES = 34,
    N_ROW_LEAVES = 46,

    // K1 keccak_rows
    K1_DATA = 0,
    K1_STRIDE = 1,
    K1_NCOLS = 2,
    K1_OFFSET = 3,
    K1_LEN = 4,
    K1_LIMIT = 5,
    K1_MASK = 6,
    K1_OUT = 7,
    K1_BATCH = 8,
    K1_PER_WARP = 9,
    K1_NARGS = 10,

    // K2 evm_step: slots 0..33 are the StateBatch leaves (L_STACK..)
    K2_B = 34,
    K2_S = 35,
    K2_M = 36,
    K2_C = 37,
    K2_D = 38,
    K2_R = 39,
    K2_K = 40,
    K2_T = 41,
    K2_FORCE_ESCAPE = 42,
    K2_FORCE_FORK = 43,
    K2_OPTAB = 44,
    K2_DIGEST = 45,
    K2_NARGS = 46,

    // K3 arena_alloc
    K3_WANT = 0,
    K3_VALUES = 1,
    K3_OP = 2,
    K3_A = 3,
    K3_B = 4,
    K3_C = 5,
    K3_IMM = 6,
    K3_IMM2 = 7,
    K3_COL_OP = 8,
    K3_COL_A = 9,
    K3_COL_B = 10,
    K3_COL_C = 11,
    K3_COL_IMM = 12,
    K3_COL_IMM2 = 13,
    K3_COL_CLS = 14,
    K3_N = 15,
    K3_CAP = 16,
    K3_CONST_VALS = 17,
    K3_N_CONST = 18,
    K3_CCAP = 19,
    K3_OUT_IDS = 20,
    K3_OUT_OVF = 21,
    K3_BATCH = 22,
    K3_NARGS = 23,

    // K4 sym_step: lane rows, stack-pool rows and escape rows (46 leaves
    // each, L_* order), the bytes of one row of each leaf, then the rest
    K4_LANE = 0,
    K4_POOL = 46,
    K4_ESC = 92,
    K4_ROW_BYTES = 138,
    K4_B = 184,
    K4_S = 185,
    K4_M = 186,
    K4_C = 187,
    K4_K = 188,
    K4_KC = 189,
    K4_P = 190,
    K4_E = 191,
    K4_CLS = 192,
    K4_CAP = 193,
    K4_STACK_TOP = 194,
    K4_ESC_COUNT = 195,
    K4_EXECUTED = 196,
    K4_FORKS = 197,
    K4_PUSHES = 198,
    K4_POPS = 199,
    K4_ENABLED = 200,
    K4_OPTAB = 201,
    K4_ISCR = 202,
    K4_FSCR = 203,
    K4_WSCR = 204,
    K4_PRED_MASK = 205,
    // the telemetry plane (read only by the TEL instantiation, kernel K9)
    K4_TEL_OP_HIST = 206,
    K4_TEL_LIFECYCLE = 207,
    K4_TEL_ESC_CAUSE = 208,
    K4_TEL_OCCUPANCY = 209,
    K4_TEL_HWM = 210,
    K4_TEL_TAG_PCS = 211,
    K4_TEL_TAG_OCC = 212,
    K4_TEL_N_TAGS = 213,
    K4_TEL_FLEET_SLOTS = 214,
    K4_TEL_N_CTX = 215,
    K4_TEL_FLEET_OCC = 216,
    K4_TEL_N_FLEET = 217,
    // shards: 1 = the scalar scheduler, D > 1 = int32[D] tops
    K4_D = 218,
    // launch geometry: lanes per block (the scan tile), threads per lane of
    // the wide launches, tiles (ceil(B / lanes per block)); the move
    // launch's phase (set by the launcher)
    K4_LPB = 219,
    K4_GROUP = 220,
    K4_NB = 221,
    K4_PHASE = 222,
    // step scratch (int32): tile-local exclusive ranks [N_SC, B], tile
    // totals [N_SC, NB], tile prefixes [N_SC, NB + 1], segment values
    // [N_SEGF, D], the move list [N_MVF, B], moves per phase [N_PHASES],
    // the allocation's bump pointers [N_ALLOC], claimed DEAD lanes [B]
    K4_SCAN = 223,
    K4_BTOT = 224,
    K4_BPRE = 225,
    K4_SEG = 226,
    K4_MOVES = 227,
    K4_NMOVES = 228,
    K4_ALLOC = 229,
    K4_DEAD_MAP = 230,
    // a row's copy plan: entries int32[E, 3] (leaf, byte offset, bytes)
    // grouped into items (entry offsets int32[N_ITEMS + 1])
    K4_ENTRIES = 231,
    K4_ITEMS = 232,
    K4_N_ITEMS = 233,
    // the arena's node columns and const pool (cls and capacity above)
    K4_AR_OP = 234,
    K4_AR_A = 235,
    K4_AR_B = 236,
    K4_AR_C = 237,
    K4_AR_IMM = 238,
    K4_AR_IMM2 = 239,
    K4_AR_N = 240,
    K4_AR_CONST = 241,
    K4_AR_N_CONST = 242,
    K4_AR_CCAP = 243,
    // kernel K9's per-step count table (uint8 [N_TC, NB rounded up to 16],
    // TEL instantiation only)
    K4_TEL_ROWS = 244,
    K4_NARGS = 245,

    // K9's count table columns, one byte a block each: the launch over
    // lanes that counts stores its block's counts, the fork phase's
    // sym_move (the step's last launch) sums every column into the plane.
    // sym_seed_count: ERRORED lanes freed; sym_fork_apply: bad jump
    // deaths, frozen forks revived; sym_classify: op classes, escape
    // causes, cold SLOADs, running lanes, then the tags and after them the
    // fleet slots (TC_TAG + n_tags + slot); sym_planes: arena-overflow
    // kills
    TC_ERR = 0,
    TC_BAD_JUMP = 1,
    TC_REVIVED = 2,
    TC_OP = 3,
    TC_CAUSE = 18,
    TC_COLD = 26,
    TC_RUNNING = 27,
    TC_OVF = 28,
    TC_TAG = 29,
    N_TC = 157,

    // K4 int32 scratch rows [N_ISCR, B]
    I_OP = 0,
    I_SYM1 = 1,
    I_SYM2 = 2,
    I_PRE_SP = 3,
    I_PRE_PC = 4,
    I_MLOAD_NODE = 5,
    I_SLOAD_NODE = 6,
    I_VAR_CLASS = 7,
    I_VAR_QUAL = 8,
    I_COUNT = 9,
    N_ISCR = 10,

    // K4 uint8 flag rows [N_FSCR, B]
    F_FORCE_ESCAPE = 0,
    F_FORCE_FORK = 1,
    F_WAS_RUNNING = 2,
    F_JUMPI_FORK = 3,
    F_FROZEN_FORK = 4,
    F_SLOAD_COLD = 5,
    F_MSTORE_SYM_VAL = 6,
    F_MLOAD_CLEAN = 7,
    F_ANY_SYM = 8,
    F_CDL_VAR = 9,
    F_ENV_VAR_OP = 10,
    F_SSTORE = 11,
    F_WANT_CA = 12,
    F_WANT_CB = 13,
    F_WANT_R = 14,
    F_WANT_E = 15,
    F_ADVANCED = 16,
    F_PUT = 17,
    F_DEST_OK = 18,
    N_FSCR = 19,

    // K4 word scratch [N_WSCR, B, 16]: the pre-step operands a and b
    W_A = 0,
    W_B = 1,
    N_WSCR = 2,

    // K4 scan components: reseeds; the four allocations (CONST a, CONST b,
    // result, env VAR); escapes; DEAD lanes and forkers
    SC_DEAD0 = 0,
    SC_CA = 1,
    SC_CB = 2,
    SC_R = 3,
    SC_E = 4,
    SC_ESC = 5,
    SC_DEAD = 6,
    SC_WANT = 7,
    N_SC = 8,

    // K4 segment values [N_SEGF, D]
    SG_TOP0 = 0,
    SG_TAKE = 1,
    SG_TAKE_BASE = 2,
    SG_ECOUNT = 3,
    SG_PUT = 4,
    SG_PUT_BASE = 5,
    SG_ESC_USED = 6,
    SG_TOP2 = 7,
    SG_HAVE = 8,
    SG_PUSH = 9,
    SG_ACT = 10,
    SG_ACT_BASE = 11,
    N_SEGF = 12,

    // K4 move list fields [N_MVF, B]: source and destination row sets
    // (K4_LANE, K4_POOL or K4_ESC) and rows; a mapped destination row
    // indexes the claimed DEAD lanes
    MV_SRC_BASE = 0,
    MV_SRC_ROW = 1,
    MV_DST_BASE = 2,
    MV_DST_ROW = 3,
    MV_DST_MAPPED = 4,
    N_MVF = 5,

    // K4 phases of the move launch (reseeds, escapes, forks)
    PH_SEED = 0,
    PH_ESC = 1,
    PH_FORK = 2,
    N_PHASES = 3,

    // K4 bump pointers of the folded allocations
    AL_NC0 = 0,
    AL_N0 = 1,
    AL_NC1 = 2,
    AL_N1 = 3,
    AL_N2 = 4,
    AL_N3 = 5,
    N_ALLOC = 6,

    // K5 frontier_summary
    K5_STATUS = 0,
    K5_FORK_COND = 1,
    K5_CTX_ID = 2,
    K5_B = 3,
    K5_STACK_TOP = 4,
    K5_ESC_COUNT = 5,
    K5_EXECUTED = 6,
    K5_FORKS = 7,
    K5_PUSHES = 8,
    K5_POPS = 9,
    K5_ARENA_N = 10,
    K5_ARENA_N_CONST = 11,
    K5_ESC_MSIZE = 12,
    K5_ESC_SP = 13,
    K5_ESC_STORAGE_USED = 14,
    K5_ESC_COND_COUNT = 15,
    K5_E = 16,
    K5_K = 17,
    K5_OUT = 18,
    // the telemetry words appended when the plane is armed (op_hist null:
    // none)
    K5_TEL_OP_HIST = 19,
    K5_TEL_LIFECYCLE = 20,
    K5_TEL_ESC_CAUSE = 21,
    K5_TEL_OCCUPANCY = 22,
    K5_TEL_HWM = 23,
    K5_TEL_TAG_OCC = 24,
    K5_TEL_N_TAGS = 25,
    K5_TEL_FLEET_OCC = 26,
    K5_TEL_N_FLEET = 27,
    // a sharded scheduler's shard block, appended last (D = 1: none)
    K5_D = 28,
    K5_STEALS_SENT = 29,
    K5_STEALS_RECEIVED = 30,
    K5_STEAL_ROWS = 31,
    // the blocks' maxima, int64[blocks, 4] (each launch writes them all,
    // its second launch combines them)
    K5_PARTIAL = 32,
    K5_NARGS = 33,

    // K6 row_maxima / pack_rows / reset_esc: slots 0..45 are the source
    // rows' leaves (L_STACK..), then the rest
    K6_LEAF = 0,
    K6_INDEX = 46,
    K6_N = 47,
    K6_ROWS = 48,
    K6_S = 49,
    K6_M = 50,
    K6_K = 51,
    K6_KC = 52,
    K6_MEM_B = 53,
    K6_SP_B = 54,
    K6_ST_B = 55,
    K6_CONDS_W = 56,
    K6_OUT_I32 = 57,
    K6_OUT_U8 = 58,
    K6_OUT_GAS = 59,
    K6_OUT_MAXIMA = 60,
    K6_ESC_COUNT = 61,
    K6_ESC_SEGMENTS = 62,
    K6_PARTIAL = 63,
    K6_NARGS = 64,

    // K7 gather_rows / scatter_rows: the lane rows' leaves, each leaf's
    // slab in the flat row block (a byte offset from K7_BASE: a gather's
    // fresh buffer, or 0 when a scatter's slabs are absolute pointers) and
    // the bytes of one row of each leaf (46 each, L_* order); the row copy
    // plan (ops._copy_plan) and its item count
    K7_LANE = 0,
    K7_SLAB = 46,
    K7_ROW_BYTES = 92,
    K7_INDEX = 138,
    K7_N = 139,
    K7_ROWS = 140,
    K7_BASE = 141,
    K7_ENTRIES = 142,
    K7_ITEMS = 143,
    K7_N_ITEMS = 144,
    K7_NARGS = 145,

    // K8 arena_delta: the six node columns (op, a, b, c, imm, imm2)
    K8_COL = 0,
    K8_CONST_VALS = 6,
    K8_START = 7,
    K8_CSTART = 8,
    K8_BUCKET = 9,
    K8_CBUCKET = 10,
    K8_OUT_ROWS = 11,
    K8_OUT_CONSTS = 12,
    K8_NARGS = 13,

    // K10 merge_pass: the 46 lane leaves (L_* order), the bytes of one row
    // of each, then the rest
    K10_LANE = 0,
    K10_ROW_BYTES = 46,
    K10_B = 92,
    K10_S = 93,
    K10_M = 94,
    K10_K = 95,
    K10_KC = 96,
    K10_W = 97,
    K10_J = 98,
    K10_N_TAGS = 99,
    K10_MERGE_PCS = 100,
    K10_MEM_PCS = 101,
    K10_MEM_WORDS = 102,
    K10_MODE = 103,
    K10_SHIFT = 104,
    K10_ROUNDS = 105,
    K10_HASH = 106,
    K10_INFO = 107,
    K10_ELIG = 108,
    K10_FI = 109,
    K10_TI = 110,
    K10_OK = 111,
    K10_STATS = 112,
    // one blend family's tables at K10_FAM + family * N_FAM_FIELDS + field
    // (family: 0 memory windows, 1 stack slots, 2 storage slots)
    K10_FAM = 113,
    FAM_WANT_CT = 0,
    FAM_WANT_CF = 1,
    FAM_WANT_ITE = 2,
    FAM_VALS_T = 3,
    FAM_VALS_F = 4,
    FAM_PRE_T = 5,
    FAM_PRE_F = 6,
    FAM_COND = 7,
    FAM_IDS_CT = 8,
    FAM_IDS_CF = 9,
    FAM_IDS_ITE = 10,
    FAM_OVF_CT = 11,
    FAM_OVF_CF = 12,
    FAM_OVF_ITE = 13,
    FAM_NODE_T = 14,
    FAM_NODE_F = 15,
    N_FAM_FIELDS = 16,
    // the sort above 1024 lanes: uint64 keys and int32 lanes
    // [K10_SORT_N], the next power of two; the stage (set by the launcher)
    K10_SORT_KEYS = 161,
    K10_SORT_IDX = 162,
    K10_SORT_N = 163,
    K10_SORT_K = 164,
    K10_SORT_J = 165,
    // the blends' folded allocations (K3's rules, arena.cuh): per pair
    // counts and their exclusive prefix over the pairs, int32 [9, B/2],
    // allocation = family * 3 + (0 true-side CONSTs, 1 false-side CONSTs,
    // 2 ITE nodes); each allocation's bump pointers int32 [9, 2] (n, n_const)
    K10_ACNT = 166,
    K10_APRE = 167,
    K10_ABASE = 168,
    // the arena, updated in place
    K10_AR_OP = 169,
    K10_AR_A = 170,
    K10_AR_B = 171,
    K10_AR_C = 172,
    K10_AR_IMM = 173,
    K10_AR_IMM2 = 174,
    K10_AR_CLS = 175,
    K10_AR_CONST = 176,
    K10_AR_N = 177,
    K10_AR_N_CONST = 178,
    K10_AR_CAP = 179,
    K10_AR_CCAP = 180,
    K10_NARGS = 181,

    // K10 per-lane info rows [N_INFO, B]
    INFO_LAST = 0,
    INFO_CC = 1,
    INFO_LAST_IDX = 2,
    INFO_JOIN = 3,
    N_INFO = 4,

    // K11 sat_step: one query's state [P, V1] / [P], or a batch's with a
    // leading query axis, the problem tensors, then the rest
    K11_ASSIGN = 0,
    K11_TRAIL = 1,
    K11_TAG = 2,
    K11_TRAIL_LEN = 3,
    K11_STATUS = 4,
    K11_LITS = 5,
    K11_VALID = 6,
    K11_ORDER = 7,
    K11_Q = 8,
    K11_P = 9,
    K11_V1 = 10,
    K11_C = 11,
    K11_FORCED_DEPTH = 12,
    K11_STEPS = 13,
    // scratch of the step plan, zero on entry and left zero by every step:
    // int32 implied keys [Q, P, V1], int32 conflict flags [Q, P]
    K11_KEY = 14,
    K11_CONFLICT = 15,
    // int32 decided flags [Q] of the batch runner's freeze (null: none)
    K11_DECIDED = 16,
    // more zero-kept scratch: int32 unit-seen flags [Q, P], uint32 bitmaps
    // of the keyed vars [Q, P, ceil(V1 / 32)]
    K11_UNIT = 17,
    K11_BITS = 18,
    // int8 variable-major mirror of the assignment [Q, V1, P], rebuilt at
    // the start of every chunk and kept by every assignment write
    K11_MIRROR = 19,
    // per (probe, variable tile) partials: int64 [Q * P, NT] (last flip
    // position or least decision key), int32 [Q * P, NT, 2] (keyed count;
    // or decision level and any-free)
    K11_PART64 = 20,
    K11_PART32 = 21,
    // int32 [Q * P, N_SAT_RES]: each probe's branch, trail length and
    // flags as the step's count launch found them
    K11_RES = 22,
    // variables per tile of the resolve launches (a power of two >= 32)
    K11_VT = 23,
    // propagate's geometry, set by mtpu_sat_run: log2 of the probe groups
    // (four probes a group, or one; padded to a power of two) and the
    // blocks per query
    K11_PROP_SHIFT = 24,
    K11_PROP_BPQ = 25,
    // the clause range [C0, C1) of each query's C clauses that propagate
    // scans (mtpu_sat_run sets the whole range; a shard its block)
    K11_C0 = 26,
    K11_C1 = 27,
    // K13, the sharded chunk: int32 exchange planes [D, N_XCHG] on this
    // shard's device, N_XCHG = Q * P * (2 * ceil(V1 / 32) + 2): each
    // shard's keyed-var bitmaps [Q * P, NW], FALSE-phase bitmaps (a var's
    // bit set where the shard's highest clause keying it implies FALSE)
    // [Q * P, NW], conflict and unit-seen flags [Q * P] each (its seal
    // writes its own plane whole, the others arrive by copy); the shard
    // count D and this shard's index
    K11_XCHG = 28,
    K11_SHARDS = 29,
    K11_SHARD = 30,
    K11_NARGS = 31,
    SAT_RES_BRANCH = 0,
    SAT_RES_LEN = 1,
    SAT_RES_CLEAR = 2,
    N_SAT_RES = 3,

    // K12 steal_pass: the stack pool's leaves and the bytes of one row of
    // each (46 each, L_* order), then the rest
    K12_POOL = 0,
    K12_ROW_BYTES = 46,
    K12_STATUS = 92,
    K12_STACK_TOP = 93,
    K12_STEALS_SENT = 94,
    K12_STEALS_RECEIVED = 95,
    K12_STEAL_ROWS = 96,
    K12_B = 97,
    K12_D = 98,
    K12_P = 99,
    K12_MIN_IMBALANCE = 100,
    K12_MAX_ROWS = 101,
    // the move list int32[D/2, 3]: each pair's donor top row, receiver's
    // first free row and rows moved (written by the plan launch)
    K12_MOVES = 102,
    // a row's copy plan (ops._copy_plan, as K4's and K7's)
    K12_ENTRIES = 103,
    K12_ITEMS = 104,
    K12_N_ITEMS = 105,
    K12_NARGS = 106,
};
