"""Batched SAT on the card: lockstep DPLL over a tiled clause matrix.

The port's counterpart of mythril_tpu/parallel/jax_solver.py, the
`--solver jax` lane (the name drops "jax": nothing here is JAX). The CNF
comes from the Tseitin bit-blaster (smt/solver/bitblast.py: every gate
clause has <= 3 literals, so the dense clause matrix is [n_clauses, 3] int32
with 0 padding).

Search shape (cube-and-conquer in lockstep): P probe lanes each run complete
chronological-backtracking DPLL, with their first `log2(P)` decision phases
forced to the bits of the lane index. Decision-variable selection is a
deterministic function of the assignment (static frequency order), so the
forced prefixes form a perfect binary tree of subspaces: UNSAT iff every
lane proves its cube UNSAT, SAT as soon as one lane completes an assignment.

One transition of every probe is kernel K11 (`kernels/sat_step.cu`, through
`kernels.ops.sat_run`), which runs a whole chunk of steps as one CUDA
graph; `step_reference` / `run_chunk_reference` are its plain PyTorch twins,
which the wrappers take only for CPU tensors. The state and the problem
arrays keep the JAX package's dtypes and shapes, so `parallel/convert.py`
carries them across leaf for leaf, and every step is bit-identical to JAX
`_step` on the CPU, including its two scatter rules:

* a variable implied by several unit clauses in one step takes the phase
  of the clause with the highest global index (the last write of JAX's
  tile-ordered scatter);
* newly implied variables append to the trail in variable order.

Problems above `clause_cap` return UNKNOWN at once, as in the JAX package:
the caller answers them with the CDCL core.

The clause-sharded route is the counterpart of JAX `_get_sharded_runner`
(K13: `run_chunk_sharded`, `kernels.ops.sat_run_sharded`; its twin
`run_chunk_sharded_reference`). A mesh of D devices (`configure`; a
device may repeat, which gives logical shards on one card) splits the
clause tiles into D contiguous blocks, each shard steps a replica of the
state over its block, and every step combines the shards' verdicts as
JAX's pmax does: conflicts and units by any-of, each implied variable's
phase by the larger code (FALSE over TRUE), after each shard's own highest
clause won inside it. So a variable implied both ways by two shards takes
FALSE where the unsharded step takes the higher clause's phase. As in the
JAX package, `solve_cnf_device` takes the route when the mesh has more
than one device and the tiles divide over it, and the clause cap scales
with the device count; `solve_cnf_device_batch` never shards.

Shapes are bucketed as in the JAX package: the ``coarse`` scheme (default)
rounds clause tiles, the variable axis (with a floor) and the batch query
axis to powers of four, ``fine`` to powers of two. The scheme is the
`scheme` argument here, where the JAX package reads an environment knob.

Every chunk of an entry point runs under a shape key, the JAX runner's
(``("single", mesh devices, chunk, forced depth, tiles, V1, probes)``,
``("batch", chunk, forced depth, tiles, V1, queries, probes)``), so that
the serve warm set writes the manifest the JAX daemon writes
(`observed_shape_keys`) and replays it (`warm_shape_key`).
``xla.bucket_compiles`` counts the first run of a key in this process and
``xla.bucket_reuses`` every later run, as the JAX package counts them; in
the port the first run of a key pays no compile (K11 is built once for
every shape), only the first chunk's CUDA-graph capture for its tensors.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..exceptions import DeviceUnavailable
from ..observe import metrics
from ..smt.solver.solver_statistics import SolverStatistics
from .batch import next_pow2

SAT, UNSAT, UNKNOWN = 1, 0, -1

# probe status
SEARCHING, S_SAT, S_UNSAT = 0, 1, 2

#: clause tile width of the unit-propagation pass
TILE = 2048

#: clause cap for device solving (one card): above it, UNKNOWN
DEFAULT_CLAUSE_CAP = 1 << 19

#: coarse-scheme floor of the padded variable axis
COARSE_VARS_FLOOR = 1 << 10

#: unassigned / true / false assignment codes
_UNASSIGNED, _TRUE, _FALSE = 0, 1, 2

#: rank of a variable that is not free (and of pad variables' order)
_NOT_FREE = 1 << 30

SCHEMES = ("coarse", "fine")

#: the clause-sharded route's settings (`configure`), read at call time
_DEFAULT_SETTINGS = {"shard": None, "mesh": None}
_settings = dict(_DEFAULT_SETTINGS)


def configure(shard: Optional[bool] = None, mesh=None) -> None:
    """The clause-sharded route's settings, read at call time as the JAX
    package reads MYTHRIL_TPU_SHARD and `jax.devices()`.

    `mesh`: a tuple of devices, one a shard; a device may repeat (logical
    shards on one card). None: every visible CUDA card when the call's
    device is a card, else the call's device alone. `shard`: None (the
    knob unset) shards when the mesh has more than one device and they are
    cards; True (=1) shards over any mesh of more than one device, the CPU
    included; False (=0) never shards."""
    _settings.update(shard=shard, mesh=None if mesh is None else tuple(mesh))


def reset_settings() -> None:
    _settings.update(_DEFAULT_SETTINGS)


def _mesh_device(device) -> torch.device:
    dev = _device.resolve(device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise DeviceUnavailable(
                f"mythril_tpu_torch: the mesh names cuda:{index}, but "
                f"{torch.cuda.device_count()} CUDA devices are visible")
        dev = torch.device("cuda", index)
    return dev


def mesh_devices(device=None) -> tuple:
    """The configured mesh, resolved, for a call on `device`. A mesh
    device that is not there, or one of another type than the call's (a
    CPU mesh under a card call, a card mesh under a CPU call), raises
    DeviceUnavailable: the call never moves to another kind of device."""
    dev = _mesh_device(device)
    mesh = _settings["mesh"]
    if mesh is None:
        if dev.type != "cuda":
            return (dev,)
        return tuple(torch.device("cuda", index)
                     for index in range(torch.cuda.device_count()))
    mesh = tuple(_mesh_device(shard) for shard in mesh)
    if any(shard.type != dev.type for shard in mesh):
        raise DeviceUnavailable(
            f"mythril_tpu_torch: the configured mesh {mesh} is not on the "
            f"call's device type ({dev.type})")
    return mesh


def shard_count(mesh: tuple) -> int:
    """The devices a query's clauses split over (JAX
    jax_solver.py:452-457): the mesh's, or 1."""
    flag = _settings["shard"]
    if len(mesh) > 1 and flag is not False \
            and (flag is True or mesh[0].type == "cuda"):
        return len(mesh)
    return 1


class Problem(NamedTuple):
    """A bucketed CNF on the host, as JAX `_build_problem` returns it."""
    lits: np.ndarray         # int32[n_tiles, TILE, 3] DIMACS literals, 0-padded
    valid: np.ndarray        # bool[n_tiles, TILE] true where a real clause lives
    order: np.ndarray        # int32[V1] decision rank per var (lower = earlier)
    init_assign: np.ndarray  # int8[V1] 0 for real vars, _FALSE for pad vars
    n_vars: int              # real variable count (connectors included)


class DeviceProblem(NamedTuple):
    """The problem tensors on a device: one query ([n_tiles, TILE, 3],
    [n_tiles, TILE], [V1]) or a batch with a leading query axis."""
    lits: torch.Tensor   # int32
    valid: torch.Tensor  # bool
    order: torch.Tensor  # int32


class SolverState(NamedTuple):
    """Every probe's DPLL state: [P, V1] / [P] for one query, with a
    leading query axis for a batch."""
    assign: torch.Tensor     # int8: 0 unassigned, 1 true, 2 false
    trail: torch.Tensor      # int32 literals in assignment order
    tag: torch.Tensor        # int8: 0 implied, 1 decision, 2 exhausted
    trail_len: torch.Tensor  # int32
    status: torch.Tensor     # int8


# ---- bucketing and the host problem -----------------------------------------------

def _next_pow4(value: int) -> int:
    bucket = 1
    while bucket < value:
        bucket <<= 2
    return bucket


def _check_scheme(scheme: str) -> bool:
    """True for the coarse scheme."""
    if scheme not in SCHEMES:
        raise ValueError(f"bucket scheme {scheme!r}: expected one of {SCHEMES}")
    return scheme == "coarse"


def bucket_tiles(tiles_needed: int, scheme: str = "coarse") -> int:
    if _check_scheme(scheme):
        return _next_pow4(tiles_needed)
    return next_pow2(tiles_needed)


def bucket_vars(vars_needed: int, scheme: str = "coarse") -> int:
    if _check_scheme(scheme):
        return max(COARSE_VARS_FLOOR, _next_pow4(vars_needed))
    return next_pow2(vars_needed)


def bucket_batch(queries_needed: int, scheme: str = "coarse") -> int:
    if _check_scheme(scheme):
        return _next_pow4(queries_needed)
    return next_pow2(queries_needed)


def build_problem(clauses: List[List[int]], n_vars: int, max_len: int = 3,
                  scheme: str = "coarse") -> Problem:
    """The bucketed clause matrix, decision order and initial assignment
    of a CNF, array for array as JAX `_build_problem`."""
    long_clauses = [c for c in clauses if len(c) > max_len]
    if long_clauses:
        # split long clauses with fresh connector variables (rare: the
        # blaster emits <=3-literal gate clauses; asserts are units)
        rebuilt = []
        for clause in clauses:
            while len(clause) > max_len:
                n_vars += 1
                rebuilt.append(clause[:max_len - 1] + [n_vars])
                clause = [-n_vars] + clause[max_len - 1:]
            rebuilt.append(clause)
        clauses = rebuilt

    n_clauses = len(clauses)
    n_tiles = bucket_tiles(max(1, -(-n_clauses // TILE)), scheme)
    lits = np.zeros((n_tiles * TILE, max_len), dtype=np.int32)
    for i, clause in enumerate(clauses):
        lits[i, :len(clause)] = clause
    valid = np.zeros(n_tiles * TILE, dtype=bool)
    valid[:n_clauses] = True

    # bucket the variable axis; padded vars start pre-assigned (false, not
    # on the trail) so they are never decided and never block the SAT check
    v1 = bucket_vars(n_vars + 1, scheme)
    counts = np.zeros(v1, dtype=np.int64)
    for clause in clauses:
        for lit in clause:
            counts[abs(lit)] += 1
    order = np.full(v1, _NOT_FREE, dtype=np.int32)
    by_freq = np.argsort(-counts[1:n_vars + 1], kind="stable") + 1
    order[by_freq] = np.arange(1, n_vars + 1, dtype=np.int32)
    init_assign = np.zeros(v1, dtype=np.int8)
    init_assign[n_vars + 1:] = _FALSE
    return Problem(lits.reshape(n_tiles, TILE, max_len),
                   valid.reshape(n_tiles, TILE), order, init_assign, n_vars)


def device_problem(problems, device=None) -> DeviceProblem:
    """One Problem's tensors, or a list's stacked on a query axis."""
    dev = _device.resolve(device)
    if isinstance(problems, Problem):
        arrays = (problems.lits, problems.valid, problems.order)
    else:
        arrays = [np.stack([getattr(p, f) for p in problems])
                  for f in ("lits", "valid", "order")]
    return DeviceProblem(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in arrays])


def initial_state(init_assign: np.ndarray, n_probes: int,
                  device=None) -> SolverState:
    """Every probe at its problem's initial assignment, nothing on the
    trail; `init_assign` int8[V1], or int8[Q, V1] for a batch."""
    dev = _device.resolve(device)
    lead = init_assign.shape[:-1] + (n_probes,)
    assign = np.broadcast_to(init_assign[..., None, :],
                             lead + init_assign.shape[-1:]).copy()
    return SolverState(
        assign=torch.from_numpy(assign).to(dev),
        trail=torch.zeros(assign.shape, dtype=torch.int32, device=dev),
        tag=torch.zeros(assign.shape, dtype=torch.int8, device=dev),
        trail_len=torch.zeros(lead, dtype=torch.int32, device=dev),
        status=torch.zeros(lead, dtype=torch.int8, device=dev))


def forced_depth_of(n_probes: int) -> int:
    return max(0, int(np.log2(max(1, n_probes))))


# ---- the plain twin of K11 --------------------------------------------------------

def _batched(state: SolverState, problem: DeviceProblem):
    """Views with a leading query axis: ([Q, P, V1] state, [Q, C, 3] lits,
    [Q, C] valid, [Q, V1] order)."""
    if state.assign.dim() == 2:
        state = SolverState(*[leaf.unsqueeze(0) for leaf in state])
        problem = DeviceProblem(*[leaf.unsqueeze(0) for leaf in problem])
    n_queries = state.assign.shape[0]
    return (state, problem.lits.reshape(n_queries, -1, 3),
            problem.valid.reshape(n_queries, -1), problem.order)


def _drop_scatter(base: torch.Tensor, index: torch.Tensor,
                  values) -> torch.Tensor:
    """`base` with values scattered along the last axis at `index`; an
    index equal to base's width is dropped (JAX's mode="drop")."""
    pad = torch.zeros(base.shape[:-1] + (1,), dtype=base.dtype,
                      device=base.device)
    wide = torch.cat([base, pad], dim=-1)
    if not isinstance(values, torch.Tensor):
        values = torch.full(index.shape, values, dtype=base.dtype,
                            device=base.device)
    wide.scatter_(-1, index, values.to(base.dtype))
    return wide[..., :-1]


def _set_at(base: torch.Tensor, index: torch.Tensor,
            values: torch.Tensor) -> torch.Tensor:
    """`base` with base[..., index[...]] = values[...] (one per row)."""
    return base.scatter(-1, index.long().unsqueeze(-1),
                        values.to(base.dtype).unsqueeze(-1))


def _shard_keys(key: torch.Tensor, unit_var: torch.Tensor, v1: int,
                shard: torch.Tensor, n_shards: int) -> torch.Tensor:
    """int64 [Q, P, D, V1]: each shard's key of each var, the highest of
    its clauses' keys ((clause + 1) << 1 | TRUE bit, 0: no unit) for that
    var (the last write of JAX's tile scan); var 0 never keyed."""
    n_queries, n_probes, _ = key.shape
    implied_key = torch.zeros((n_queries, n_probes, n_shards * v1),
                              dtype=torch.int64, device=key.device)
    implied_key.scatter_reduce_(-1, unit_var + shard * v1, key, "amax")
    implied_key = implied_key.view(n_queries, n_probes, n_shards, v1)
    implied_key[..., 0] = 0
    return implied_key


def _implied(key: torch.Tensor, unit_var: torch.Tensor, v1: int,
             shard: torch.Tensor, n_shards: int) -> torch.Tensor:
    """int8 [Q, P, V1] phase codes of the implied vars, from each clause's
    key ((clause + 1) << 1 | TRUE bit, 0: no unit), var and shard: inside
    each shard the highest clause's phase (`_shard_keys`), then the larger
    code over the shards (JAX's pmax over the "clauses" axis)."""
    implied_key = _shard_keys(key, unit_var, v1, shard, n_shards)
    phase = torch.where(implied_key == 0, _UNASSIGNED,
                        torch.where((implied_key & 1) == 1, _TRUE, _FALSE))
    return phase.amax(-2).to(torch.int8)


def _clause_units(assign: torch.Tensor, lits: torch.Tensor,
                  valid: torch.Tensor) -> tuple:
    """Unit propagation over every clause at once, on batched views: per
    (query, probe, clause) whether the clause is a conflict (every literal
    false), and its key ((clause + 1) << 1 | TRUE bit; 0 unless a unit
    clause) and unit var (0 unless a unit clause)."""
    n_queries, n_probes, _ = assign.shape
    n_clauses = lits.shape[1]
    lit64 = lits.long()
    var = lit64.abs()                                        # [Q, C, 3]
    av = torch.gather(assign, -1, var.reshape(n_queries, 1, -1).expand(
        -1, n_probes, -1)).reshape(n_queries, n_probes, n_clauses, 3)
    # the value that makes each literal true, and the one that leaves it
    # open; a pad slot (0) matches neither (3 is no assignment code)
    true_code = torch.where(lit64 > 0, _TRUE, _FALSE)
    true_code = torch.where(lit64 == 0, 3, true_code).to(torch.int8)[:, None]
    open_code = torch.where(lit64 == 0, 3, _UNASSIGNED).to(torch.int8)[:, None]
    val_true = av == true_code
    val_unassigned = av == open_code
    clause_sat = val_true.any(-1) | ~valid[:, None, :]       # [Q, P, C]
    n_un = val_unassigned.sum(-1)
    clause_conflict = ~clause_sat & (n_un == 0)
    unit_clause = ~clause_sat & (n_un == 1)
    # the first unassigned slot (argmax of a bool row)
    unit_slot = torch.where(val_unassigned[..., 0], 0,
                            torch.where(val_unassigned[..., 1], 1, 2))
    unit_lit = torch.gather(lit64[:, None].expand(-1, n_probes, -1, -1), -1,
                            unit_slot.unsqueeze(-1)).squeeze(-1)
    # the highest clause index decides a variable implied by several units
    # (inside each shard)
    clause = torch.arange(n_clauses, device=assign.device)
    key = torch.where(unit_clause, ((clause + 1) << 1) | (unit_lit > 0).long(),
                      0)
    unit_var = torch.where(unit_clause, unit_lit.abs(), 0)
    return clause_conflict, key, unit_var


def _step_batched(state: SolverState, lits: torch.Tensor, valid: torch.Tensor,
                  order: torch.Tensor, forced_depth: int,
                  frozen: Optional[torch.Tensor] = None,
                  n_shards: int = 1) -> SolverState:
    """One transition of JAX `_step` for every probe of every query, on
    batched views; queries with `frozen` set keep their state. With
    `n_shards` > 1, the step of the clause axis split into that many
    contiguous blocks (`_step` with axis_name)."""
    assign, trail, tag, trail_len, status = state
    n_queries, n_probes, v1 = assign.shape
    dev = assign.device
    searching = status == SEARCHING
    if frozen is not None:
        searching = searching & ~frozen[:, None]

    # ---- unit propagation over every clause at once ---------------------------
    n_clauses = lits.shape[1]
    clause_conflict, key, unit_var = _clause_units(assign, lits, valid)
    conflict = clause_conflict.any(-1)                       # [Q, P]
    clause = torch.arange(n_clauses, device=dev)
    implied = _implied(key, unit_var, v1, clause // (n_clauses // n_shards),
                       n_shards)
    newly = (implied != 0) & (assign == _UNASSIGNED)         # [Q, P, V1]
    has_units = newly.any(-1)

    pos = torch.arange(v1, device=dev)
    len64 = trail_len.long()

    # ---- branch 1: assert all unit literals ------------------------------------
    u_assign = torch.where(newly, implied, assign)
    new_rank = newly.long().cumsum(-1) - 1
    append_pos = torch.where(newly, len64[..., None] + new_rank, v1)
    append_pos = append_pos.clamp(max=v1)
    signed = torch.where(implied == _TRUE, 1, -1) * pos
    u_trail = _drop_scatter(trail, append_pos, signed)
    u_tag = _drop_scatter(tag, append_pos, 0)
    u_len = trail_len + newly.sum(-1).to(torch.int32)

    # ---- branch 2: backtrack ----------------------------------------------------
    in_trail = pos < len64[..., None]
    flippable = (tag == 1) & in_trail
    has_flip = flippable.any(-1)
    last_flip = torch.where(flippable, pos, -1).amax(-1)
    flip_pos = torch.where(has_flip, last_flip, 0)
    kill = in_trail & (pos > flip_pos[..., None])
    kill_var = torch.where(kill, trail.long().abs(), v1)
    b_assign = _drop_scatter(assign, kill_var, 0)
    flip_lit = torch.gather(trail, -1, flip_pos.unsqueeze(-1)).squeeze(-1)
    flip_var = flip_lit.long().abs()
    new_phase = torch.where(flip_lit > 0, _FALSE, _TRUE)
    current = torch.gather(b_assign, -1, flip_var.unsqueeze(-1)).squeeze(-1)
    b_assign = _set_at(b_assign, flip_var,
                       torch.where(has_flip, new_phase, current.long()))
    b_trail = _set_at(trail, flip_pos, -flip_lit)
    b_tag = _set_at(tag, flip_pos, torch.full_like(flip_pos, 2))
    b_len = torch.where(has_flip, (flip_pos + 1).to(torch.int32), trail_len)
    b_status = torch.where(has_flip, SEARCHING, S_UNSAT).to(torch.int8)

    # ---- branch 3: decide -------------------------------------------------------
    free = assign == _UNASSIGNED
    free[..., 0] = False
    any_free = free.any(-1)
    pick_rank = torch.where(free, order[:, None, :].long(), _NOT_FREE)
    # argmin, first index on ties
    d_var = ((pick_rank << 32) | pos).amin(-1) & 0xFFFFFFFF
    level = ((tag >= 1) & in_trail).sum(-1)
    in_prefix = level < forced_depth
    probe = torch.arange(n_probes, device=dev)[None, :]
    probe_bit = (probe >> level.clamp(0, 30)) & 1
    d_phase_true = in_prefix & (probe_bit == 1)
    d_assign = _set_at(assign, d_var, torch.where(d_phase_true, _TRUE, _FALSE))
    d_pos = len64.clamp(0, v1 - 1)
    d_trail = _set_at(trail, d_pos, torch.where(d_phase_true, d_var, -d_var))
    d_tag = _set_at(tag, d_pos, torch.where(in_prefix, 2, 1))
    d_len = trail_len + 1

    # ---- combine: conflict > units > all-assigned (SAT) > decide ----------------
    take_b = searching & conflict
    take_u = searching & ~conflict & has_units
    take_sat = searching & ~conflict & ~has_units & ~any_free
    take_d = searching & ~conflict & ~has_units & any_free

    def mix(bt, un, de, old):
        m_b, m_u, m_d = take_b, take_u, take_d
        if bt.dim() > m_b.dim():
            m_b, m_u, m_d = m_b[..., None], m_u[..., None], m_d[..., None]
        out = torch.where(m_b, bt, old)
        out = torch.where(m_u, un, out)
        return torch.where(m_d, de, out)

    new_status = torch.where(take_b, b_status, status)
    new_status = torch.where(take_sat, torch.tensor(S_SAT, dtype=torch.int8,
                                                    device=dev), new_status)
    return SolverState(mix(b_assign, u_assign, d_assign, assign),
                       mix(b_trail, u_trail, d_trail, trail),
                       mix(b_tag, u_tag, d_tag, tag),
                       mix(b_len, u_len, d_len, trail_len), new_status)


def _decided(status: torch.Tensor) -> torch.Tensor:
    """Per query of a [Q, P] status: some probe SAT or none searching."""
    return (status == S_SAT).any(-1) | (status != SEARCHING).all(-1)


def step_reference(state: SolverState, problem: DeviceProblem,
                   forced_depth: int) -> SolverState:
    """The plain twin of one K11 step: JAX `_step` (vmapped over a leading
    query axis, if any). Pure: returns new tensors."""
    batched, lits, valid, order = _batched(state, problem)
    new = _step_batched(batched, lits, valid, order, forced_depth)
    if state.assign.dim() == 2:
        new = SolverState(*[leaf.squeeze(0) for leaf in new])
    return new


def _run_twin(state: SolverState, problem: DeviceProblem, chunk: int,
              forced_depth: int, freeze: bool, n_shards: int) -> SolverState:
    """`chunk` twin steps in place."""
    batched, lits, valid, order = _batched(state, problem)
    current = batched
    for _ in range(chunk):
        frozen = _decided(current.status) if freeze else None
        current = _step_batched(current, lits, valid, order, forced_depth,
                                frozen, n_shards)
    for leaf, value in zip(batched, current):
        leaf.copy_(value)
    return state


def run_chunk_reference(state: SolverState, problem: DeviceProblem,
                        chunk: int, forced_depth: int,
                        freeze: bool = False) -> SolverState:
    """The plain twin of `run_chunk`, in place: `chunk` steps as JAX
    `_get_runner` (freeze False) or `_get_batch_runner` (freeze True: a
    query stops once one probe is SAT or none is searching)."""
    return _run_twin(state, problem, chunk, forced_depth, freeze, 1)


def run_chunk_sharded_reference(state: SolverState, problem: DeviceProblem,
                                chunk: int, forced_depth: int,
                                n_shards: int) -> SolverState:
    """The plain twin of `run_chunk_sharded`, in place: `chunk` steps as
    JAX `_get_sharded_runner` over `n_shards` devices (the tiles must
    divide); a batch-shaped state steps each query so."""
    n_tiles = problem.valid.shape[-2]
    if n_shards < 1 or n_tiles % n_shards:
        raise ValueError(f"{n_tiles} clause tiles do not split over "
                         f"{n_shards} shards")
    return _run_twin(state, problem, chunk, forced_depth, False, n_shards)


# ---- the kernel path ------------------------------------------------------------

def run_chunk(state: SolverState, problem: DeviceProblem, chunk: int,
              forced_depth: int, freeze: bool = False,
              graph: bool = True) -> SolverState:
    """`chunk` DPLL steps of every probe, in place: K11 on CUDA tensors
    (the chunk's CUDA graph, captured once for these tensors and replayed;
    `graph=False`: one host call that launches every step), the twin on
    CPU tensors."""
    if not state.assign.is_cuda:
        return run_chunk_reference(state, problem, chunk, forced_depth, freeze)
    from ..kernels import ops

    return ops.sat_run(state, problem, chunk, forced_depth, freeze, graph)


def run_chunk_sharded(state: SolverState, problem: DeviceProblem,
                      chunk: int, forced_depth: int, mesh: tuple
                      ) -> SolverState:
    """`chunk` steps of the clause-sharded route over `mesh` (one shard a
    device), in place: K13 on CUDA tensors (a mesh all on the state's card:
    one replay of the chunk's CUDA graph; a mesh of several cards: every
    shard's launches and the planes' copies, a step at a time), the twin
    on CPU tensors."""
    if not state.assign.is_cuda:
        return run_chunk_sharded_reference(state, problem, chunk,
                                           forced_depth, len(mesh))
    from ..kernels import ops

    return ops.sat_run_sharded(state, problem, chunk, forced_depth, mesh)


def step(state: SolverState, problem: DeviceProblem,
         forced_depth: int) -> SolverState:
    """One DPLL step of every probe, in place (K11 on CUDA tensors)."""
    return run_chunk(state, problem, 1, forced_depth)


# ---- shape accounting and the serve warm hooks -----------------------------------

#: shape keys whose chunk has run at least once in this process
_SHAPES_RUN: set = set()

#: sanity bounds for manifest-sourced shape keys (JAX jax_solver.py:639-645):
#: a corrupt or hostile manifest must not allocate arbitrary device memory
#: at daemon start
_WARM_MAX_TILES = 1 << 12
_WARM_MAX_VARS = 1 << 22
_WARM_MAX_PROBES = 1 << 10
_WARM_MAX_BATCH = 1 << 12
_WARM_MAX_CHUNK = 1 << 12


def _run_accounted(shape_key: tuple, state: SolverState,
                   problem: DeviceProblem, chunk: int, forced_depth: int,
                   freeze: bool = False, mesh: Optional[tuple] = None
                   ) -> SolverState:
    """`run_chunk` (`run_chunk_sharded` over `mesh`) with the JAX bucket
    accounting (jax_solver.py:91): the first run of `shape_key` in this
    process counts ``xla.bucket_compiles``, every later run
    ``xla.bucket_reuses``."""
    if shape_key in _SHAPES_RUN:
        metrics.inc("xla.bucket_reuses")
    else:
        _SHAPES_RUN.add(shape_key)
        metrics.inc("xla.bucket_compiles")
    if mesh is not None:
        return run_chunk_sharded(state, problem, chunk, forced_depth, mesh)
    return run_chunk(state, problem, chunk, forced_depth, freeze)


def observed_shape_keys() -> List[tuple]:
    """Every shape key run in this process, sorted: what the serve warm
    set writes into its manifest."""
    return sorted(_SHAPES_RUN)


def warm_shape_key(key, device=None) -> bool:
    """Run one chunk of K11 (K13 for a key of more than one device) at a
    manifest key's padded shapes, on a zero-clause problem (every probe
    just decides variables), so that the key counts as run (JAX
    `warm_shape_key`, jax_solver.py:646).

    Returns False for a malformed key, one out of the sanity bounds, or a
    sharded key the mesh cannot host (fewer devices than the key names, or
    tiles that do not divide over them); True for a key already run. Any
    failure of a well-formed key raises, as every kernel failure does."""
    try:
        key = tuple(key)
        kind = key[0]
        if kind == "single":
            _, n_devices, chunk, forced_depth, n_tiles, v1, n_probes = key
            n_padded = 0
        elif kind == "batch":
            _, chunk, forced_depth, n_tiles, v1, n_padded, n_probes = key
            n_devices = 1
        else:
            return False
        dims = [n_devices, chunk, forced_depth, n_tiles, v1, n_probes]
        if kind == "batch":
            dims.append(n_padded)
        if not all(isinstance(d, int) and d >= 0 for d in dims):
            return False
        if not (0 < n_tiles <= _WARM_MAX_TILES
                and 0 < v1 <= _WARM_MAX_VARS
                and 0 < n_probes <= _WARM_MAX_PROBES
                and 0 < chunk <= _WARM_MAX_CHUNK
                and forced_depth <= 30
                and (kind != "batch" or 0 < n_padded <= _WARM_MAX_BATCH)):
            return False
    except (TypeError, ValueError, IndexError):
        return False
    if key in _SHAPES_RUN:
        return True
    dev = _device.resolve(device)
    mesh = None
    if n_devices > 1:
        mesh = mesh_devices(dev)
        if len(mesh) < n_devices or n_tiles % n_devices:
            return False
        mesh = mesh[:n_devices]
        dev = mesh[0]
    problem = Problem(np.zeros((n_tiles, TILE, 3), dtype=np.int32),
                      np.zeros((n_tiles, TILE), dtype=bool),
                      np.arange(v1, dtype=np.int32),
                      np.zeros(v1, dtype=np.int8), 0)
    if kind == "batch":
        tensors = device_problem([problem] * n_padded, dev)
        init_assign = np.zeros((n_padded, v1), dtype=np.int8)
    else:
        tensors = device_problem(problem, dev)
        init_assign = problem.init_assign
    state = initial_state(init_assign, n_probes, dev)
    _run_accounted(key, state, tensors, chunk, forced_depth,
                   freeze=kind == "batch", mesh=mesh)
    return True


# ---- entry points ---------------------------------------------------------------

def _model(assign_row: torch.Tensor, n_vars: int) -> List[bool]:
    row = assign_row.cpu().numpy()
    return [bool(value == _TRUE) for value in row[1:n_vars + 1]]


def solve_cnf_device(clauses: List[List[int]], n_vars: int,
                     n_probes: int = 32, max_steps: int = 20_000,
                     chunk: int = 256, clause_cap: int = DEFAULT_CLAUSE_CAP,
                     scheme: str = "coarse", device=None
                     ) -> Tuple[int, Optional[List[bool]]]:
    """Solve a CNF on the card: (status, model) with model[v-1] the value
    of DIMACS var v, as JAX `solve_cnf_device`: over the configured mesh's
    clause shards when it shards (`configure`) and the tiles divide over
    it, else on `device`.

    Returns UNKNOWN (never raises, never guesses) when the problem exceeds
    `clause_cap` times the mesh's shard count, or `clause_cap` when its
    tiles do not divide over the mesh."""
    dev = _device.resolve(device)
    if not clauses:
        # trivially satisfiable: padding with a zero row would fabricate an
        # empty (always-false) clause
        return SAT, [False] * n_vars
    for clause in clauses:
        if not clause:
            return UNSAT, None
    mesh = mesh_devices(dev)
    n_devices = shard_count(mesh)
    if len(clauses) > clause_cap * n_devices:
        return UNKNOWN, None

    problem = build_problem(clauses, n_vars, scheme=scheme)
    forced_depth = forced_depth_of(n_probes)
    n_tiles = problem.lits.shape[0]
    if n_devices > 1 and n_tiles % n_devices == 0 and n_tiles >= n_devices:
        dev = mesh[0]
    else:
        # the mesh-scaled cap holds only where the tiles shard
        if len(clauses) > clause_cap:
            return UNKNOWN, None
        mesh = None
    tensors = device_problem(problem, dev)
    state = initial_state(problem.init_assign, n_probes, dev)
    shape_key = ("single", n_devices, chunk, forced_depth, n_tiles,
                 problem.order.shape[0], n_probes)
    steps = 0
    while steps < max_steps:
        _run_accounted(shape_key, state, tensors, chunk, forced_depth,
                       mesh=mesh)
        steps += chunk
        status = state.status.cpu().numpy()
        if (status == S_SAT).any() or (status != SEARCHING).all():
            break

    status = state.status.cpu().numpy()
    sat_lanes = np.nonzero(status == S_SAT)[0]
    if len(sat_lanes):
        return SAT, _model(state.assign[int(sat_lanes[0])], problem.n_vars)
    if (status == S_UNSAT).all():
        return UNSAT, None
    return UNKNOWN, None


def solve_cnf_device_batch(queries: List[Tuple[List[List[int]], int]],
                           n_probes: int = 32, max_steps: int = 20_000,
                           chunk: int = 256,
                           clause_cap: Optional[int] = None,
                           scheme: str = "coarse", device=None
                           ) -> List[Tuple[int, Optional[List[bool]]]]:
    """Solve many independent CNFs in shape-bucketed batches on the card,
    as JAX `solve_cnf_device_batch`: one (status, model) per query,
    aligned; trivial cases answer on the host, oversize queries return
    UNKNOWN.

    Problems bucket by their padded (n_tiles, v1) shape, and the query axis
    pads by repeating the last problem; a bucket's loop stops once every
    REAL query in it has a verdict. `clause_cap=None` reads
    DEFAULT_CLAUSE_CAP at call time."""
    dev = _device.resolve(device)
    if clause_cap is None:
        clause_cap = DEFAULT_CLAUSE_CAP
    results: List[Optional[Tuple[int, Optional[List[bool]]]]] = \
        [None] * len(queries)
    buckets: dict = {}  # (n_tiles, v1) -> [(query index, Problem)]
    for index, (clauses, n_vars) in enumerate(queries):
        if not clauses:
            results[index] = (SAT, [False] * n_vars)
            continue
        if any(not clause for clause in clauses):
            results[index] = (UNSAT, None)
            continue
        if len(clauses) > clause_cap:
            results[index] = (UNKNOWN, None)
            continue
        problem = build_problem(clauses, n_vars, scheme=scheme)
        key = (problem.lits.shape[0], problem.order.shape[0])
        buckets.setdefault(key, []).append((index, problem))

    forced_depth = forced_depth_of(n_probes)
    for (n_tiles, v1), group in buckets.items():
        n_real = len(group)
        n_padded = bucket_batch(n_real, scheme)
        problems = [problem for _, problem in group]
        problems += [problems[-1]] * (n_padded - n_real)
        SolverStatistics().batch_bucket_shapes.add((n_tiles, v1, n_padded))

        tensors = device_problem(problems, dev)
        state = initial_state(np.stack([p.init_assign for p in problems]),
                              n_probes, dev)
        shape_key = ("batch", chunk, forced_depth, n_tiles, v1, n_padded,
                     n_probes)
        steps = 0
        while steps < max_steps:
            _run_accounted(shape_key, state, tensors, chunk, forced_depth,
                           freeze=True)
            steps += chunk
            status = state.status.cpu().numpy()[:n_real]
            if ((status == S_SAT).any(axis=1)
                    | (status != SEARCHING).all(axis=1)).all():
                break

        status = state.status.cpu().numpy()
        for slot, (index, problem) in enumerate(group):
            sat_lanes = np.nonzero(status[slot] == S_SAT)[0]
            if len(sat_lanes):
                results[index] = (SAT, _model(
                    state.assign[slot, int(sat_lanes[0])], problem.n_vars))
            elif (status[slot] == S_UNSAT).all():
                results[index] = (UNSAT, None)
            else:
                results[index] = (UNKNOWN, None)
    return results
