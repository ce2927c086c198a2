"""The port's checkpoints and resume (mythril_tpu_torch/support/
checkpoint.py, `core/svm.py`'s saves and resume, `parallel/frontier.py`
`DeviceFrontier.save_checkpoint`/`load_checkpoint`) against the JAX
package's, on the CPU.

- The device frontier's .npz (the cases of tests/test_frontier_checkpoint.py
  on the plain twins): a save and load on the port continues bit for bit;
  the port's arrays at a save point equal the JAX frontier's key by key,
  dtypes and shapes included, for the JAX test's direct save and for the
  drain loop's periodic save with rows held in the scheduler; and the port
  continues bit for bit from an .npz the JAX frontier wrote.
- The host checkpoint (the cases of tests/test_checkpoint_resume.py and the
  checkpoint cases of tests/test_resilience.py) on the port's analyzer: a
  resume from a transaction boundary and from a run killed mid-transaction
  (`host_crash`) gives the uninterrupted run's issues, the witness held by
  `report_parity`'s rule (tests/_torch_engine.py); payloads round-trip
  with interned terms; a corrupt, truncated, foreign-format or JAX-written
  checkpoint degrades to a fresh run, the JAX-written one without
  importing `mythril_tpu` (a fresh process).
- `analyze --engine tpu --checkpoint` on the device driver's twins: the
  frontier's `.device` files and the periodic save's hand-off of the
  deferred rows."""

import contextlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import __graft_entry__ as graft  # noqa: E402
from _torch_engine import JAX, PORT, replay_reaches, run_on  # noqa: E402
from _torch_parity import (assert_same, np_tree, seed_frontier,  # noqa: E402
                           to_port)
from chip_smoke import KILLBILLY, branchy_contract  # noqa: E402
from mythril_tpu.parallel import arena as jarena  # noqa: E402
from mythril_tpu.parallel import frontier as jf  # noqa: E402
from mythril_tpu.parallel import symstep as jsym  # noqa: E402
from mythril_tpu.support import checkpoint as jcheckpoint  # noqa: E402
from mythril_tpu.support import resilience as jresilience  # noqa: E402
from mythril_tpu_torch.frontends.asm import assemble, dispatcher  # noqa: E402
from mythril_tpu_torch.parallel import convert  # noqa: E402
from mythril_tpu_torch.parallel import frontier as pf  # noqa: E402
from mythril_tpu_torch.parallel import symstep as psym  # noqa: E402
from mythril_tpu_torch.support import checkpoint as pcheckpoint  # noqa: E402
from mythril_tpu_torch.support import resilience as presilience  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_LANES = 8
CHECKPOINT = {"jax": jcheckpoint, "port": pcheckpoint}
RESILIENCE = {"jax": jresilience, "port": presilience}


@pytest.fixture(autouse=True)
def _one_thread():
    """The twins on one torch thread (beside other test processes a pool
    of threads per small op costs more than it gives)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# ---- the device frontier's .npz ---------------------------------------------------

def graft_point():
    """tests/test_frontier_checkpoint.py's save point on both packages:
    the graft entry's symbolic batch at 8 lanes, a 1<<10-row arena, four
    driver-less steps, forks 3 and lane-steps 123. Returns the JAX
    (frontier, state, planes) and the port's."""
    state, planes = graft._symbolic_batch(N_LANES)
    jfr = jf._Frontier(laser_evm=None, n_lanes=N_LANES)
    jfr.arena = jarena.new_arena(capacity=1 << 10, const_capacity=1 << 6)
    pstate, pplanes = to_port("state", state), to_port("planes", planes)
    pfr = pf.DeviceFrontier(N_LANES, device="cpu",
                            arena=to_port("arena", jfr.arena))
    state, planes, jfr.arena = jsym.sym_step_many(state, planes, jfr.arena, 4)
    pstate, pplanes, pfr.arena = psym.sym_step_many(pstate, pplanes,
                                                    pfr.arena, 4)
    for fr in (jfr, pfr):
        fr.forks, fr.lane_steps = 3, 123
    return (jfr, state, planes), (pfr, pstate, pplanes)


def npz_arrays(path) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return {key: data[key] for key in data.files}


def assert_same_arrays(got: dict, want: dict, what: str) -> None:
    """Key by key: the same keys, dtypes, shapes and values."""
    assert sorted(got) == sorted(want), what
    for key, array in want.items():
        assert got[key].dtype == array.dtype, f"{what} {key}: dtype"
        assert got[key].shape == array.shape, f"{what} {key}: shape"
        assert np.array_equal(got[key], array), f"{what} {key} differs"


def continue_port(fr, state, planes):
    """Four driver-less twin steps from a frontier's trees, on copies."""
    state, planes, arena = psym.sym_step_many(
        convert.clone(state), convert.clone(planes), convert.clone(fr.arena),
        4)
    return convert.to_numpy(state), convert.to_numpy(planes), \
        convert.to_numpy(arena)


def assert_same_trees(got, want, what: str) -> None:
    for part_got, part_want in zip(got, want):
        for name, leaf in zip(part_want._fields, part_want):
            np.testing.assert_array_equal(
                np.asarray(getattr(part_got, name)), np.asarray(leaf),
                err_msg=f"{what}: {name}")


def test_checkpoint_roundtrip_and_identical_continuation(tmp_path):
    """tests/test_frontier_checkpoint.py on the port's twins: the counters
    and the arena's fill come back, and both continuations are bit for
    bit the same."""
    _, (fr, state, planes) = graft_point()
    path = fr.save_checkpoint(str(tmp_path / "frontier"), state, planes)
    assert path.endswith(".npz") and not os.path.exists(path + ".tmp")
    restored = pf.DeviceFrontier(N_LANES, device="cpu")
    r_state, r_planes = restored.load_checkpoint(path)
    assert (restored.forks, restored.lane_steps) == (3, 123)
    assert int(restored.arena.n) == int(fr.arena.n)
    assert restored.harena is None
    assert_same_trees(continue_port(restored, r_state, r_planes),
                      continue_port(fr, state, planes), "continuation")


def test_npz_equals_the_jax_frontiers_key_by_key(tmp_path):
    """At the same save point the port writes the JAX frontier's arrays:
    every key, dtype, shape and value, the pickled host terms and contract
    ids (none here) included."""
    (jfr, jstate, jplanes), (pfr, pstate, pplanes) = graft_point()
    jfr.save_checkpoint(str(tmp_path / "jax.npz"), jstate, jplanes)
    pfr.save_checkpoint(str(tmp_path / "port.npz"), pstate, pplanes)
    assert_same_arrays(npz_arrays(tmp_path / "port.npz"),
                       npz_arrays(tmp_path / "jax.npz"), "graft point")


def test_port_continues_from_the_jax_npz(tmp_path):
    """The port loads an .npz the JAX frontier wrote and continues bit for
    bit as the JAX package continues its own trees."""
    (jfr, jstate, jplanes), _ = graft_point()
    path = str(tmp_path / "jax.npz")
    jfr.save_checkpoint(path, jstate, jplanes)
    fr = pf.DeviceFrontier(N_LANES, device="cpu")
    state, planes = fr.load_checkpoint(path)
    assert (fr.forks, fr.lane_steps, fr.pending) == (3, 123, [])
    assert_same(jstate, state, "loaded state ")
    assert_same(jplanes, planes, "loaded planes ")
    assert_same(jfr.arena, fr.arena, "loaded arena ")
    want = np_tree(jsym.sym_step_many(jstate, jplanes, jfr.arena, 4))
    assert_same_trees(continue_port(fr, state, planes), want,
                      "continuation from the JAX .npz")


#: the drain loop's periodic save: branchy(6) at 16 lanes and chunk 4, so
#: the save every 16 chunks lands with rows in the sibling stack
DRIVE_LANES, DRIVE_CHUNK, DRIVE_BRANCHES = 16, 4, 6


@contextlib.contextmanager
def no_budget():
    """Both packages' global execution budgets disarmed (an earlier
    analysis in the process may leave its clock expired, and a drive with
    no time left hands its lanes over at once), then restored."""
    handlers = (JAX.time_handler, PORT.time_handler)
    saved = [(h._start_time, h._execution_time) for h in handlers]
    for handler in handlers:
        handler.reset()
    try:
        yield
    finally:
        for handler, (start, budget) in zip(handlers, saved):
            handler._start_time, handler._execution_time = start, budget


def drive_save_point(side: str, tmp_path):
    """The first periodic save of the drain loop on one package, with the
    telemetry and merging off: the .npz's arrays (copied before the drive
    deletes it at its end) and the trees the loop saved."""
    code = assemble(dispatcher({"stress()": branchy_contract(
        DRIVE_BRANCHES)}))
    state, planes, arena = seed_frontier([code], DRIVE_LANES,
                                         arena_capacity=1 << 16)
    saved = []
    path = str(tmp_path / f"{side}.npz")
    if side == "jax":
        fr = jf._Frontier(laser_evm=None, n_lanes=DRIVE_LANES)
        fr.arena = arena
        fr.telemetry_enabled = False
        fr.state_merge = False
        original = fr.save_checkpoint

        def save(target, *trees, **kwargs):
            original(target, *trees, **kwargs)
            if not saved:
                saved.append(npz_arrays(target))

        fr.save_checkpoint = save
        with pytest.MonkeyPatch.context() as patch, no_budget():
            patch.setenv("MYTHRIL_TPU_CHUNK", str(DRIVE_CHUNK))
            patch.setenv("MYTHRIL_TPU_CHECKPOINT", path)
            fr.run(state, planes)
    else:
        fr = pf.DeviceFrontier(
            DRIVE_LANES, device="cpu", chunk=DRIVE_CHUNK,
            arena=to_port("arena", arena), telemetry=False,
            state_merge=False, **dict(zip(
                ("tag_pcs", "tag_names", "merge_pcs", "merge_names",
                 "mem_pcs", "mem_words"),
                [[], [], [], [], [], []])))
        fr.checkpoint_path = path
        original = fr.save_checkpoint

        def save(target, *trees, **kwargs):
            written = original(target, *trees, **kwargs)
            if not saved:
                saved.append(npz_arrays(written))
            return written

        fr.save_checkpoint = save
        with no_budget():
            fr.run(to_port("state", state), to_port("planes", planes))
    assert not os.path.exists(path), "a drained drive keeps its checkpoint"
    return saved[0]


def test_periodic_save_equals_the_jax_drive_key_by_key(tmp_path):
    """The drain loop's save every 16 chunks (scheduler rows saved as
    pending rows through K7's twin) writes the JAX loop's arrays."""
    port = drive_save_point("port", tmp_path)
    jax = drive_save_point("jax", tmp_path)
    assert "pend_state_status" in jax, "no scheduler rows at the save point"
    assert_same_arrays(port, jax, "periodic save")


# ---- the host checkpoint ------------------------------------------------------------

def analyze(side, tx_count, modules, checkpoint=None, resume=None):
    """tests/test_checkpoint_resume.py's `_analyze` on one side: KILLBILLY's
    creation code through SymExecWrapper, bfs, the host engine."""
    from importlib import import_module

    package = "mythril_tpu" if side is JAX else "mythril_tpu_torch"
    security = import_module(package + ".analysis.security")
    symbolic = import_module(package + ".analysis.symbolic")
    security.reset_callback_modules()
    creation = side.asm.creation_wrapper(
        side.asm.assemble(side.asm.dispatcher(KILLBILLY)))
    wrapper = symbolic.SymExecWrapper(
        creation.hex(), address=None, strategy="bfs", max_depth=128,
        execution_timeout=240, create_timeout=30,
        transaction_count=tx_count, modules=modules,
        compulsory_statespace=False, checkpoint_path=checkpoint,
        resume_path=resume)
    return security.fire_lasers(wrapper, white_list=modules)


def issue_view(issues) -> list:
    return [(issue.swc_id, issue.address, issue.function) for issue in issues]


def witness_parity(got, want) -> None:
    """`report_parity`'s rule for one issue's witness: equal, or the port's
    replayed concretely on its engine reaches the issue."""
    steps = got.transaction_sequence["steps"]
    if [step["input"] for step in steps] == \
            [step["input"] for step in want.transaction_sequence["steps"]]:
        return
    assert replay_reaches(steps,
                          got.transaction_sequence["initialState"]["accounts"],
                          got.address)


def tx_boundary_resume(side, tmp_path):
    modules = ["AccidentallyKillable"]
    full = analyze(side, 2, modules)
    ckpt = str(tmp_path / f"{side.name}-analysis.ckpt")
    partial = analyze(side, 1, modules, checkpoint=ckpt)
    assert partial == [] and os.path.exists(ckpt)
    resumed = analyze(side, 2, modules, resume=ckpt)
    return full, resumed


def test_resume_from_tx_boundary_finds_identical_issues(tmp_path):
    """Cut after the first transaction, resume into the second: the
    2-transaction selfdestruct is found as by the uninterrupted run, on
    both packages alike."""
    jax_full, jax_resumed = run_on(JAX, tx_boundary_resume, tmp_path)
    full, resumed = run_on(PORT, tx_boundary_resume, tmp_path)
    assert issue_view(resumed) == issue_view(full) == \
        issue_view(jax_resumed) == issue_view(jax_full)
    assert [issue.swc_id for issue in resumed] == ["106"]
    witness_parity(resumed[0], full[0])


def payload_roundtrip(side, tmp_path):
    ckpt = str(tmp_path / f"{side.name}-payload.ckpt")
    analyze(side, 1, ["AccidentallyKillable"], checkpoint=ckpt)
    payload = CHECKPOINT[side.name].load_host_checkpoint(ckpt)
    assert payload is not None and payload["open_states"]
    for constraint in payload["open_states"][0].constraints:
        assert pickle.loads(pickle.dumps(constraint.raw)) is constraint.raw
    return [payload["tx_index"], len(payload["open_states"]),
            len(payload["work_list"]), payload["total_states"],
            payload["contract_id"], sorted(payload["detectors"])]


def test_checkpoint_payload_roundtrip(tmp_path):
    """The payload restores the worklist's structure, terms interned; its
    shape is the JAX package's."""
    port = run_on(PORT, payload_roundtrip, tmp_path)
    assert port == run_on(JAX, payload_roundtrip, tmp_path)
    assert port[0] == 1


def test_corrupt_checkpoint_degrades_to_fresh_run(tmp_path):
    ckpt = tmp_path / "garbage.ckpt"
    ckpt.write_bytes(b"not a pickle")
    issues = run_on(PORT, lambda side: analyze(
        side, 2, ["AccidentallyKillable"], resume=str(ckpt)))
    assert [issue.swc_id for issue in issues] == ["106"]


def rejects_missing_keys(side, tmp_path):
    cp = CHECKPOINT[side.name]
    path = tmp_path / f"{side.name}-truncated.ckpt"
    loaded = []
    for payload in ({"version": cp.FORMAT_VERSION, "tx_index": 1},
                    ["not", "a", "dict"], {"version": cp.FORMAT_VERSION + 1}):
        with open(path, "wb") as handle:
            pickle.dump(payload, handle)
        loaded.append(cp.load_host_checkpoint(str(path)))
    return [cp.FORMAT_VERSION, cp.REQUIRED_KEYS, loaded]


def test_load_checkpoint_rejects_missing_keys(tmp_path):
    port = rejects_missing_keys(PORT, tmp_path)
    assert port == rejects_missing_keys(JAX, tmp_path)
    assert port[2] == [None, None, None]


def test_fsync_replace_promotes_atomically(tmp_path):
    for name, cp in CHECKPOINT.items():
        target = tmp_path / f"{name}.bin"
        target.write_bytes(b"old")
        tmp = tmp_path / f"{name}.bin.tmp"
        tmp.write_bytes(b"new")
        cp.fsync_replace(str(tmp), str(target))
        assert target.read_bytes() == b"new" and not tmp.exists()
    assert pcheckpoint.request_checkpoint_path("/x", "a/b c") == \
        jcheckpoint.request_checkpoint_path("/x", "a/b c")


def killed_and_resumed(side, tmp_path, monkeypatch):
    """tests/test_resilience.py's kill: a save every 5 popped states, the
    13th kills the run; the resumed run finishes it."""
    modules = ["AccidentallyKillable"]
    full = analyze(side, 2, modules)
    if side is JAX:
        monkeypatch.setenv("MYTHRIL_TPU_CHECKPOINT_STATES", "5")
    else:
        pcheckpoint.configure(state_interval=5)
    ckpt = str(tmp_path / f"{side.name}-killed.ckpt")
    resilience = RESILIENCE[side.name]
    resilience.configure("host_crash:13")
    try:
        with pytest.raises(resilience.InjectedCrash):
            analyze(side, 2, modules, checkpoint=ckpt)
    finally:
        pcheckpoint.configure()
        monkeypatch.delenv("MYTHRIL_TPU_CHECKPOINT_STATES", raising=False)
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".tmp")
    payload = CHECKPOINT[side.name].load_host_checkpoint(ckpt)
    resilience.configure(None)
    resumed = analyze(side, 2, modules, resume=ckpt)
    return full, resumed, (payload["tx_index"], len(payload["work_list"]))


def test_killed_run_resumes_from_atomic_checkpoint(tmp_path, monkeypatch):
    """A run killed mid-transaction (`host_crash`) resumes from its last
    atomic checkpoint to the uninterrupted run's issues, saved at the same
    point as the JAX package's."""
    jax_full, jax_resumed, jax_saved = run_on(
        JAX, killed_and_resumed, tmp_path, monkeypatch)
    full, resumed, saved = run_on(PORT, killed_and_resumed, tmp_path,
                                  monkeypatch)
    assert saved == jax_saved
    assert issue_view(resumed) == issue_view(full) == \
        issue_view(jax_resumed) == issue_view(jax_full)
    assert [issue.swc_id for issue in resumed] == ["106"]
    witness_parity(resumed[0], full[0])


#: a fresh process resumes the port's analysis from a JAX-written checkpoint
FOREIGN_RESUME = """
import json, logging, sys
sys.path.insert(0, sys.argv[2])
messages = []
handler = logging.Handler()
handler.emit = lambda record: messages.append(record.getMessage())
logging.getLogger("mythril_tpu_torch.support.checkpoint").addHandler(handler)
from mythril_tpu_torch.analysis.security import fire_lasers
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.frontends.asm import (assemble, creation_wrapper,
                                             dispatcher)
from chip_smoke import KILLBILLY
modules = ["AccidentallyKillable"]
wrapper = SymExecWrapper(
    creation_wrapper(assemble(dispatcher(KILLBILLY))).hex(), address=None,
    strategy="bfs", max_depth=128, execution_timeout=240, create_timeout=30,
    transaction_count=2, modules=modules, compulsory_statespace=False,
    resume_path=sys.argv[1])
issues = fire_lasers(wrapper, white_list=modules)
print(json.dumps({
    "issues": [[issue.swc_id, issue.address] for issue in issues],
    "imported": sorted(name for name in sys.modules
                       if name.split(".")[0] == "mythril_tpu"),
    "refused": any("not a class of mythril_tpu_torch" in message
                   for message in messages)}))
"""


def test_jax_checkpoint_degrades_to_a_fresh_run(tmp_path):
    """A host checkpoint the JAX package wrote names its classes: the port
    refuses it before importing any (`_PortUnpickler`), warns, and runs
    fresh, to the issues of a run with no checkpoint — in a fresh process,
    which never imports `mythril_tpu`."""
    import json

    ckpt = str(tmp_path / "jax.ckpt")
    run_on(JAX, lambda side: analyze(side, 1, ["AccidentallyKillable"],
                                     checkpoint=ckpt))
    with open(ckpt, "rb") as handle:
        assert b"mythril_tpu.smt.terms" in handle.read()
    with open(ckpt, "rb") as handle, \
            pytest.raises(pcheckpoint.ForeignPayload):
        pcheckpoint._PortUnpickler(handle).load()
    proc = subprocess.run(
        [sys.executable, "-c", FOREIGN_RESUME, ckpt,
         os.path.join(REPO, "tests")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"issues": [["106", 52]], "imported": [],
                      "refused": True}, result


# ---- the device driver's checkpoint inside an analysis --------------------------------

#: SPIN (chip_smoke.py: a counting loop past the step budget beside an
#: unprotected kill) at 16 lanes, chunk 8 and a 256-step budget: the drive
#: saves at 128 and 256 steps
TPU_SETTINGS = dict(lanes=16, chunk=8, max_steps=256, device="cpu")


def spin_laser(checkpoint=None, resume=None, saves=None):
    """`LaserEVM(engine="tpu")` on SPIN's creation code, one transaction;
    `saves` collects (worklist length, deferred rows, npz arrays) at each
    device save."""
    from chip_smoke import SPIN

    if saves is not None:
        original = pf.Frontier.save_checkpoint

        def save(self, path, *trees, **kwargs):
            written = original(self, path, *trees, **kwargs)
            saves.append((len(self.laser.work_list), self.undelivered(),
                          npz_arrays(written)))
            return written

        pf.Frontier.save_checkpoint = save
    try:
        runtime = PORT.asm.assemble(PORT.asm.dispatcher(SPIN))
        laser = PORT.svm.LaserEVM(
            max_depth=128, execution_timeout=600, create_timeout=600,
            transaction_count=1, engine="tpu", checkpoint_path=checkpoint,
            resume_path=resume)
        laser.sym_exec(creation_code=PORT.asm.creation_wrapper(runtime).hex(),
                       contract_name="spin")
        return laser
    finally:
        if saves is not None:
            pf.Frontier.save_checkpoint = original


def test_engine_tpu_saves_and_resumes_the_device_phase(tmp_path, caplog):
    """With a checkpoint path the driver saves `<path>.device.npz` every 16
    chunks, after handing its deferred rows to the worklist, and deletes
    it when the drive ends; the statespace is the run's without one. A
    resume path whose `.device.npz` holds such a save replaces the seeded
    trees (identity, transaction and contract checked) and the drive goes
    on from the saved counters."""
    import logging
    import shutil

    pf.configure(**TPU_SETTINGS)
    try:
        plain = run_on(PORT, lambda side: spin_laser().total_states)
        saves = []
        ckpt = str(tmp_path / "spin.ckpt")
        laser = run_on(PORT, lambda side: spin_laser(checkpoint=ckpt,
                                                     saves=saves))
        assert laser.total_states == plain
        assert [deferred for _, deferred, _ in saves] == [0, 0]
        assert not os.path.exists(ckpt + ".device.npz")
        first = saves[0][2]
        assert first["tx_index"].tolist() == [0]
        assert first["identity"].tolist() == [16, 1]
        steps_saved = int(first["counters"][3])
        # resume from the first save: the drive continues past it
        resume = str(tmp_path / "resume.ckpt")
        np.savez_compressed(resume + ".device.npz", **first)
        with caplog.at_level(logging.INFO,
                             logger="mythril_tpu_torch.parallel.frontier"):
            resumed = run_on(PORT, lambda side: spin_laser(resume=resume))
        assert resumed._device_resume_path is None
        loaded = [r.getMessage() for r in caplog.records
                  if r.getMessage().startswith("resumed frontier from")]
        assert loaded == [f"resumed frontier from {resume}.device.npz "
                          f"({int(first['counters'][0])} forks so far)"]
        assert resumed.frontier_lane_steps > steps_saved
        # a foreign seeding (another lane count) is refused and runs fresh
        caplog.clear()
        pf.configure(**{**TPU_SETTINGS, "lanes": 32})
        with caplog.at_level(logging.WARNING,
                             logger="mythril_tpu_torch.parallel.frontier"):
            run_on(PORT, lambda side: spin_laser(resume=resume))
        assert any("checkpoint identity mismatch" in r.getMessage()
                   for r in caplog.records)
        shutil.rmtree(tmp_path, ignore_errors=True)
    finally:
        pf.reset()
