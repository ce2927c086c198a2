"""Recompute chip_smoke.py's SAT-lane constants with the JAX package.

    JAX_PLATFORMS=cpu python tests/_torch_sat_constants.py            # EXPECTED_SAT*
    JAX_PLATFORMS=cpu python tests/_torch_sat_constants.py stability  # STABLE_CNFS

The first form runs every query of chip_smoke.SAT_LANE_QUERIES and
SAT_BATCH_QUERIES through mythril_tpu's from_smt2 -> lower_constraints ->
Blaster, the native CDCL core and `jax_solver.solve_cnf_device` (or
`solve_cnf_device_batch`) with their defaults on the CPU, and prints the
counts, digests and verdicts chip_smoke holds the port's lane to. The lane
runs 256 steps a chunk, so this takes several minutes.

The second form lowers every corpus query in four fresh processes with
different string-hash seeds and prints the names whose CNF came out the
same in all four: the JAX pipeline orders commutative operands by a hash
of their children's ids (terms.py), so most captured queries blast to a
CNF that depends on the process, and only these can be held to a digest.
"""

import itertools
import os
import subprocess
import sys
import tarfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

CORPUS = os.path.join(HERE, "data", "smt2_corpus.tar.gz")


def jax_cnf(name):
    from mythril_tpu.smt.smtlib import from_smt2
    from mythril_tpu.smt.solver import preprocess
    from mythril_tpu.smt.solver.bitblast import Blaster

    preprocess._fresh_counter = itertools.count()
    with tarfile.open(CORPUS) as tar:
        text = tar.extractfile(name).read().decode("utf-8")
    lowered, _ = preprocess.lower_constraints(list(from_smt2(text)))
    blaster = Blaster()
    for node in lowered:
        blaster.assert_true(node)
    return blaster.clauses, blaster.n_vars


class _Stop(Exception):
    pass


def run_jax(solve, *args, stop_after=None, **kwargs):
    """A JAX entry point's (result, states after its first two chunks,
    chunk count); with `stop_after`, it is stopped after that many chunks
    and the result is None."""
    import numpy as np

    from mythril_tpu.parallel import jax_solver

    run, states, count = jax_solver._run_accounted, [], [0]

    def counted(*call):
        out = run(*call)
        count[0] += 1
        if len(states) < 2:
            states.append([np.asarray(leaf) for leaf in out])
        if stop_after is not None and count[0] >= stop_after:
            raise _Stop
        return out

    jax_solver._run_accounted = counted
    try:
        result = solve(*args, **kwargs)
    except _Stop:
        result = None
    finally:
        jax_solver._run_accounted = run
    return result, states, count[0]


def constants():
    import chip_smoke as cs
    import mythril_tpu.parallel  # noqa: F401  (x64 on)
    from mythril_tpu.parallel import jax_solver
    from mythril_tpu.smt.solver import sat

    out = {}
    for name in dict.fromkeys(cs.SAT_LANE_QUERIES + cs.SAT_BATCH_QUERIES):
        clauses, n_vars = jax_cnf(name)
        tiles = jax_solver._build_problem(clauses, n_vars).lits.shape[0]
        entry = {"clauses": len(clauses), "n_vars": n_vars, "tiles": tiles,
                 "cdcl": sat.solve_cnf_native(clauses, n_vars, 2_000_000)[0]}
        if name in cs.STABLE_CNFS:
            entry["cnf"] = cs.cnf_digest(clauses, n_vars)
        if name in cs.STABLE_CNFS and name in cs.SAT_LANE_QUERIES:
            full = name == cs.SAT_FULL_QUERY
            result, states, chunks = run_jax(
                jax_solver.solve_cnf_device, clauses, n_vars,
                stop_after=None if full else 2)
            entry["chunks"] = [cs.state_digest(s) for s in states]
            if full:
                entry["jax"] = {"status": result[0], "chunks": chunks,
                                "model": cs.model_digest(result[1])}
        out[name] = entry
        print(name, entry, flush=True)
    _, states, _ = run_jax(jax_solver.solve_cnf_device_batch,
                           [jax_cnf(name) for name in cs.SAT_BATCH_QUERIES],
                           chunk=cs.SAT_BATCH_CHUNK, stop_after=1)
    print("EXPECTED_SAT =", out)
    print("EXPECTED_SAT_BATCH =", repr(cs.state_digest(states[0])))


_DIGESTS = r"""
import sys, tarfile
sys.path[:0] = [{repo!r}, {here!r}]
import _torch_sat_constants as c, chip_smoke as cs
with tarfile.open(c.CORPUS) as tar:
    names = [m.name for m in tar.getmembers() if m.name.endswith(".smt2")]
for name in names:
    print(name, cs.cnf_digest(*c.jax_cnf(name)))
"""


def stability():
    digests = []
    for seed in ("0", "1", "2", "3"):
        env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-c", _DIGESTS.format(repo=os.path.dirname(HERE),
                                                   here=HERE)],
            env=env, capture_output=True, text=True, check=True)
        digests.append(dict(line.split() for line in proc.stdout.splitlines()))
    stable = sorted(name for name in digests[0]
                    if len({run[name] for run in digests}) == 1)
    print(f"{len(stable)} of {len(digests[0])} stable:", stable)


if __name__ == "__main__":
    stability() if sys.argv[1:] == ["stability"] else constants()
