"""Durable-warmth smoke of the PyTorch/CUDA port for its pre-merge gate
(tools/check_torch.sh).

The port's copy of tools/warm_smoke.py: two processes, a cold one and a
warm one, against a private warm-set directory, with the JAX tool's corpus,
phases and bound. It imports only the port and the standard library, and
reads no environment: the manifest and the device are arguments.

    python -m tools.torch_warm_smoke                 # K11 on the CUDA card
    python -m tools.torch_warm_smoke --device cpu    # K11's plain twin

The children run the batched device dispatch on the device that
``--device`` names through ``dispatch.configure(device=...)``, never on a
device picked because the card is missing: a ``cuda`` run without a card
fails. The JAX tool's counters mean, in the port, what the serving tier
defines (serve/warmset.py, kernels/build.py):

* ``xla.bucket_compiles`` counts the first run of a K11 shape key in the
  process. A warm respawn's warmup runs every manifest key once, so its
  first runs are the warmup's own: the warm child asserts that warmup ran
  no key beyond the manifest's and that the replay ran none at all;
* a compile is an nvcc build of a kernel library (``cache.exec.misses``),
  and an executable-cache hit is a library loaded from disk
  (``cache.exec.hits``). The warm child asserts zero builds; on the card
  it also asserts hits > 0 and the cold child a K11 library on disk. On
  the CPU the twin loads no library, so the hit and library checks do not
  apply there and the child's line says so;
* the warmup runs one K11 chunk (256 steps) at each manifest key. On the
  card that is milliseconds and the 2 s ready bound is asserted; on the
  CPU the plain twin's chunk alone takes about as long as the bound (and
  far longer on a loaded host), so there the child prints its ready time
  beside the bound and does not assert it.

1. **cold** (child 1): pushes a small CNF corpus through the batched
   device dispatch — every shape bucket pays its first run — then
   ``WarmSet.record_observed()`` writes the shape manifest and the verdict
   sidecar.
2. **warm** (child 2, a fresh interpreter): ``WarmSet.warmup()`` must
   build no kernel library, warm every manifest bucket, load verdicts > 0,
   and reach ready inside the 2 s acceptance bound (on the card) — and a
   replay of the same corpus must answer from the imported verdict cache
   (``dispatch.cache_hits`` > 0) without a first run of any key.

Prints ``WARM_SMOKE=ok`` on success; any failure exits non-zero with a
diagnostic. The caller bounds the wall clock (check_torch.sh wraps this in
`timeout`)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: Acceptance bound: a warm respawn must reach ready inside this wall.
WARM_READY_BUDGET_S = 2.0

#: Tiny deterministic corpus (the JAX tool's) — varied enough to exercise
#: SAT and UNSAT verdicts.
_CORPUS = [
    # SAT: (x1 | x2) & (!x1 | x2) & (x1 | !x2)  -> x1=x2=True
    ([[1, 2], [-1, 2], [1, -2]], 2),
    # UNSAT: x1 & !x1
    ([[1], [-1]], 1),
    # SAT: 3 vars, mixed widths
    ([[1, 2, 3], [-1, -2], [2, 3]], 3),
]


def _solve_corpus() -> list:
    """Run the corpus through the batched device dispatch; returns the
    verdict list (dispatch caches every SAT/UNSAT on the way)."""
    from mythril_tpu_torch.smt.solver import dispatch

    futures = [dispatch.submit(clauses, n_vars, max_conflicts=4096)
               for clauses, n_vars in _CORPUS]
    dispatch.flush()
    return [future.result()[0] for future in futures]


def _counters() -> dict:
    from mythril_tpu_torch.observe import metrics

    return {name: int(metrics.value(name)) for name in (
        "xla.bucket_compiles", "cache.exec.hits", "cache.exec.misses",
        "dispatch.cache_hits")}


def _run_cold(manifest: str, device: str) -> int:
    from mythril_tpu_torch.kernels import build
    from mythril_tpu_torch.serve.warmset import WarmSet
    from mythril_tpu_torch.smt.solver import dispatch, sat

    verdicts = _solve_corpus()
    decided = [v for v in verdicts if v in (sat.SAT, sat.UNSAT)]
    if not decided:
        print(f"cold: no decided verdicts (got {verdicts}) — nothing to "
              "persist", file=sys.stderr)
        return 1
    if not dispatch.export_verdicts():
        print("cold: verdict cache is empty after decided solves",
              file=sys.stderr)
        return 1
    compiles = _counters()["xla.bucket_compiles"]
    if compiles < 1:
        print("cold: expected at least one bucket compile, saw "
              f"{compiles}", file=sys.stderr)
        return 1
    WarmSet(manifest).record_observed()
    stored = "n/a (the CPU twin loads no kernel library)"
    if device != "cpu":
        library = build.library_path("sat_step")
        if not os.path.exists(library):
            print(f"cold: no K11 kernel library at {library}",
                  file=sys.stderr)
            return 1
        stored = 1
    print(json.dumps({"compiles": compiles, "stored": stored,
                      "verdicts": len(dispatch.export_verdicts())}))
    return 0


def _run_warm(manifest: str, device: str) -> int:
    from mythril_tpu_torch.serve.warmset import WarmSet
    from mythril_tpu_torch.smt.solver import sat

    warmset = WarmSet(manifest)
    started = time.perf_counter()
    warmed = warmset.warmup()
    ready_wall = time.perf_counter() - started

    problems = []
    after_warmup = _counters()
    compiles = after_warmup["xla.bucket_compiles"]
    builds = after_warmup["cache.exec.misses"]
    exec_hits = after_warmup["cache.exec.hits"]
    if warmed < 1:
        problems.append(f"warmed {warmed} buckets, expected >= 1")
    if compiles != warmed:
        problems.append(f"warmup ran {compiles} first run(s) of a K11 "
                        f"shape key, expected the {warmed} manifest "
                        "bucket(s) only")
    if builds != 0:
        problems.append(f"warm respawn paid {builds} kernel build(s), "
                        "expected 0 (load-only)")
    if device != "cpu" and exec_hits < 1:
        problems.append(f"executable cache hits {exec_hits}, expected >= 1")
    if warmset.loaded_verdicts < 1:
        problems.append(f"loaded {warmset.loaded_verdicts} verdicts, "
                        "expected >= 1")
    if device != "cpu" and ready_wall >= WARM_READY_BUDGET_S:
        problems.append(f"respawn-to-ready took {ready_wall:.2f}s, budget "
                        f"{WARM_READY_BUDGET_S:.1f}s")

    # replay: every corpus verdict must come from the imported cache,
    # and the replay itself must not run a new shape key
    verdicts = _solve_corpus()
    decided = [v for v in verdicts if v in (sat.SAT, sat.UNSAT)]
    after_replay = _counters()
    verdict_hits = after_replay["dispatch.cache_hits"]
    if len(decided) != len(_CORPUS):
        problems.append(f"replay decided {len(decided)}/{len(_CORPUS)} "
                        "corpus queries")
    if verdict_hits < 1:
        problems.append(f"replay verdict-cache hits {verdict_hits}, "
                        "expected >= 1")
    replay_compiles = after_replay["xla.bucket_compiles"] - compiles
    if replay_compiles != 0:
        problems.append(f"replay paid {replay_compiles} bucket compile(s), "
                        "expected 0")

    for problem in problems:
        print(f"warm: {problem}", file=sys.stderr)
    if problems:
        return 1
    print(json.dumps({
        "ready_s": round(ready_wall, 3),
        "ready_budget_s": WARM_READY_BUDGET_S if device != "cpu"
        else f"{WARM_READY_BUDGET_S} (not asserted on the CPU twin)",
        "warmed": warmed,
        "exec_hits": exec_hits if device != "cpu"
        else "n/a (the CPU twin loads no kernel library)",
        "verdicts_loaded": warmset.loaded_verdicts,
        "verdict_hits": verdict_hits}))
    return 0


def _child(phase: str, workdir: str,
           device: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "tools.torch_warm_smoke", "--phase", phase,
         "--manifest", os.path.join(workdir, "warmset.json"),
         "--device", device],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tools.torch_warm_smoke",
        description="two-process durable-warmth gate of the port (cold "
                    "first runs + persist, then a fresh process must "
                    "respawn warm)")
    parser.add_argument("--phase", choices=("cold", "warm"), default=None,
                        help="internal: run one child phase in-process")
    parser.add_argument("--manifest", default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the dispatch's device in both children "
                             "(default: the CUDA card)")
    args = parser.parse_args(argv)

    if args.phase is not None:
        from mythril_tpu_torch.smt.solver import dispatch

        dispatch.configure(device=args.device)
        dispatch.resolve_device()
        run = _run_cold if args.phase == "cold" else _run_warm
        return run(args.manifest, args.device)

    workdir = tempfile.mkdtemp(prefix="torch_warm_smoke_")
    for phase in ("cold", "warm"):
        started = time.perf_counter()
        result = _child(phase, workdir, args.device)
        wall = time.perf_counter() - started
        if result.returncode != 0:
            sys.stderr.write(result.stdout)
            sys.stderr.write(result.stderr)
            print(f"WARM_SMOKE={phase} phase failed "
                  f"(rc={result.returncode})", file=sys.stderr)
            return 1
        print(f"{phase}: {result.stdout.strip().splitlines()[-1]} "
              f"({wall:.1f}s)")
    print("WARM_SMOKE=ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
