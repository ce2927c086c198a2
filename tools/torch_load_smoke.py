"""torch_load_smoke — the overload-resilience SLO gate for the PyTorch/CUDA
port's daemon (tools/check_torch.sh).

The port's copy of tools/load_smoke.py, with the same invariants, words and
bounds. It imports only the port (through tools/torch_loadgen.py) and the
standard library. Runs tools/torch_loadgen.py's SLO A/B — a short
uncontended interactive-only baseline, then a ~30 s contended run (1
worker elastic to 2, small admission queue, bulk demand past capacity,
duplicate-heavy mix) — and asserts the acceptance invariants:

1. **zero interactive requests shed** — every ``overloaded`` reply
   landed on bulk traffic; the priority queue protected the class that
   matters;
2. **bulk absorbed the shedding** — the flood actually overloaded the
   daemon (>=1 bulk shed), so invariant 1 was tested under pressure,
   not in an idle daemon;
3. **interactive p99 bounded** — the contended interactive p99 stays
   within max(2x, +5 s) of the uncontended baseline p99 (the +5 s floor
   absorbs shared-CI scheduling noise on sub-second baselines; the 2x
   bound is the real SLO once baselines grow);
4. **>=1 autoscale-up** — the backlog drove the supervisor pool past
   its starting size through the hysteresis controller;
5. **>=1 result-store hit** — a repeat codehash was answered from the
   content-addressed store without a worker dispatch.

Exit 0 with ``{"ok": true, ...}`` on stdout, exit 1 with the failed
invariants listed. Wall-clock budget ~2-3 min including daemon spawns.
"""

from __future__ import annotations

import json
import sys

from tools import torch_loadgen as loadgen


def main() -> int:
    ab = loadgen.slo_ab()
    slo = ab["slo"]
    contended = ab["contended"]
    classes = contended["classes"]
    autoscale = contended["autoscale"]
    cache = contended["cache"]

    problems = []
    if classes["interactive"]["shed"] != 0:
        problems.append(
            f"{classes['interactive']['shed']} interactive request(s) "
            f"shed — the priority queue must only ever shed bulk")
    if classes["bulk"]["shed"] < 1:
        problems.append(
            "no bulk request was shed: the flood never overloaded the "
            "daemon, so the interactive-protection invariant went "
            "untested (raise --rate or shrink --queue-max)")
    base_p99 = slo["baseline_interactive_p99_ms"]
    load_p99 = slo["contended_interactive_p99_ms"]
    p99_bound = max(2.0 * base_p99, base_p99 + 5000.0)
    if load_p99 > p99_bound:
        problems.append(
            f"contended interactive p99 {load_p99:.0f}ms exceeds "
            f"{p99_bound:.0f}ms (uncontended baseline {base_p99:.0f}ms)")
    transport = [outcome
                 for name in classes
                 for outcome, count in classes[name]["outcomes"].items()
                 if outcome.startswith("transport:") for _ in range(count)]
    if transport:
        problems.append(f"{len(transport)} transport failure(s): "
                        f"{transport[:5]} — replies must be typed sheds, "
                        f"never dropped connections")
    if not autoscale["scale_ups"]:
        problems.append("autoscaler never scaled up under a sustained "
                        "backlog (expected pool 1 -> 2)")
    if (autoscale["peak_pool"] or 0) < 2:
        problems.append(f"pool never actually grew (peak "
                        f"{autoscale['peak_pool']}, expected >= 2)")
    if not cache["store_hits"]:
        problems.append("result store answered zero repeat codehashes "
                        "in a duplicate-heavy mix")

    verdict = {
        "ok": not problems,
        "problems": problems,
        "slo": slo,
        "interactive": {k: classes["interactive"][k]
                        for k in ("sent", "ok", "shed", "p50_ms",
                                  "p95_ms", "p99_ms")},
        "bulk": {k: classes["bulk"][k]
                 for k in ("sent", "ok", "shed", "shed_rate")},
        "autoscale": autoscale,
        "cache": cache,
    }
    print(json.dumps(verdict, sort_keys=True), flush=True)
    if problems:
        for problem in problems:
            print(f"torch_load_smoke: FAIL — {problem}", file=sys.stderr)
        return 1
    print(f"torch_load_smoke: ok — {classes['interactive']['sent']} "
          f"interactive all served (0 shed, p99 {load_p99:.0f}ms vs baseline "
          f"{base_p99:.0f}ms), bulk shed {classes['bulk']['shed']}/"
          f"{classes['bulk']['sent']}, "
          f"{autoscale['scale_ups']} scale-up(s) to pool "
          f"{autoscale['peak_pool']}, "
          f"{cache['store_hits']} result-store hit(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
