"""Gas superoptimization over the CFA + batched device SAT stack.

The first non-detection workload on the engine substrate (ROADMAP item
5(a)): per contract, walk the recovered basic blocks, enumerate
candidate rewrites (peephole catalog + bounded exhaustive
stack-scheduling search, :mod:`.rules`), encode original-vs-candidate
as symbolic transformer-equality miters (:mod:`.encode`), discharge all
obligations through the batched dispatch queue or the host CDCL oracle,
and re-emit the runtime bytecode with the proven-cheapest bodies
(:mod:`.engine`), ranked by the static gas table (:mod:`.gas`) weighted
by absint-proven loop trip bounds.

Surfaces: the `myth-tpu optimize` CLI subcommand, the serve-tier
`optimize` protocol op, `bench.py superopt_ab`, and
`tools/superopt_smoke.py` (jax-free check.sh fast path).

The port's copy of mythril_tpu/superopt/: `python -m mythril_tpu_torch
optimize --solver jax` proves its rewrites on the device SAT lane (K11 on
the CUDA card, through smt/solver/dispatch.py), `--solver cdcl` on the
port's host CDCL.
"""

from .engine import BlockRewrite, OptimizationReport, optimize_bytecode
from .gas import STATIC_GAS, sequence_gas, static_gas

__all__ = [
    "BlockRewrite",
    "OptimizationReport",
    "STATIC_GAS",
    "optimize_bytecode",
    "sequence_gas",
    "static_gas",
]
