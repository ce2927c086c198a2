"""Global engine flags (API parity: mythril/support/support_args.py:5).

The reference copies argparse values wholesale into this singleton and reads it from
arbitrary depths. Kept for CLI/capability parity, but engine components snapshot the
values they need at construction so nothing inside a jitted TPU step reads mutable
globals (SURVEY.md §5 config note).

The port's own copy of the JAX package's singleton: the static screens
(`smt/solver/cfa_screen.py`, `analysis/module_screen.py`) read its `cfa`,
`absint` and `taint` fields."""

from __future__ import annotations


class Args:
    """Singleton flag object."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._init_defaults()
        return cls._instance

    def _init_defaults(self):
        self.solver_log = None
        self.transaction_sequences = None
        self.use_integer_module = True
        self.use_issue_annotations = False
        self.solver_timeout = 10000
        self.parallel_solving = False
        self.unconstrained_storage = False
        self.call_depth_limit = 3
        self.disable_iprof = True
        self.solc_args = None
        self.disable_coverage_strategy = False
        self.disable_mutation_pruner = False
        self.incremental_txs = True
        self.epic = False
        self.pruning_factor = None
        #: solver backend: "cdcl" (native host solver) or "jax" (batched TPU solver)
        self.solver = "cdcl"
        #: word-level simplification ahead of the bit-blaster (smt/solver/simplify.py);
        #: --no-simplify turns it off for A/B measurement
        self.simplify = True
        #: batched device SAT dispatch (smt/solver/dispatch.py): verdict
        #: cache + deferred-flush query batching on the jax lane;
        #: --no-batch-solve turns it off for A/B measurement
        self.batch_solve = True
        #: static control-flow-analysis screen (staticanalysis/ +
        #: smt/solver/cfa_screen.py); --no-cfa turns all consumers off
        #: for A/B measurement
        self.cfa = True
        #: taint module screen (staticanalysis/taint.py +
        #: analysis/module_screen.py); --no-taint turns all consumers
        #: off for A/B measurement
        self.taint = True
        #: value-range / memory-region abstract interpretation
        #: (staticanalysis/absint.py): widened memory-plane merging,
        #: proven loop bounds, constant-JUMPI pruning; --no-absint turns
        #: all consumers off for A/B measurement
        self.absint = True
        #: device-resident frontier counter plane (parallel/symstep.py);
        #: --no-frontier-telemetry compiles it out for A/B measurement
        self.frontier_telemetry = True
        #: on-device state merging at post-dominator join points
        #: (parallel/symstep.py merge_pass); --no-state-merge turns it
        #: off for A/B measurement. Distinct from enable_state_merging
        #: below, which is the host post-transaction merge plugin.
        self.state_merge = True
        self.sparse_pruning = True
        self.enable_state_merging = False
        self.enable_summaries = False
        #: deterministic fault injection spec, `CLASS[:NTH],...`
        #: (support/resilience.py; --inject-fault / MYTHRIL_TPU_INJECT_FAULT)
        self.inject_fault = None
        #: cross-check every Nth device verdict against the host CDCL oracle
        #: (0 = off); a divergence quarantines the device backend for the run
        self.device_crosscheck = 0


args = Args()
