"""Port-owned copies of the JAX package's host engine: the state model
(`state/`), the instruction interpreter (`instructions`, `natives`, `call`,
`cheat_code`), transactions (`transaction/`), search strategies
(`strategy/`) and the worklist executor `svm.LaserEVM`, plus `time_handler`,
the wall-clock budget that `support.model.get_model` and `Optimize` read.
The plugins, the concolic strategy and checkpoints come later (ROADMAP A
6b.2b, 6b.3)."""
