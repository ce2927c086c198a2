"""Port-owned copies of the JAX package's host engine: the state model
(`state/`), the instruction interpreter (`instructions`, `natives`, `call`,
`cheat_code`), transactions (`transaction/`), search strategies
(`strategy/`) and the worklist executor `svm.LaserEVM`, plus `time_handler`,
the wall-clock budget that `support.model.get_model` and `Optimize` read,
the laser plugins (`plugin/`), the transaction prioritiser and the
concolic strategy. Checkpoints come with the device driver (ROADMAP A
7)."""
