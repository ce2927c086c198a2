"""The port's copy of the JAX package's host-side SMT layer, as far as the
device SAT lane needs it: the term IR (`terms`), SMT-LIB2 reading
(`smtlib.from_smt2`) and, under `solver/`, simplification, lowering and
bit-blasting to CNF. Pure Python; nothing here touches a device."""
