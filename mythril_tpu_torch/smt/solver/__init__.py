"""The port's solver stack, copies of the JAX package's modules of the same
names: the one-shot CNF pipeline (`preprocess.lower_constraints` after
`simplify`, then `bitblast.Blaster`), the native CDCL and the Python DPLL
(`sat`), the incremental pipeline (`incremental`), `Solver`/`Optimize`
(`solver`) and `IndependenceSolver`."""
