"""The one-shot CNF pipeline of the port: `preprocess.lower_constraints`
(after `simplify`) and `bitblast.Blaster`, copies of the JAX package's
modules of the same names."""
