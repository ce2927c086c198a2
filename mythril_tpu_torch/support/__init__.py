"""Port-owned copies of the JAX package's support modules (`support_args`,
`signatures`, `resilience`, `model`); see mythril_tpu_torch/__init__.py."""
