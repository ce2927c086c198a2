"""Port-owned copies of the JAX package's host engine modules; so far only
`time_handler`, the wall-clock budget that `support.model.get_model` and
`Optimize` read."""
