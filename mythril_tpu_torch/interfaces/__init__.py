"""The port's copy of mythril_tpu/interfaces/__init__.py."""

