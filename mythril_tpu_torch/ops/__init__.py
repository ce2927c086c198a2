"""Port-owned copy; see mythril_tpu_torch/__init__.py."""
