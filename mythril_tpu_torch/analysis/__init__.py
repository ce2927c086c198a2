"""Port-owned copy of the taint module screen (`module_screen`); see
mythril_tpu_torch/__init__.py."""
