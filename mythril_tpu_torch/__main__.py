"""`python -m mythril_tpu_torch ...` == `myth-tpu-torch ...`.

The port's copy of mythril_tpu/__main__.py."""

import sys

from .interfaces.cli import main

if __name__ == "__main__":
    sys.exit(main())
