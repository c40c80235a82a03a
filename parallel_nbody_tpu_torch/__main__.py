"""``python -m parallel_nbody_tpu_torch`` — alias for the CLI
(same argv contract as the reference binary, see cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
