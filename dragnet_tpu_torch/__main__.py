"""python -m dragnet_tpu_torch SUBCOMMAND ... (see cli.py)."""

import sys

from .cli import main

if __name__ == '__main__':
    sys.exit(main())
