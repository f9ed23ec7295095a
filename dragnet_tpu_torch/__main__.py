"""python -m dragnet_tpu_torch SUBCOMMAND ... (see cli.py)."""

import time as _time
_T0 = _time.time()   # before the port's imports: the 'require' span

import sys  # noqa: E402

from .cli import main  # noqa: E402
_REQUIRE_S = _time.time() - _T0

if __name__ == '__main__':
    sys.exit(main(startup=(_T0, _REQUIRE_S)))
