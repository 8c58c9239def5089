"""``python -m baton_tpu_torch.ops`` — the live fleet ops console.

Thin entry point; everything lives in :mod:`baton_tpu_torch.ops.console` so
the poll/render helpers are importable (and testable) without argv.
"""

import sys

from baton_tpu_torch.ops.console import main

if __name__ == "__main__":
    sys.exit(main())
