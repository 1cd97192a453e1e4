"""``python -m lighthouse_tpu_torch`` — the CLI entry (reference: the
``lighthouse`` binary)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
