"""`python -m gol_tpu_torch` — process entry (ref: main.go)."""

import sys

from gol_tpu_torch.cli import main

sys.exit(main())
