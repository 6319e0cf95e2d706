"""``python -m odesat_tpu_torch`` entry point."""

import sys

from odesat_tpu_torch.cli import main

sys.exit(main())
