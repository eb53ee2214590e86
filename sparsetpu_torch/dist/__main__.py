"""``python -m sparsetpu_torch.dist [n]``: the dry run on n gloo ranks on
the CPU (4 by default), ``dryrun.dryrun_multichip``."""

import sys

from .dryrun import dryrun_multichip

dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
