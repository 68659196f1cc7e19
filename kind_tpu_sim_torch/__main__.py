"""``python -m kind_tpu_sim_torch``: the port's command line (``cli.py``)."""

import sys

from kind_tpu_sim_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
