"""``python -m trpx_tpu_torch.cli encode|decode|info|verify|concat|bench``."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
