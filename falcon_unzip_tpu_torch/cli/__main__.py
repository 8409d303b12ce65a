"""python -m falcon_unzip_tpu_torch.cli — the port's command line."""
import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
