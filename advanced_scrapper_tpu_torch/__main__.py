"""``python -m advanced_scrapper_tpu_torch``: the port's CLI."""

import sys

from advanced_scrapper_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
