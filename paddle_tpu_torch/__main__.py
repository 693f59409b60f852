"""``python -m paddle_tpu_torch <train|test|gen|dump_config|version> --flags``."""

import sys

from paddle_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
