"""`python -m glom_tpu_torch.resilience` — the chaos scenario harness."""

import sys

from glom_tpu_torch.resilience.chaos import main

if __name__ == "__main__":
    sys.exit(main())
