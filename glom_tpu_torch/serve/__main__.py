"""`python -m glom_tpu_torch.serve ...`: the serving micro-server
(serve/cli.py)."""

import sys

if __name__ == "__main__":
    from glom_tpu_torch.serve.cli import main

    sys.exit(main(sys.argv[1:]))
