"""`python -m glom_tpu_torch.telemetry ...`: the telemetry CLI.

    python -m glom_tpu_torch.telemetry FILE...         lint JSONL logs against
                                                       the versioned schema
    python -m glom_tpu_torch.telemetry trace FILE...   rebuild one request's
                                                       causal tree

glom_tpu's other subcommands (compare, perfetto, aggregate, watch, audit)
come with ROADMAP queue A item 9.
"""

import sys

if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv and argv[0] == "trace":
        from glom_tpu_torch.telemetry.tracectx import main as trace_main

        sys.exit(trace_main(argv[1:]))
    from glom_tpu_torch.telemetry.schema import main

    sys.exit(main(argv))
