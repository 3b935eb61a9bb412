"""`python -m glom_tpu_torch.telemetry ...`: the telemetry CLI.

    python -m glom_tpu_torch.telemetry FILE...           lint JSONL logs against
                                                         the versioned schema
    python -m glom_tpu_torch.telemetry compare BASE NEW  bench-trajectory
                                                         regression gate
    python -m glom_tpu_torch.telemetry perfetto FILE...  span/flight JSONL ->
                                                         Perfetto JSON trace
    python -m glom_tpu_torch.telemetry trace FILE...     rebuild one request's
                                                         causal tree
    python -m glom_tpu_torch.telemetry aggregate PATH... merge N hosts' streams
                                                         into one pod rollup
    python -m glom_tpu_torch.telemetry watch DIR --slo R=T  live SLO monitor,
                                                         stamps slo_breach
    python -m glom_tpu_torch.telemetry audit FILE...     replay the elastic
                                                         decision chain

The lint, compare and perfetto entries touch no device: they read files
only.
"""

import sys

if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv and argv[0] == "compare":
        from glom_tpu_torch.telemetry.compare import main as compare_main

        sys.exit(compare_main(argv[1:]))
    if argv and argv[0] == "perfetto":
        from glom_tpu_torch.telemetry.perfetto import main as perfetto_main

        sys.exit(perfetto_main(argv[1:]))
    if argv and argv[0] == "trace":
        from glom_tpu_torch.telemetry.tracectx import main as trace_main

        sys.exit(trace_main(argv[1:]))
    if argv and argv[0] == "aggregate":
        from glom_tpu_torch.telemetry.aggregate import aggregate_main

        sys.exit(aggregate_main(argv[1:]))
    if argv and argv[0] == "watch":
        from glom_tpu_torch.telemetry.aggregate import watch_main

        sys.exit(watch_main(argv[1:]))
    if argv and argv[0] == "audit":
        from glom_tpu_torch.telemetry.audit import main as audit_main

        sys.exit(audit_main(argv[1:]))
    from glom_tpu_torch.telemetry.schema import main

    sys.exit(main(argv))
