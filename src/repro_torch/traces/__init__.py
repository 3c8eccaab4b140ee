from .workloads import TraceSpec, generate_trace, mean_length  # noqa: F401
