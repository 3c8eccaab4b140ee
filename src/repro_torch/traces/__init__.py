from .requests import (expected_request_rate,  # noqa: F401
                       generate_request_demand)
from .workloads import (DagConfig, TraceSpec, dag_mean_task_length,  # noqa: F401
                        generate_dag_specs, generate_dag_trace,
                        generate_trace, mean_length)
