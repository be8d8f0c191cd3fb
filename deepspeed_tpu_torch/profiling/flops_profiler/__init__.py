from .profiler import (FlopsProfiler, cost_analysis, duration_to_string, flops_to_string,  # noqa: F401
                       get_model_profile, macs_to_string, number_to_string, params_to_string)
