from upgpt_torch.utils.diagnostics import (  # noqa: F401
    PhaseTimer,
    cast_floating,
    count_params,
    device_memory_stats,
    nan_guard,
    profile_trace,
)
