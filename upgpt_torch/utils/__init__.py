from upgpt_torch.utils.diagnostics import (  # noqa: F401
    cast_floating,
    count_params,
    device_memory_stats,
    nan_guard,
)
