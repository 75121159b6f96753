"""open3d_tpu_torch.utils: leveled logging, timers and memory statistics
(port of open3d_tpu/utils/)."""

from open3d_tpu_torch.utils.logging import (  # noqa: F401
    VerbosityLevel,
    get_verbosity_level,
    log_debug,
    log_error,
    log_info,
    log_warning,
    set_verbosity_level,
    verbosity_context,
)
from open3d_tpu_torch.utils.timer import FPSTimer, ScopeTimer, Timer  # noqa: F401
