from multimodal_sc_torch.obs.metrics_writer import (
    MetricsWriter,
    Timer,
    steps_per_sec_per_chip,
)
from multimodal_sc_torch.obs.profiling import (
    NaNWatchdog,
    annotate,
    corrupt_symbols,
    maybe_trace,
)
