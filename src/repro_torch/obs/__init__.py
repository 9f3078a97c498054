"""repro_torch.obs — observability of the port: the counterpart of the JAX
package's ``repro.obs`` for what the port runs so far.

* :mod:`repro_torch.obs.trace` — span API with a JSONL event sink, the
  reference's schema (``obs.span``/``counter``/``gauge``/``event`` are cheap
  no-ops until :func:`configure` installs a tracer);
* :mod:`repro_torch.obs.metrics` — log-bucket latency histograms and a
  metrics registry with its JSONL and Prometheus exports;
* :mod:`repro_torch.obs.log` — structured ``[component] msg k=v`` logging,
  mirrored to the tracer as events;
* :mod:`repro_torch.obs.costmodel` — roofline hardware terms (the H100 the
  port runs on) and the fitted two-term latency model;
* :mod:`repro_torch.obs.profile` — kernel and serving profiles on the card.

Violation monitors, the bench trajectory and the report CLI are not
ported yet.
"""
from .trace import (  # noqa: F401
    SCHEMA,
    Tracer,
    configure,
    counter,
    enabled,
    event,
    flush,
    gauge,
    get_tracer,
    load_events,
    shutdown,
    span,
    validate_events,
)
from .metrics import Histogram, MetricsRegistry  # noqa: F401
from .log import get_logger  # noqa: F401
from .costmodel import (  # noqa: F401
    H100_SXM,
    TPU_POD_CHIP,
    CostModel,
    Hardware,
    certificate_cost_report,
    cost_report,
    fit_cost_model,
    format_bits,
    render_cost_report,
    scope_class,
)
from .profile import (  # noqa: F401
    flash_decode_terms,
    gemm_terms,
    measure,
    profile_kernels,
    profile_serving,
)
